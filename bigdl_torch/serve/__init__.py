"""Online serving: dynamic batching, the inference server with hot swap,
canary, replica restarts and autoscaling, traffic traces, continuous
train-to-serve deployment and the continuous-batching decode engine.

The reference's fleet half (``FleetSupervisor``, ``FleetFront``,
``MemberLostError``) and its topology router (``TopologyRouter``,
``PlacementError``, ``plan_subsets``) are not ported yet (ROADMAP queue A
items 5 and 8)."""

from .autoscale import AutoScaler
from .batcher import (DecodeQueue, DynamicBatcher, PendingRequest,
                      RequestTimeout, ServeError, ServerClosed,
                      ServerOverloaded, default_buckets, fit_bucket, pad_rows,
                      pad_tail, predict_in_fixed_batches)
from .continuous import (DeployController, ReleasePublisher,
                         ReleaseRejected, read_release)
from .control import (CanaryController, CanaryRejected, QuotaExceeded,
                      ReplicaLostError, ReplicaMonitor, TenantQuotas)
from .decode import DecodeEngine, SlotFault, page_ladder
from .server import InferenceServer, ModelVersion
from .tracefile import (TraceEvent, TraceFormatError, TraceRecorder,
                        read_trace, replay, resolve_outcomes, slo_report,
                        write_trace)

__all__ = ["InferenceServer", "ModelVersion", "DynamicBatcher",
           "PendingRequest", "ServeError", "ServerOverloaded",
           "ServerClosed", "RequestTimeout", "ReplicaLostError",
           "CanaryRejected", "QuotaExceeded", "TenantQuotas",
           "CanaryController", "ReplicaMonitor", "default_buckets",
           "pad_rows", "pad_tail", "fit_bucket", "predict_in_fixed_batches",
           "AutoScaler", "TraceEvent", "TraceFormatError",
           "TraceRecorder", "read_trace", "write_trace", "replay",
           "resolve_outcomes", "slo_report",
           "DeployController", "ReleasePublisher", "ReleaseRejected",
           "read_release",
           "DecodeEngine", "DecodeQueue", "SlotFault", "page_ladder"]
