"""Online serving: dynamic batching, the inference server and the
continuous-batching decode engine."""

from .batcher import (DecodeQueue, DynamicBatcher, PendingRequest,
                      RequestTimeout, ServeError, ServerClosed,
                      ServerOverloaded, default_buckets, fit_bucket, pad_rows,
                      pad_tail)
from .control import QuotaExceeded, TenantQuotas
from .decode import DecodeEngine, SlotFault, page_ladder
from .server import InferenceServer, ModelVersion

__all__ = ["InferenceServer", "ModelVersion", "DynamicBatcher",
           "DecodeQueue", "PendingRequest", "ServeError", "ServerOverloaded",
           "ServerClosed", "RequestTimeout", "QuotaExceeded", "TenantQuotas",
           "DecodeEngine", "SlotFault", "page_ladder", "default_buckets",
           "fit_bucket", "pad_rows", "pad_tail"]
