"""Process-level configuration from ``BIGDL_TORCH_*`` environment variables.

Counterpart of ``bigdl_tpu/utils/config.py`` for the knobs the port has.
Nothing here selects between a kernel and its plain version: on the card
the kernels always run.

| env var                          | meaning                                        | default |
|----------------------------------|------------------------------------------------|---------|
| BIGDL_TORCH_SEED                 | seed of the default init generator             | 0       |
| BIGDL_TORCH_SERVE_MAX_BATCH      | max requests coalesced per device batch        | 8       |
| BIGDL_TORCH_SERVE_MAX_WAIT_MS    | max ms the oldest request waits for batch fill | 5       |
| BIGDL_TORCH_SERVE_QUEUE_LIMIT    | bounded queue; admission past it is shed       | 64      |
| BIGDL_TORCH_SERVE_REPLICAS       | worker threads draining the shared queue       | 1       |
| BIGDL_TORCH_SERVE_DEADLINE_MS    | default per-request deadline (0 = none)        | 0       |
| BIGDL_TORCH_SERVE_STALL_SECONDS  | per-replica supervision deadline (0 = unwatched) | 0     |
| BIGDL_TORCH_SERVE_REPLICA_LOST   | replica heartbeat silence before a restart (0 = monitor off) | 0 |
| BIGDL_TORCH_SERVE_RESTART_BUDGET / _RESTART_BACKOFF | restarts a replica before unhealthy; base backoff, s | 3 / 0.1 |
| BIGDL_TORCH_SERVE_CANARY_MIN_BATCHES / _WINDOW / _LATENCY_RATIO / _ERROR_MARGIN | canary promotion and rollback | 8 / 64 / 2.0 / 0.05 |
| BIGDL_TORCH_SERVE_TENANT_QPS / _TENANT_BURST | per-tenant token bucket (0 = quotas off) | 0 / 0 |
| BIGDL_TORCH_SERVE_AUTOSCALE_*    | queue-driven autoscaling (``serve/autoscale.py``) | off  |
| BIGDL_TORCH_SERVE_TRACE_LIMIT    | offered-traffic events kept while recording    | 100000  |
| BIGDL_TORCH_DEPLOY_*             | the deploy controller (``serve/continuous.py``) | see there |
| BIGDL_TORCH_TRACE / _TRACE_RING / _TRACE_FLUSH_EVERY | span tracer (``utils/telemetry.py``) | off / 65536 / 4096 |
| BIGDL_TORCH_METRICS / _METRICS_SLO_MS / _METRICS_WINDOW | metrics registry (``utils/metrics_export.py``) | 1 / 100 / 512 |
| BIGDL_TORCH_COORDINATOR          | rank 0's host:port, or an init URL (file://…)  | (none)  |
| BIGDL_TORCH_NUM_PROCESSES        | world size of the data group                   | 1       |
| BIGDL_TORCH_PROCESS_ID           | this process's rank                            | 0       |
| BIGDL_TORCH_PREFETCH_DEPTH       | batches the input worker keeps ready; 0: none  | 2       |
| BIGDL_TORCH_PREFETCH_STAGE       | the input worker also copies batches to device | 1       |
| BIGDL_TORCH_DATA_SKIP_BUDGET     | corrupt records a data pass may quarantine     | 0       |
| BIGDL_TORCH_DECODE_SLOTS         | decode engine: fixed in-flight sequence slots  | 4       |
| BIGDL_TORCH_DECODE_PAGE          | cache-page quantum; cache length is page * 2^k | 128     |
| BIGDL_TORCH_DECODE_MAX_LEN       | cache-length cap (0 = the model's positions)   | 0       |
| BIGDL_TORCH_DECODE_QUEUE_LIMIT   | bounded decode admission queue                 | 64      |
| BIGDL_TORCH_DECODE_DEADLINE_MS   | default time-to-last-token deadline (0 = none) | 0       |
| BIGDL_TORCH_DECODE_ADMISSION     | ``continuous`` (join per tick) or ``batch``    | continuous |
| BIGDL_TORCH_DECODE_MIN_STEP_MS   | per-tick pacing floor                          | 0       |
| BIGDL_TORCH_CKPT_KEEP_LAST       | snapshot pairs kept (0 = all)                  | 0       |
| BIGDL_TORCH_CKPT_KEEP_EVERY_EPOCHS | also keep each N-th epoch's first (0 = off)  | 0       |
| BIGDL_TORCH_RETRY_TIMES          | failed attempts the retry loop recovers from   | 5       |
| BIGDL_TORCH_RETRY_INTERVAL       | seconds between failures that reset the count  | 120     |
| BIGDL_TORCH_PREEMPTION_CHECKPOINT | SIGTERM -> a final snapshot, TrainingPreempted | 1       |
| BIGDL_TORCH_IO_RETRIES           | remote-IO attempts per op after the first      | 3       |
| BIGDL_TORCH_IO_BACKOFF_BASE      | remote-IO backoff base, seconds                | 0.05    |
| BIGDL_TORCH_IO_BACKOFF_MAX       | remote-IO backoff cap, seconds                 | 2.0     |
| BIGDL_TORCH_IO_DEADLINE          | seconds a retried remote op may take in all    | 60      |
| BIGDL_TORCH_CHAOS                | fault-injection spec (``utils/chaos.py``)      | off     |
| BIGDL_TORCH_SUPERVISE_DATA / _STEP / _COMPILE / _CHECKPOINT / _VALIDATION / _SERVE | per-phase stall deadline, seconds (``utils/supervisor.py``) | 0 (off) |
| BIGDL_TORCH_SUPERVISE_DEADLINE   | stall deadline of the phases without their own | 0 (off) |
| BIGDL_TORCH_SUPERVISE_POLICY     | ``raise`` a StallError or hard-``exit``        | raise   |
| BIGDL_TORCH_FUSED_UPDATE         | the update over one flat tensor per dtype      | 0       |
| BIGDL_TORCH_WIRE_BUCKET_MB       | gradient bucket cap, MB (0 = per-leaf wire)    | 0       |
| BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS | cap on (T, B, gates) elements of the hoisted input projection | 2^28 |
"""

from __future__ import annotations

import os

__all__ = ["get_int", "get_float", "get_bool", "get_str", "seed",
           "retry_times", "retry_time_interval"]


def get_str(name: str, default: str) -> str:
    return os.environ.get(f"BIGDL_TORCH_{name}", default)


def get_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(f"BIGDL_TORCH_{name}", default))
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(f"BIGDL_TORCH_{name}", default))
    except ValueError:
        return default


def get_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(f"BIGDL_TORCH_{name}")
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def seed() -> int:
    return get_int("SEED", 0)


def retry_times() -> int:
    """(reference: bigdl.failure.retryTimes, DistriOptimizer.scala:751)."""
    return get_int("RETRY_TIMES", 5)


def retry_time_interval() -> float:
    """Seconds between two failures beyond which the retry count starts
    over (bigdl.failure.retryTimeInterval, DistriOptimizer.scala:752)."""
    return get_float("RETRY_INTERVAL", 120.0)
