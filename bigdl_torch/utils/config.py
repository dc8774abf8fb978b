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
| BIGDL_TORCH_COORDINATOR          | rank 0's host:port, or an init URL (file://…)  | (none)  |
| BIGDL_TORCH_NUM_PROCESSES        | world size of the data group                   | 1       |
| BIGDL_TORCH_PROCESS_ID           | this process's rank                            | 0       |
| BIGDL_TORCH_PREFETCH_DEPTH       | batches the input worker keeps ready; 0: none  | 2       |
| BIGDL_TORCH_PREFETCH_STAGE       | the input worker also copies batches to device | 1       |
| BIGDL_TORCH_DECODE_SLOTS         | decode engine: fixed in-flight sequence slots  | 4       |
| BIGDL_TORCH_DECODE_PAGE          | cache-page quantum; cache length is page * 2^k | 128     |
| BIGDL_TORCH_DECODE_MAX_LEN       | cache-length cap (0 = the model's positions)   | 0       |
| BIGDL_TORCH_DECODE_QUEUE_LIMIT   | bounded decode admission queue                 | 64      |
| BIGDL_TORCH_DECODE_DEADLINE_MS   | default time-to-last-token deadline (0 = none) | 0       |
| BIGDL_TORCH_DECODE_ADMISSION     | ``continuous`` (join per tick) or ``batch``    | continuous |
| BIGDL_TORCH_DECODE_MIN_STEP_MS   | per-tick pacing floor                          | 0       |
"""

from __future__ import annotations

import os

__all__ = ["get_int", "get_float", "get_bool", "get_str", "seed"]


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
