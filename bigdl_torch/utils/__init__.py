"""Configuration, the CUDA and host builds, weight and optimizer-state
carry-over, checkpoint files and their CRC32C, the Engine's data group,
the Torch-style ``Table``, the seeded ``RandomGenerator``, telemetry
(``utils.telemetry``) and live metrics (``utils.metrics_export``), and the
measurement helpers: device timing (``utils.timing``), FLOP counting and
the device peak (``utils.flops``), memory (``utils.memstats``), the module
profiler and traced steps (``utils.profiling``) and the dependencies' log
filter (``utils.logger_filter``)."""

from .engine import Engine
from .rng import RNG, RandomGenerator
from .table import T, Table
from .thread_pool import ThreadPool
from .util import kth_largest

__all__ = ["Table", "T", "Engine", "RandomGenerator", "RNG", "kth_largest",
           "ThreadPool"]
