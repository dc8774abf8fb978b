"""Configuration, the CUDA and host builds, weight and optimizer-state
carry-over, checkpoint files and their CRC32C, the Engine's data group,
the Torch-style ``Table`` and the seeded ``RandomGenerator``."""

from .engine import Engine
from .rng import RNG, RandomGenerator
from .table import T, Table

__all__ = ["Engine", "Table", "T", "RandomGenerator", "RNG"]
