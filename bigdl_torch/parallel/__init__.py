"""Data parallelism: sharding strategies and the gradient wire."""

from .sharding import (DataParallel, LayoutSharding, ShardedDataParallel,
                       ShardingStrategy, TensorParallel)
from .wire import wire_cast

__all__ = ["ShardingStrategy", "DataParallel", "ShardedDataParallel",
           "TensorParallel", "LayoutSharding", "wire_cast"]
