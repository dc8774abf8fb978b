"""Data parallelism: sharding strategies, the gradient wire and its
buckets; elastic training (``elastic``: host-loss recovery and
re-admission)."""

from .elastic import ElasticNegotiationError, PeerLostError
from .sharding import (DataParallel, LayoutSharding, ShardedDataParallel,
                       ShardingStrategy, TensorParallel)
from .wire import (bucket_assignment, bucket_count,
                   measure_collective_seconds, wire_bucket_mb, wire_cast)

__all__ = ["ShardingStrategy", "DataParallel", "ShardedDataParallel",
           "TensorParallel", "LayoutSharding", "wire_cast",
           "bucket_assignment", "bucket_count", "measure_collective_seconds",
           "wire_bucket_mb", "PeerLostError", "ElasticNegotiationError"]
