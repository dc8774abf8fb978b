"""Data parallelism: sharding strategies, the gradient wire and its
buckets; elastic training (``elastic``: host-loss recovery and
re-admission); mixture-of-experts (``expert``: capacity routing, the MoE
FFN and its all-to-all over a mesh axis)."""

from .elastic import ElasticNegotiationError, PeerLostError
from .expert import (MoEFFN, expert_parallel_ffn, load_balancing_loss,
                     top_k_routing)
from .sharding import (DataParallel, LayoutSharding, ShardedDataParallel,
                       ShardingStrategy, TensorParallel)
from .wire import (bucket_assignment, bucket_count,
                   measure_collective_seconds, wire_bucket_mb, wire_cast)

__all__ = ["ShardingStrategy", "DataParallel", "ShardedDataParallel",
           "TensorParallel", "LayoutSharding", "wire_cast",
           "bucket_assignment", "bucket_count", "measure_collective_seconds",
           "wire_bucket_mb", "PeerLostError", "ElasticNegotiationError",
           "MoEFFN", "expert_parallel_ffn", "top_k_routing",
           "load_balancing_loss"]
