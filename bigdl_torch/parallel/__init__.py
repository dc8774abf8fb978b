"""Parallelism: data parallelism (sharding strategies, the gradient wire
and its buckets); elastic training (``elastic``: host-loss recovery and
re-admission); mixture-of-experts (``expert``: capacity routing, the MoE
FFN and its all-to-all over a mesh axis); pipeline parallelism
(``pipeline``, ``schedule``: stage stacks under GPipe and 1F1B over a
``pipe`` axis); sequence parallelism (``ring_attention``: ring and
Ulysses attention over a ``seq`` axis); the mesh layouts (``layout``:
``MeshLayout`` and the role table; ``mesh_plan``: parameters held as
mesh shards; ``LayoutSharding`` and ``TensorParallel``)."""

from .elastic import ElasticNegotiationError, PeerLostError
from .layout import (MeshLayout, MeshReformError, UnannotatedParameterError,
                     assign_shardings, assign_specs)
from .expert import (MoEFFN, expert_parallel_ffn, load_balancing_loss,
                     top_k_routing)
from .pipeline import (GPipeSequential, PipelinePartitionError,
                       bubble_fraction, partition_pipeline, pipe_microbatches,
                       pipe_schedule, pipe_virtual_stages, pipeline_apply,
                       pipeline_apply_scheduled, stack_stage_params)
from .ring_attention import ring_attention, ulysses_attention
from .schedule import ScheduleTable, build_schedule
from .sharding import (DataParallel, LayoutSharding, ShardedDataParallel,
                       ShardingStrategy, TensorParallel)
from .wire import (bucket_assignment, bucket_count,
                   measure_collective_seconds, wire_bucket_mb, wire_cast)

__all__ = ["ShardingStrategy", "DataParallel", "ShardedDataParallel",
           "TensorParallel", "LayoutSharding", "wire_cast",
           "bucket_assignment", "bucket_count", "measure_collective_seconds",
           "wire_bucket_mb", "PeerLostError", "ElasticNegotiationError",
           "MoEFFN", "expert_parallel_ffn", "top_k_routing",
           "load_balancing_loss", "ring_attention", "ulysses_attention",
           "pipeline_apply", "pipeline_apply_scheduled",
           "stack_stage_params", "GPipeSequential", "partition_pipeline",
           "PipelinePartitionError", "pipe_microbatches", "pipe_schedule",
           "pipe_virtual_stages", "bubble_fraction", "ScheduleTable",
           "build_schedule", "MeshLayout", "UnannotatedParameterError",
           "MeshReformError", "assign_specs", "assign_shardings"]
