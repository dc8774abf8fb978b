"""Sharding strategies: how parameters and batches map onto the data group.

Counterpart of ``bigdl_tpu/parallel/sharding.py``.  The reference's only
inter-node strategy is synchronous data parallelism
(``parameters/AllReduceParameter.scala``), expressed there as shardings of
one compiled program.  Here a strategy is what the ``Optimizer`` does
around each rank's eager step:

- :class:`DataParallel`: parameters and buffers are replicated, broadcast
  from rank 0 when the optimizer starts; each rank feeds its own rows
  (``DataSet.array(..., distributed=True)``), and after the backward the
  gradients are averaged over the group in one all-reduce.

Not ported yet (constructing one raises): ``ShardedDataParallel`` (ZeRO,
ROADMAP queue A item 4), ``TensorParallel`` and ``LayoutSharding`` (the
MeshLayout axes, queue A item 8).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from ..utils.engine import Engine

__all__ = ["ShardingStrategy", "DataParallel", "ShardedDataParallel",
           "TensorParallel", "LayoutSharding"]


class ShardingStrategy:
    """What the Optimizer does around each rank's step."""

    def setup(self, model: torch.nn.Module) -> None:
        """Make the model's parameters and buffers agree across ranks
        before the first step."""
        raise NotImplementedError

    def reduce(self, grads: List[torch.Tensor], loss: torch.Tensor
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(gradients, loss) of this rank's batch -> those of the global
        batch, the loss a 0-d float32 tensor (reading it would wait for
        the card)."""
        raise NotImplementedError


class DataParallel(ShardingStrategy):
    """Replicated parameters, per-rank rows, averaged gradients (the
    reference's strategy)."""

    @torch.no_grad()
    def setup(self, model):
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, 0, group=Engine.group())

    @torch.no_grad()
    def reduce(self, grads, loss):
        """Every gradient and the loss flattened into one float32 buffer,
        summed over the group in one all-reduce, divided by the world size
        and split back: each rank's loss is the mean over its rows, so the
        mean over ranks is the global-batch loss and gradient."""
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().float().reshape(1)])
        Engine.all_reduce(flat, "grads")
        flat /= Engine.world()
        parts = torch.split(flat[:-1], [g.numel() for g in grads])
        return ([p.view(g.shape) for p, g in zip(parts, grads)], flat[-1])


class _NotPorted(ShardingStrategy):
    ITEM = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__} is not ported "
                                  f"yet (ROADMAP queue A item {self.ITEM})")


class ShardedDataParallel(_NotPorted):
    """ZeRO: parameters and optimizer state in 1/N slices."""
    ITEM = "4"


class TensorParallel(_NotPorted):
    """Wide layers split over a 'model' axis."""
    ITEM = "8"


class LayoutSharding(_NotPorted):
    """The MeshLayout (data, fsdp, tp, pipe, expert) strategy."""
    ITEM = "8"
