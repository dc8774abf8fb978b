"""The gradient wire: every gradient rounded through the wire dtype, per
leaf or in size-capped buckets, and the collective-cost probe.

Counterpart of ``bigdl_tpu/parallel/wire.py``.  The reference ships
gradients between nodes in a bf16-truncated format
(``FP16CompressedTensor``), and its train step rounds each gradient
through ``DTypePolicy.wire_dtype`` after the regularizers and scales and
before clipping and the update, on one device as on many
(``optim/optimizer.py`` ``_build_step``).  The port's ``Optimizer`` does
the same with :func:`wire_cast`.

``BIGDL_TORCH_WIRE_BUCKET_MB`` (:func:`wire_bucket_mb`, default 0) cuts the
gradient leaves, in order, into buckets of at most that many megabytes
(:func:`bucket_assignment`: greedy, a leaf larger than the cap gets a bucket
of its own and is never split).  :func:`wire_cast` then rounds each bucket
as one buffer: the cast is elementwise and the concatenation and split move
values verbatim, so the values are bit-identical to the per-leaf cast.  The
same assignment, over float32 bytes, cuts ``DataParallel``'s gradient
all-reduce into one all-reduce per bucket, each launched from the backward
as soon as its last gradient is ready (``parallel/sharding.py``): the
counterpart of the reference's buckets under XLA's latency-hiding
scheduler.  ``bucket_mb <= 0`` keeps the per-leaf cast and the single
all-reduce.

:func:`measure_collective_seconds` times a standalone all-reduce of the
same bucket layout over the Engine's group: the unoverlapped cost of the
step's gradient reduction, to set beside the step time.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from ..utils import config
from ..utils.engine import Engine

__all__ = ["bucket_assignment", "bucket_count", "wire_cast",
           "measure_collective_seconds", "wire_bucket_mb"]


def wire_bucket_mb() -> float:
    """The ``BIGDL_TORCH_WIRE_BUCKET_MB`` knob: the most megabytes per
    gradient bucket; 0 (the default) keeps the per-leaf wire."""
    return config.get_float("WIRE_BUCKET_MB", 0.0)


def bucket_assignment(sizes: Sequence[int], itemsize: int,
                      cap_mb: float) -> List[List[int]]:
    """Leaf indices by bucket: consecutive leaves share a bucket until the
    next would take it past ``cap_mb`` megabytes at ``itemsize`` bytes an
    element; a leaf larger than the cap gets its own bucket."""
    cap_elems = max(1, int(cap_mb * (1 << 20) / max(itemsize, 1)))
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_elems = 0
    for i, n in enumerate(sizes):
        if cur and cur_elems + n > cap_elems:
            buckets.append(cur)
            cur, cur_elems = [], 0
        cur.append(i)
        cur_elems += n
    if cur:
        buckets.append(cur)
    return buckets


def bucket_count(tensors: Sequence[torch.Tensor], wire: Optional[torch.dtype],
                 bucket_mb: Optional[float] = None) -> int:
    """How many buckets of ``wire`` elements the leaves ``tensors`` take
    (0: ``wire`` is None or bucketing is off), from the same assignment
    :func:`wire_cast` and the bucketed all-reduce use."""
    if wire is None:
        return 0
    if bucket_mb is None:
        bucket_mb = wire_bucket_mb()
    sizes = [t.numel() for t in tensors]
    if bucket_mb <= 0 or not sizes:
        return 0
    return len(bucket_assignment(sizes, wire.itemsize, bucket_mb))


def wire_cast(grads: List[torch.Tensor], wire: Optional[torch.dtype],
              bucket_mb: Optional[float] = None) -> List[torch.Tensor]:
    """Each gradient rounded to ``wire`` and widened back to float32;
    ``wire=None`` returns ``grads`` as they are.  ``bucket_mb`` (default:
    the knob) <= 0 casts leaf by leaf (``g.to(wire).float()``); above 0
    each bucket is cast as one buffer and split back into views, with
    bit-identical values."""
    if wire is None:
        return grads
    if bucket_mb is None:
        bucket_mb = wire_bucket_mb()
    if bucket_mb <= 0:
        return [g.to(wire).float() for g in grads]
    sizes = [g.numel() for g in grads]
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for bucket in bucket_assignment(sizes, wire.itemsize, bucket_mb):
        buf = torch.cat([grads[i].reshape(-1).to(wire) for i in bucket])
        parts = buf.float().split([sizes[i] for i in bucket])
        for i, part in zip(bucket, parts):
            out[i] = part.view(grads[i].shape)
    return out


def measure_collective_seconds(params: Sequence[torch.Tensor],
                               wire: Optional[torch.dtype] = None,
                               bucket_mb: Optional[float] = None,
                               iters: int = 3) -> float:
    """Seconds of one standalone reduction of the gradient wire: zero
    buffers of ``wire`` (default float32, the dtype the port's gradient
    all-reduce carries) in the bucket layout of ``bucket_mb`` (default:
    the knob; <= 0: one buffer per leaf), each all-reduced over the
    Engine's group, the mean of ``iters`` rounds after one untimed round.
    0.0 without a group or at a world of one, where no collective exists.
    Counted under the kind ``"probe"``."""
    if Engine.group() is None or Engine.group_size() <= 1:
        return 0.0
    wire = wire or torch.float32
    sizes = [p.numel() for p in params]
    if not sizes:
        return 0.0
    if bucket_mb is None:
        bucket_mb = wire_bucket_mb()
    if bucket_mb > 0:
        elems = [sum(sizes[i] for i in b)
                 for b in bucket_assignment(sizes, wire.itemsize, bucket_mb)]
    else:
        elems = sizes
    device = Engine.device()
    bufs = [torch.zeros(n, dtype=wire, device=device) for n in elems]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def one_round():
        for b in bufs:
            Engine.all_reduce(b, "probe")
        sync()
    one_round()
    t0 = time.perf_counter()
    for _ in range(iters):
        one_round()
    return (time.perf_counter() - t0) / iters
