"""The ranks of one mesh axis and the tensors that travel between them.

``parallel/pipeline.py`` and ``parallel/ring_attention.py`` run over the
ranks of one named axis of a 1-D ``DeviceMesh`` (``Engine.init(
mesh_shape={"pipe": n})`` or ``{"seq": n}``, or a mesh passed by the
caller).  :func:`axis_group` finds that axis; :class:`AxisGroup` moves
tensors over it: a hop to the neighbouring ranks of the ring (the
reference's ``ppermute``), a broadcast from one rank, a sum, a gather and
an all-to-all.

Where the group's backend is gloo and the tensors live on a CUDA device
(two ranks sharing one card, which NCCL refuses), a hop goes through host
copies (``.cpu()`` and back): gloo's point-to-point send and receive hand
its TCP transport the raw device pointer, which it reads as host memory
(the process dies with ``writev ... Bad address``: two gloo ranks on one
H100, torch 2.11 with CUDA 12.8).  Its broadcast, all-reduce, all-gather
and all-to-all take CUDA tensors, and ``chip_smoke.py``'s ``pipe_seq``
phase runs each of them on the card.  The backend decides the route; no
route is chosen by catching an error.  :data:`host_copies` counts the
tensors that went through the host, by operation, in this process.  Each
hop that moves a tensor counts one in ``Engine.permutes`` and each
all-to-all one in ``Engine.all_to_alls``, by the caller's ``kind``
(``Engine.collectives()``).
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "axis_group", "host_copies"]

#: tensors that went through host memory in this process, by operation
host_copies = collections.Counter()


def axis_group(mesh, axis: str) -> Optional["AxisGroup"]:
    """The :class:`AxisGroup` of ``mesh``'s ``axis`` (``mesh`` None: the
    Engine's), or None where there is no mesh or it has no such axis."""
    if mesh is None:
        from ..utils.engine import Engine
        mesh = Engine.mesh()
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names:
        return None
    return AxisGroup(mesh.get_group(axis))


class AxisGroup:
    """One axis's process group: its size ``n``, this process's ``rank``
    on it, and the collectives the parallel modules use."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    def global_rank(self, r: int) -> int:
        """The default group's rank of this group's rank ``r`` (mod n)."""
        return dist.get_global_rank(self.group, r % self.n)

    def hop(self, sends: Sequence, recvs: Sequence,
            kind: str = "hop") -> List[torch.Tensor]:
        """One hop of point-to-point transfers, posted together:
        ``sends`` are (tensor, rank offset, tag), ``recvs`` are (template
        tensor, rank offset, tag), each offset relative to this rank on
        the ring (+1 the next rank, -1 the previous).  Returns the received
        tensors, shaped and typed like their templates, on their device;
        counted under ``kind`` in ``Engine.permutes``."""
        ops, bufs, outs = [], [], []
        for t, off, tag in sends:
            if t is None:
                raise RuntimeError(f"a hop to rank offset {off} (tag {tag}) "
                                   "has nothing to send")
            t = t.detach().contiguous()
            if self.backend == "gloo" and t.is_cuda:
                t = t.cpu()
                host_copies["hop"] += 1
            ops.append(dist.P2POp(dist.isend, t, self.global_rank(
                self.rank + off), self.group, tag))
        for like, off, tag in recvs:
            host = self.backend == "gloo" and like.is_cuda
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if host else like.device)
            bufs.append((buf, host, like.device))
            ops.append(dist.P2POp(dist.irecv, buf, self.global_rank(
                self.rank + off), self.group, tag))
        if ops:
            from ..utils.engine import Engine
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            Engine.permutes[kind] += 1
        for buf, host, device in bufs:
            if host:
                host_copies["hop"] += 1
                buf = buf.to(device)
            outs.append(buf)
        return outs

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place."""
        dist.broadcast(t, self.global_rank(src), group=self.group)
        return t

    def all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """The sum of ``t`` over the axis, in place, counted under
        ``kind`` in ``Engine.all_reduces``."""
        from ..utils.engine import Engine
        return Engine.all_reduce(t, kind, group=self.group)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, t: torch.Tensor,
                   kind: str = "all_to_all") -> torch.Tensor:
        """``t``'s block r (of ``n`` along axis 0) to rank r; returns the
        blocks received, block r from rank r; counted under ``kind`` in
        ``Engine.all_to_alls``."""
        from ..utils.engine import Engine
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        Engine.all_to_alls[kind] += 1
        return out
