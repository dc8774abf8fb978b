"""Sequence parallelism over the ranks of a ``seq`` axis: ring and Ulysses
attention.

Counterpart of ``bigdl_tpu/parallel/ring_attention.py``.  Both functions
take and return THIS rank's shard [B, H, T/n, D] of q, k, v (rank r holds
rows ``[r·T/n, (r+1)·T/n)`` of T), the view of the reference's
``shard_map`` body, over the ``seq`` axis of ``mesh`` or of the
Engine's (``Engine.init(mesh_shape={"seq": n})``, or ``{"data": d,
"seq": n}``, where each data row's seq group rings its own rows of the
batch; ``MultiHeadAttention``'s seam rings over a layout's ``tp`` axis).

- :func:`ring_attention`: each rank keeps its query shard and passes its
  k/v block to the next rank around the ring.  Each ring step is the
  flash-attention forward B6 with the log-sum-exp on (q, k block, v
  block) (the reference computes that step in jnp, ``_block_attn``; B6
  computes the same function), and the blocks are merged in float32 by
  the log-sum-exp rule.  With equal shards a block below the diagonal is
  not causal, the diagonal block is causal, and a block above it is
  skipped (the reference masks it to exactly zero).  The backward is a
  second trip around the ring: B7 per block with the FINAL output and
  log-sum-exp, so each block's probabilities are the global ones; dq
  accumulates at home, while dk and dv travel with their k/v block and
  take one more hop home at the end.
- :func:`ulysses_attention`: an all-to-all from sequence shards to head
  shards [B, H/n, T, D], ``flash_attention`` (B6, B7) over the whole T
  on H/n heads, and an all-to-all back; the backward of each all-to-all
  is the reverse all-to-all.

On CPU tensors the kernels' plain versions run (``ops/attention.py``;
the ring's block backward from the final log-sum-exp is
:func:`block_bwd_reference`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import attention as attn_ops
from .hops import AxisGroup, axis_group

__all__ = ["ring_attention", "ulysses_attention", "block_bwd_reference"]


def _seq_axis(mesh, seq_axis: str) -> AxisGroup:
    ax = axis_group(mesh, seq_axis)
    if ax is None:
        raise ValueError(
            f"sequence parallelism needs a mesh with a {seq_axis!r} axis "
            "(Engine.init(mesh_shape={'seq': n}) or mesh=)")
    return ax


def block_bwd_reference(q, k, v, o, do, lse, *, causal: bool,
                        sm_scale: float):
    """(dq, dk, dv) of one block of a softmax normalized elsewhere, in
    plain PyTorch: P = exp(s - lse) with the FINAL log-sum-exp, Δ =
    rowsum(do·o) with the final output, dS = P(dP - Δ) — what B7 computes
    from the ``lse`` it is given.  Float32 results."""
    qf, kf, vf = q.float(), k.float(), v.float()
    gf, of = do.float(), o.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None]
        kj = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
    p = torch.exp(s - lse[..., None])
    delta = (gf * of).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sm_scale
    return dq, dk, dv


def _block_bwd(q, k, v, o, do, lse, causal, sm_scale):
    """One block's (dq, dk, dv), float32: B7 on the card, the plain
    version on the CPU."""
    if q.device.type == "cpu":
        return block_bwd_reference(q, k, v, o, do, lse, causal=causal,
                                   sm_scale=sm_scale)
    dq, dk, dv = attn_ops.flash_attention_bwd(q, k, v, o, do, lse=lse,
                                              causal=causal,
                                              sm_scale=sm_scale)
    return dq.float(), dk.float(), dv.float()


def _blocks(n: int, rank: int, causal: bool):
    """(ring step, block index, causal flag) of each block this rank
    attends to: at step s it holds block (rank - s) mod n; with a causal
    mask the blocks above the diagonal are skipped."""
    out = []
    for s in range(n):
        b = (rank - s) % n
        if causal and b > rank:
            continue
        out.append((s, b, causal and b == rank))
    return out


class _Ring(torch.autograd.Function):
    """Ring attention over one axis: (q, k, v shards) -> o shard."""

    @staticmethod
    def forward(ctx, ax: AxisGroup, q, k, v, causal, sm_scale):
        n, r = ax.n, ax.rank
        todo = {s: c for s, _, c in _blocks(n, r, causal)}
        o = lse = None
        kb, vb = k, v
        for s in range(n):
            if s in todo:
                ob, lb = attn_ops.flash_attention_with_lse(
                    q, kb, vb, causal=todo[s], sm_scale=sm_scale)
                ob = ob.float()
                if o is None:
                    o, lse = ob, lb
                else:
                    # the log-sum-exp merge, in float32
                    new = torch.logaddexp(lse, lb)
                    o = (o * torch.exp(lse - new)[..., None]
                         + ob * torch.exp(lb - new)[..., None])
                    lse = new
            if s + 1 < n:
                kb, vb = ax.hop([(kb, 1, 0), (vb, 1, 1)],
                                [(k, -1, 0), (v, -1, 1)], "ring")
        out = o.to(q.dtype)
        ctx.ax, ctx.causal, ctx.sm_scale = ax, causal, sm_scale
        ctx.save_for_backward(q, k, v, out, lse.contiguous())
        return out

    @staticmethod
    def backward(ctx, do):
        ax, causal, sm_scale = ctx.ax, ctx.causal, ctx.sm_scale
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        n, r = ax.n, ax.rank
        todo = {s: c for s, _, c in _blocks(n, r, causal)}
        f32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, **f32)
        dk = torch.zeros(k.shape, **f32)
        dv = torch.zeros(v.shape, **f32)
        kb, vb = k, v
        for s in range(n):
            if s in todo:
                gq, gk, gv = _block_bwd(q, kb, vb, o, do, lse, todo[s],
                                        sm_scale)
                dq += gq
                dk += gk
                dv += gv
            # dk and dv travel with their block; after the last step the
            # block and its gradients are one hop from home
            sends = [(dk, 1, 2), (dv, 1, 3)]
            recvs = [(dk, -1, 2), (dv, -1, 3)]
            if s + 1 < n:
                sends += [(kb, 1, 0), (vb, 1, 1)]
                recvs += [(k, -1, 0), (v, -1, 1)]
            got = ax.hop(sends, recvs, "ring") if n > 1 else [dk, dv]
            dk, dv = got[0], got[1]
            if s + 1 < n:
                kb, vb = got[2], got[3]
        return (None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None)


def ring_attention(q, k, v, *, mesh=None, seq_axis: str = "seq",
                   causal: bool = False, sm_scale: Optional[float] = None,
                   batch_axis=None):
    """Sequence-parallel exact attention (module docstring).  q, k, v:
    this rank's [B, H, T/n, D] shards of T over ``seq_axis``; returns its
    [B, H, T/n, D] shard of the output.  ``batch_axis`` names the mesh
    axes the batch splits over, as in the reference's signature: B is
    this rank's rows of them, and the ring runs in this rank's group of
    the seq axis, so each coordinate of the batch axes rings its own
    rows."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ax = _seq_axis(mesh, seq_axis)
    return _Ring.apply(ax, q, k, v, bool(causal), float(sm_scale))


class _SeqToHeads(torch.autograd.Function):
    """[B, H, T/n, D] sequence shard -> [B, H/n, T, D] head shard; the
    backward is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, ax: AxisGroup, x):
        ctx.ax = ax
        return _seq_to_heads(ax, x)

    @staticmethod
    def backward(ctx, g):
        return None, _heads_to_seq(ctx.ax, g)


class _HeadsToSeq(torch.autograd.Function):
    """The inverse of :class:`_SeqToHeads`."""

    @staticmethod
    def forward(ctx, ax: AxisGroup, x):
        ctx.ax = ax
        return _heads_to_seq(ax, x)

    @staticmethod
    def backward(ctx, g):
        return None, _seq_to_heads(ctx.ax, g)


def _seq_to_heads(ax: AxisGroup, x):
    B, H, t, D = x.shape
    n = ax.n
    # block j (heads [j·H/n, (j+1)·H/n)) to rank j; block i received holds
    # rank i's rows of T for this rank's heads
    send = x.reshape(B, n, H // n, t, D).permute(1, 0, 2, 3, 4)
    got = ax.all_to_all(send, "ulysses")
    return got.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * t, D)


def _heads_to_seq(ax: AxisGroup, x):
    B, h, T, D = x.shape
    n = ax.n
    send = x.reshape(B, h, n, T // n, D).permute(2, 0, 1, 3, 4)
    got = ax.all_to_all(send, "ulysses")
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * h, T // n, D)


def ulysses_attention(q, k, v, *, mesh=None, seq_axis: str = "seq",
                      causal: bool = False, sm_scale: Optional[float] = None,
                      batch_axis=None):
    """All-to-all sequence parallelism (module docstring); the heads must
    divide among the ``seq_axis`` ranks.  Shards in and out as
    :func:`ring_attention`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ax = _seq_axis(mesh, seq_axis)
    if q.shape[1] % ax.n:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by "
                         f"|{seq_axis}|={ax.n}")
    qh, kh, vh = (_SeqToHeads.apply(ax, t) for t in (q, k, v))
    oh = attn_ops.flash_attention(qh, kh, vh, causal=causal,
                                  sm_scale=sm_scale)
    return _HeadsToSeq.apply(ax, oh)
