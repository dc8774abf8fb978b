"""Attention layers: ``MultiHeadAttention``.

Counterpart of ``bigdl_tpu/nn/attention.py``: q/k/v projections ->
flash attention (the CUDA kernel of ``ops/attention.py`` on the card) ->
output projection.  Training differentiates through the flash forward's
``torch.autograd.Function``, whose backward is the B7 kernel on the card;
its gradients come back in the [B, T, H, D] memory the head merge reads.

``seq_parallel=True`` runs the attention as ring attention over the
``seq_axis`` ranks of the Engine's mesh (``parallel/ring_attention.py``),
keeping the reference's contract: a global [B, T, E] in and out on every
rank.  Each rank slices its rows of T out of q, k and v, whose backward
all-gathers the ranks' shard gradients, runs the ring, and all-gathers
o, whose backward takes this rank's shard of the gradient.  The two
operators are conjugate (Megatron's sequence-parallel pair), so every
rank's gradients come out the same with no reduce.  Without a ``seq``
axis the forward raises, as the reference's ``shard_map`` does.  On a
``{"data": d, "seq": n}`` mesh the pair runs in this rank's seq group,
on its data row's rows of the batch.

The seam (``BIGDL_TORCH_RING_ATTN=1``, the reference's
``BIGDL_TPU_RING_ATTN``): on a layout whose ``tp`` axis is wider than
one and divides T, the attention core runs the same slice, ring and
gather over the ``tp`` group (the batch axes are ``data x fsdp``, each
of their coordinates ringing its own rows); otherwise it stays inert.
The ring needs every head's q, k and v for this rank's rows of T, while
a tp split computes the heads of this rank only.  Of the two ways to
reconcile them (gather the four kernels over tp, or move from heads to
rows with one all-to-all) the port takes the first: while the seam is
on, :meth:`MultiHeadAttention.tp_ok` is false, so the plan gathers the
kernels over tp like any sharded leaf and every tp rank projects the
whole q, k, v of its rows.  It adds no collective to the layer beyond
the gather at use that FSDP already does, and the layer's code path is
the seq-parallel one; the all-to-all would save the duplicated
projections at the cost of a second layout of the activations.

Under a layout whose tp axis splits the four kernels along their output
features (``parallel/mesh_plan.py`` sets ``_tp``), each rank projects,
attends to and projects out its own heads (:meth:`MultiHeadAttention.
_qkv`, :meth:`MultiHeadAttention._out`).
"""

from __future__ import annotations

import torch

from ..common import get_policy
from ..ops.attention import flash_attention
from ..utils import config
from .initialization import compute_fans, default_weight_init
from .linear import matmul_f32
from .module import Module

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(Module):
    """Self-attention over [B, T, E] inputs.  The (E, E) projections are
    applied as ``x @ w``."""

    PARAM_ROLES = {"wq": "kernel_in", "wk": "kernel_in", "wv": "kernel_in",
                   "wo": "kernel_in", "*": "bias"}
    #: used only as their casts to the compute dtype (parallel/mesh_plan.py)
    COMPUTE_CAST = ("wq", "wk", "wv", "wo")

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 seq_parallel: bool = False, seq_axis: str = "seq",
                 with_bias: bool = True):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % num_heads {num_heads}")
        self.seq_parallel = seq_parallel
        self.seq_axis = seq_axis
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.with_bias = with_bias

    def _init(self, generator):
        e = self.embed_dim
        dt = get_policy().param_dtype
        fi, fo = compute_fans((e, e))
        winit = self.weight_initializer or default_weight_init
        p = {n: winit(generator, (e, e), fi, fo, dt)
             for n in ("wq", "wk", "wv", "wo")}
        if self.with_bias:
            p.update({n: torch.zeros((e,), dtype=dt)
                      for n in ("bq", "bk", "bv", "bo")})
        return p

    def _proj(self, x, name):
        # unlike Linear: the float32 sum is cast to the compute dtype FIRST
        # and the bias is added in the compute dtype
        c = get_policy().compute_dtype
        y = matmul_f32(x.to(c), getattr(self, "w" + name).to(c)).to(c)
        if self.with_bias:
            y = y + getattr(self, "b" + name).to(c)
        return y

    def tp_ok(self, n: int) -> bool:
        """Whether a tensor-parallel split of the kernels' output features
        over ``n`` ranks leaves whole heads on each (not under ring
        attention, nor with the seam on)."""
        return (self.num_heads % n == 0 and not self.seq_parallel
                and not config.get_bool("RING_ATTN", False))

    def _seam(self, T: int):
        """The tp axis's group where the seam rings over it (module
        docstring), else None."""
        if self.__dict__.get("_tp") is not None or \
                not config.get_bool("RING_ATTN", False):
            return None
        from ..parallel.hops import axis_group
        ax = axis_group(None, "tp")
        if ax is None or ax.n <= 1 or T % ax.n:
            return None
        return ax

    def _qkv(self, x):
        """q, k, v of x [B, T, E] as [B, H', T, D] views (the kernel reads
        them strided).  H' is H, or H / tp under a tensor-parallel split
        (``_tp``, parallel/mesh_plan.py): q, k and v come out head-major,
        so this rank's slice of their output features is H / tp whole
        heads, and the attention runs on them alone."""
        B, T, _ = x.shape
        D = self.head_dim
        tp = self.__dict__.get("_tp")
        if tp is None:
            return [self._proj(x, n).reshape(B, T, self.num_heads, D)
                    .transpose(1, 2) for n in "qkv"]
        c = get_policy().compute_dtype
        xe, x = tp.enter(x), x.to(c)
        if self.with_bias:
            bias = tp.slice(torch.stack([self.bq, self.bk, self.bv]), -1)
        out = []
        for i, n in enumerate("qkv"):
            y = tp.matmul(xe, x, getattr(self, "w" + n).to(c)).to(c)
            if self.with_bias:
                y = y + bias[i].to(c)
            out.append(y.reshape(B, T, -1, D).transpose(1, 2))
        return out

    def _out(self, o):
        """The output projection of the heads' outputs o [B, T, E'] (E' =
        H' · D): under a tensor-parallel split the heads are gathered over
        tp first, then this rank's output features are projected and
        gathered."""
        tp = self.__dict__.get("_tp")
        if tp is None:
            return self._proj(o, "o")
        c = get_policy().compute_dtype
        o = tp.gather(o, -1)
        y = tp.gather(tp.matmul(tp.enter(o), o.to(c), self.wo.to(c)).to(c),
                      -1)
        if self.with_bias:
            y = y + self.bo.to(c)
        return y

    def forward(self, x):
        B, T, _ = x.shape
        q, k, v = self._qkv(x)
        seam = None if self.seq_parallel else self._seam(T)
        if self.seq_parallel:
            o = self._ring(q, k, v)
        elif seam is not None:
            o = self._ring(q, k, v, seam, "tp")
        else:
            # [B, H', T, D]: under a tp split of 2 at the bench width
            # [B, 4, 512, 64], this rank's heads only
            o = flash_attention(q, k, v, causal=self.causal)
        return self._out(o.transpose(1, 2).reshape(B, T, -1))

    def _ring(self, q, k, v, ax=None, axis=None):
        from ..parallel.hops import axis_group
        from ..parallel.ring_attention import ring_attention
        axis = axis or self.seq_axis
        ax = ax or axis_group(None, axis)
        if ax is None:
            raise ValueError(
                f"MultiHeadAttention(seq_parallel=True) needs a mesh with "
                f"a {self.seq_axis!r} axis: Engine.init(mesh_shape="
                f"{{{self.seq_axis!r}: n}})")
        T = q.shape[2]
        if T % ax.n:
            raise ValueError(f"sequence length {T} does not divide among "
                             f"the {ax.n} ranks of {self.seq_axis!r}")
        q, k, v = (_ShardRows.apply(ax, t) for t in (q, k, v))
        o = ring_attention(q, k, v, seq_axis=axis, causal=self.causal,
                           batch_axis=("data", "fsdp"))
        return _GatherRows.apply(ax, o)


class _ShardRows(torch.autograd.Function):
    """This rank's rows of T of a [B, H, T, D] tensor held whole on every
    rank; the backward all-gathers the ranks' shard gradients."""

    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        t = x.shape[2] // ax.n
        return x[:, :, ax.rank * t:(ax.rank + 1) * t]

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ax.all_gather(g, dim=2)


class _GatherRows(torch.autograd.Function):
    """The ranks' [B, H, T/n, D] shards gathered along T on every rank;
    the backward takes this rank's shard of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return ax.all_gather(x, dim=2)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        t = g.shape[2] // ax.n
        return None, g[:, :, ax.rank * t:(ax.rank + 1) * t]
