"""Attention layers: ``MultiHeadAttention``.

Counterpart of ``bigdl_tpu/nn/attention.py``: q/k/v projections ->
flash attention (the CUDA kernel of ``ops/attention.py`` on the card) ->
output projection.  Training differentiates through the flash forward's
``torch.autograd.Function``, whose backward is the B7 kernel on the card;
its gradients come back in the [B, T, H, D] memory the head merge reads.
Sequence parallelism (ring attention over a mesh axis) comes with the
parallelism slice.
"""

from __future__ import annotations

import torch

from ..common import get_policy
from ..ops.attention import flash_attention
from .initialization import compute_fans, default_weight_init
from .linear import matmul_f32
from .module import Module

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(Module):
    """Self-attention over [B, T, E] inputs.  The (E, E) projections are
    applied as ``x @ w``."""

    PARAM_ROLES = {"wq": "kernel_in", "wk": "kernel_in", "wv": "kernel_in",
                   "wo": "kernel_in", "*": "bias"}

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 seq_parallel: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % num_heads {num_heads}")
        if seq_parallel:
            raise NotImplementedError(
                "MultiHeadAttention(seq_parallel=True): ring attention is "
                "not ported yet")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal

    def _init(self, generator):
        e = self.embed_dim
        dt = get_policy().param_dtype
        fi, fo = compute_fans((e, e))
        p = {n: default_weight_init(generator, (e, e), fi, fo, dt)
             for n in ("wq", "wk", "wv", "wo")}
        p.update({n: torch.zeros((e,), dtype=dt)
                  for n in ("bq", "bk", "bv", "bo")})
        return p

    def _proj(self, x, name):
        # unlike Linear: the float32 sum is cast to the compute dtype FIRST
        # and the bias is added in the compute dtype
        c = get_policy().compute_dtype
        y = matmul_f32(x.to(c), getattr(self, "w" + name).to(c)).to(c)
        return y + getattr(self, "b" + name).to(c)

    def forward(self, x):
        B, T, E = x.shape
        H, D = self.num_heads, self.head_dim
        # [B, T, H, D] -> [B, H, T, D] views: the kernel reads them strided
        q, k, v = (self._proj(x, n).reshape(B, T, H, D).transpose(1, 2)
                   for n in "qkv")
        o = flash_attention(q, k, v, causal=self.causal)
        o = o.transpose(1, 2).reshape(B, T, E)
        return self._proj(o, "o")
