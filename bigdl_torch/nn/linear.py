"""Dense layers: ``Linear`` (nn/Linear.scala).

Counterpart of ``bigdl_tpu/nn/linear.py`` for what the serving and
training slices use.  The product is a plain matrix product left to the
library, as the reference leaves it to XLA.
"""

from __future__ import annotations

import torch

from ..common import get_policy
from .initialization import compute_fans, default_bias_init, default_weight_init
from .module import Module

__all__ = ["Linear", "matmul_f32"]


def _mm_f32(a2: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a2[M, K] @ b[K, N] of one dtype, accumulated and returned in
    float32.  On CUDA that is one cuBLAS call with a float32 output; on the
    CPU the operands widen exactly to float32 first, which computes the
    same products."""
    if a2.dtype == torch.float32:
        return a2 @ b
    if a2.device.type == "cuda":
        return torch.mm(a2, b, out_dtype=torch.float32)
    return a2.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(..., out_dtype=float32)`` has no derivative, so the
    product carries its own: each gradient is a product in the operands'
    dtype with float32 accumulation, cast to that dtype."""

    @staticmethod
    def forward(ctx, a2, b):
        ctx.save_for_backward(a2, b)
        return _mm_f32(a2, b)

    @staticmethod
    def backward(ctx, g):
        a2, b = ctx.saved_tensors
        g = g.to(a2.dtype)
        ga = _mm_f32(g, b.t()).to(a2.dtype) if ctx.needs_input_grad[0] \
            else None
        gb = _mm_f32(a2.t(), g).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[..., K] @ b[K, N]`` accumulated and returned in float32, for
    operands in one dtype: the reference's ``dot_general(...,
    preferred_element_type=float32)``.  bfloat16 operands keep their
    rounding; only the sum is float32.  Differentiable."""
    if a.dtype == torch.float32:
        return a @ b
    a2 = a.reshape(-1, a.shape[-1])
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        out = _MatmulF32.apply(a2, b)
    else:
        # no gradient wanted: skip the Function, whose per-call cost shows
        # in serving's launch-bound forward (about 1.5 ms of 6 on the card)
        out = _mm_f32(a2, b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class Linear(Module):
    """y = x W^T + b with weight (out, in).  x and W are cast to the compute
    dtype and multiplied with float32 accumulation; the bias is added in
    float32 before the cast back to the compute dtype."""

    PARAM_ROLES = {"weight": "kernel_out", "bias": "bias"}

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size

    def _init(self, generator):
        shape = (self.output_size, self.input_size)
        fi, fo = compute_fans(shape)
        dt = get_policy().param_dtype
        return {"weight": default_weight_init(generator, shape, fi, fo, dt),
                "bias": default_bias_init(generator, (self.output_size,),
                                          fi, fo, dt)}

    def forward(self, x):
        c = get_policy().compute_dtype
        return (matmul_f32(x.to(c), self.weight.to(c).t())
                + self.bias).to(c)
