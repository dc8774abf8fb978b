"""Dense layers: ``Linear`` (nn/Linear.scala).

Counterpart of ``bigdl_tpu/nn/linear.py`` for what the serving slice
uses.  The product is a plain matrix product left to the library, as the
reference leaves it to XLA.
"""

from __future__ import annotations

import torch

from ..common import get_policy
from .initialization import compute_fans, default_bias_init, default_weight_init
from .module import Module

__all__ = ["Linear", "matmul_f32"]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[..., K] @ b[K, N]`` accumulated and returned in float32, for
    operands in one dtype: the reference's ``dot_general(...,
    preferred_element_type=float32)``.  bfloat16 operands keep their
    rounding; only the sum is float32.  On CUDA that is one cuBLAS call
    with a float32 output; on the CPU the bfloat16 values widen exactly to
    float32 first, which computes the same products."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


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
