"""Normalization layers: ``LayerNorm``.

Counterpart of ``bigdl_tpu/nn/normalization.py`` for what the serving
slice uses.  BatchNormalization and its kernels come with the training
slice.
"""

from __future__ import annotations

import torch

from ..common import get_policy
from .module import Module

__all__ = ["LayerNorm"]


class LayerNorm(Module):
    """Layer normalization over the last axis.  Statistics in float32 with
    the biased variance whatever the input dtype; the output is cast back
    to the input dtype."""

    PARAM_ROLES = {"weight": "norm_scale", "bias": "norm_scale"}

    def __init__(self, n_output: int, eps: float = 1e-5):
        super().__init__()
        self.n_output = n_output
        self.eps = eps

    def _init(self, generator):
        dt = get_policy().param_dtype
        return {"weight": torch.ones((self.n_output,), dtype=dt),
                "bias": torch.zeros((self.n_output,), dtype=dt)}

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)
