"""Normalization layers: ``BatchNormalization``,
``SpatialBatchNormalization`` and ``LayerNorm``.

Counterpart of ``bigdl_tpu/nn/normalization.py`` for what the serving and
training slices use.  BatchNorm in training mode runs the CUDA kernels of
``ops/batchnorm.py`` (forward B1, backward B2) on the card and their plain
versions on the CPU; there is no knob between routes (the reference's
``BIGDL_TPU_BN_IMPL``, ``BN_FUSED_VJP`` and ``BN_STAT_ROWS`` routes are not
ported).  The running statistics are buffers of the module.
"""

from __future__ import annotations

import torch

from ..common import get_policy
from ..ops.batchnorm import bn_train
from .module import Module

__all__ = ["BatchNormalization", "SpatialBatchNormalization", "LayerNorm"]


class BatchNormalization(Module):
    """BN over the last (feature) axis; every leading axis is a reduction
    axis (nn/BatchNormalization.scala).

    Training normalizes with the biased float32 batch statistics and
    updates the running EMA in place with the unbiased variance
    (``new = (1 - momentum)·old + momentum·batch``); eval normalizes with
    the running statistics.  Cross-device sync-BN (``sync_axis``) comes
    with the data-parallel slice; ``affine=False`` is not ported."""

    PARAM_ROLES = {"weight": "norm_scale", "bias": "norm_scale"}

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 sync_axis: str = None):
        super().__init__()
        if sync_axis is not None:
            raise NotImplementedError("sync-BN (sync_axis) comes with the "
                                      "data-parallel slice")
        if not affine:
            raise NotImplementedError("BatchNormalization(affine=False) is "
                                      "not ported")
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.sync_axis = sync_axis

    def _init(self, generator):
        dt = get_policy().param_dtype
        winit = self.weight_initializer
        w = (winit(generator, (self.n_output,), self.n_output,
                   self.n_output, dt)
             if winit else torch.ones((self.n_output,), dtype=dt))
        return {"weight": w, "bias": torch.zeros((self.n_output,), dtype=dt)}

    def _init_state(self):
        dt = get_policy().param_dtype
        return {"running_mean": torch.zeros((self.n_output,), dtype=dt),
                "running_var": torch.ones((self.n_output,), dtype=dt)}

    def forward(self, x):
        if self.training:
            y, mean, var = bn_train(x.contiguous(), self.weight, self.bias,
                                    self.eps)
            self._ema_update(mean, var, x.numel() // x.shape[-1])
            return y
        inv = torch.rsqrt(self.running_var + self.eps)
        scale = self.weight * inv
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype) + shift.to(x.dtype)

    @torch.no_grad()
    def _ema_update(self, mean, var, n: int) -> None:
        """Torch's convention (reference ``_ema_update``): normalize with
        the biased batch var, accumulate the unbiased one; ``n`` is the
        count of rows the statistics were taken over."""
        m = self.momentum
        unbiased = var * (n / max(n - 1, 1))
        dt = self.running_mean.dtype
        self.running_mean.copy_((1 - m) * self.running_mean
                                + m * mean.to(dt))
        self.running_var.copy_((1 - m) * self.running_var
                               + m * unbiased.to(dt))


class SpatialBatchNormalization(BatchNormalization):
    """BN over NHWC images: per-channel statistics over (N, H, W)
    (nn/SpatialBatchNormalization.scala); the feature axis is last either
    way."""


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
