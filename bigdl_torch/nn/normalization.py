"""Normalization layers: ``BatchNormalization``,
``SpatialBatchNormalization`` and ``LayerNorm``.

Counterpart of ``bigdl_tpu/nn/normalization.py`` for what the serving and
training slices use.  BatchNorm in training mode runs the CUDA kernels of
``ops/batchnorm.py`` on the card and their plain versions on the CPU: on
one device B1 forward and B2 backward, under the Engine's data group
sync-BN with B3 and B4 (see :class:`BatchNormalization`).  There is no
knob between routes (the reference's ``BIGDL_TPU_BN_IMPL``,
``BN_FUSED_VJP`` and ``BN_STAT_ROWS`` routes are not ported).  The running
statistics are buffers of the module.
"""

from __future__ import annotations

import torch

from ..common import get_policy
from ..ops.batchnorm import bn_train, bn_train_sync, global_rows
from ..utils.engine import Engine
from .module import Module

__all__ = ["BatchNormalization", "SpatialBatchNormalization", "LayerNorm"]


class BatchNormalization(Module):
    """BN over the last (feature) axis; every leading axis is a reduction
    axis (nn/BatchNormalization.scala).

    Training normalizes with the biased float32 batch statistics and
    updates the running EMA in place with the unbiased variance
    (``new = (1 - momentum)·old + momentum·batch``); eval normalizes with
    the running statistics.  ``affine=False`` is not ported.

    The route is chosen by whether the Engine has a data group: with one,
    training takes sync-BN (``bn_train_sync``: B3, B4 and two all-reduces
    of per-channel sums) and the statistics, and the EMA's row count, are
    the global batch's; without one, the single-device route (B1, B2).
    The reference chooses by ``jax.device_count() > 1`` instead
    (``nn/normalization.py:228-235``).  Here the data-parallel path must
    run its kernels and collectives on a single card too (a group of one
    rank), and both routes compute the same function.  ``sync_axis="data"``
    (``Engine.DATA_AXIS``) names that group explicitly and then requires
    it; another axis name raises."""

    PARAM_ROLES = {"weight": "norm_scale", "bias": "norm_scale"}

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 sync_axis: str = None):
        super().__init__()
        if sync_axis not in (None, Engine.DATA_AXIS):
            raise ValueError(f"sync_axis={sync_axis!r}: the port syncs only "
                             f"over the Engine's {Engine.DATA_AXIS!r} group")
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
            group = Engine.group()
            if group is None and self.sync_axis is not None:
                raise RuntimeError(f"sync_axis={self.sync_axis!r} needs the "
                                   "Engine's data group: call Engine.init()")
            if group is None:
                y, mean, var = bn_train(x.contiguous(), self.weight,
                                        self.bias, self.eps)
            else:
                y, mean, var = bn_train_sync(x.contiguous(), self.weight,
                                             self.bias, self.eps, group)
            self._ema_update(mean, var,
                             global_rows(x.numel() // x.shape[-1], group))
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
