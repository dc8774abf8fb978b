"""Normalization layers: ``BatchNormalization``,
``SpatialBatchNormalization``, ``LayerNorm``, ``Normalize``, the local
response normalizations ``SpatialCrossMapLRN`` and
``SpatialWithinChannelLRN``, and the subtractive, divisive and contrastive
normalizations.

Counterpart of ``bigdl_tpu/nn/normalization.py``.  The last six are PyTorch
ops, as the reference leaves them to XLA: a window sum over channels
(``unfold``), a spatial one (``avg_pool2d`` of the explicitly padded
input) and a depthwise Gaussian blur (a grouped convolution).  BatchNorm
in training mode runs the CUDA kernels of ``ops/batchnorm.py`` on the
card and their plain versions on the CPU: on one device B1 forward and
B2 backward, under the Engine's data group sync-BN with B3 and B4 (see :class:`BatchNormalization`).  There is no
knob between routes (the reference's ``BIGDL_TPU_BN_IMPL``,
``BN_FUSED_VJP`` and ``BN_STAT_ROWS`` routes are not ported).  The running
statistics are buffers of the module.  ``affine=False`` (no weight, no
bias) is left to PyTorch ops, as the reference leaves it to XLA (its
Pallas route needs ``affine``): float32 mean and E[x²] - mean² over the
rows, no kernel launch; under a data group of several ranks, over every
rank's rows (``ops/batchnorm.py`` ``bn_plain_train_sync``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..common import get_policy
from ..ops.batchnorm import (bn_plain_train_sync, bn_train, bn_train_sync,
                             global_rows)
from ..utils.engine import Engine
from ..utils import remat
from .module import Module

__all__ = ["BatchNormalization", "SpatialBatchNormalization", "LayerNorm",
           "Normalize", "SpatialCrossMapLRN", "SpatialWithinChannelLRN",
           "SpatialSubtractiveNormalization", "SpatialDivisiveNormalization",
           "SpatialContrastiveNormalization"]


class BatchNormalization(Module):
    """BN over the last (feature) axis; every leading axis is a reduction
    axis (nn/BatchNormalization.scala).

    Training normalizes with the biased float32 batch statistics and
    updates the running EMA in place with the unbiased variance
    (``new = (1 - momentum)·old + momentum·batch``); eval normalizes with
    the running statistics.

    The route is chosen by whether the Engine has a data group: with one,
    training takes sync-BN (``bn_train_sync``: B3, B4 and two all-reduces
    of per-channel sums) and the statistics, and the EMA's row count, are
    the global batch's; without one, the single-device route (B1, B2).
    With ``affine=False`` training takes PyTorch ops instead, on any
    device: :meth:`_plain_train` without a group or in a world of one,
    else ``bn_plain_train_sync``, whose statistics and EMA row count are
    every rank's (the reference's data-parallel step is one program over
    the global batch, so its mean is the global batch's).
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
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.sync_axis = sync_axis

    def _init(self, generator):
        if not self.affine:
            return {}
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

    def _plain_train(self, x):
        """affine=False training in PyTorch ops: biased float32 batch
        statistics as E[x²] - mean², normalize, EMA update."""
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = xf.square().mean(dim=dims) - mean.square()
        self._ema_update(mean.detach(), var.detach(),
                         x.numel() // x.shape[-1])
        inv = torch.rsqrt(var + self.eps)
        return x * inv.to(x.dtype) + (-mean * inv).to(x.dtype)

    def forward(self, x):
        if self.training:
            group = Engine.group()
            if group is None and self.sync_axis is not None:
                raise RuntimeError(f"sync_axis={self.sync_axis!r} needs the "
                                   "Engine's data group: call Engine.init()")
        if self.training and not self.affine:
            if group is None or Engine.group_size() == 1:
                return self._plain_train(x)
            y, mean, var, n = bn_plain_train_sync(x, self.eps, group)
            self._ema_update(mean, var, int(n))
            return y
        if self.training:
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
        scale = self.weight * inv if self.affine else inv
        shift = (self.bias if self.affine else 0.0) - \
            self.running_mean * scale
        return x * scale.to(x.dtype) + shift.to(x.dtype)

    def _ema_update(self, mean, var, n: int) -> None:
        """Torch's convention (reference ``_ema_update``): normalize with
        the biased batch var, accumulate the unbiased one; ``n`` is the
        count of rows the statistics were taken over.  Under remat the
        update runs once, after the checkpointed forward, and never in its
        recompute (``utils/remat.py``)."""
        if not remat.defer_ema(lambda: self._apply_ema(mean, var, n)):
            self._apply_ema(mean, var, n)

    @torch.no_grad()
    def _apply_ema(self, mean, var, n: int) -> None:
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

    def __init__(self, n_output: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.affine = affine

    def _init(self, generator):
        if not self.affine:
            return {}
        dt = get_policy().param_dtype
        return {"weight": torch.ones((self.n_output,), dtype=dt),
                "bias": torch.zeros((self.n_output,), dtype=dt)}

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class Normalize(Module):
    """L_p normalization along the last (feature) axis
    (nn/Normalize.scala): x / (‖x‖_p + eps); ``p = inf`` takes the largest
    magnitude, whose gradient tied maxima share (``amax``), as JAX's max
    does."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p, self.eps = p, eps

    def forward(self, x):
        if self.p == math.inf:
            norm = x.abs().amax(dim=-1, keepdim=True)
        else:
            norm = (x.abs() ** self.p).sum(dim=-1, keepdim=True) ** (
                1.0 / self.p)
        return x / (norm + self.eps)


class SpatialCrossMapLRN(Module):
    """Local response normalization across channels
    (nn/SpatialCrossMapLRN.scala): y = x / (k + alpha/size · Σ x²)^beta,
    the sum over a window of ``size`` channels padded (size//2,
    size - size//2 - 1) with zeros, over the last (channel) axis."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        half = self.size // 2
        sq = F.pad(x * x, (half, self.size - half - 1))
        summed = sq.unfold(-1, self.size, 1).sum(dim=-1)
        return x / (self.k + self.alpha / self.size * summed) ** self.beta


def _pad_window(x_nchw, size, value=0.0):
    """H and W padded (size//2, size - size//2 - 1), as the reference's
    windows of an even size are."""
    half = size // 2
    lo, hi = half, size - half - 1
    return F.pad(x_nchw, (lo, hi, lo, hi), value=value)


class SpatialWithinChannelLRN(Module):
    """LRN within each channel over a ``size`` x ``size`` spatial window
    (nn/SpatialWithinChannelLRN.scala): the window mean of x², padding
    zeros counted, then x / (1 + alpha · mean)^beta."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75):
        super().__init__()
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        sq = _pad_window((x * x).permute(0, 3, 1, 2), self.size)
        mean_sq = F.avg_pool2d(sq, self.size, 1).permute(0, 2, 3, 1)
        return x / (1.0 + self.alpha * mean_sq) ** self.beta


def _gaussian_kernel(size: int, dtype=torch.float32, device=None):
    """The reference's normalized 1-D Gaussian: sigma = size / 4 (1 for a
    size of 1), centred on (size - 1) / 2."""
    xs = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    sigma = size / 4.0 if size > 1 else 1.0
    k = torch.exp(-(xs * xs) / (2 * sigma * sigma))
    return k / k.sum()


class _GaussianBlur(Module):
    """Depthwise Gaussian smoothing of NHWC maps, for the subtractive and
    divisive normalizations: a grouped convolution with the outer product
    of :func:`_gaussian_kernel`, padded as the reference's windows."""

    def __init__(self, size: int, n_channels: int):
        super().__init__()
        self.size, self.n_channels = size, n_channels

    def blur(self, x):
        k1 = _gaussian_kernel(self.size, x.dtype, x.device)
        c = x.shape[-1]
        kern = torch.outer(k1, k1).expand(c, 1, self.size, self.size)
        y = F.conv2d(_pad_window(x.permute(0, 3, 1, 2), self.size), kern,
                     groups=c)
        return y.permute(0, 2, 3, 1)


class SpatialSubtractiveNormalization(_GaussianBlur):
    """x less the local Gaussian-weighted mean over every plane
    (nn/SpatialSubtractiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel_size: int = 9):
        super().__init__(kernel_size, n_input_plane)

    def forward(self, x):
        # the blur is normalized per plane; the mean over the planes
        # completes the cross-plane local mean
        return x - self.blur(x).mean(dim=-1, keepdim=True)


class SpatialDivisiveNormalization(_GaussianBlur):
    """x over the local standard deviation (the square root of the
    plane-mean of the blurred x²), which under ``threshold`` is replaced
    by ``thresval`` (nn/SpatialDivisiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel_size: int = 9,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__(kernel_size, n_input_plane)
        self.threshold, self.thresval = threshold, thresval

    def forward(self, x):
        local_sq = self.blur(x * x)
        std = torch.sqrt(torch.clamp(local_sq.mean(dim=-1, keepdim=True),
                                     min=0.0))
        std = torch.where(std < self.threshold,
                          torch.full_like(std, self.thresval), std)
        return x / std


class SpatialContrastiveNormalization(Module):
    """The subtractive, then the divisive normalization
    (nn/SpatialContrastiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel_size: int = 9,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel_size)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel_size,
                                                threshold, thresval)

    def forward(self, x):
        return self.div(self.sub(x))
