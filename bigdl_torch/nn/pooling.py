"""Pooling: ``SpatialMaxPooling``, ``SpatialAveragePooling``,
``VolumetricMaxPooling`` and ``RoiPooling`` (nn/SpatialMaxPooling.scala,
nn/SpatialAveragePooling.scala, nn/VolumetricMaxPooling.scala,
nn/RoiPooling.scala).

Counterpart of ``bigdl_tpu/nn/pooling.py``, over NHWC (NDHWC for the
volumetric one).  The output size follows Torch's ceil/floor formula
(:func:`_pool_pads`, the reference's own).  Where every window lies inside
the symmetrically padded input, the library's pooling with that padding
computes exactly the reference's windows, and runs on a ``channels_last``
view with no copy.  Otherwise (pad -1 for SAME, or a ceil-mode window that
overhangs the padding) the input is padded explicitly to the reference's
(lo, hi) and pooled without padding, which is the reference's own
construction.  ``RoiPooling`` gathers every bin of every region in one
indexing op and takes each bin's max with ``amax``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .module import Module

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling",
           "VolumetricMaxPooling", "RoiPooling"]


def _pool_pads(size, kernel, stride, pad, ceil_mode):
    """(output size, (lo, hi) padding) per dim; hi is extended so the
    window count matches Torch's ceil/floor formula, and pad=-1 means
    SAME (the reference's ``_pool_pads``)."""
    if pad == -1:
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        return out, (total // 2, total - total // 2)
    if ceil_mode:
        out = int(math.ceil((size + 2 * pad - kernel) / stride)) + 1
        if pad > 0 and (out - 1) * stride >= size + pad:
            out -= 1
    else:
        out = int(math.floor((size + 2 * pad - kernel) / stride)) + 1
    needed = (out - 1) * stride + kernel - size - pad
    return out, (pad, max(needed, 0))


def _plan(x, kernel, stride, pad, ceil_mode):
    """(padding for the library call, or None) and the explicit (lo, hi)
    pads of both dims."""
    pads, native = [], True
    for d in range(2):
        size, k, s, p = x.shape[1 + d], kernel[d], stride[d], pad[d]
        out, lohi = _pool_pads(size, k, s, p, ceil_mode)
        pads.append(lohi)
        native = native and p != -1 and 2 * p <= k and \
            (out - 1) * s + k <= size + 2 * p
    return (tuple(pad) if native else None), pads


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _explicit_pad(x, pads, value):
    (ph0, ph1), (pw0, pw1) = pads
    return F.pad(_nchw(x), (pw0, pw1, ph0, ph1), value=value)


class SpatialMaxPooling(Module):
    """Max pool; the signature keeps the reference's (kW, kH, dW, dH, padW,
    padH) order."""

    def __init__(self, k_w: int, k_h: int, d_w: int = None, d_h: int = None,
                 pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.kernel = (k_h, k_w)
        self.stride = (d_h or k_h, d_w or k_w)
        self.pad = (pad_h, pad_w)
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def forward(self, x):
        native, pads = _plan(x, self.kernel, self.stride, self.pad,
                             self.ceil_mode)
        if native is not None:
            return _nhwc(F.max_pool2d(_nchw(x), self.kernel, self.stride,
                                      native, ceil_mode=self.ceil_mode))
        return _nhwc(F.max_pool2d(_explicit_pad(x, pads, -math.inf),
                                  self.kernel, self.stride))


class SpatialAveragePooling(Module):
    """Average pool; ``count_include_pad`` matches the reference's divisor
    convention (the window size, or the count of real input elements)."""

    def __init__(self, k_w: int, k_h: int, d_w: int = None, d_h: int = None,
                 pad_w: int = 0, pad_h: int = 0, global_pooling: bool = False,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True):
        super().__init__()
        self.kernel = (k_h, k_w)
        self.stride = (d_h or k_h, d_w or k_w)
        self.pad = (pad_h, pad_w)
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def ceil(self):
        self.ceil_mode = True
        return self

    def forward(self, x):
        if self.global_pooling:
            kernel = stride = (x.shape[1], x.shape[2])
            pad = (0, 0)
        else:
            kernel, stride, pad = self.kernel, self.stride, self.pad
        native, pads = _plan(x, kernel, stride, pad, self.ceil_mode)
        if native is not None and self.divide:
            return _nhwc(F.avg_pool2d(
                _nchw(x), kernel, stride, native, ceil_mode=self.ceil_mode,
                count_include_pad=self.count_include_pad))
        summed = F.avg_pool2d(_explicit_pad(x, pads, 0.0), kernel, stride,
                              divisor_override=1)
        if not self.divide:
            return _nhwc(summed)
        if self.count_include_pad:
            return _nhwc(summed / (kernel[0] * kernel[1]))
        ones = torch.ones((1, x.shape[1], x.shape[2], 1), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(_explicit_pad(ones, pads, 0.0), kernel, stride,
                              divisor_override=1)
        return _nhwc(summed / counts)


class VolumetricMaxPooling(Module):
    """3-D max pool over NDHWC (nn/VolumetricMaxPooling.scala): the
    reference's (k_t, k_w, k_h) argument order, the stride the kernel's by
    default, padding with -inf, no ceil mode."""

    def __init__(self, k_t, k_w, k_h, d_t=None, d_w=None, d_h=None,
                 pad_t=0, pad_w=0, pad_h=0):
        super().__init__()
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)

    def forward(self, x):
        xc = x.permute(0, 4, 1, 2, 3)
        pad = self.pad
        if any(2 * p > k for p, k in zip(pad, self.kernel)):
            # the library pads at most half a window; -inf is what it pads
            pt, ph, pw = pad
            xc = F.pad(xc, (pw, pw, ph, ph, pt, pt), value=-math.inf)
            pad = (0, 0, 0)
        y = F.max_pool3d(xc, self.kernel, self.stride, pad)
        return y.permute(0, 2, 3, 4, 1)


class RoiPooling(Module):
    """Region-of-interest max pooling (nn/RoiPooling.scala).

    Input ``[features (N, H, W, C), rois (R, 5)]``, each roi a row
    (batch index, x1, y1, x2, y2) in input coordinates; output (R,
    pooled_h, pooled_w, C).  The corners are scaled by ``spatial_scale``
    and rounded half to even, the bins' edges floored and ceiled, as in
    the reference; positions outside the map belong to no bin, and a bin
    with none gives 0.  Every bin of every roi is gathered in one indexing
    op over a window as large as the largest bin (the one host read of
    the forward), positions outside the bin masked to -inf, and reduced
    by ``amax``, so tied maxima share the gradient as JAX's max does."""

    def __init__(self, pooled_w: int, pooled_h: int,
                 spatial_scale: float = 1.0):
        super().__init__()
        self.pooled_w, self.pooled_h = pooled_w, pooled_h
        self.spatial_scale = spatial_scale

    def _bins(self, lo, hi, n_bins, size):
        """(start, valid) of each bin's positions along one axis: the
        roi's extent [lo, hi] (rounded corners) cut into ``n_bins``."""
        extent = torch.clamp(hi - lo + 1, min=1).to(torch.float32)
        width = extent / n_bins
        i = torch.arange(n_bins, dtype=torch.float32, device=lo.device)
        start = torch.floor(i * width[:, None]).long() + lo[:, None]
        end = torch.ceil((i + 1) * width[:, None]).long() + lo[:, None]
        span = int((end - start).max()) if start.numel() else 0
        pos = start[..., None] + torch.arange(span, device=lo.device)
        valid = (pos < end[..., None]) & (pos >= 0) & (pos < size)
        return pos.clamp(0, size - 1), valid

    def forward(self, inputs):
        feats, rois = inputs[0], inputs[1]
        _, H, W, _ = feats.shape
        b = rois[:, 0].to(torch.int64)
        x1, y1, x2, y2 = (torch.round(rois[:, k] * self.spatial_scale)
                          .to(torch.int64) for k in range(1, 5))
        rows, vrow = self._bins(y1, y2, self.pooled_h, H)  # (R, ph, kh)
        cols, vcol = self._bins(x1, x2, self.pooled_w, W)  # (R, pw, kw)
        # (R, ph, kh, pw, kw, C)
        g = feats[b[:, None, None, None, None], rows[:, :, :, None, None],
                  cols[:, None, None, :, :]]
        inside = vrow[:, :, :, None, None] & vcol[:, None, None, :, :]
        g = torch.where(inside[..., None], g,
                        torch.full((), -math.inf, dtype=g.dtype,
                                   device=g.device))
        out = g.amax(dim=(2, 4))
        return torch.where(torch.isfinite(out), out,
                           torch.zeros((), dtype=out.dtype, device=out.device))
