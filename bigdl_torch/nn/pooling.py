"""Pooling: ``SpatialMaxPooling`` and ``SpatialAveragePooling``
(nn/SpatialMaxPooling.scala, nn/SpatialAveragePooling.scala).

Counterpart of ``bigdl_tpu/nn/pooling.py`` for what the training slice
uses, over NHWC.  The output size follows Torch's ceil/floor formula
(:func:`_pool_pads`, the reference's own).  Where every window lies inside
the symmetrically padded input, the library's pooling with that padding
computes exactly the reference's windows, and runs on a ``channels_last``
view with no copy.  Otherwise (pad -1 for SAME, or a ceil-mode window that
overhangs the padding) the input is padded explicitly to the reference's
(lo, hi) and pooled without padding, which is the reference's own
construction.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .module import Module

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling"]


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
