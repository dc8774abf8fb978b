"""Convolution: ``SpatialConvolution`` (nn/SpatialConvolution.scala).

Counterpart of ``bigdl_tpu/nn/conv.py`` for what the training slice uses.
The layout is the reference's: NHWC activations and HWIO weights
(kh, kw, cin/groups, cout).  The convolution itself is left to the library
(cuDNN on the card), as the reference leaves it to XLA: the NHWC input is
handed over as ``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC
tensor is a ``channels_last`` NCHW view, so no copy is made; cuDNN then
writes a ``channels_last`` output, whose permutation back to NHWC is
contiguous again.  x and w are cast to the policy's compute dtype; bf16
convolutions accumulate in float32 inside the library, as the TPU's
matrix unit does.  The reference's ``_pad_tiny_cin`` works around a TPU
compiler pathology and changes no numbers, so it is not ported.
``pad_w`` or ``pad_h`` of -1 is the reference's SAME padding (XLA's: the
output is ceil(in / stride) and the odd pixel of padding goes after), an
explicit pad of the input before a convolution without padding.  Under
``Optimizer.set_remat("conv_out")`` the convolution's output is the tensor
kept for the backward (``utils/remat.py``), the reference's ``conv_out``.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..common import get_policy
from ..utils import remat
from .initialization import default_bias_init, default_weight_init
from .module import Module

__all__ = ["SpatialConvolution"]


class SpatialConvolution(Module):
    """2-D convolution over NHWC input.  The argument order keeps the
    reference's (nInputPlane, nOutputPlane, kW, kH, dW, dH, padW, padH,
    nGroup) signature."""

    PARAM_ROLES = {"weight": "conv_kernel", "bias": "bias"}

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not divide into {n_group} groups")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.n_group = n_group
        self.with_bias = with_bias
        # gradient terms the Optimizer adds (optim/regularizer.py)
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer

    def _weight_shape(self):
        kh, kw = self.kernel
        return (kh, kw, self.n_input_plane // self.n_group,
                self.n_output_plane)

    def _init(self, generator):
        shape = self._weight_shape()
        fan_in = shape[0] * shape[1] * shape[2]
        fan_out = shape[0] * shape[1] * shape[3] // self.n_group
        dt = get_policy().param_dtype
        winit = self.weight_initializer or default_weight_init
        binit = self.bias_initializer or default_bias_init
        p = {"weight": winit(generator, shape, fan_in, fan_out, dt)}
        if self.with_bias:
            p["bias"] = binit(generator, (self.n_output_plane,), fan_in,
                              fan_out, dt)
        return p

    def _same_pads(self, x):
        """(lo, hi) SAME padding of H and W for ``x`` (NHWC)."""
        pads = []
        for d in range(2):
            n, k, s = x.shape[1 + d], self.kernel[d], self.stride[d]
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads

    def forward(self, x):
        c = get_policy().compute_dtype
        xc = x.to(c).permute(0, 3, 1, 2)
        pad = self.pad
        if -1 in pad:
            (hl, hh), (wl, wh) = self._same_pads(x)
            xc = F.pad(xc, (wl, wh, hl, hh))
            pad = (0, 0)
        # under set_remat("conv_out") the output is the kept tensor
        y = remat.conv2d(xc, self.weight.to(c).permute(3, 2, 0, 1),
                         self.stride, pad, self.n_group).permute(0, 2, 3, 1)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y
