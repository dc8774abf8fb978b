"""Convolutions: ``SpatialConvolution`` (nn/SpatialConvolution.scala),
``SpatialShareConvolution``, ``SpatialConvolutionMap``,
``SpatialDilatedConvolution``, ``SpatialFullConvolution``,
``TemporalConvolution`` and ``VolumetricConvolution``.

Counterpart of ``bigdl_tpu/nn/conv.py``.  The layouts are the
reference's: NHWC activations and HWIO weights (kh, kw, cin/groups,
cout); (batch, time, features) and (k, in, out) for the temporal one;
NDHWC and (kt, kh, kw, in, out) for the volumetric one.  The
convolution itself is left to the library (cuDNN on the card), as the
reference leaves it to XLA: the NHWC input is
handed over as ``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC
tensor is a ``channels_last`` NCHW view, so no copy is made; cuDNN then
writes a ``channels_last`` output, whose permutation back to NHWC is
contiguous again.  x and w are cast to the policy's compute dtype; bf16
convolutions accumulate in float32 inside the library, as the TPU's
matrix unit does.  The reference's ``_pad_tiny_cin`` works around a TPU
compiler pathology and changes no numbers, so it is not ported.
``pad_w`` or ``pad_h`` of -1 is the reference's SAME padding (XLA's: the
output is ceil(in / stride) and the odd pixel of padding goes after), an
explicit pad of the input before a convolution without padding.

Under ``Optimizer.set_remat("conv_out")`` the convolution's output is the
tensor kept for the backward (``utils/remat.py``), the reference's
``conv_out``.  The volumetric convolution is cuDNN's on the
``channels_last_3d`` view of the NDHWC input; the temporal one is a 2-D
convolution of height 1 on the NHWC view of its input.
``SpatialFullConvolution`` is ``F.conv_transpose2d``: see its docstring
for the one case the library refuses.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..common import get_policy
from ..utils import remat
from .initialization import default_bias_init, default_weight_init
from .module import Module

__all__ = ["SpatialConvolution", "SpatialDilatedConvolution",
           "SpatialFullConvolution", "TemporalConvolution",
           "VolumetricConvolution", "SpatialShareConvolution",
           "SpatialConvolutionMap"]


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

    def _same_pads(self, x, dilation=(1, 1)):
        """(lo, hi) SAME padding of H and W for ``x`` (NHWC)."""
        pads = []
        for d in range(2):
            n, s = x.shape[1 + d], self.stride[d]
            k = (self.kernel[d] - 1) * dilation[d] + 1
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads

    def _conv(self, x, weight, dilation=(1, 1)):
        c = get_policy().compute_dtype
        xc = x.to(c).permute(0, 3, 1, 2)
        pad = self.pad
        if -1 in pad:
            (hl, hh), (wl, wh) = self._same_pads(x, dilation)
            xc = F.pad(xc, (wl, wh, hl, hh))
            pad = (0, 0)
        # under set_remat("conv_out") the output is the kept tensor
        y = remat.conv2d(xc, weight.to(c).permute(3, 2, 0, 1), self.stride,
                         pad, self.n_group, dilation).permute(0, 2, 3, 1)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y

    def forward(self, x):
        return self._conv(x, self.weight)


class SpatialShareConvolution(SpatialConvolution):
    """The reference's ``nn/SpatialShareConvolution.scala`` shares im2col
    buffers between layers; the library owns its buffers here, so it is
    ``SpatialConvolution`` under the reference's name."""


class SpatialConvolutionMap(SpatialConvolution):
    """Convolution over a sparse input-to-output connection table
    (nn/SpatialConvolutionMap.scala).

    The weight is the dense HWIO kernel, multiplied in every forward by
    the table's 0/1 mask (a buffer, not a parameter), so a masked entry
    gets a zero gradient and stays as it is under training, as in the
    reference.  ``conn_table`` is an int array (n_connections, 2) of
    0-based (input map, output map) pairs; :meth:`full`,
    :meth:`one_to_one` and :meth:`random` build the reference's tables.
    The plane counts default to the table's largest index + 1."""

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 n_input_plane: int = None, n_output_plane: int = None):
        table = np.asarray(conn_table, dtype=np.int64)
        n_in = n_input_plane or int(table[:, 0].max()) + 1
        n_out = n_output_plane or int(table[:, 1].max()) + 1
        if int(table[:, 0].max()) >= n_in or int(table[:, 1].max()) >= n_out:
            raise ValueError("connection table indexes beyond plane counts")
        super().__init__(n_in, n_out, kernel_w, kernel_h, stride_w, stride_h,
                         pad_w, pad_h, 1, True, with_bias,
                         w_regularizer, b_regularizer)
        mask = torch.zeros((n_in, n_out))
        mask[torch.from_numpy(table[:, 0]), torch.from_numpy(table[:, 1])] = 1
        # (1, 1, cin, cout): broadcast over kh, kw
        self.register_buffer("mask", mask[None, None], persistent=False)

    @staticmethod
    def full(n_in: int, n_out: int):
        """Every input map to every output map (``full``)."""
        return np.stack(np.meshgrid(np.arange(n_in), np.arange(n_out),
                                    indexing="ij"), -1).reshape(-1, 2)

    @staticmethod
    def one_to_one(n_features: int):
        """Map i to map i (``oneToOne``)."""
        r = np.arange(n_features)
        return np.stack([r, r], -1)

    @staticmethod
    def random(n_in: int, n_out: int, n_to: int, seed: int = 0):
        """Each output map from ``n_to`` input maps drawn without
        replacement (``random``): the reference's numpy draws."""
        rng = np.random.default_rng(seed)
        rows = []
        for o in range(n_out):
            for i in rng.choice(n_in, size=min(n_to, n_in), replace=False):
                rows.append((int(i), o))
        return np.array(rows, dtype=np.int32)

    def forward(self, x):
        return self._conv(x, self.weight * self.mask.to(self.weight.dtype))


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (nn/SpatialDilatedConvolution.scala); the
    reference's argument order, ``dilation_w`` before ``dilation_h``."""

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0,
                 dilation_w=1, dilation_h=1, with_bias=True,
                 w_regularizer=None, b_regularizer=None):
        super().__init__(n_input_plane, n_output_plane, kernel_w, kernel_h,
                         stride_w, stride_h, pad_w, pad_h, 1, True, with_bias,
                         w_regularizer, b_regularizer)
        self.dilation = (dilation_h, dilation_w)

    def forward(self, x):
        return self._conv(x, self.weight, self.dilation)


def _init_conv(module, shape, fan_in, fan_out, n_bias, generator):
    """Weight and (where ``module.with_bias``) bias from the module's
    initializers, the reference's fans."""
    dt = get_policy().param_dtype
    winit = module.weight_initializer or default_weight_init
    binit = module.bias_initializer or default_bias_init
    p = {"weight": winit(generator, shape, fan_in, fan_out, dt)}
    if module.with_bias:
        p["bias"] = binit(generator, (n_bias,), fan_in, fan_out, dt)
    return p


class SpatialFullConvolution(Module):
    """Transposed convolution (nn/SpatialFullConvolution.scala); the
    output is (in - 1)·stride - 2·pad + kernel + adj.

    The weight is (kh, kw, n_in/groups, n_out), as in the reference, which
    correlates its spatial flip with the input dilated by the stride,
    padded (k-1-p, k-1-p+adj).  That is ``F.conv_transpose2d`` with the
    weight as (n_in, n_out/groups, kh, kw) group by group, ``padding=p``
    and ``output_padding=adj``.  PyTorch refuses ``adj >= stride``, which
    the reference accepts: there the untrimmed transposed convolution
    (no padding) is cut to the reference's rows and columns, and rows
    past its end (``adj > pad``) are zeros, as the reference's padding
    gives them, before the bias."""

    PARAM_ROLES = {"weight": "conv_kernel", "bias": "bias"}

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0, adj_w=0, adj_h=0,
                 n_group=1, no_bias=False, w_regularizer=None,
                 b_regularizer=None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not divide into {n_group} groups")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.adj = (adj_h, adj_w)
        self.n_group = n_group
        self.with_bias = not no_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer

    def _init(self, generator):
        kh, kw = self.kernel
        shape = (kh, kw, self.n_input_plane // self.n_group,
                 self.n_output_plane)
        fan_in = kh * kw * shape[2]
        return _init_conv(self, shape, fan_in, fan_in, self.n_output_plane,
                          generator)

    def _torch_weight(self, c):
        """(kh, kw, cin/G, cout) -> (cin, cout/G, kh, kw), group by
        group."""
        kh, kw, cin_g, cout = self.weight.shape
        g = self.n_group
        w = self.weight.to(c).reshape(kh, kw, cin_g, g, cout // g)
        return w.permute(3, 2, 4, 0, 1).reshape(g * cin_g, cout // g, kh, kw)

    def forward(self, x):
        c = get_policy().compute_dtype
        xc = x.to(c).permute(0, 3, 1, 2)
        w = self._torch_weight(c)
        if all(a < s for a, s in zip(self.adj, self.stride)):
            y = F.conv_transpose2d(xc, w, stride=self.stride,
                                   padding=self.pad,
                                   output_padding=self.adj,
                                   groups=self.n_group)
        else:
            full = F.conv_transpose2d(xc, w, stride=self.stride,
                                      groups=self.n_group)
            y = full
            for d in range(2):
                n_in = x.shape[1 + d]
                p, k, s, a = (self.pad[d], self.kernel[d], self.stride[d],
                              self.adj[d])
                out = (n_in - 1) * s - 2 * p + k + a
                beyond = max(p + out - y.shape[2 + d], 0)
                y = F.pad(y, (0, beyond, 0, 0) if d else (0, 0, 0, beyond))
                y = y.narrow(2 + d, p, out)
        y = y.permute(0, 2, 3, 1)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y


class TemporalConvolution(Module):
    """1-D convolution over (batch, time, features)
    (nn/TemporalConvolution.scala): weight (k, in, out), no padding.  On
    the NHWC view (batch, 1, time, features) it is a 2-D convolution of
    height 1, a ``channels_last`` view as ``SpatialConvolution`` hands
    cuDNN, so no copy is made."""

    PARAM_ROLES = {"weight": "conv_kernel", "bias": "bias"}

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1,
                 propagate_back: bool = True, w_regularizer=None,
                 b_regularizer=None):
        super().__init__()
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.with_bias = True
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer

    def _init(self, generator):
        shape = (self.kernel_w, self.input_frame_size,
                 self.output_frame_size)
        fan_in = self.kernel_w * self.input_frame_size
        return _init_conv(self, shape, fan_in, fan_in,
                          self.output_frame_size, generator)

    def forward(self, x):
        c = get_policy().compute_dtype
        xc = x.to(c)[:, None].permute(0, 3, 1, 2)
        w = self.weight.to(c).permute(2, 1, 0)[:, :, None]
        y = remat.conv2d(xc, w, (1, self.stride_w), (0, 0), 1)
        y = y.permute(0, 2, 3, 1)[:, 0]
        return y + self.bias.to(y.dtype)


class VolumetricConvolution(Module):
    """3-D convolution over NDHWC (nn/VolumetricConvolution.scala).  The
    arguments come as the reference's (k_t, k_w, k_h), w before h; the
    weight is (kt, kh, kw, in, out)."""

    PARAM_ROLES = {"weight": "conv_kernel", "bias": "bias"}

    def __init__(self, n_input_plane, n_output_plane, k_t, k_w, k_h,
                 d_t=1, d_w=1, d_h=1, pad_t=0, pad_w=0, pad_h=0,
                 with_bias=True, w_regularizer=None, b_regularizer=None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer

    def _init(self, generator):
        kt, kh, kw = self.kernel
        shape = (kt, kh, kw, self.n_input_plane, self.n_output_plane)
        fan_in = kt * kh * kw * self.n_input_plane
        return _init_conv(self, shape, fan_in, fan_in, self.n_output_plane,
                          generator)

    def forward(self, x):
        c = get_policy().compute_dtype
        # NDHWC -> a channels_last_3d NCDHW view, no copy
        y = F.conv3d(x.to(c).permute(0, 4, 1, 2, 3),
                     self.weight.to(c).permute(4, 3, 0, 1, 2),
                     stride=self.stride, padding=self.pad)
        y = y.permute(0, 2, 3, 4, 1)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y
