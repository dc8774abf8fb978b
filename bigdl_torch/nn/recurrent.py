"""Recurrent layers: the dense cells ``RnnCell``, ``LSTM``,
``LSTMPeephole`` and ``GRU``, the convolutional cells
``ConvLSTMPeephole`` and ``ConvLSTMPeephole3D``, and the wrappers
``Recurrent``, ``TimeDistributed`` and ``BiRecurrent``.

Counterpart of ``bigdl_tpu/nn/recurrent.py`` (BigDL ``nn/Cell.scala``,
``nn/RNN.scala``, ``nn/LSTM.scala``, ``nn/LSTMPeephole.scala``,
``nn/GRU.scala``, ``nn/ConvLSTMPeephole.scala``,
``nn/ConvLSTMPeephole3D.scala``, ``nn/Recurrent.scala``,
``nn/TimeDistributed.scala``, ``nn/BiRecurrent.scala``).  The param
trees are the reference's: LSTM's is ``{"kernel": (in + H, 4H), "bias":
(4H,)}`` with the gates in the order input, forget, cell, output, so
``load_reference_tree`` carries weights across unchanged (not cuDNN's
layout).

The computation is the reference's.  ``Recurrent`` hoists the input half
of every gate projection out of the time loop as one float32-accumulating
gemm over all (time, batch) rows (``Cell.project_inputs``) when
``_dense_hoist_ok`` allows it (``BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS``, the
reference's cap), then runs the hidden half step by step
(``Cell.step_projected``) in a Python loop: the reference's ``lax.scan``
body, launched once a step.  The cell's ``p`` is variational dropout on
the cell input: one mask of shape ``(B,) + x.shape[2:]`` for every time
step, drawn from the generator that
:func:`~bigdl_torch.nn.dropout.dropout_rng` hands the forward; without
one, as in the reference without a key, no mask is drawn.

The convolutional cells hoist the input half of their gate convolution
the same way, as one convolution over all (time, batch) maps, up to the
same cap on the projection's elements; above it each step convolves its
own input, as the reference's fallback does.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F

from ..common import get_policy
from ..utils import config
from .dropout import _generator_for
from .linear import matmul_f32
from .module import Container, Module

__all__ = ["Cell", "RnnCell", "LSTM", "LSTMPeephole", "GRU",
           "ConvLSTMPeephole", "ConvLSTMPeephole3D", "Recurrent",
           "TimeDistributed", "BiRecurrent"]


def _uniform(generator, shape, stdv):
    return torch.empty(shape, dtype=get_policy().param_dtype).uniform_(
        -stdv, stdv, generator=generator)


def _dense_hoist_ok(xs, gate_width: int) -> bool:
    """Whether the hoisted (T, B, gate_width) float32 projection stays
    under the cap; one step (T = 1) always does."""
    t, b = xs.shape[0], xs.shape[1]
    return t == 1 or t * b * gate_width <= config.get_int(
        "RNN_HOIST_MAX_ELEMENTS", 1 << 28)


def _project(xs, w):
    """(T, B, I) @ (I, G) as one flat gemm with float32 accumulation:
    (T, B, G) float32."""
    cd = get_policy().compute_dtype
    t, b, i = xs.shape
    proj = matmul_f32(xs.reshape(t * b, i).to(cd), w.to(cd))
    return proj.float().reshape(t, b, -1)


def _hidden_mm(h, w):
    """h @ w in the compute dtype with float32 accumulation."""
    cd = get_policy().compute_dtype
    return matmul_f32(h.to(cd), w.to(cd)).float()


class Cell(Module):
    """RNN-cell base (nn/Cell.scala).

    ``init_hidden(batch_size, dtype, device)`` gives the zero state;
    ``step(x_t, hidden)`` -> (output_t, new hidden).  A cell that has
    ``project_inputs`` / ``step_projected`` (all the dense cells) takes
    ``step`` from them, so one step and ``Recurrent``'s hoisted loop share
    one set of equations."""

    hidden_size: int

    def init_hidden(self, batch_size: int, dtype=torch.float32,
                    device=None):
        raise NotImplementedError

    def step(self, x_t, hidden):
        proj = self.project_inputs(x_t[None])
        if proj is None:
            raise NotImplementedError
        xp_t = tuple(p[0] for p in proj) if isinstance(proj, tuple) \
            else proj[0]
        return self.step_projected(xp_t, hidden)

    def project_inputs(self, xs):
        """Time-major (T, B, I) inputs -> the input half of the gate
        projections (a tensor or a tuple of tensors indexed by time), or
        None where the cell does not hoist."""
        return None

    def step_projected(self, xp_t, hidden):
        raise NotImplementedError

    def forward(self, x):
        """A bare cell on (batch, features): one step from the zero
        state."""
        out, _ = self.step(x, self.init_hidden(x.shape[0], x.dtype,
                                               device=x.device))
        return out


def _zeros(batch_size, hidden_size, dtype, device):
    return torch.zeros((batch_size, hidden_size), dtype=dtype, device=device)


class RnnCell(Cell):
    """h' = activation(x W + h U + b) (nn/RNN.scala)."""

    PARAM_ROLES = {"w_ih": "kernel_in", "w_hh": "kernel_in",
                   "bias": "bias"}

    def __init__(self, input_size: int, hidden_size: int,
                 activation=torch.tanh):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation

    def _init(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        return {"w_ih": _uniform(generator, (self.input_size,
                                             self.hidden_size), stdv),
                "w_hh": _uniform(generator, (self.hidden_size,
                                             self.hidden_size), stdv),
                "bias": _uniform(generator, (self.hidden_size,), stdv)}

    def init_hidden(self, batch_size, dtype=torch.float32, device=None):
        return _zeros(batch_size, self.hidden_size, dtype, device)

    def project_inputs(self, xs):
        if not _dense_hoist_ok(xs, self.hidden_size):
            return None
        return _project(xs, self.w_ih)

    def step_projected(self, xp_t, h):
        c = get_policy().compute_dtype
        pre = xp_t + h.to(c) @ self.w_hh.to(c) + self.bias
        h_new = self.activation(pre).to(h.dtype)
        return h_new, h_new


class LSTM(Cell):
    """LSTM cell (nn/LSTM.scala): the four gate projections in one
    (in + H, 4H) kernel, gates in the order input, forget, cell, output.
    ``p`` is the dropout on the cell input that ``Recurrent`` applies."""

    PARAM_ROLES = {"kernel": "kernel_in", "bias": "bias"}

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p

    def _init(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        return {"kernel": _uniform(generator,
                                   (self.input_size + self.hidden_size,
                                    4 * self.hidden_size), stdv),
                "bias": _uniform(generator, (4 * self.hidden_size,), stdv)}

    def init_hidden(self, batch_size, dtype=torch.float32, device=None):
        return (_zeros(batch_size, self.hidden_size, dtype, device),
                _zeros(batch_size, self.hidden_size, dtype, device))

    def project_inputs(self, xs):
        if not _dense_hoist_ok(xs, 4 * self.hidden_size):
            return None
        return _project(xs, self.kernel[:self.input_size])

    def step_projected(self, xp_t, hidden):
        h, cst = hidden
        gates = xp_t + _hidden_mm(h, self.kernel[self.input_size:])
        gates = gates + self.bias
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_new = f * cst.float() + i * g
        h_new = (o * torch.tanh(c_new)).to(h.dtype)
        return h_new, (h_new, c_new.to(h.dtype))


class LSTMPeephole(Cell):
    """LSTM whose gates also see the cell state through diagonal weights
    (nn/LSTMPeephole.scala)."""

    PARAM_ROLES = {"kernel": "kernel_in", "bias": "bias",
                   "peep_i": "elementwise", "peep_f": "elementwise",
                   "peep_o": "elementwise"}

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p

    def _init(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        H = self.hidden_size
        return {"kernel": _uniform(generator, (self.input_size + H, 4 * H),
                                   stdv),
                "bias": _uniform(generator, (4 * H,), stdv),
                "peep_i": _uniform(generator, (H,), stdv),
                "peep_f": _uniform(generator, (H,), stdv),
                "peep_o": _uniform(generator, (H,), stdv)}

    def init_hidden(self, batch_size, dtype=torch.float32, device=None):
        return (_zeros(batch_size, self.hidden_size, dtype, device),
                _zeros(batch_size, self.hidden_size, dtype, device))

    def project_inputs(self, xs):
        if not _dense_hoist_ok(xs, 4 * self.hidden_size):
            return None
        return _project(xs, self.kernel[:self.input_size])

    def step_projected(self, xp_t, hidden):
        h, cst = hidden
        gates = xp_t + _hidden_mm(h, self.kernel[self.input_size:])
        gates = gates + self.bias
        i, f, g, o = gates.chunk(4, dim=-1)
        cf = cst.float()
        i = torch.sigmoid(i + self.peep_i * cf)
        f = torch.sigmoid(f + self.peep_f * cf)
        g = torch.tanh(g)
        c_new = f * cf + i * g
        o = torch.sigmoid(o + self.peep_o * c_new)
        h_new = (o * torch.tanh(c_new)).to(h.dtype)
        return h_new, (h_new, c_new.to(h.dtype))


class GRU(Cell):
    """GRU cell (nn/GRU.scala): the reset and update gates in one
    (in + H, 2H) kernel, the candidate in another."""

    PARAM_ROLES = {"gate_kernel": "kernel_in", "gate_bias": "bias",
                   "cand_kernel": "kernel_in", "cand_bias": "bias"}

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p

    def _init(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        H = self.hidden_size
        return {"gate_kernel": _uniform(generator,
                                        (self.input_size + H, 2 * H), stdv),
                "gate_bias": _uniform(generator, (2 * H,), stdv),
                "cand_kernel": _uniform(generator, (self.input_size + H, H),
                                        stdv),
                "cand_bias": _uniform(generator, (H,), stdv)}

    def init_hidden(self, batch_size, dtype=torch.float32, device=None):
        return _zeros(batch_size, self.hidden_size, dtype, device)

    def project_inputs(self, xs):
        if not _dense_hoist_ok(xs, 3 * self.hidden_size):  # both kernels
            return None
        I = self.input_size
        return (_project(xs, self.gate_kernel[:I]),
                _project(xs, self.cand_kernel[:I]))

    def step_projected(self, xp_t, h):
        cd = get_policy().compute_dtype
        I = self.input_size
        xp_gate, xp_cand = xp_t
        gates = torch.sigmoid(xp_gate + _hidden_mm(h, self.gate_kernel[I:])
                              + self.gate_bias)
        r, u = gates.chunk(2, dim=-1)
        rh = (r * h.float()).to(cd)
        cand = torch.tanh(xp_cand + _hidden_mm(rh, self.cand_kernel[I:])
                          + self.cand_bias)
        h_new = ((1.0 - u) * h.float() + u * cand).to(h.dtype)
        return h_new, h_new


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM with peepholes over NHWC maps
    (nn/ConvLSTMPeephole.scala).  The ``kernel`` parameter is HWIO over
    the input and hidden channels concatenated, ``(k, k, in + out,
    4·out)``, gates in the order input, forget, cell, output; the
    peepholes are float32 and start at zero.  The convolutions are
    ``kernel_i`` wide (``kernel_width``; the reference's ``kernel``
    attribute, which here names the parameter), padded ``kernel_i // 2``,
    at ``stride``.  Under ``Recurrent`` the state takes the input's
    spatial shape."""

    PARAM_ROLES = {"kernel": "conv_kernel", "bias": "bias",
                   "peep_i": "elementwise", "peep_f": "elementwise",
                   "peep_o": "elementwise"}

    #: spatial rank; ConvLSTMPeephole3D overrides with 3 (NDHWC maps)
    SPATIAL_NDIM = 2

    def __init__(self, input_size: int, output_size: int, kernel_i: int = 3,
                 kernel_c: int = 3, stride: int = 1,
                 with_peephole: bool = True):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.kernel_width = kernel_i
        self.stride = stride
        self.with_peephole = with_peephole
        self.hidden_size = output_size
        self._spatial = None  # the maps' spatial shape, bound by the caller

    def _init(self, generator):
        k, n = self.kernel_width, self.SPATIAL_NDIM
        cin = self.input_size + self.output_size
        stdv = 1.0 / math.sqrt((k ** n) * cin)
        p = {"kernel": _uniform(generator, (k,) * n + (
                 cin, 4 * self.output_size), stdv),
             "bias": _uniform(generator, (4 * self.output_size,), stdv)}
        if self.with_peephole:
            for name in ("peep_i", "peep_f", "peep_o"):
                p[name] = torch.zeros((self.output_size,),
                                      dtype=torch.float32)
        return p

    def init_hidden(self, batch_size, dtype=torch.float32, spatial=None,
                    device=None):
        if spatial is None:
            spatial = self._spatial
        z = torch.zeros((batch_size,) + tuple(spatial) + (self.output_size,),
                        dtype=dtype, device=device)
        return (z, z)

    def _gate_conv(self, x, kernel):
        """The channels-last convolution of ``x`` with an HWIO (DHWIO)
        slice of the kernel, in x's dtype."""
        n = self.SPATIAL_NDIM
        conv = F.conv2d if n == 2 else F.conv3d
        w = kernel.to(x.dtype).permute((n + 1, n) + tuple(range(n)))
        y = conv(x.permute((0, n + 1) + tuple(range(1, n + 1))), w,
                 stride=self.stride, padding=self.kernel_width // 2)
        return y.permute((0,) + tuple(range(2, n + 2)) + (1,))

    def project_inputs(self, xs):
        # a convolution is linear in its input channels: conv([x, h], K) =
        # conv(x, Kx) + conv(h, Kh), so the x half of every step is one
        # convolution over T·B maps, unless the projection would pass the
        # cap (one step always may)
        t, b = xs.shape[0], xs.shape[1]
        elems = t * b * 4 * self.output_size * math.prod(
            xs.shape[2:2 + self.SPATIAL_NDIM])
        if t > 1 and elems > config.get_int("RNN_HOIST_MAX_ELEMENTS",
                                            1 << 28):
            return None
        flat = xs.reshape((t * b,) + tuple(xs.shape[2:]))
        proj = self._gate_conv(flat, self.kernel[..., :self.input_size, :])
        return proj.reshape((t, b) + tuple(proj.shape[1:]))

    def step_projected(self, xp_t, hidden):
        h, cst = hidden
        gates = xp_t + self._gate_conv(
            h, self.kernel[..., self.input_size:, :]) + self.bias
        i, f, g, o = gates.chunk(4, dim=-1)
        cf = cst.float()
        if self.with_peephole:
            i = i + self.peep_i * cf
            f = f + self.peep_f * cf
        i, f = torch.sigmoid(i), torch.sigmoid(f)
        g = torch.tanh(g)
        c_new = f * cf + i * g
        if self.with_peephole:
            o = o + self.peep_o * c_new
        o = torch.sigmoid(o)
        h_new = (o * torch.tanh(c_new)).to(h.dtype)
        return h_new, (h_new, c_new.to(h.dtype))

    def forward(self, x):
        """A bare cell on (batch, *spatial, channels): one step from the
        zero state."""
        self._spatial = tuple(x.shape[1:1 + self.SPATIAL_NDIM])
        return super().forward(x)


class ConvLSTMPeephole3D(ConvLSTMPeephole):
    """Volumetric convolutional LSTM with peepholes over NDHWC maps
    (nn/ConvLSTMPeephole3D.scala); input (batch, time, D, H, W, C) under
    ``Recurrent``."""

    SPATIAL_NDIM = 3


class Recurrent(Container):
    """A cell unrolled over the time axis of (batch, time, features...)
    input (nn/Recurrent.scala); the output is (batch, time, ...)."""

    def __init__(self, cell: Cell = None):
        super().__init__()
        if cell is not None:
            self.add(cell)
        self._return_state = False

    def _dropped(self, x):
        """The cell input under variational dropout: one keep-mask of shape
        (B,) + x.shape[2:] shared by every step."""
        p = getattr(self.layers[0], "p", 0.0)
        if not self.training or p <= 0.0:
            return x
        gen = _generator_for(x)
        if gen is None:
            return x
        keep = 1.0 - p
        mask = torch.rand((x.shape[0],) + tuple(x.shape[2:]), generator=gen,
                          device=x.device) < keep
        return torch.where(mask[:, None], x,
                           torch.zeros((), dtype=x.dtype,
                                       device=x.device)) / keep

    def forward(self, x):
        cell: Cell = self.layers[0]
        if isinstance(cell, ConvLSTMPeephole):
            cell._spatial = tuple(x.shape[2:2 + cell.SPATIAL_NDIM])
        x = self._dropped(x)
        h = cell.init_hidden(x.shape[0], x.dtype, device=x.device)
        xs = x.transpose(0, 1)  # time-major
        proj = cell.project_inputs(xs)
        outs = []
        if proj is not None:
            # the input half hoisted into one gemm (after the dropout, so
            # the mask still applies); each step runs the hidden half
            for t in range(xs.shape[0]):
                xp_t = tuple(p[t] for p in proj) \
                    if isinstance(proj, tuple) else proj[t]
                out, h = cell.step_projected(xp_t, h)
                outs.append(out)
        else:
            for t in range(xs.shape[0]):
                out, h = cell.step(xs[t], h)
                outs.append(out)
        out = torch.stack(outs, dim=1)
        if self._return_state:
            return out, h
        return out


class TimeDistributed(Container):
    """A layer applied at every time step (nn/TimeDistributed.scala): the
    (batch, time) axes folded into one, then unfolded."""

    def __init__(self, module: Module):
        super().__init__(module)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        out = self.layers[0](x.reshape((b * t,) + tuple(x.shape[2:])))
        return out.reshape((b, t) + tuple(out.shape[1:]))


class BiRecurrent(Container):
    """The cell run forward over time and a copy of it run backward
    (nn/BiRecurrent.scala); ``merge`` is ``"sum"`` (the reference's
    default) or ``"concat"`` along the features.  The param list is
    [forward's, backward's]."""

    def __init__(self, cell: Cell, merge: str = "sum"):
        super().__init__()
        self.add(Recurrent(cell))
        self.add(Recurrent(copy.deepcopy(cell)))
        self.merge = merge

    def forward(self, x):
        fwd = self.layers[0](x)
        bwd = torch.flip(self.layers[1](torch.flip(x, (1,))), (1,))
        if self.merge == "concat":
            return torch.cat([fwd, bwd], dim=-1)
        return fwd + bwd
