"""Activations.

Counterpart of ``bigdl_tpu/nn/activation.py`` (one Scala file each under
BigDL ``nn/``).  Each is an elementwise PyTorch expression; ``inplace`` /
``ip`` flags are accepted for the reference's signatures and ignored, as
there.  ``PReLU``'s slope is a float32 parameter, as in the reference.
``RReLU`` in training draws its slopes from the generator that
:func:`~bigdl_torch.nn.dropout.dropout_rng` hands the forward (the one
Dropout draws from); without one, and in eval, it uses the mean slope, as
the reference does without a key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dropout import _generator_for
from .module import Module

__all__ = ["ReLU", "ReLU6", "PReLU", "RReLU", "LeakyReLU", "ELU", "Tanh",
           "TanhShrink", "Sigmoid", "SoftMax", "SoftMin", "SoftPlus",
           "SoftSign", "SoftShrink", "HardShrink", "HardTanh", "Threshold",
           "LogSoftMax", "LogSigmoid", "GELU"]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def softplus(x):
    """log(1 + e^x) without F.softplus's threshold, as jax.nn.softplus."""
    return torch.logaddexp(x, _zero(x))


class ReLU(Module):
    """max(x, 0) (nn/ReLU.scala).  ``ip`` (in place) is accepted for API
    parity and ignored, as in the reference."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, x):
        return torch.relu(x)


class ReLU6(Module):
    """min(max(x, 0), 6) (nn/ReLU6.scala)."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, x):
        return x.clamp(0.0, 6.0)


class PReLU(Module):
    """Learnable leaky slope (nn/PReLU.scala): one shared scalar when
    ``n_output_plane`` is 0, else one per channel of the last axis."""

    PARAM_ROLES = {"weight": "elementwise"}

    def __init__(self, n_output_plane: int = 0):
        super().__init__()
        self.n_output_plane = n_output_plane

    def _init(self, generator):
        n = max(self.n_output_plane, 1)
        return {"weight": torch.full((n,), 0.25, dtype=torch.float32)}

    def forward(self, x):
        w = self.weight
        a = w[0] if self.n_output_plane == 0 else w
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.where(x >= 0, x.to(dt), a * x.to(dt))


class RReLU(Module):
    """Randomized leaky ReLU (nn/RReLU.scala): negative inputs times a
    slope drawn from U(lower, upper) per element in training, times the
    mean slope in eval."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 ip: bool = False):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        gen = _generator_for(x) if self.training else None
        if gen is None:
            a = (self.lower + self.upper) / 2.0
        else:
            u = torch.rand(x.shape, generator=gen, device=x.device)
            a = (self.lower + (self.upper - self.lower) * u).to(x.dtype)
        return torch.where(x >= 0, x, a * x)


class LeakyReLU(Module):
    """x for x >= 0, ``negval`` * x below (nn/LeakyReLU.scala)."""

    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def forward(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class ELU(Module):
    """x for x > 0, alpha (e^x - 1) below (nn/ELU.scala)."""

    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return torch.where(x > 0, x, self.alpha * torch.expm1(x))


class Tanh(Module):
    """tanh(x) (nn/Tanh.scala)."""

    def forward(self, x):
        return torch.tanh(x)


class TanhShrink(Module):
    """x - tanh(x) (nn/TanhShrink.scala)."""

    def forward(self, x):
        return x - torch.tanh(x)


class Sigmoid(Module):
    """1 / (1 + e^-x) (nn/Sigmoid.scala)."""

    def forward(self, x):
        return torch.sigmoid(x)


class SoftMax(Module):
    """Softmax over the last (feature) axis (nn/SoftMax.scala)."""

    def forward(self, x):
        return torch.softmax(x, dim=-1)


class SoftMin(Module):
    """Softmax of -x over the last axis (nn/SoftMin.scala)."""

    def forward(self, x):
        return torch.softmax(-x, dim=-1)


class SoftPlus(Module):
    """log(1 + e^(beta x)) / beta (nn/SoftPlus.scala)."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return softplus(self.beta * x) / self.beta


class SoftSign(Module):
    """x / (1 + |x|) (nn/SoftSign.scala)."""

    def forward(self, x):
        return x / (1.0 + x.abs())


class SoftShrink(Module):
    """x - lam above lam, x + lam below -lam, 0 between
    (nn/SoftShrink.scala)."""

    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def forward(self, x):
        return torch.where(x > self.lam, x - self.lam,
                           torch.where(x < -self.lam, x + self.lam,
                                       _zero(x)))


class HardShrink(Module):
    """x where |x| > lam, else 0 (nn/HardShrink.scala)."""

    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def forward(self, x):
        return torch.where(x.abs() > self.lam, x, _zero(x))


class HardTanh(Module):
    """x clipped to [min_value, max_value] (nn/HardTanh.scala)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return x.clamp(self.min_value, self.max_value)


class Threshold(Module):
    """x if x > th else v (nn/Threshold.scala)."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        # kept for the reference's wire format, as there
        self.th, self.v, self.ip = th, v, bool(ip)

    def forward(self, x):
        return torch.where(x > self.th, x,
                           torch.full((), self.v, dtype=x.dtype,
                                      device=x.device))


class LogSoftMax(Module):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


class LogSigmoid(Module):
    """log(sigmoid(x)) (nn/LogSigmoid.scala)."""

    def forward(self, x):
        return F.logsigmoid(x)


class GELU(Module):
    """Gaussian-error linear unit in its tanh approximation, which is what
    ``jax.nn.gelu`` computes by default."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")
