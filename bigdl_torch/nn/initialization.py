"""Parameter initialization.

Counterpart of ``bigdl_tpu/nn/initialization.py``: Torch's default uniform
init, ``Zeros``, ``Ones``, ``ConstInitMethod``, ``RandomUniform``,
``RandomNormal``, ``Xavier``, ``MsraFiller`` and ``BilinearFiller``
(InitializationMethod.scala).  An initializer is a callable
``(generator, shape, fan_in, fan_out, dtype) -> torch.Tensor`` drawing from
an explicit ``torch.Generator`` on the host.  The distributions are the
reference's; the random numbers differ from JAX's, so parity tests copy
weights, and compare only the deterministic initializers' values.
"""

from __future__ import annotations

import math

import torch

__all__ = ["compute_fans", "default_weight_init", "default_bias_init",
           "InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
           "BilinearFiller"]


def compute_fans(shape):
    """fan_in/fan_out for dense (out,in) and conv (kh,kw,cin,cout) shapes."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:  # (out, in)
        return shape[1], shape[0]
    receptive = math.prod(shape[:-2])
    return receptive * shape[-2], receptive * shape[-1]


def default_weight_init(generator, shape, fan_in, fan_out,
                        dtype=torch.float32):
    """Torch's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (InitializationMethod.scala:163-190), for weights and biases alike."""
    stdv = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape, dtype=dtype).uniform_(-stdv, stdv,
                                                    generator=generator)


default_bias_init = default_weight_init


class InitializationMethod:
    """An initializer object for ``Module.set_init_method``
    (InitializationMethod.scala:139)."""

    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)


class Ones(InitializationMethod):
    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        return torch.full(shape, self.value, dtype=dtype)


class RandomUniform(InitializationMethod):
    """U(lower, upper); with no bounds, Torch's 1/sqrt(fan_in)
    (InitializationMethod.scala:163-190)."""

    def __init__(self, lower=None, upper=None):
        self.lower, self.upper = lower, upper

    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        if self.lower is None:
            fi = fan_in if fan_in else compute_fans(shape)[0]
            lo, hi = -1.0 / math.sqrt(fi), 1.0 / math.sqrt(fi)
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, dtype=dtype).uniform_(lo, hi,
                                                        generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean=0.0, stdv=1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        return self.mean + self.stdv * torch.randn(
            shape, generator=generator, dtype=dtype)


class Xavier(InitializationMethod):
    """U(-a, a), a = sqrt(6 / (fan_in + fan_out))
    (InitializationMethod.scala:257)."""

    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        if fan_in is None:
            fan_in, fan_out = compute_fans(shape)
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=dtype).uniform_(-a, a,
                                                        generator=generator)


class MsraFiller(InitializationMethod):
    """He/MSRA init: N(0, sqrt(2/n)) with n = fan_in, or the mean of the
    fans with ``variance_norm_average``."""

    def __init__(self, variance_norm_average: bool = False):
        self.variance_norm_average = variance_norm_average

    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        if fan_in is None:
            fan_in, fan_out = compute_fans(shape)
        n = (fan_in + fan_out) / 2.0 if self.variance_norm_average else fan_in
        return math.sqrt(2.0 / n) * torch.randn(shape, generator=generator,
                                                dtype=dtype)


class BilinearFiller(InitializationMethod):
    """The bilinear-upsampling kernel (InitializationMethod.scala:277) for
    (kh, kw, cin, cout) weights; no draw."""

    def __call__(self, generator, shape, fan_in=None, fan_out=None,
                 dtype=torch.float32):
        kh, kw = shape[0], shape[1]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (kh - 1) / (2.0 * f_h) if kh > 1 else 0.0
        c_w = (kw - 1) / (2.0 * f_w) if kw > 1 else 0.0
        ys = torch.arange(kh, dtype=torch.float64).reshape(-1, 1)
        xs = torch.arange(kw, dtype=torch.float64).reshape(1, -1)
        filt = (1 - (ys / f_h - c_h).abs()) * (1 - (xs / f_w - c_w).abs())
        w = torch.zeros(shape, dtype=torch.float32)
        w[...] = filt.to(torch.float32).reshape(kh, kw, *([1] * (len(shape)
                                                                 - 2)))
        return w.to(dtype)
