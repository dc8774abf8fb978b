"""Parameter initialization.

Counterpart of ``bigdl_tpu/nn/initialization.py`` for what the serving
and training slices use: Torch's default uniform init, ``Zeros`` and
``MsraFiller`` (ResNet's convolutions).  An initializer is a callable
``(generator, shape, fan_in, fan_out, dtype) -> torch.Tensor`` drawing from
a ``torch.Generator`` on the host.  The distributions are the reference's;
the numbers differ from JAX's, so parity tests copy weights, never compare
init.
"""

from __future__ import annotations

import math

import torch

__all__ = ["compute_fans", "default_weight_init", "default_bias_init",
           "InitializationMethod", "Zeros", "MsraFiller"]


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
