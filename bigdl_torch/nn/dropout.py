"""Dropout.

Counterpart of ``bigdl_tpu/nn/dropout.py`` ``Dropout`` (reference
``nn/Dropout.scala``): inverted dropout over a bernoulli keep-mask.  The
reference threads an explicit PRNG key through ``apply``; here the masks
come from an explicit ``torch.Generator`` on the module's device, handed to
the training forward with :func:`dropout_rng` (the Optimizer owns one,
seeded from ``BIGDL_TORCH_SEED`` and its rank), never from torch's global
RNG.  The two frameworks draw different bits from one seed, so masks match
the reference in distribution, not bit for bit.

``GradientReversal`` (nn/GradientReversal.scala) is the identity forward
and -lambda times the gradient backward, as a ``torch.autograd.Function``
(the reference's ``jax.custom_vjp``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from .module import Module

__all__ = ["Dropout", "GradientReversal", "dropout_rng"]

_rng: contextvars.ContextVar = contextvars.ContextVar("bigdl_dropout_rng",
                                                      default=None)


@contextlib.contextmanager
def dropout_rng(generator: Optional[torch.Generator]):
    """Every Dropout in training mode inside this block draws its mask from
    ``generator``, which must live on the activations' device."""
    token = _rng.set(generator)
    try:
        yield generator
    finally:
        _rng.reset(token)


def _generator_for(x: torch.Tensor) -> Optional[torch.Generator]:
    """The generator of the enclosing :func:`dropout_rng` block, or None;
    one on another device than ``x`` raises."""
    gen = _rng.get()
    if gen is not None and gen.device != x.device and not (
            gen.device.type == x.device.type == "cuda"
            and gen.device.index in (None, x.device.index)):
        raise ValueError(f"the generator lives on {gen.device}, the "
                         f"activations on {x.device}")
    return gen


class Dropout(Module):
    """Inverted dropout (nn/Dropout.scala): zero each element with
    probability p and, when ``scale`` (the reference's default), divide the
    survivors by 1 - p.  The identity in eval mode or at p = 0.
    ``inplace`` is accepted for the reference's signature; the output is
    always a new tensor."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.scale = scale

    def set_p(self, p: float):
        self.p = p
        return self

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        gen = _generator_for(x)
        if gen is None:
            raise ValueError("Dropout in training mode needs a generator: "
                             "run the forward inside dropout_rng(generator)")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        y = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        if self.scale:
            y = y / keep
        return y.to(x.dtype)


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(Module):
    """Identity forward, -lambda x the gradient backward
    (nn/GradientReversal.scala)."""

    def __init__(self, the_lambda: float = 1.0):
        super().__init__()
        self.the_lambda = the_lambda

    def set_lambda(self, lam: float):
        self.the_lambda = lam
        return self

    def forward(self, x):
        return _Reverse.apply(x, self.the_lambda)
