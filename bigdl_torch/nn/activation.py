"""Activations: ``LogSoftMax`` and ``GELU``.

Counterpart of ``bigdl_tpu/nn/activation.py`` for what the serving slice
uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .module import Module

__all__ = ["LogSoftMax", "GELU"]


class LogSoftMax(Module):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


class GELU(Module):
    """Gaussian-error linear unit in its tanh approximation, which is what
    ``jax.nn.gelu`` computes by default."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")
