"""Activations: ``ReLU``, ``LogSoftMax`` and ``GELU``.

Counterpart of ``bigdl_tpu/nn/activation.py`` for what the serving and
training slices use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .module import Module

__all__ = ["ReLU", "LogSoftMax", "GELU"]


class ReLU(Module):
    """max(x, 0) (nn/ReLU.scala).  ``ip`` (in place) is accepted for API
    parity and ignored, as in the reference."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, x):
        return torch.relu(x)


class LogSoftMax(Module):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


class GELU(Module):
    """Gaussian-error linear unit in its tanh approximation, which is what
    ``jax.nn.gelu`` computes by default."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")
