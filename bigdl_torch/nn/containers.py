"""Composite modules.

Counterpart of ``bigdl_tpu/nn/containers.py`` for what the serving slice
uses: ``Sequential`` (nn/Sequential.scala), ``Concat`` (nn/Concat.scala),
``ConcatTable`` (nn/ConcatTable.scala) and ``Identity`` (nn/Identity.scala).
"""

from __future__ import annotations

import torch

from .module import Container, Module

__all__ = ["Sequential", "Concat", "ConcatTable", "Identity"]


class Sequential(Container):
    """Fold the input through the children in order."""

    def forward(self, x):
        for m in self.layers:
            x = m(x)
        return x


class Concat(Container):
    """Run every child on the same input and concatenate the outputs along
    ``dimension``, a 0-based axis of the NHWC layout (channels: -1), as in
    the reference."""

    def __init__(self, dimension: int = -1):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self.layers], dim=self.dimension)


class ConcatTable(Container):
    """Run every child on the same input; the outputs form a list."""

    def forward(self, x):
        return [m(x) for m in self.layers]


class Identity(Module):
    def forward(self, x):
        return x
