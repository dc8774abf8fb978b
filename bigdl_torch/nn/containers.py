"""Composite modules.

Counterpart of ``bigdl_tpu/nn/containers.py`` for what the serving slice
uses: ``Sequential`` (nn/Sequential.scala), ``ConcatTable``
(nn/ConcatTable.scala) and ``Identity`` (nn/Identity.scala).
"""

from __future__ import annotations

from .module import Container, Module

__all__ = ["Sequential", "ConcatTable", "Identity"]


class Sequential(Container):
    """Fold the input through the children in order."""

    def forward(self, x):
        for m in self.layers:
            x = m(x)
        return x


class ConcatTable(Container):
    """Run every child on the same input; the outputs form a list."""

    def forward(self, x):
        return [m(x) for m in self.layers]


class Identity(Module):
    def forward(self, x):
        return x
