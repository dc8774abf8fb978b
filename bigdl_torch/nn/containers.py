"""Composite modules.

Counterpart of ``bigdl_tpu/nn/containers.py``: ``Sequential``
(nn/Sequential.scala), ``Concat`` (nn/Concat.scala), ``ConcatTable``
(nn/ConcatTable.scala), ``ParallelTable`` (nn/ParallelTable.scala),
``MapTable`` (nn/MapTable.scala, one child whose parameters every input
shares), ``Identity`` (nn/Identity.scala), ``Echo`` (nn/Echo.scala) and
``Bottle`` (nn/Bottle.scala).  A container's parameter tree is the list
of its children's, as in the reference; ``MapTable``'s is ``[child's]``.
"""

from __future__ import annotations

import torch

from .module import Container, Module

__all__ = ["Sequential", "Concat", "ConcatTable", "ParallelTable", "MapTable",
           "Identity", "Echo", "Bottle"]


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


class ParallelTable(Container):
    """The i-th child on the i-th input; the outputs form a list."""

    def forward(self, inputs):
        return [m(x) for m, x in zip(self.layers, inputs)]


class MapTable(Container):
    """One child applied to every input, its parameters shared."""

    def __init__(self, module: Module = None):
        super().__init__()
        if module is not None:
            self.add(module)

    def forward(self, inputs):
        m = self.layers[0]
        return [m(x) for x in inputs]


class Echo(Module):
    """The identity, printing the module's name and the input's shape."""

    def forward(self, x):
        print(f"{self.name}: shape {tuple(x.shape)}")
        return x


class Bottle(Container):
    """The child applied to the input with its leading ``n_input_dim`` axes
    folded into one, which are then unfolded from the output:
    (d1, ..., dn, *rest) -> (d1 * ... * dn, *rest) -> child -> (d1, ...,
    dn, *child's)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = None):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim or n_input_dim

    def forward(self, x):
        lead = tuple(x.shape[:self.n_input_dim])
        out = self.layers[0](x.reshape((-1,) + tuple(
            x.shape[self.n_input_dim:])))
        return out.reshape(lead + tuple(out.shape[1:]))
