"""Multi-input (Table) layers.

Counterpart of ``bigdl_tpu/nn/table_ops.py`` (BigDL ``nn/CAddTable.scala``
... ``nn/Pack.scala``).  Inputs and outputs are Python lists, the
reference's ``Table`` Activity.  Axis, offset and index arguments are
0-based, as in the reference.
"""

from __future__ import annotations

import functools

import torch

from .module import Module

__all__ = ["CAddTable", "CSubTable", "CMulTable", "CDivTable", "CMaxTable",
           "CMinTable", "JoinTable", "SplitTable", "NarrowTable",
           "FlattenTable", "SelectTable", "MixtureTable", "Pack"]


class CAddTable(Module):
    """Elementwise sum of the inputs.  Types promote as in JAX: a bfloat16
    branch added to a float32 residual gives float32."""

    def __init__(self, inplace: bool = False):
        super().__init__()
        # the reference keeps the flag for its signature and wire format;
        # the sum is a new tensor either way (autograd needs the inputs)
        self.inplace = inplace

    def forward(self, inputs):
        return functools.reduce(torch.add, inputs)


class CSubTable(Module):
    """inputs[0] - inputs[1] (nn/CSubTable.scala)."""

    def forward(self, inputs):
        return inputs[0] - inputs[1]


class CMulTable(Module):
    """Elementwise product of the inputs (nn/CMulTable.scala)."""

    def forward(self, inputs):
        return functools.reduce(torch.mul, inputs)


class CDivTable(Module):
    """inputs[0] / inputs[1] (nn/CDivTable.scala)."""

    def forward(self, inputs):
        return inputs[0] / inputs[1]


class CMaxTable(Module):
    """Elementwise maximum of the inputs (nn/CMaxTable.scala)."""

    def forward(self, inputs):
        return functools.reduce(torch.maximum, inputs)


class CMinTable(Module):
    """Elementwise minimum of the inputs (nn/CMinTable.scala)."""

    def forward(self, inputs):
        return functools.reduce(torch.minimum, inputs)


class JoinTable(Module):
    """Concatenate the inputs along ``dimension`` (nn/JoinTable.scala);
    ``n_input_dims`` is kept for the reference's signature."""

    def __init__(self, dimension: int, n_input_dims: int = 0):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, inputs):
        return torch.cat(list(inputs), dim=self.dimension)


class SplitTable(Module):
    """A tensor as the list of its slices along ``dimension``
    (nn/SplitTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = 0):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return list(torch.unbind(x, dim=self.dimension))


class NarrowTable(Module):
    """``length`` inputs from ``offset`` (nn/NarrowTable.scala); a negative
    length ends |length| - 1 before the end."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset, self.length = offset, length

    def forward(self, inputs):
        length = self.length
        if length < 0:
            length = len(inputs) - self.offset + length + 1
        return list(inputs)[self.offset:self.offset + length]


class FlattenTable(Module):
    """Nested lists flattened into one list (nn/FlattenTable.scala)."""

    def forward(self, inputs):
        out = []

        def rec(t):
            if isinstance(t, (list, tuple)):
                for e in t:
                    rec(e)
            else:
                out.append(t)

        rec(inputs)
        return out


class SelectTable(Module):
    """Input ``index`` of the list (nn/SelectTable.scala)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, inputs):
        return inputs[self.index]


class MixtureTable(Module):
    """Mixture of experts (nn/MixtureTable.scala): input [gate (batch, n),
    experts as a list of n (batch, ...) tensors or one (batch, n, ...)
    tensor]; output sum_i gate_i * expert_i."""

    def __init__(self, dim: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, inputs):
        gate, experts = inputs[0], inputs[1]
        if isinstance(experts, (list, tuple)):
            experts = torch.stack(list(experts), dim=1)
        g = gate.reshape(tuple(gate.shape) +
                         (1,) * (experts.dim() - gate.dim()))
        return (g * experts).sum(1)


class Pack(Module):
    """Stack the inputs along a new axis ``dimension`` (nn/Pack.scala); a
    single tensor gains the axis."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, inputs):
        if isinstance(inputs, (list, tuple)):
            return torch.stack(list(inputs), dim=self.dimension)
        return inputs.unsqueeze(self.dimension)
