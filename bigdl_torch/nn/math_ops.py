"""Elementwise, reduction and product layers.

Counterpart of ``bigdl_tpu/nn/math_ops.py`` (BigDL ``nn/Power.scala`` ...
``nn/CosineDistance.scala``).  Axes are 0-based over the whole tensor,
batch included, as in the reference.  Layers with parameters keep them in
float32, as the reference does.
"""

from __future__ import annotations

import math

import torch

from .linear import uniform_f32
from .module import Module

__all__ = ["Power", "Sqrt", "Square", "Clamp", "Max", "Min", "Mean", "Sum",
           "Exp", "Log", "Abs", "Scale", "MM", "MV", "Cosine", "Euclidean",
           "DotProduct", "PairwiseDistance", "CosineDistance"]


def unit_rows(t):
    """Each row of ``t`` over its L2 norm (+ 1e-12)."""
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)


class Power(Module):
    """(shift + scale * x) ^ power (nn/Power.scala)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return (self.shift + self.scale * x) ** self.power


class Sqrt(Module):
    def forward(self, x):
        return torch.sqrt(x)


class Square(Module):
    def forward(self, x):
        return torch.square(x)


class Clamp(Module):
    def __init__(self, min_value: float, max_value: float):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return x.clamp(self.min_value, self.max_value)


class Max(Module):
    """Max along ``dim`` (nn/Max.scala); values only."""

    def __init__(self, dim: int = -1, num_input_dims: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.amax(x, dim=self.dim)


class Min(Module):
    def __init__(self, dim: int = -1, num_input_dims: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.amin(x, dim=self.dim)


class Mean(Module):
    def __init__(self, dimension: int = 0, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        return x.mean(dim=self.dimension, keepdim=not self.squeeze)


class Sum(Module):
    def __init__(self, dimension: int = 0, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__()
        self.dimension, self.size_average, self.squeeze = \
            dimension, size_average, squeeze

    def forward(self, x):
        if self.size_average:
            return x.mean(dim=self.dimension, keepdim=not self.squeeze)
        return x.sum(dim=self.dimension, keepdim=not self.squeeze)


class Exp(Module):
    def forward(self, x):
        return torch.exp(x)


class Log(Module):
    def forward(self, x):
        return torch.log(x)


class Abs(Module):
    def forward(self, x):
        return torch.abs(x)


class Scale(Module):
    """x * weight + bias with learnable ``size``-shaped weight and bias
    (nn/Scale.scala)."""

    PARAM_ROLES = {"weight": "elementwise", "bias": "elementwise"}

    def __init__(self, size):
        super().__init__()
        self.size = tuple(size)

    def _init(self, generator):
        return {"weight": torch.ones(self.size, dtype=torch.float32),
                "bias": torch.zeros(self.size, dtype=torch.float32)}

    def forward(self, x):
        return x * self.weight + self.bias


class MM(Module):
    """Matrix product of a two-tensor input, batched over leading axes
    (nn/MM.scala), accumulated in float32 and cast to the first operand's
    dtype."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, inputs):
        a, b = inputs[0], inputs[1]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a.float(), b.float()).to(a.dtype)


class MV(Module):
    """Matrix-vector product of a two-tensor input (nn/MV.scala)."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, inputs):
        m, v = inputs[0], inputs[1]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class Cosine(Module):
    """Cosine similarity of each input row to each of ``output_size``
    learned anchors (nn/Cosine.scala)."""

    PARAM_ROLES = {"weight": "kernel_out"}

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size

    def _init(self, generator):
        return {"weight": uniform_f32(generator,
                                   (self.output_size, self.input_size),
                                   1.0 / math.sqrt(self.input_size))}

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return unit_rows(x).to(dt) @ unit_rows(self.weight).t().to(dt)


class Euclidean(Module):
    """Euclidean distance of each input row to each learned center
    (nn/Euclidean.scala)."""

    PARAM_ROLES = {"weight": "kernel_out"}

    def __init__(self, input_size: int, output_size: int,
                 fast_backward: bool = True):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size

    def _init(self, generator):
        return {"weight": uniform_f32(generator,
                                   (self.output_size, self.input_size),
                                   1.0 / math.sqrt(self.input_size))}

    def forward(self, x):
        diff = x[:, None, :] - self.weight[None, :, :]
        return torch.sqrt(diff.square().sum(-1) + 1e-12)


class DotProduct(Module):
    """Row-wise dot product of a two-tensor input (nn/DotProduct.scala)."""

    def forward(self, inputs):
        return (inputs[0] * inputs[1]).sum(-1)


class PairwiseDistance(Module):
    """Row-wise L_p distance of a two-tensor input
    (nn/PairwiseDistance.scala)."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, inputs):
        d = inputs[0] - inputs[1]
        return (d.abs() ** self.norm).sum(-1) ** (1.0 / self.norm)


class CosineDistance(Module):
    """Row-wise cosine similarity of a two-tensor input
    (nn/CosineDistance.scala)."""

    def forward(self, inputs):
        return (unit_rows(inputs[0]) * unit_rows(inputs[1])).sum(-1)
