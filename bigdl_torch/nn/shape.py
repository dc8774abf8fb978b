"""Shape layers.

Counterpart of ``bigdl_tpu/nn/shape.py`` (BigDL ``nn/Reshape.scala`` ...
``nn/Contiguous.scala``).  Axis arguments are 0-based over the whole
tensor, batch included, as in the reference.  ``MaskedSelect`` returns
``t[mask]``, the reference's eager (outside ``jit``) result; the port runs
eagerly, so the reference's fixed-size traced form has no counterpart.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .module import Module

__all__ = ["Reshape", "InferReshape", "View", "Transpose", "Replicate",
           "Squeeze", "Unsqueeze", "Select", "Narrow", "Index",
           "MaskedSelect", "Reverse", "Padding", "SpatialZeroPadding",
           "Contiguous"]


class Reshape(Module):
    """Reshape the non-batch dims to ``size``; with ``batch_mode=False`` the
    whole tensor takes ``size``."""

    def __init__(self, size, batch_mode: bool = True):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class InferReshape(Module):
    """Reshape with -1 (inferred) and 0 (keep the input's dim) entries
    (nn/InferReshape.scala)."""

    def __init__(self, size, batch_mode: bool = False):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + out)
        return x.reshape(out)


class View(Module):
    """Reshape keeping the element count; sizes may hold -1 (nn/View.scala).
    The batch axis is kept when the sizes hold -1 or fewer elements than
    the input, as the reference decides."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n):
        self.num_input_dims = n
        return self

    def forward(self, x):
        n_view = math.prod(s for s in self.sizes if s > 0)
        if -1 in self.sizes or x.numel() != n_view:
            return x.reshape((x.shape[0],) + self.sizes)
        return x.reshape(self.sizes)


class Transpose(Module):
    """Swap the listed axis pairs in order (nn/Transpose.scala)."""

    def __init__(self, permutations):
        super().__init__()
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, x):
        perm = list(range(x.dim()))
        for a, b in self.permutations:
            perm[a], perm[b] = perm[b], perm[a]
        return x.permute(perm)


class Replicate(Module):
    """A new axis of ``n_features`` copies at ``dim``
    (nn/Replicate.scala)."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = None):
        super().__init__()
        self.n_features, self.dim = n_features, dim

    def forward(self, x):
        y = x.unsqueeze(self.dim)
        reps = [1] * y.dim()
        reps[self.dim] = self.n_features
        return y.repeat(reps)


class Squeeze(Module):
    """Drop size-1 dims (nn/Squeeze.scala); ``dim=None`` drops all."""

    def __init__(self, dim: int = None, num_input_dims: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        if self.dim is None:
            return x.squeeze()
        if x.shape[self.dim] != 1:
            raise ValueError(f"Squeeze: axis {self.dim} of {tuple(x.shape)}"
                             " is not of size 1")
        return x.squeeze(self.dim)


class Unsqueeze(Module):
    def __init__(self, pos: int, num_input_dims: int = None):
        super().__init__()
        self.pos = pos

    def forward(self, x):
        return x.unsqueeze(self.pos)


class Select(Module):
    """Index ``index`` of axis ``dim``, the axis dropped (nn/Select.scala);
    a negative index counts from the end."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def forward(self, x):
        return x.select(self.dim, self.index)


class Narrow(Module):
    """[offset, offset + length) along ``dim`` (nn/Narrow.scala); a negative
    length ends |length| - 1 before the end."""

    def __init__(self, dim: int, offset: int, length: int = 1):
        super().__init__()
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x):
        length = self.length
        if length < 0:
            length = x.shape[self.dim] - self.offset + length + 1
        return x.narrow(self.dim, self.offset, length)


class Index(Module):
    """The rows of a tensor that an index tensor names, along ``dim``
    (nn/Index.scala); input [tensor, indices]."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, inputs):
        t, idx = inputs[0], inputs[1]
        idx = torch.as_tensor(idx, device=t.device).long()
        dim = self.dim % t.dim()
        out = t.index_select(dim, idx.reshape(-1))
        return out.reshape(t.shape[:dim] + idx.shape + t.shape[dim + 1:])


class MaskedSelect(Module):
    """The elements of a tensor where the mask is nonzero, as one flat
    tensor (nn/MaskedSelect.scala); input [tensor, mask]."""

    def forward(self, inputs):
        t, mask = inputs[0], inputs[1]
        return t[torch.as_tensor(mask, device=t.device).bool()]


class Reverse(Module):
    """Reverse along ``dimension`` (nn/Reverse.scala)."""

    def __init__(self, dimension: int = 0):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return torch.flip(x, (self.dimension,))


class Padding(Module):
    """``pad`` entries of ``value`` after (before, when negative) axis
    ``dim`` (nn/Padding.scala)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int = 0,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim, self.pad, self.value = dim, pad, value

    def forward(self, x):
        shape = list(x.shape)
        shape[self.dim] = abs(self.pad)
        fill = torch.full(shape, self.value, dtype=x.dtype, device=x.device)
        parts = [fill, x] if self.pad < 0 else [x, fill]
        return torch.cat(parts, dim=self.dim)


class SpatialZeroPadding(Module):
    """Zero-pad H and W of an NHWC tensor (nn/SpatialZeroPadding.scala)."""

    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None):
        super().__init__()
        self.l = pad_left
        self.r = pad_right if pad_right is not None else pad_left
        self.t = pad_top if pad_top is not None else pad_left
        self.b = pad_bottom if pad_bottom is not None else pad_left

    def forward(self, x):
        # F.pad lists the last axis first: C, then W, then H
        return F.pad(x, (0, 0, self.l, self.r, self.t, self.b))


class Contiguous(Module):
    """(nn/Contiguous.scala) a contiguous copy where the input is not."""

    def forward(self, x):
        return x.contiguous()
