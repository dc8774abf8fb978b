"""Shape layers: ``Reshape`` (nn/Reshape.scala).

Counterpart of ``bigdl_tpu/nn/shape.py`` for what the training slice uses.
"""

from __future__ import annotations

from .module import Module

__all__ = ["Reshape"]


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
