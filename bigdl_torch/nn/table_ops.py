"""Multi-input (Table) layers: ``CAddTable`` (nn/CAddTable.scala).

Counterpart of ``bigdl_tpu/nn/table_ops.py``.  Inputs are Python lists,
the reference's ``Table`` Activity.
"""

from __future__ import annotations

import functools

import torch

from .module import Module

__all__ = ["CAddTable"]


class CAddTable(Module):
    """Elementwise sum of the inputs.  Types promote as in JAX: a bfloat16
    branch added to a float32 residual gives float32."""

    def forward(self, inputs):
        return functools.reduce(torch.add, inputs)
