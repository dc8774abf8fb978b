"""Embedding layers: ``LookupTable`` (nn/LookupTable.scala).

Counterpart of ``bigdl_tpu/nn/embedding.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import get_policy
from .module import Module

__all__ = ["LookupTable"]


class LookupTable(Module):
    """Embedding lookup: indices -> rows of a (n_index, n_output) weight.
    Indices are 0-based (``one_based=True`` for reference data).  The
    output is in the parameter dtype, not the compute dtype.
    ``should_scale_grad_by_freq`` is accepted and ignored, as in the
    reference."""

    PARAM_ROLES = {"weight": "embedding_row"}

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = None, max_norm: float = None,
                 norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 one_based: bool = False, w_regularizer=None):
        super().__init__()
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.one_based = one_based
        # a gradient term the Optimizer adds (optim/regularizer.py)
        self.w_regularizer = w_regularizer

    def _init(self, generator):
        w = torch.randn((self.n_index, self.n_output), generator=generator,
                        dtype=get_policy().param_dtype)
        if self.padding_value is not None:
            pad_idx = int(self.padding_value) - (1 if self.one_based else 0)
            if 0 <= pad_idx < self.n_index:
                w[pad_idx] = 0.0
        return {"weight": w}

    def forward(self, idx):
        w = self.weight
        if self.max_norm is not None:
            # functional renorm, as the reference: the table is not mutated
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = torch.where(norms > self.max_norm,
                            w * (self.max_norm / norms), w)
        i = idx.long()
        if self.one_based:
            i = i - 1
        return F.embedding(i, w)
