"""Tree-structured LSTMs: ``TreeLSTM`` and ``BinaryTreeLSTM``.

Counterpart of ``bigdl_tpu/nn/tree.py`` (BigDL ``nn/TreeLSTM.scala``,
``nn/BinaryTreeLSTM.scala``; Tai et al. 2015).  Trees come encoded as
the reference's arrays, nodes children-before-parent:

    children: (batch, n_nodes, 2) int, the left and right child's node
              index, -1 for a leaf (and for a padding row);
    leaf_ids: (batch, n_nodes) int, a leaf's index into the input
              sequence, -1 for an internal node (and for a padding row).

The input is ``(inputs (batch, seq, in), children, leaf_ids)``, the output
every node's hidden state (batch, n_nodes, hidden), a padding row's zero,
in the input's dtype.  The reference scans over node slots one example at
a time (``vmap``); here the loop over node index runs the whole batch at
once, each step gathering every example's children by index from float32
(h, c) buffers.  As in the reference every node computes both the leaf and
the composer path and keeps the one its row selects.
"""

from __future__ import annotations

import math

import torch

from ..common import get_policy
from .module import Module

__all__ = ["TreeLSTM", "BinaryTreeLSTM"]


def _uniform(generator, shape, stdv):
    return torch.empty(shape, dtype=get_policy().param_dtype).uniform_(
        -stdv, stdv, generator=generator)


class TreeLSTM(Module):
    """The base holding the sizes (nn/TreeLSTM.scala)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size


class BinaryTreeLSTM(TreeLSTM):
    """Binary constituency TreeLSTM (nn/BinaryTreeLSTM.scala).

    Leaf: c = x W_c + b_c, h = o · tanh(c) with o = sigmoid(x W_o + b_o)
    (h = tanh(c) without ``gate_output``).  Internal node: the gates i,
    f_l, f_r, o, g from [h_l, h_r] W + b; c = i·tanh(g) + f_l·c_l + f_r·c_r,
    h = o · tanh(c)."""

    PARAM_ROLES = {"leaf_c": "kernel_in", "leaf_o": "kernel_in",
                   "comp_w": "kernel_in", "leaf_cb": "bias",
                   "leaf_ob": "bias", "comp_b": "bias"}

    def __init__(self, input_size: int, hidden_size: int,
                 gate_output: bool = True):
        super().__init__(input_size, hidden_size)
        self.gate_output = gate_output

    def _init(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        h = self.hidden_size
        return {
            "leaf_c": _uniform(generator, (self.input_size, h), stdv),
            "leaf_cb": _uniform(generator, (h,), stdv),
            "leaf_o": _uniform(generator, (self.input_size, h), stdv),
            "leaf_ob": _uniform(generator, (h,), stdv),
            # composer: [h_l, h_r] -> the gates i, f_l, f_r, o, g
            "comp_w": _uniform(generator, (2 * h, 5 * h), stdv),
            "comp_b": _uniform(generator, (5 * h,), stdv),
        }

    def _leaf(self, x):
        cd = get_policy().compute_dtype
        xc = x.to(cd)
        c = xc @ self.leaf_c.to(cd) + self.leaf_cb
        if self.gate_output:
            h = torch.sigmoid(xc @ self.leaf_o.to(cd) + self.leaf_ob) * \
                torch.tanh(c)
        else:
            h = torch.tanh(c)
        return h, c

    def _compose(self, h_l, c_l, h_r, c_r):
        cd = get_policy().compute_dtype
        z = torch.cat([h_l, h_r], dim=-1).to(cd)
        gates = z @ self.comp_w.to(cd) + self.comp_b
        i, f_l, f_r, o, g = gates.chunk(5, dim=-1)
        c = (torch.sigmoid(i) * torch.tanh(g) + torch.sigmoid(f_l) * c_l
             + torch.sigmoid(f_r) * c_r)
        h = (torch.sigmoid(o) if self.gate_output else 1.0) * torch.tanh(c)
        return h, c

    def forward(self, inp):
        inputs, children, leaf_ids = inp
        children = torch.as_tensor(children, device=inputs.device).long()
        leaf_ids = torch.as_tensor(leaf_ids, device=inputs.device).long()
        b, n_nodes = children.shape[0], children.shape[1]
        rows = torch.arange(b, device=inputs.device)
        zero = torch.zeros((), dtype=torch.float32, device=inputs.device)
        h_buf = torch.zeros((b, n_nodes, self.hidden_size),
                            dtype=torch.float32, device=inputs.device)
        c_buf = torch.zeros_like(h_buf)
        for k in range(n_nodes):
            left, right = children[:, k, 0], children[:, k, 1]
            leaf = leaf_ids[:, k]
            h_leaf, c_leaf = self._leaf(inputs[rows, leaf.clamp(min=0)])
            lc, rc = left.clamp(min=0), right.clamp(min=0)
            h_int, c_int = self._compose(h_buf[rows, lc], c_buf[rows, lc],
                                         h_buf[rows, rc], c_buf[rows, rc])
            is_leaf = (left < 0)[:, None]
            valid = ((leaf >= 0) | (left >= 0))[:, None]
            h = torch.where(valid, torch.where(is_leaf, h_leaf, h_int), zero)
            c = torch.where(valid, torch.where(is_leaf, c_leaf, c_int), zero)
            h_buf = h_buf.index_copy(1, rows.new_tensor([k]),
                                     h.float()[:, None])
            c_buf = c_buf.index_copy(1, rows.new_tensor([k]),
                                     c.float()[:, None])
        return h_buf.to(inputs.dtype)
