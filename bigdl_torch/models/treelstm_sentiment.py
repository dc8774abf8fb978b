"""The TreeLSTM sentiment model and its tree encoding.

Counterpart of ``bigdl_tpu/models/treelstm_sentiment.py`` (BigDL
``example/treeLSTMSentiment``): an embedding, a ``BinaryTreeLSTM`` over
constituency trees and a per-node classifier.  ``encode_tree`` (numpy, a
copy of the reference's) turns a nested ``(left, right)`` tuple tree of
token indices into the (children, leaf_ids) arrays the tree LSTM loops
over, padded to ``n_nodes`` with the root in the last slot.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import nn
from ..nn.module import Container

__all__ = ["TreeLSTMSentiment", "encode_tree"]


def encode_tree(tree, n_nodes: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """A nested tuple tree of leaf ids -> (children, leaf_ids, root_slot).

    ``tree`` is an int (a leaf: an index into the token sequence) or a
    pair (left, right).  Nodes are laid out children-before-parent and
    padded to ``n_nodes`` with -1 rows inserted before the root, which
    always takes the last slot (``root_slot == n_nodes - 1``), the slot
    ``TreeNNAccuracy`` reads."""
    children: List[List[int]] = []
    leaf_ids: List[int] = []

    def walk(t) -> int:
        if isinstance(t, (int, np.integer)):
            children.append([-1, -1])
            leaf_ids.append(int(t))
            return len(children) - 1
        left, right = t
        li = walk(left)
        ri = walk(right)
        children.append([li, ri])
        leaf_ids.append(-1)
        return len(children) - 1

    walk(tree)
    if len(children) > n_nodes:
        raise ValueError(f"tree has {len(children)} nodes > {n_nodes}")
    root_row, root_leaf = children.pop(), leaf_ids.pop()
    while len(children) < n_nodes - 1:
        children.append([-1, -1])
        leaf_ids.append(-1)
    children.append(root_row)
    leaf_ids.append(root_leaf)
    return (np.asarray(children, np.int32), np.asarray(leaf_ids, np.int32),
            n_nodes - 1)


class TreeLSTMSentiment(Container):
    """LookupTable -> BinaryTreeLSTM -> Linear -> log-softmax per node.

    Input (tokens (b, seq) int, children (b, n, 2), leaf_ids (b, n));
    output (b, n_nodes, classes) log-probabilities, the root in the last
    slot.  The param tree is the reference's dict ``{"embedding",
    "tree", "head"}``."""

    TREE_KEYS = ("embedding", "tree", "head")

    def __init__(self, vocab_size: int, embed_dim: int, hidden_size: int,
                 class_num: int = 5):
        super().__init__(nn.LookupTable(vocab_size, embed_dim),
                         nn.BinaryTreeLSTM(embed_dim, hidden_size),
                         nn.Linear(hidden_size, class_num))

    def forward(self, inp):
        tokens, children, leaf_ids = inp
        embedding, tree_lstm, head = self.layers
        hiddens = tree_lstm((embedding(tokens), children, leaf_ids))
        return torch.log_softmax(head(hiddens), dim=-1)
