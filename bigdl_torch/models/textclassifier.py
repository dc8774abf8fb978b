"""The text-classification CNN (the reference's GloVe + CNN example).

Counterpart of ``bigdl_tpu/models/textclassifier.py`` (BigDL
``example/utils/TextClassifier.scala:171-197`` ``buildModel``): three
stages of a width-5 convolution of 128 filters and ReLU over the sequence,
the first two max-pooled 5/5 and the last over the whole remaining
sequence, then Linear(128, 100), Linear(100, classes) and LogSoftMax.  The
input is (batch, seq_len, embed_dim) pre-embedded vectors, or with
``vocab_size`` (batch, seq_len) token ids through a trained
``LookupTable`` front.
"""

from __future__ import annotations

from ..nn import (Linear, LogSoftMax, LookupTable, Max, ReLU, Reshape,
                  Sequential, TemporalConvolution)
from ..nn.module import Module

__all__ = ["TextClassifier", "TemporalMaxPooling"]


class TemporalMaxPooling(Module):
    """Max pool over the time axis of (batch, time, features), windows of
    ``k_w`` every ``d_w`` (default ``k_w``) steps, the last partial one
    dropped (Torch's nn.TemporalMaxPooling)."""

    def __init__(self, k_w: int, d_w: int = None):
        super().__init__()
        self.k_w = k_w
        self.d_w = d_w or k_w

    def forward(self, x):
        # (batch, n_out, features, k_w) windows of a view, no copy
        return x.unfold(1, self.k_w, self.d_w).amax(dim=-1)


def TextClassifier(class_num: int, embed_dim: int = 200,
                   seq_len: int = 500, vocab_size: int = None):
    """``vocab_size=None`` keeps the reference's pipeline, (batch,
    seq_len, embed_dim) vectors in; with it, a ``LookupTable`` front takes
    (batch, seq_len) token ids.  ``seq_len`` is advisory: the stack needs
    at least 149 steps."""
    model = Sequential()
    if vocab_size is not None:
        model.add(LookupTable(vocab_size, embed_dim))
    model.add(TemporalConvolution(embed_dim, 128, 5))
    model.add(ReLU())
    model.add(TemporalMaxPooling(5, 5))
    model.add(TemporalConvolution(128, 128, 5))
    model.add(ReLU())
    model.add(TemporalMaxPooling(5, 5))
    model.add(TemporalConvolution(128, 128, 5))
    model.add(ReLU())
    # the last stage pools the whole remaining sequence (35 steps at 500)
    model.add(Max(dim=1))
    model.add(Reshape((128,)))
    model.add(Linear(128, 100))
    model.add(Linear(100, class_num))
    model.add(LogSoftMax())
    return model
