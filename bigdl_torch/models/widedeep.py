"""Wide & Deep recommender.

Counterpart of ``bigdl_tpu/models/widedeep.py`` (the BigDL paper's
production workload, arXiv:1804.05839): a wide linear model over hashed
cross-product features and a deep MLP over learned embeddings, whose
logits sum into one LogSoftMax.  The children are the reference's, in its
order: the shared deep ``LookupTable``, the wide ``LookupTable`` (its
width is ``class_num``: a cross id's row is that feature's per-class logit
contribution), the MLP and the ``LogSoftMax``.

Input: one flat float32 vector per record (``dataset/recsys.py``
``TabularToSample``): one-hot ids, multi-hot tag ids (-1 = an empty
slot), wide cross ids, dense floats.  The ids are cast to int64 on the
tensor's device by the tables.  An empty slot reads row 0 and is masked
out of the bag sum by a multiply, so row 0 gets no gradient from it (no
boolean index op, which the bag would otherwise need).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..nn import Linear, LogSoftMax, LookupTable, ReLU, Sequential
from ..nn.module import Container

__all__ = ["WideDeep"]


class WideDeep(Container):
    """Wide linear (hashed cross features) + deep MLP (embedding bag) ->
    summed logits -> LogSoftMax."""

    def __init__(self, class_num: int = 2, n_onehot: int = 8,
                 multihot_slots: int = 4, n_wide: int = 7, n_dense: int = 4,
                 deep_buckets: int = 8192, wide_buckets: int = 4096,
                 embed_dim: int = 16, hidden: Sequence[int] = (64, 32)):
        # one-hot embeddings concatenate; the multi-hot slots sum into one
        # bag vector; the dense floats append as they are
        deep_in = (n_onehot + (1 if multihot_slots else 0)) * embed_dim \
            + n_dense
        mlp = Sequential()
        last = deep_in
        for h in hidden:
            mlp.add(Linear(last, h))
            mlp.add(ReLU())
            last = h
        mlp.add(Linear(last, class_num))
        super().__init__(LookupTable(deep_buckets, embed_dim),
                         LookupTable(wide_buckets, class_num),
                         mlp, LogSoftMax())
        self.class_num = class_num
        self.n_onehot = n_onehot
        self.multihot_slots = multihot_slots
        self.n_wide = n_wide
        self.n_dense = n_dense
        self.embed_dim = embed_dim

    @classmethod
    def from_spec(cls, spec, class_num: int = 2, embed_dim: int = 16,
                  hidden: Sequence[int] = (64, 32)) -> "WideDeep":
        """A model matching a ``dataset/recsys.FeatureSpec``."""
        return cls(class_num=class_num, n_onehot=spec.n_cat,
                   multihot_slots=spec.multihot_slots, n_wide=spec.n_wide,
                   n_dense=spec.n_dense, deep_buckets=spec.deep_buckets,
                   wide_buckets=spec.wide_buckets, embed_dim=embed_dim,
                   hidden=hidden)

    @property
    def input_dim(self) -> int:
        return self.n_onehot + self.multihot_slots + self.n_wide \
            + self.n_dense

    def forward(self, x):
        deep_t, wide_t, mlp, out = self.layers
        n_slots = self.n_onehot + self.multihot_slots
        ids = x[..., :n_slots]
        wide_ids = x[..., n_slots:n_slots + self.n_wide]
        dense = x[..., n_slots + self.n_wide:]

        # one gather over the shared table for every slot; empty (-1)
        # slots read row 0 and are multiplied out of the bag sum
        emb = deep_t(ids.clamp(min=0.0))
        onehot = emb[..., :self.n_onehot, :]
        parts = [onehot.reshape(onehot.shape[:-2]
                                + (self.n_onehot * self.embed_dim,))]
        if self.multihot_slots:
            tags = emb[..., self.n_onehot:, :]
            mask = (ids[..., self.n_onehot:] >= 0).to(tags.dtype)
            parts.append((tags * mask[..., None]).sum(dim=-2))
        if self.n_dense:
            parts.append(dense.to(emb.dtype))
        logits = mlp(torch.cat(parts, dim=-1))
        if self.n_wide:
            # each cross id's row is its per-class logit vector
            logits = logits + wide_t(wide_ids).sum(dim=-2)
        return out(logits)
