"""DataSet: in-memory data sources feeding the Optimizer.

Counterpart of ``bigdl_tpu/dataset/__init__.py`` for what the training
slice uses (reference ``dataset/DataSet.scala``): ``DataSet.array`` over a
record list, transformed into MiniBatches by ``SampleToMiniBatch``.  The
shuffle is a permutation drawn from ``np.random.default_rng(seed)`` exactly
as the reference draws it, so both packages visit records in the same
order from the same seed.  The distributed (per-process sharded) datasets,
the record and prefetch pipelines and the text/recsys/image sources are not
ported yet.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from .sample import MiniBatch, Sample
from .transformer import ChainedTransformer, SampleToMiniBatch, Transformer

__all__ = ["AbstractDataSet", "LocalArrayDataSet", "TransformedDataSet",
           "DataSet", "Sample", "MiniBatch", "Transformer",
           "ChainedTransformer", "SampleToMiniBatch"]


class AbstractDataSet:
    """(reference: dataset/DataSet.scala:46)."""

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def data(self, train: bool) -> Iterator:
        """One pass over the (transformed) records; the Optimizer calls it
        once per epoch."""
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)


class LocalArrayDataSet(AbstractDataSet):
    """In-memory record list (reference: dataset/DataSet.scala:128)."""

    def __init__(self, records: Sequence, seed: int = 1):
        self.records = list(records)
        self._perm = np.arange(len(self.records))
        self._rng = np.random.default_rng(seed)

    def size(self) -> int:
        return len(self.records)

    def shuffle(self) -> None:
        self._rng.shuffle(self._perm)

    def data(self, train: bool) -> Iterator:
        order = self._perm if train else np.arange(len(self.records))
        for i in order:
            yield self.records[i]


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(
            self.base, ChainedTransformer(self.transformer, transformer))


class DataSet:
    """Builder namespace (reference: object DataSet,
    dataset/DataSet.scala:319)."""

    @staticmethod
    def array(records, distributed: bool = False, seed: int = 1):
        if distributed:
            raise NotImplementedError("distributed datasets come with the "
                                      "data-parallel slice")
        return LocalArrayDataSet(records, seed=seed)
