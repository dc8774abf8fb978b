"""Record transformers: ``SampleToMiniBatch``.

Counterpart of ``bigdl_tpu/dataset/transformer.py`` for what the training
slice uses (reference ``dataset/Transformer.scala``): an iterator-to-
iterator transform.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .sample import MiniBatch

__all__ = ["Transformer", "ChainedTransformer", "SampleToMiniBatch"]


class Transformer:
    """Iterator -> Iterator transform (Transformer.scala:44)."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, it):
        return self.second(self.first(it))


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of ``batch_size`` (Transformer.scala:
    309); ``drop_last`` drops a final partial batch, ``pad_last`` pads it
    to full size with copies of its last sample and records the real row
    count in ``MiniBatch.valid`` (for evaluation).  Features and labels
    are single arrays of one shape: the reference's multi-tensor records
    and padding parameters are not ported."""

    def __init__(self, batch_size: int, drop_last: bool = False,
                 pad_last: bool = False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.pad_last = pad_last

    def __call__(self, it: Iterator) -> Iterator[MiniBatch]:
        buf = []
        for sample in it:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self._batch(buf)
                buf = []
        if buf and not self.drop_last:
            if self.pad_last:
                valid = len(buf)
                buf += [buf[-1]] * (self.batch_size - valid)
                b = self._batch(buf)
                b.valid = valid
                yield b
            else:
                yield self._batch(buf)

    @staticmethod
    def _batch(samples) -> MiniBatch:
        feats = np.stack([s.feature for s in samples])
        if samples[0].label is None:
            return MiniBatch(feats)
        return MiniBatch(feats, np.stack([s.label for s in samples]))
