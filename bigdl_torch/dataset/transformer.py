"""Record transformers: composable iterator-to-iterator data transforms.

Counterpart of ``bigdl_tpu/dataset/transformer.py`` (reference
``dataset/Transformer.scala:44``): ``Transformer`` composed with ``>>``
(the reference's ``->``, ``:49``) into a ``ChainedTransformer`` (``:86``),
``Identity``, and ``SampleToMiniBatch`` (``:309``, ``:354``) with its
padding parameters, multi-tensor Samples and a multi-threaded variant,
``MTSampleToMiniBatch``.  Equal-shape rows are stacked by the native
gather kernel (``utils/native.py`` ``gather_rows``).
"""

from __future__ import annotations

import copy
import os
from typing import Iterator

import numpy as np

from ..utils.native import gather_rows
from .sample import FixedLength, MiniBatch, PaddingParam

__all__ = ["Transformer", "ChainedTransformer", "Batcher",
           "SampleToMiniBatch", "MTSampleToMiniBatch", "Identity"]


class Transformer:
    """Iterator -> Iterator transform (Transformer.scala:44)."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        """``a >> b`` is the reference's ``a -> b`` (Transformer.scala:49)."""
        return ChainedTransformer(self, other)

    def clone_transformer(self):
        """A deep copy, random generators included (Transformer.scala:56)."""
        return copy.deepcopy(self)


class ChainedTransformer(Transformer):
    """(Transformer.scala:86)."""

    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, it):
        return self.second(self.first(it))


class Identity(Transformer):
    def __call__(self, it):
        return it


def _stack_features(values, padding: PaddingParam = None):
    """Stack per-sample arrays (lists of them position by position):
    equal shapes through ``gather_rows``; otherwise, or under
    ``FixedLength``, each sample's dim 0 padded with the padding value to
    the longest (or the fixed length, cutting longer ones)."""
    if isinstance(values[0], (list, tuple)):
        return [_stack_features([v[i] for v in values], padding)
                for i in range(len(values[0]))]
    shapes = [v.shape for v in values]
    if shapes[0] == () and all(s == () for s in shapes):
        # scalars (class labels) stack to (n,); the reference's gather
        # makes each a (1,) row, (n, 1)
        return np.stack(values)
    if all(s == shapes[0] for s in shapes) and \
            not isinstance(padding, FixedLength):
        return gather_rows(values)
    if isinstance(padding, FixedLength):
        max_len = padding.length
    else:
        max_len = max(s[0] for s in shapes)
    pad_val = padding.padding_value if padding else 0.0
    out = np.full((len(values), max_len) + shapes[0][1:], pad_val,
                  dtype=values[0].dtype)
    for i, v in enumerate(values):
        n = min(v.shape[0], max_len)
        out[i, :n] = v[:n]
    return out


class Batcher(Transformer):
    """A transformer that groups its input into MiniBatches of
    ``batch_size``, with ``drop_last`` and ``pad_last``.  The Optimizer's
    accumulation check finds every batcher of a chain by this class."""

    batch_size: int
    drop_last: bool = False
    pad_last: bool = False


class SampleToMiniBatch(Batcher):
    """Group Samples into MiniBatches of ``batch_size``.  ``drop_last``
    drops a final partial batch; ``pad_last`` pads it to full size with
    copies of its last sample and records the real row count in
    ``MiniBatch.valid`` (for evaluation).  ``feature_padding`` and
    ``label_padding`` (``PaddingParam``, ``FixedLength``) pad
    variable-length samples on dim 0."""

    def __init__(self, batch_size: int, feature_padding: PaddingParam = None,
                 label_padding: PaddingParam = None, drop_last: bool = False,
                 pad_last: bool = False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.drop_last = drop_last
        self.pad_last = pad_last

    def __call__(self, it: Iterator) -> Iterator[MiniBatch]:
        buf = []
        for sample in it:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            if self.pad_last:
                valid = len(buf)
                buf += [buf[-1]] * (self.batch_size - valid)
                b = self._collate(buf)
                b.valid = valid
                yield b
            else:
                yield self._collate(buf)

    def _collate(self, samples) -> MiniBatch:
        return self._batch(samples, self.feature_padding, self.label_padding)

    @staticmethod
    def _batch(samples, feature_padding: PaddingParam = None,
               label_padding: PaddingParam = None) -> MiniBatch:
        feats = _stack_features([s.feature for s in samples],
                                feature_padding)
        if samples[0].label is None:
            return MiniBatch(feats)
        return MiniBatch(feats, _stack_features([s.label for s in samples],
                                                label_padding))


class MTSampleToMiniBatch(SampleToMiniBatch):
    """Multi-threaded batcher: each batch's samples go through a clone of
    the upstream ``transformer`` and are stacked in a worker pool that
    keeps at least ``prefetch`` batches in flight (reference
    ``MTLabeledBGRImgToBatch.scala``).  The transformer must map one
    sample to one (a count change raises).

    As in the reference, every batch gets a fresh clone of ``transformer``
    taken from the same, never advanced, original: a random transformer
    replays the same draws for every batch (``ROADMAP.md`` queue C)."""

    def __init__(self, batch_size: int, transformer: Transformer = None,
                 feature_padding: PaddingParam = None,
                 label_padding: PaddingParam = None, drop_last: bool = False,
                 pad_last: bool = False, num_threads: int = None,
                 prefetch: int = 4):
        super().__init__(batch_size, feature_padding, label_padding,
                         drop_last, pad_last)
        self.transformer = transformer
        self.num_threads = num_threads or min(8, os.cpu_count() or 1)
        self.prefetch = prefetch

    def __call__(self, it: Iterator) -> Iterator[MiniBatch]:
        from ..utils.thread_pool import ThreadPool

        def chunks():
            buf = []
            for s in it:
                buf.append(s)
                if len(buf) == self.batch_size:
                    yield buf
                    buf = []
            if buf and not self.drop_last:
                yield buf

        def assemble(buf):
            if self.transformer is not None:
                out = list(self.transformer.clone_transformer()(iter(buf)))
                if len(out) != len(buf):
                    raise ValueError(
                        "MTSampleToMiniBatch requires a 1:1 transformer "
                        f"(chunk of {len(buf)} became {len(out)}); apply "
                        "filtering transformers upstream of the batcher")
                buf = out
            valid = len(buf)
            if self.pad_last:
                buf += [buf[-1]] * (self.batch_size - valid)
            b = self._collate(buf)
            if valid != len(buf):
                b.valid = valid
            return b

        pool = ThreadPool(self.num_threads)
        window = max(self.prefetch, self.num_threads)
        pending = []
        try:
            for buf in chunks():
                pending.extend(pool.invoke([lambda b=buf: assemble(b)]))
                if len(pending) >= window:
                    yield pending.pop(0).result()
            for f in pending:
                yield f.result()
        finally:
            for f in pending:
                f.cancel()
            pool.shutdown()
