"""Sample and MiniBatch: the data-record types, and the padding
parameters.

Counterpart of ``bigdl_tpu/dataset/sample.py`` (reference
``dataset/Sample.scala:31``, ``dataset/MiniBatch.scala:39``, padding
``:522``, ``:560``).  Records are plain numpy on the host; a Sample or a
MiniBatch may carry several feature or label arrays as a list.  The
Optimizer moves a batch to the device.  The classes are plain data with the
reference's fields, so pickles of the reference's records read as these
(``utils/recordio.py`` ``loads``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["Sample", "MiniBatch", "PaddingParam", "FixedLength"]


def _shape(x):
    if isinstance(x, (list, tuple)):
        return [_shape(e) for e in x]
    return x.shape


def _first(x):
    return x[0] if isinstance(x, (list, tuple)) else x


class Sample:
    """One record: feature(s) and label(s)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label

    def feature_size(self):
        return _shape(self.feature)

    def label_size(self):
        return None if self.label is None else _shape(self.label)

    @staticmethod
    def from_ndarray(features, labels=None) -> "Sample":
        def conv(x):
            if x is None:
                return None
            if isinstance(x, (list, tuple)):
                return [np.asarray(e) for e in x]
            return np.asarray(x)
        return Sample(conv(features), conv(labels))

    def __repr__(self):
        return (f"Sample(feature={self.feature_size()}, "
                f"label={self.label_size()})")


class MiniBatch:
    """A batch of stacked samples; ``input`` and ``target`` are arrays or
    lists of them.  ``valid`` is the number of real rows, less than
    ``size()`` for a last batch padded to full size
    (``SampleToMiniBatch(pad_last=True)``): evaluation scores only
    those."""

    __slots__ = ("input", "target", "valid")

    def __init__(self, input, target=None, valid: Optional[int] = None):
        self.input = input
        self.target = target
        self.valid = valid if valid is not None else _first(input).shape[0]

    def size(self) -> int:
        return _first(self.input).shape[0]

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """Rows [offset, offset + length), 0-based (MiniBatch.scala:154)."""
        def sl(x):
            if isinstance(x, (list, tuple)):
                return [sl(e) for e in x]
            return x[offset:offset + length]
        return MiniBatch(sl(self.input),
                         None if self.target is None else sl(self.target))

    def __repr__(self):
        target = None if self.target is None else _shape(self.target)
        return f"MiniBatch(input={_shape(self.input)}, target={target})"


class PaddingParam:
    """Variable-length padding (MiniBatch.scala:522): ``padding_value``
    fills; the padded length is the batch's longest."""

    def __init__(self, padding_value: float = 0.0, padding_strategy=None):
        self.padding_value = padding_value
        self.padding_strategy = padding_strategy


class FixedLength(PaddingParam):
    """Pad (or cut) every sequence to ``length`` (MiniBatch.scala:560)."""

    def __init__(self, length: int, padding_value: float = 0.0):
        super().__init__(padding_value)
        self.length = length
