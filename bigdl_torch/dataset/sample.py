"""Sample and MiniBatch: the data-record types.

Counterpart of ``bigdl_tpu/dataset/sample.py`` (reference
``dataset/Sample.scala:31``, ``dataset/MiniBatch.scala:39``).  Records are
plain numpy on the host, one feature and one label array each; the
Optimizer moves a batch to the device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Sample", "MiniBatch"]


class Sample:
    """One record: feature(s) and label(s)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label

    @staticmethod
    def from_ndarray(features, labels=None) -> "Sample":
        return Sample(np.asarray(features),
                      None if labels is None else np.asarray(labels))

    def __repr__(self):
        label = None if self.label is None else self.label.shape
        return f"Sample(feature={self.feature.shape}, label={label})"


class MiniBatch:
    """A batch of stacked samples."""

    __slots__ = ("input", "target")

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        return self.input.shape[0]

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target
