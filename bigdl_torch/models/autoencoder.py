"""The fully connected MNIST autoencoder.

Counterpart of ``bigdl_tpu/models/autoencoder.py`` (reference
``models/autoencoder/Autoencoder.scala:27-37``): Reshape(784) ->
Linear(784, class_num) -> ReLU -> Linear(class_num, 784) -> Sigmoid,
trained with ``MSECriterion`` against the flattened input.
"""

from __future__ import annotations

from ..nn import Linear, ReLU, Reshape, Sequential, Sigmoid

__all__ = ["Autoencoder"]

ROW_N = 28
COL_N = 28
FEATURE_SIZE = ROW_N * COL_N


def Autoencoder(class_num: int = 32):
    return (Sequential()
            .add(Reshape((FEATURE_SIZE,)))
            .add(Linear(FEATURE_SIZE, class_num))
            .add(ReLU())
            .add(Linear(class_num, FEATURE_SIZE))
            .add(Sigmoid()))
