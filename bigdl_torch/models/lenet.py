"""LeNet-5, the repo's quick-start model.

Counterpart of ``bigdl_tpu/models/lenet.py`` (reference
``models/lenet/LeNet5.scala:23-39``): Reshape(28, 28, 1) ->
SpatialConvolution(1, 6, 5, 5) -> Tanh -> MaxPool(2, 2, 2, 2) ->
SpatialConvolution(6, 12, 5, 5) -> Tanh -> MaxPool(2, 2, 2, 2) ->
Reshape(12 * 4 * 4) -> Linear(192, 100) -> Tanh -> Linear(100, classNum)
-> LogSoftMax, in the reference's NHWC layout: input (batch, 28, 28, 1).
It launches none of the port's kernels (cuDNN and cuBLAS do its work).
"""

from __future__ import annotations

from ..nn import (Linear, LogSoftMax, Reshape, Sequential, SpatialConvolution,
                  SpatialMaxPooling, Tanh)

__all__ = ["LeNet5", "lenet5"]


def LeNet5(class_num: int = 10):
    return (Sequential()
            .add(Reshape((28, 28, 1)))
            .add(SpatialConvolution(1, 6, 5, 5).set_name("conv1_5x5"))
            .add(Tanh())
            .add(SpatialMaxPooling(2, 2, 2, 2))
            .add(SpatialConvolution(6, 12, 5, 5).set_name("conv2_5x5"))
            .add(Tanh())
            .add(SpatialMaxPooling(2, 2, 2, 2))
            .add(Reshape((12 * 4 * 4,)))
            .add(Linear(12 * 4 * 4, 100).set_name("fc_1"))
            .add(Tanh())
            .add(Linear(100, class_num).set_name("fc_2"))
            .add(LogSoftMax()))


lenet5 = LeNet5
