"""AlexNet, the Caffe variant with grouped convolutions.

Counterpart of ``bigdl_tpu/models/alexnet.py`` (BigDL
``example/loadmodel/AlexNet.scala``): conv 11/4, LRN, pool; grouped conv
5, LRN, pool; three 3x3 convs (two grouped); pool; fc 4096, 4096 and the
classes with dropout; LogSoftMax.  Input 227 x 227 x 3 (Caffe's crop),
NHWC.
"""

from __future__ import annotations

from ..nn import (Dropout, Linear, LogSoftMax, ReLU, Reshape, Sequential,
                  SpatialConvolution, SpatialCrossMapLRN, SpatialMaxPooling,
                  Xavier, Zeros)

__all__ = ["AlexNet"]


def _conv(n_in, n_out, k, stride=1, pad=0, group=1, name=""):
    c = SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad,
                           n_group=group)
    c.set_init_method(Xavier(), Zeros())
    return c.set_name(name)


def AlexNet(class_num: int = 1000):
    return (Sequential()
            .add(_conv(3, 96, 11, 4, 0, name="conv1"))
            .add(ReLU())
            .add(SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(SpatialMaxPooling(3, 3, 2, 2))
            .add(_conv(96, 256, 5, 1, 2, group=2, name="conv2"))
            .add(ReLU())
            .add(SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(SpatialMaxPooling(3, 3, 2, 2))
            .add(_conv(256, 384, 3, 1, 1, name="conv3"))
            .add(ReLU())
            .add(_conv(384, 384, 3, 1, 1, group=2, name="conv4"))
            .add(ReLU())
            .add(_conv(384, 256, 3, 1, 1, group=2, name="conv5"))
            .add(ReLU())
            .add(SpatialMaxPooling(3, 3, 2, 2))
            .add(Reshape((6 * 6 * 256,)))
            .add(Linear(6 * 6 * 256, 4096).set_name("fc6"))
            .add(ReLU())
            .add(Dropout(0.5))
            .add(Linear(4096, 4096).set_name("fc7"))
            .add(ReLU())
            .add(Dropout(0.5))
            .add(Linear(4096, class_num).set_name("fc8"))
            .add(LogSoftMax()))
