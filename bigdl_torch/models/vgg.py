"""VGG: the CIFAR-10 variant with BatchNorm and dropout, and VGG-16 / 19.

Counterpart of ``bigdl_tpu/models/vgg.py`` (BigDL
``models/vgg/VggForCifar10.scala:23-70``, ``Vgg_16.scala``,
``Vgg_19.scala``), layer for layer.  NHWC.
"""

from __future__ import annotations

from ..nn import (BatchNormalization, Dropout, Linear, LogSoftMax, ReLU,
                  Reshape, Sequential, SpatialBatchNormalization,
                  SpatialConvolution, SpatialMaxPooling)

__all__ = ["VggForCifar10", "Vgg_16", "Vgg_19"]


def VggForCifar10(class_num: int = 10):
    """Five conv-BN-ReLU stacks (dropout between their convolutions) each
    closed by a 2x2 max pool, then a 512-unit classifier, on 32 x 32 x 3."""
    model = Sequential()
    for block, drop in (((3, 64, 64), 0.3), ((64, 128, 128), 0.4),
                        ((128, 256, 256, 256), 0.4),
                        ((256, 512, 512, 512), 0.4),
                        ((512, 512, 512, 512), 0.4)):
        for i in range(len(block) - 1):
            model.add(SpatialConvolution(block[i], block[i + 1], 3, 3,
                                         1, 1, 1, 1))
            model.add(SpatialBatchNormalization(block[i + 1], 1e-3))
            model.add(ReLU())
            if i < len(block) - 2:
                model.add(Dropout(drop))
        model.add(SpatialMaxPooling(2, 2, 2, 2).ceil())
    return (model.add(Reshape((512,)))
            .add(Dropout(0.5))
            .add(Linear(512, 512))
            .add(BatchNormalization(512))
            .add(ReLU())
            .add(Dropout(0.5))
            .add(Linear(512, class_num))
            .add(LogSoftMax()))


def _vgg(cfg, class_num):
    """3x3 conv-ReLU stacks ("M": a 2x2 max pool), then the 4096-unit
    classifier, on 224 x 224 x 3."""
    model, n_in = Sequential(), 3
    for v in cfg:
        if v == "M":
            model.add(SpatialMaxPooling(2, 2, 2, 2))
        else:
            model.add(SpatialConvolution(n_in, v, 3, 3, 1, 1, 1, 1))
            model.add(ReLU())
            n_in = v
    return (model.add(Reshape((512 * 7 * 7,)))
            .add(Linear(512 * 7 * 7, 4096)).add(ReLU()).add(Dropout(0.5))
            .add(Linear(4096, 4096)).add(ReLU()).add(Dropout(0.5))
            .add(Linear(4096, class_num)).add(LogSoftMax()))


def Vgg_16(class_num: int = 1000):
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"], class_num)


def Vgg_19(class_num: int = 1000):
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
                class_num)
