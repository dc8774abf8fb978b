"""ResNet: ImageNet (18/34/50/101/152/200) and CIFAR-10 (6n+2).

Counterpart of ``bigdl_tpu/models/resnet.py`` (reference:
``models/resnet/ResNet.scala:131-260``): basic and bottleneck residual
units built as ConcatTable(branch, shortcut) -> CAddTable -> ReLU, MSRA
init for the convolutions with zero biases, a BatchNorm after every
convolution, NHWC input.  Shortcut types B (1x1 conv + BN where the shape
changes) and C (always) are ported; type A (zero-pad identity) needs
``Concat`` and ``MulConstant`` and raises ``NotImplementedError`` until
those are ported.
"""

from __future__ import annotations

from ..nn import (CAddTable, ConcatTable, Identity, Linear, LogSoftMax,
                  MsraFiller, ReLU, Reshape, Sequential,
                  SpatialAveragePooling, SpatialBatchNormalization,
                  SpatialConvolution, SpatialMaxPooling, Zeros)

__all__ = ["ResNet", "ShortcutType"]


class ShortcutType:
    A = "A"  # zero-pad identity (CIFAR paper style)
    B = "B"  # 1x1 conv when shape changes (ImageNet default)
    C = "C"  # conv always


def _conv(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0):
    c = SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph)
    c.set_init_method(MsraFiller(), Zeros())
    return c


def _shortcut(n_in, n_out, stride, shortcut_type):
    use_conv = shortcut_type == ShortcutType.C or (
        shortcut_type == ShortcutType.B and n_in != n_out)
    if use_conv:
        return (Sequential()
                .add(_conv(n_in, n_out, 1, 1, stride, stride))
                .add(SpatialBatchNormalization(n_out)))
    if n_in != n_out:
        raise NotImplementedError(
            "shortcut type A (zero-pad identity) needs Concat and "
            "MulConstant, which are not ported yet; use shortcut_type='B'")
    return Identity()


def _residual(branch, shortcut):
    return (Sequential()
            .add(ConcatTable().add(branch).add(shortcut))
            .add(CAddTable())
            .add(ReLU()))


def _basic_block(n_in, n, stride, shortcut_type):
    branch = (Sequential()
              .add(_conv(n_in, n, 3, 3, stride, stride, 1, 1))
              .add(SpatialBatchNormalization(n))
              .add(ReLU())
              .add(_conv(n, n, 3, 3, 1, 1, 1, 1))
              .add(SpatialBatchNormalization(n)))
    return _residual(branch, _shortcut(n_in, n, stride, shortcut_type)), n


def _bottleneck(n_in, n, stride, shortcut_type):
    branch = (Sequential()
              .add(_conv(n_in, n, 1, 1))
              .add(SpatialBatchNormalization(n))
              .add(ReLU())
              .add(_conv(n, n, 3, 3, stride, stride, 1, 1))
              .add(SpatialBatchNormalization(n))
              .add(ReLU())
              .add(_conv(n, n * 4, 1, 1))
              .add(SpatialBatchNormalization(n * 4)))
    return (_residual(branch, _shortcut(n_in, n * 4, stride, shortcut_type)),
            n * 4)


_IMAGENET_CFG = {
    18: ((2, 2, 2, 2), 512, _basic_block),
    34: ((3, 4, 6, 3), 512, _basic_block),
    50: ((3, 4, 6, 3), 2048, _bottleneck),
    101: ((3, 4, 23, 3), 2048, _bottleneck),
    152: ((3, 8, 36, 3), 2048, _bottleneck),
    200: ((3, 24, 36, 3), 2048, _bottleneck),
}


def ResNet(depth: int = 18, class_num: int = 10, dataset: str = "cifar10",
           shortcut_type: str = None, with_softmax: bool = False):
    """Build a ResNet (reference ``ResNet.scala:131`` ``apply``): logits
    for ``CrossEntropyCriterion``, or a LogSoftMax head with
    ``with_softmax=True`` for ``ClassNLLCriterion``."""
    model = Sequential()

    def stack(block, n_in, features, count, stride, st):
        s = Sequential()
        for i in range(count):
            b, n_in = block(n_in, features, stride if i == 0 else 1, st)
            s.add(b)
        return s, n_in

    if dataset == "imagenet":
        st = shortcut_type or ShortcutType.B
        if depth not in _IMAGENET_CFG:
            raise ValueError(f"invalid ImageNet depth {depth}")
        (c1, c2, c3, c4), n_feat, block = _IMAGENET_CFG[depth]
        model.add(_conv(3, 64, 7, 7, 2, 2, 3, 3))
        model.add(SpatialBatchNormalization(64))
        model.add(ReLU())
        model.add(SpatialMaxPooling(3, 3, 2, 2, 1, 1))
        ch = 64
        for features, count, stride in ((64, c1, 1), (128, c2, 2),
                                        (256, c3, 2), (512, c4, 2)):
            s, ch = stack(block, ch, features, count, stride, st)
            model.add(s)
        model.add(SpatialAveragePooling(7, 7, 1, 1))
        model.add(Reshape((n_feat,)))
        model.add(Linear(n_feat, class_num))
    elif dataset == "cifar10":
        st = shortcut_type or ShortcutType.A
        if (depth - 2) % 6 != 0:
            raise ValueError("CIFAR depth must be 6n+2 (20, 32, 44, 56, "
                             "110, 1202)")
        n = (depth - 2) // 6
        model.add(_conv(3, 16, 3, 3, 1, 1, 1, 1))
        model.add(SpatialBatchNormalization(16))
        model.add(ReLU())
        ch = 16
        for features, stride in ((16, 1), (32, 2), (64, 2)):
            s, ch = stack(_basic_block, ch, features, n, stride, st)
            model.add(s)
        model.add(SpatialAveragePooling(8, 8, 1, 1))
        model.add(Reshape((64,)))
        model.add(Linear(64, class_num))
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    if with_softmax:
        model.add(LogSoftMax())
    return model
