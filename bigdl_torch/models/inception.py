"""Inception-v1 (GoogLeNet) and BN-Inception (Inception-v2).

Counterpart of ``bigdl_tpu/models/inception.py`` (BigDL
``models/inception/Inception_v1.scala``, ``Inception_v2.scala``), built
from the same layers in the same order with the same names, so the
parameter and state trees are the reference's leaf for leaf.
``Inception_Layer_v1`` (:23) is a Concat of four towers (1x1 / 3x3-reduce
and 3x3 / 5x5-reduce and 5x5 / pool and projection);
``Inception_v1_NoAuxClassifier`` (:64) the plain tower; ``Inception_v1``
(:103) adds the two auxiliary heads, its output [main | aux2 | aux1]
along the class axis.  BN-Inception's convolutions are each followed by
``SpatialBatchNormalization(eps=1e-3)`` and ReLU; ``fuse_conv_bn`` turns
its 37 adjacent 1x1 pairs into ``ConvBN``.  NHWC; the Concat axis is the
channel axis (-1).
"""

from __future__ import annotations

from ..nn import (Concat, Dropout, Linear, LogSoftMax, ReLU, Reshape,
                  Sequential, SpatialAveragePooling,
                  SpatialBatchNormalization, SpatialConvolution,
                  SpatialCrossMapLRN, SpatialMaxPooling, Xavier, Zeros)

__all__ = ["Inception_Layer_v1", "Inception_v1",
           "Inception_v1_NoAuxClassifier", "Inception_Layer_v2",
           "Inception_v2", "Inception_v2_NoAuxClassifier"]


def _conv(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, name=""):
    c = SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph)
    c.set_init_method(Xavier(), Zeros())
    return c.set_name(name)


def Inception_Layer_v1(input_size: int, config, name_prefix: str = ""):
    """``config`` = ((n1x1,), (n3x3r, n3x3), (n5x5r, n5x5), (npool,)), the
    reference's nested Table (Inception_v1.scala:23-61)."""
    concat = Concat(-1)
    concat.add(Sequential()
               .add(_conv(input_size, config[0][0], 1, 1,
                          name=name_prefix + "1x1"))
               .add(ReLU()))
    concat.add(Sequential()
               .add(_conv(input_size, config[1][0], 1, 1,
                          name=name_prefix + "3x3_reduce"))
               .add(ReLU())
               .add(_conv(config[1][0], config[1][1], 3, 3, 1, 1, 1, 1,
                          name=name_prefix + "3x3"))
               .add(ReLU()))
    concat.add(Sequential()
               .add(_conv(input_size, config[2][0], 1, 1,
                          name=name_prefix + "5x5_reduce"))
               .add(ReLU())
               .add(_conv(config[2][0], config[2][1], 5, 5, 1, 1, 2, 2,
                          name=name_prefix + "5x5"))
               .add(ReLU()))
    concat.add(Sequential()
               .add(SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
               .add(_conv(input_size, config[3][0], 1, 1,
                          name=name_prefix + "pool_proj"))
               .add(ReLU()))
    return concat.set_name(name_prefix + "output")


def _stem():
    return [
        _conv(3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2"), ReLU(),
        SpatialMaxPooling(3, 3, 2, 2).ceil(),
        SpatialCrossMapLRN(5, 0.0001, 0.75),
        _conv(64, 64, 1, 1, name="conv2/3x3_reduce"), ReLU(),
        _conv(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3"), ReLU(),
        SpatialCrossMapLRN(5, 0.0001, 0.75),
        SpatialMaxPooling(3, 3, 2, 2).ceil(),
    ]


#: (input_size, config, prefix) of Inception_v1.scala's nine blocks, with
#: a stride-2 max pool after 3b and after 4e
_V1_BLOCKS = [
    (192, ((64,), (96, 128), (16, 32), (32,)), "inception_3a/"),
    (256, ((128,), (128, 192), (32, 96), (64,)), "inception_3b/"),
    (480, ((192,), (96, 208), (16, 48), (64,)), "inception_4a/"),
    (512, ((160,), (112, 224), (24, 64), (64,)), "inception_4b/"),
    (512, ((128,), (128, 256), (24, 64), (64,)), "inception_4c/"),
    (512, ((112,), (144, 288), (32, 64), (64,)), "inception_4d/"),
    (528, ((256,), (160, 320), (32, 128), (128,)), "inception_4e/"),
    (832, ((256,), (160, 320), (32, 128), (128,)), "inception_5a/"),
    (832, ((384,), (192, 384), (48, 128), (128,)), "inception_5b/"),
]


def _v1_blocks(model, blocks):
    for n_in, cfg, prefix in blocks:
        model.add(Inception_Layer_v1(n_in, cfg, prefix))
        if prefix in ("inception_3b/", "inception_4e/"):
            model.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    return model


def _classifier(model, class_num, pool, dropout=0.0):
    """``pool``, Dropout (v1 only), Reshape, the classifier, LogSoftMax."""
    model.add(pool)
    if dropout:
        model.add(Dropout(dropout))
    model.add(Reshape((1024,)))
    fc = Linear(1024, class_num).set_name("loss3/classifier")
    fc.set_init_method(Xavier(), Zeros())
    return model.add(fc).add(LogSoftMax())


def Inception_v1_NoAuxClassifier(class_num: int = 1000):
    model = Sequential()
    for m in _stem():
        model.add(m)
    return _classifier(_v1_blocks(model, _V1_BLOCKS), class_num,
                       SpatialAveragePooling(7, 7, 1, 1), 0.4)


def _aux_head(n_in: int, class_num: int, prefix: str):
    return (Sequential()
            .add(SpatialAveragePooling(5, 5, 3, 3).ceil())
            .add(_conv(n_in, 128, 1, 1, name=prefix + "conv"))
            .add(ReLU())
            .add(Reshape((128 * 4 * 4,)))
            .add(Linear(128 * 4 * 4, 1024).set_name(prefix + "fc"))
            .add(ReLU())
            .add(Dropout(0.7))
            .add(Linear(1024, class_num).set_name(prefix + "classifier"))
            .add(LogSoftMax()))


def Inception_v1(class_num: int = 1000):
    """GoogLeNet with the auxiliary heads; the output is [main | aux2 |
    aux1] along the class axis (Inception_v1.scala:169-186)."""
    feature1 = Sequential()
    for m in _stem():
        feature1.add(m)
    _v1_blocks(feature1, _V1_BLOCKS[:3])            # 3a, 3b, pool, 4a
    output1 = _aux_head(512, class_num, "loss1/")
    feature2 = _v1_blocks(Sequential(), _V1_BLOCKS[3:6])  # 4b, 4c, 4d
    output2 = _aux_head(528, class_num, "loss2/")
    output3 = _v1_blocks(Sequential(), _V1_BLOCKS[6:])    # 4e, pool, 5a, 5b
    _classifier(output3, class_num, SpatialAveragePooling(7, 7, 1, 1), 0.4)
    split2 = Concat(-1).add(output3).add(output2)
    main_branch = Sequential().add(feature2).add(split2)
    split1 = Concat(-1).add(main_branch).add(output1)
    return Sequential().add(feature1).add(split1)


# -- Inception-v2 (BN-Inception), models/inception/Inception_v2.scala ------

def _conv_bn(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, name=""):
    """conv (with its bias, as the reference's), BN(eps=1e-3), ReLU
    (Inception_v2.scala:30-36)."""
    c = SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph)
    c.set_init_method(Xavier(), Zeros())
    return [c.set_name(name),
            SpatialBatchNormalization(n_out, eps=1e-3).set_name(name + "/bn"),
            ReLU()]


def _seq(*groups):
    s = Sequential()
    for group in groups:
        for m in group:
            s.add(m)
    return s


def Inception_Layer_v2(input_size: int, config, name_prefix: str = ""):
    """BN-Inception block (Inception_v2.scala:28-104): [1x1] | [3x3 reduce,
    3x3] | [double 3x3 reduce, 3x3, 3x3] | [pool, optional projection].
    ``config`` = ((n1x1,), (n3x3r, n3x3), (nd3x3r, nd3x3), (pool_kind,
    npool)), pool_kind "avg" or "max"; ("max", 0) marks the stride-2
    reduction block, and n1x1 = 0 drops the 1x1 tower."""
    pool_kind, npool = config[3]
    reduction = pool_kind == "max" and npool == 0
    stride = 2 if reduction else 1
    p = name_prefix
    concat = Concat(-1)
    if config[0][0] != 0:
        concat.add(_seq(_conv_bn(input_size, config[0][0], 1, 1,
                                 name=p + "1x1")))
    concat.add(_seq(
        _conv_bn(input_size, config[1][0], 1, 1, name=p + "3x3_reduce"),
        _conv_bn(config[1][0], config[1][1], 3, 3, stride, stride, 1, 1,
                 name=p + "3x3")))
    concat.add(_seq(
        _conv_bn(input_size, config[2][0], 1, 1,
                 name=p + "double3x3_reduce"),
        _conv_bn(config[2][0], config[2][1], 3, 3, 1, 1, 1, 1,
                 name=p + "double3x3a"),
        _conv_bn(config[2][1], config[2][1], 3, 3, stride, stride, 1, 1,
                 name=p + "double3x3b")))
    if pool_kind == "avg":
        pool = SpatialAveragePooling(3, 3, 1, 1, 1, 1).ceil()
    elif reduction:
        pool = SpatialMaxPooling(3, 3, 2, 2).ceil()
    else:
        pool = SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()
    concat.add(_seq([pool], _conv_bn(input_size, npool, 1, 1,
                                     name=p + "pool_proj") if npool else []))
    return concat.set_name(name_prefix + "output")


#: (input_size, config, prefix), exactly Inception_v2.scala:122-141
_V2_BLOCKS = [
    (192, ((64,), (64, 64), (64, 96), ("avg", 32)), "inception_3a/"),
    (256, ((64,), (64, 96), (64, 96), ("avg", 64)), "inception_3b/"),
    (320, ((0,), (128, 160), (64, 96), ("max", 0)), "inception_3c/"),
    (576, ((224,), (64, 96), (96, 128), ("avg", 128)), "inception_4a/"),
    (576, ((192,), (96, 128), (96, 128), ("avg", 128)), "inception_4b/"),
    (576, ((160,), (128, 160), (128, 160), ("avg", 96)), "inception_4c/"),
    (576, ((96,), (128, 192), (160, 192), ("avg", 96)), "inception_4d/"),
    (576, ((0,), (128, 192), (192, 256), ("max", 0)), "inception_4e/"),
    (1024, ((352,), (192, 320), (160, 224), ("avg", 128)), "inception_5a/"),
    (1024, ((352,), (192, 320), (192, 224), ("max", 128)), "inception_5b/"),
]


def _v2_stem():
    return (_conv_bn(3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2")
            + [SpatialMaxPooling(3, 3, 2, 2).ceil()]
            + _conv_bn(64, 64, 1, 1, name="conv2/3x3_reduce")
            + _conv_bn(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3")
            + [SpatialMaxPooling(3, 3, 2, 2).ceil()])


def _v2_blocks(model, blocks):
    for n_in, cfg, prefix in blocks:
        model.add(Inception_Layer_v2(n_in, cfg, prefix))
    return model


def Inception_v2_NoAuxClassifier(class_num: int = 1000):
    """The BN-Inception tower without auxiliary heads
    (Inception_v2.scala:107-150)."""
    return _classifier(_v2_blocks(_seq(_v2_stem()), _V2_BLOCKS), class_num,
                       SpatialAveragePooling(7, 7, 1, 1).ceil())


def _v2_aux_head(n_in: int, spatial: int, class_num: int, prefix: str):
    """avg pool 5x5/3 (ceil), 1x1 conv, BN, ReLU, fc 1024, ReLU, classifier
    (Inception_v2.scala:175-183, :200-208): no dropout, unlike v1's."""
    head = _seq([SpatialAveragePooling(5, 5, 3, 3).ceil()],
                _conv_bn(n_in, 128, 1, 1, name=prefix + "conv"))
    return (head
            .add(Reshape((128 * spatial * spatial,)))
            .add(Linear(128 * spatial * spatial, 1024)
                 .set_name(prefix + "fc"))
            .add(ReLU())
            .add(Linear(1024, class_num).set_name(prefix + "classifier"))
            .add(LogSoftMax()))


def Inception_v2(class_num: int = 1000):
    """BN-Inception with the two auxiliary heads, [main | aux2 | aux1]
    (Inception_v2.scala:153-230): aux1 after 3c (576 x 14 x 14), aux2 after
    4e (1024 x 7 x 7)."""
    feature1 = _v2_blocks(_seq(_v2_stem()), _V2_BLOCKS[:3])  # 3a, 3b, 3c
    output1 = _v2_aux_head(576, 4, class_num, "loss1/")
    feature2 = _v2_blocks(Sequential(), _V2_BLOCKS[3:8])     # 4a to 4e
    output2 = _v2_aux_head(1024, 2, class_num, "loss2/")
    output3 = _classifier(_v2_blocks(Sequential(), _V2_BLOCKS[8:]),  # 5a, 5b
                          class_num, SpatialAveragePooling(7, 7, 1, 1).ceil())
    split2 = Concat(-1).add(output3).add(output2)
    main_branch = Sequential().add(feature2).add(split2)
    split1 = Concat(-1).add(main_branch).add(output1)
    return Sequential().add(feature1).add(split1)
