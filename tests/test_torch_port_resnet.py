"""The training slice as a whole against the JAX package: a small
bottleneck ResNet trained through both packages' ``Optimizer``, ResNet-50's
fused structure, and ResNet-50's (params, state) tree carried both ways.

The network is built in both packages from the reference's own block
builders (``models/resnet.py`` ``_bottleneck``, ``_residual``, ``_conv``):
a 7x7 stride-2 stem with BN and ReLU, a 3x3 stride-2 max pool, two narrow
bottleneck stages (the second strided, with a conv shortcut), a 4x4 average
pool, Reshape and Linear, on 32x32x3 inputs at batch 8.  The port starts
from the JAX model's weights; the data is numpy-seeded and both datasets
shuffle it in the same order.  The JAX side trains on the test mesh (8
virtual CPU devices, as tests/test_e2e_lenet.py) with its BatchNorm and
fused conv-BN kernels in interpret mode (``BIGDL_TPU_BN_IMPL=
pallas_interpret``); the port on the CPU runs its kernels' plain versions.

Tolerance: each step's loss, and every param and running statistic after 3
steps, within 2e-3 (the roadmap's training-parity bound).  Both sides are
float32 and differ in summation order (the JAX side also in its sharded
BatchNorm statistics), amplified by three SGD steps at lr 0.1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import ResNet
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

TOL = 2e-3
STEPS = 3
BATCH = 8


def small_resnet(mod, nn, fuse: bool):
    """Stem, max pool, two bottleneck stages, head: 32x32x3 -> 10."""
    m = nn.Sequential()
    m.add(mod._conv(3, 16, 7, 7, 2, 2, 3, 3))
    m.add(nn.SpatialBatchNormalization(16)).add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    b1, ch = mod._bottleneck(16, 4, 1, "B")
    b2, ch = mod._bottleneck(ch, 8, 2, "B")
    m.add(nn.Sequential().add(b1)).add(nn.Sequential().add(b2))
    m.add(nn.SpatialAveragePooling(4, 4, 1, 1))
    m.add(nn.Reshape((ch,))).add(nn.Linear(ch, 10))
    if fuse:
        nn.fuse_conv_bn(m)
    return m


def _data(n=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, 32, 32, 3)).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int32)
    return x, y


def _recorder(trigger_cls, losses):
    """End trigger after STEPS iterations that also records the loss the
    driver observed after each step (keyed by the iteration it ended)."""
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_small_resnet_trains_like_reference(fuse, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_BN_IMPL", "pallas_interpret")
    jm = small_resnet(jresnet, jnn, fuse)
    jm.build(jax.random.key(0))
    tm = small_resnet(tresnet, tnn, fuse).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    kinds = {type(m).__name__ for m in tm.modules()}
    assert ("ConvBNAddReLU" in kinds) == fuse
    x, y = _data()

    Engine.init()
    jlosses, tlosses = {}, {}
    jopt = JOptimizer(jm, JDataSet.array(
        [JSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        jnn.CrossEntropyCriterion(), batch_size=BATCH)
    jopt.set_optim_method(JSGD(0.1, momentum=0.9, weight_decay=1e-4))
    jopt.set_end_when(_recorder(JTrigger, jlosses)).optimize()
    topt = TOptimizer(tm, TDataSet.array(
        [TSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        tnn.CrossEntropyCriterion(), batch_size=BATCH, device="cpu")
    topt.set_optim_method(TSGD(0.1, momentum=0.9, weight_decay=1e-4))
    topt.set_end_when(_recorder(TTrigger, tlosses)).optimize()

    assert sorted(tlosses) == sorted(jlosses) == list(range(1, STEPS + 1))
    for k in jlosses:
        assert np.isfinite(tlosses[k])
        assert abs(tlosses[k] - jlosses[k]) <= TOL, (k, tlosses, jlosses)
    assert topt.optim_method.hyper["neval"] == STEPS + 1
    assert topt.optim_method.hyper["evalCounter"] == STEPS
    tp, ts = to_reference_tree(tm)
    for got, ref in ((tp, jm.params), (ts, jm.state)):
        gl, rl = jax.tree.leaves(got), jax.tree.leaves(ref)
        assert len(gl) == len(rl)
        for a, b in zip(gl, rl):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)
    # the running statistics moved off their initial (0, 1)
    assert any(np.abs(s).max() > 0 for s in jax.tree.leaves(ts))
    # eval mode on the trained weights and running statistics
    jy, _ = jax.jit(lambda p, s, x_: jm.apply(p, s, x_, training=False))(
        jm.params, jm.state, jnp.asarray(x[:4]))
    with torch.no_grad():
        ty = tm.eval()(torch.from_numpy(x[:4]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)


def _count(model, cls):
    return sum(type(m) is cls for m in model.modules())


def test_resnet50_fused_structure():
    """Under ``fuse_conv_bn`` ResNet-50 has 17 ConvBN pairs (16 block
    openers and the stride-1 shortcut of stage 1) and 16 ConvBNAddReLU
    tails; 20 BatchNorms stay unfused (stem, 16 3x3 convs, 3 strided
    shortcuts) and run B1/B2; unfused, all 53 do."""
    fused = tnn.fuse_conv_bn(ResNet(50, class_num=1000, dataset="imagenet"))
    assert _count(fused, tnn.ConvBN) == 17
    assert _count(fused, tnn.ConvBNAddReLU) == 16
    inside = {id(m.layers[1]) for m in fused.modules()
              if type(m) is tnn.ConvBN}
    inside |= {id(m.layers[2]) for m in fused.modules()
               if type(m) is tnn.ConvBNAddReLU}
    bns = [m for m in fused.modules()
           if type(m) is tnn.SpatialBatchNormalization]
    assert len(bns) == 53
    assert len([m for m in bns if id(m) not in inside]) == 20
    plain = ResNet(50, class_num=1000, dataset="imagenet")
    assert _count(plain, tnn.SpatialBatchNormalization) == 53
    assert _count(plain, tnn.ConvBN) == 0


def test_resnet50_tree_round_trip():
    """ResNet-50's JAX (params, state) tree, fused as the bench runs it,
    carries into the port and back unchanged (no forward runs)."""
    jm = jnn.fuse_conv_bn(jresnet.ResNet(50, class_num=1000,
                                         dataset="imagenet"))
    # the reference's tree shapes, filled with numpy values (no JAX init)
    rs = np.random.RandomState(1)
    params, state = jax.tree.map(
        lambda a: rs.standard_normal(a.shape).astype(a.dtype),
        jax.eval_shape(jm.init, jax.random.key(1)))
    tm = tnn.fuse_conv_bn(ResNet(50, class_num=1000,
                                 dataset="imagenet")).build("cpu")
    load_reference_tree(tm, params, state)
    back_p, back_s = to_reference_tree(tm)
    assert jax.tree.structure(back_p) == jax.tree.structure(params)
    assert jax.tree.structure(back_s) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((back_p, back_s)),
                    jax.tree.leaves((params, state))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a tree of the unfused model does not line up with the fused one
    unfused = jax.eval_shape(jresnet.ResNet(50, class_num=1000,
                                            dataset="imagenet").init,
                             jax.random.key(2))[0]
    with pytest.raises(ValueError, match="param tree"):
        load_reference_tree(tm, jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype), unfused))


def test_resnet_shortcut_type_a_not_ported():
    with pytest.raises(NotImplementedError, match="type A"):
        ResNet(20, class_num=10, dataset="cifar10")
    model = ResNet(20, class_num=10, dataset="cifar10", shortcut_type="B")
    assert _count(model, tnn.SpatialBatchNormalization) == 21
