"""The bucketed gradient wire against the JAX package: the bucket
assignment and count, the bucketed ``wire_cast``, ``DataParallel``'s
all-reduce in buckets launched from the backward, and the collective
probe.  Everything here runs in one process (a gloo world of one where a
group is needed); the two-rank runs are in ``test_torch_port_zero.py``.

Tolerances: none.  Bucket assignments and counts are exact; the bucketed
cast moves values verbatim around an elementwise cast, so it is
bit-equal to the per-leaf cast and to the reference's values; the
bucketed all-reduce sums the same elements as the single one, so training
through it is bit-equal, with accumulation, remat and clipping.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.parallel import wire as jwire

import bigdl_torch.nn as tnn
from bigdl_torch import Engine
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.parallel import (DataParallel, bucket_assignment,
                                  bucket_count, measure_collective_seconds,
                                  wire_bucket_mb, wire_cast)

from test_torch_port_dp import _data, _small_resnet

STEPS = 3


@pytest.fixture(autouse=True)
def _port_engine():
    Engine.reset()
    yield
    Engine.reset()


@pytest.mark.parametrize("cap_mb", [1e-4, 0.001, 0.01, 1.0, 25.0])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_bucket_assignment_matches_reference(itemsize, cap_mb):
    sizes = np.random.RandomState(3).randint(1, 3000, 40).tolist()
    sizes[7] = 10 ** 6      # larger than every cap but the last
    assert bucket_assignment(sizes, itemsize, cap_mb) == \
        jwire.bucket_assignment(sizes, itemsize, cap_mb)


@pytest.mark.parametrize("cap_mb", [0.0, 1.0, 4.0, 25.0])
@pytest.mark.parametrize("wire", ["bf16", "f32", None])
def test_bucket_count_matches_reference_on_resnet50(wire, cap_mb):
    """On the reference's ResNet-50 tree (``jax.eval_shape``: nothing is
    built) and the same shapes as meta tensors."""
    jtree = jax.eval_shape(jnn.fuse_conv_bn(jresnet.ResNet(
        50, class_num=1000, dataset="imagenet")).init, jax.random.key(0))[0]
    leaves = [torch.empty(a.shape, device="meta")
              for a in jax.tree.leaves(jtree)]
    jw, tw = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f32": (jnp.float32, torch.float32), None: (None, None)}[wire]
    got = bucket_count(leaves, tw, cap_mb)
    assert got == jwire.bucket_count(jtree, jw, cap_mb)
    assert (got > 1) == (wire is not None and cap_mb > 0)


def _grads(seed=0):
    rs = np.random.RandomState(seed)
    shapes = [(7, 7, 3, 16), (16,), (300, 40), (5,), (1, 1, 64, 256), (3,)]
    return [(rs.standard_normal(s) * 10.0 ** rs.randint(-6, 3))
            .astype(np.float32) for s in shapes]


@pytest.mark.parametrize("cap_mb", [1e-4, 0.01, 25.0])
def test_bucketed_wire_cast_bit_equal(cap_mb, monkeypatch):
    """The bucketed cast equals the per-leaf cast and the reference's
    bucketed cast bit for bit; the knob selects it."""
    grads = _grads()
    tg = [torch.from_numpy(g) for g in grads]
    per_leaf = wire_cast(tg, torch.bfloat16, 0)
    bucketed = wire_cast(tg, torch.bfloat16, cap_mb)
    ref = jwire.wire_cast([jnp.asarray(g) for g in grads], jnp.bfloat16,
                          cap_mb)
    for a, b, r in zip(per_leaf, bucketed, ref):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
        assert np.array_equal(b.numpy(), np.asarray(r))
    assert wire_cast(tg, None, cap_mb) is tg
    monkeypatch.setenv("BIGDL_TORCH_WIRE_BUCKET_MB", str(cap_mb))
    assert wire_bucket_mb() == cap_mb
    for a, b in zip(per_leaf, wire_cast(tg, torch.bfloat16)):
        assert torch.equal(a, b)


def _samples():
    x, y = _data(16)
    return [Sample.from_ndarray(x[i], y[i]) for i in range(len(x))]


def _train(monkeypatch, bucket_mb, accum=1, clip=None, remat=None):
    """The small ResNet, three SGD steps at batch 16 in a gloo world of
    one with ``BIGDL_TORCH_WIRE_BUCKET_MB`` set to ``bucket_mb``: (losses,
    parameters, the Engine's collective counts)."""
    monkeypatch.setenv("BIGDL_TORCH_WIRE_BUCKET_MB", str(bucket_mb))
    Engine.init(device="cpu")
    model = _small_resnet(tresnet, tnn, True).build(
        "cpu", torch.Generator().manual_seed(1))
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    opt = Optimizer(model, DataSet.array(_samples(), distributed=True),
                    tnn.CrossEntropyCriterion(), batch_size=16,
                    strategy=DataParallel())
    opt.set_optim_method(SGD(0.1, momentum=0.9, weight_decay=1e-4))
    if accum > 1:
        opt.set_gradient_accumulation(accum)
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if remat is not None:
        opt.set_remat(remat)
    opt.set_end_when(Trigger(end, "steps")).optimize()
    out = (losses, [p.detach().clone() for p in model.parameters()],
           Engine.collectives())
    Engine.reset()
    return out


@pytest.mark.parametrize("accum,clip,remat", [(1, None, None),
                                              (2, 0.5, None),
                                              (2, None, "full")],
                         ids=["plain", "accum2_clip", "accum2_remat"])
def test_bucketed_all_reduce_trains_bit_equal(monkeypatch, accum, clip,
                                              remat):
    """One all-reduce per bucket, launched from the backward (the last
    microbatch's under accumulation, beside remat's recomputed forward),
    and the wire cast in the same buckets: losses and parameters
    bit-equal to the single all-reduce and the per-leaf cast."""
    base = _train(monkeypatch, 0, accum, clip, remat)
    got = _train(monkeypatch, 0.002, accum, clip, remat)
    assert got[0] == base[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], base[1]))
    model = _small_resnet(tresnet, tnn, True).build("cpu")
    n = bucket_count(list(model.parameters()), torch.float32, 0.002)
    assert n > 3
    assert base[2]["all_reduce"]["grads"] == STEPS
    assert got[2]["all_reduce"]["grads"] == n * STEPS


def test_bucket_of_a_parameter_without_gradient():
    """A parameter the backward never reaches sends zeros; its bucket
    still launches, after the backward, in bucket order."""
    Engine.init(device="cpu")
    model = tnn.Sequential().add(tnn.Linear(4, 3)).add(tnn.Linear(3, 2))
    model.build("cpu")
    dp = DataParallel()
    dp.setup(model, None, 1e-5)
    params = list(model.parameters())
    loss = model.layers[0](torch.ones(2, 4)).sum()
    assert dp.arm(params, loss.detach(), 1)
    loss.backward()
    grads, reduced = dp.reduce(None, loss)
    assert float(reduced) == float(loss.detach())
    assert torch.equal(grads[0], params[0].grad)
    assert not grads[2].any() and not grads[3].any()
    assert Engine.all_reduces["grads"] == 4 == bucket_count(
        params, torch.float32, 1e-5)


def test_collective_probe_world_of_one():
    """No collective exists without a group or in a world of one: 0.0,
    and nothing is counted (the two-rank probe is in
    ``test_torch_port_zero.py``)."""
    params = [torch.zeros(10), torch.zeros(3)]
    assert measure_collective_seconds(params) == 0.0
    Engine.init(device="cpu")
    assert measure_collective_seconds(params, torch.float32, 1.0) == 0.0
    assert Engine.all_reduces == {}
