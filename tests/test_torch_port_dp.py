"""The data-parallel slice against the JAX package: the Engine's process
group, ``DistributedDataSet``, the sync-BN statistics kernel's plain
version (B3), ``bn_train_sync``, and ``Optimizer`` with ``DataParallel``.

Groups here are gloo groups on the CPU: a world of one in this process, or
two worker processes started with ``subprocess`` (they import torch, numpy
and ``bigdl_torch`` only) that meet through a ``file://`` store in
``tmp_path``.  On the card ``chip_smoke.py`` runs the same path under NCCL
and holds the CUDA kernels to these plain versions.

Tolerances, as a bound on max|port − reference| relative to
max(1, max|reference|) unless stated:
- B3's plain version against ``_bn_stats_pallas`` in interpret mode:
  1e-5.  Both are float32 sums of the same values in another order.
- ``bn_train_sync`` in a world of one against the reference's
  ``bn_train_sync`` inside ``shard_map`` over 8 shards: 1e-5 for y, the
  statistics and every gradient.  Both compute the same float32
  expressions; the reference sums 8 shard partials, the port one shard.
- Two ranks at local batch 8 against the JAX ``Optimizer`` at batch 16 on
  the 8-device mesh: 2e-3 (the roadmap's training-parity bound) for each
  loss and every param and running statistic after 3 steps.  A rank's
  batch holds the reference batch's rows in another order, so statistics
  and losses agree to summation order, amplified by three SGD steps; the
  gradients of both go through the bf16 wire.  The two ranks must end
  bit-identical.
- A world of one against the single-device ``Optimizer`` on the same rows,
  float32 with no wire: 1e-5.  The routes differ only in how dx is
  grouped (B2's ``x̂·Σdy·x̂/R`` against sync-BN's ``x̂·(Σdy·x̂/R)``), a few
  float32 ulps per step.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.ops import batchnorm as jbn
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch import Engine
from bigdl_torch.common import DTypePolicy, get_policy, set_policy
from bigdl_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_torch.dataset import DistributedDataSet
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.ops import batchnorm as tbn
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.parallel import (DataParallel, LayoutSharding,
                                  ShardedDataParallel, TensorParallel)
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

EPS = 1e-5
F32 = 1e-5
TRAIN_TOL = 2e-3
STEPS = 3
LOCAL_BATCH = 8
WORKER_TIMEOUT = 120
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_engine():
    Engine.reset()
    yield
    Engine.reset()


def _close(port, ref, tol=F32):
    port = (port.detach().float().numpy() if isinstance(port, torch.Tensor)
            else np.asarray(port, np.float32))
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


# -- (b) B3's plain version --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", [(1000, 3), (1000, 130), (37, 64)])
def test_bn_stats_matches_pallas(R, C, dtype):
    """(Σx, Σx²) of the plain version against ``_bn_stats_pallas``; R is
    no multiple of the reference's row block and C of its 128 lanes."""
    rs = np.random.RandomState(R + C)
    x = (rs.standard_normal((R, C)) * 2 + 0.5).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    js, jss = jbn._bn_stats_pallas(jnp.asarray(x).astype(jdt), block_r=256,
                                   interpret=True)
    ts, tss = tbn.bn_stats(torch.from_numpy(x).to(tdt))
    assert ts.dtype == tss.dtype == torch.float32
    _close(ts, js)
    _close(tss, jss)


def test_bn_stats_gives_b1_statistics():
    """B3's sums are B1's: Σx/R and Σx²/R − mean² equal B1's mean and
    var bit for bit (the plain versions; on the card, the kernels)."""
    x = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (500, 7)).astype(np.float32))
    s, ss = tbn.bn_stats(x)
    _, mean, var = tbn.bn_forward(x, torch.ones(7), torch.zeros(7), EPS)
    m = s / 500
    assert torch.equal(m, mean) and torch.equal(ss / 500 - m * m, var)


def test_bn_stats_has_no_other_route():
    x = torch.empty((8, 4), device="meta")
    launches = tbn.bn_stats.launches
    with pytest.raises(ValueError, match="no route"):
        tbn.bn_stats(x)
    assert tbn.bn_stats.launches == launches


# -- (c) bn_train_sync in a world of one --------------------------------------

def test_bn_train_sync_matches_reference_shardmap():
    """The port's ``bn_train_sync`` over a gloo world of one against the
    reference's inside ``shard_map`` over 8 devices
    (``tests/test_bn_pallas.py``'s sync test): y, mean, var and dx, dγ, dβ;
    dγ and dβ must not be counted once per shard."""
    from jax.sharding import Mesh, PartitionSpec as P

    from bigdl_tpu.utils.compat import shard_map_unchecked

    rs = np.random.RandomState(0)
    x = (rs.standard_normal((32, 6, 5)) * 2 + 1).astype(np.float32)
    w = (1.0 + 0.1 * rs.standard_normal(5)).astype(np.float32)
    b = (0.1 * rs.standard_normal(5)).astype(np.float32)
    dy = rs.standard_normal((32, 6, 5)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("data",))
    xs = P("data", None, None)
    f = shard_map_unchecked(
        lambda xl, w_, b_: jbn.bn_train_sync(xl, w_, b_, EPS, "data", 1024,
                                             True),
        mesh=mesh, in_specs=(xs, P(None), P(None)),
        out_specs=(xs, P(None), P(None)))
    (jy, jm, jv), vjp = jax.vjp(jax.jit(f), jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    jdx, jdw, jdb = vjp((jnp.asarray(dy), jnp.zeros(5), jnp.zeros(5)))

    group = Engine.init(device="cpu")
    assert Engine.world() == 1
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    ty, tm, tv = tbn.bn_train_sync(tx, tw, tb, EPS, group)
    assert not tm.requires_grad and not tv.requires_grad
    ty.backward(torch.from_numpy(dy))
    for got, ref in ((ty, jy), (tm, jm), (tv, jv), (tx.grad, jdx),
                     (tw.grad, jdw), (tb.grad, jdb)):
        _close(got, ref)
    assert Engine.all_reduces == {"bn_stats": 1, "bn_grad_stats": 1}


# -- (d) two ranks against the JAX package ------------------------------------

def _small_resnet(mod, nn, fuse: bool):
    """tests/test_torch_port_resnet.py's network: 32x32x3 -> 10."""
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


# the worker's own code; ``_small_resnet`` is prepended to it
_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    from bigdl_torch import Engine
    import bigdl_torch.nn as nn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models import resnet as mod
    from bigdl_torch.optim import SGD, Optimizer, Trigger
    from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

    job = pickle.load(open(sys.argv[1], "rb"))
    Engine.init(device="cpu")
    model = _small_resnet(mod, nn, job["fuse"]).build("cpu")
    load_reference_tree(model, job["params"], job["state"])
    losses = {}
    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > job["steps"]
    x, y = job["x"], job["y"]
    opt = Optimizer(model, DataSet.array(
        [Sample.from_ndarray(x[i], y[i]) for i in range(len(x))],
        distributed=True), nn.CrossEntropyCriterion(),
        batch_size=job["batch"])
    opt.set_optim_method(SGD(0.1, momentum=0.9, weight_decay=1e-4))
    opt.set_end_when(Trigger(end, "steps")).optimize()
    params, state = to_reference_tree(model)
    out = {"rank": Engine.rank(), "world": Engine.world(), "losses": losses,
           "params": params, "state": state,
           "all_reduces": dict(Engine.all_reduces)}
    pickle.dump(out, open(job["out"] + "." + str(Engine.rank()), "wb"))
    Engine.reset()
''')


def _spawn_ranks(job, tmp_path, n=2, worker=_WORKER):
    """Start ``n`` ranks of ``worker`` (after ``_small_resnet``'s source)
    on ``job``; returns a function that waits for them and returns their
    results by rank."""
    import inspect

    job = dict(job, out=str(tmp_path / "result"))
    (tmp_path / "job.pkl").write_bytes(pickle.dumps(job))
    (tmp_path / "worker.py").write_text(
        inspect.getsource(_small_resnet) + worker)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp_path / 'store'}",
           "BIGDL_TORCH_NUM_PROCESSES": str(n)}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"),
         str(tmp_path / "job.pkl")],
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]

    def wait():
        try:
            errs = [p.communicate(timeout=WORKER_TIMEOUT)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, err in zip(procs, errs):
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        return [pickle.loads((tmp_path / f"result.{i}").read_bytes())
                for i in range(n)]
    return wait


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_two_ranks_train_like_reference(fuse, tmp_path, monkeypatch):
    """Two gloo ranks at local batch 8 against the JAX ``Optimizer`` at
    batch 16 on the 8-device mesh, whose BatchNorms take the reference's
    sync route (B3 inside ``shard_map``) under ``pallas_interpret``."""
    monkeypatch.setenv("BIGDL_TPU_BN_IMPL", "pallas_interpret")
    jm = _small_resnet(jresnet, jnn, fuse)
    jm.build(jax.random.key(0))
    x, y = _data()
    wait = _spawn_ranks(dict(
        fuse=fuse, params=jax.tree.map(np.asarray, jm.params),
        state=jax.tree.map(np.asarray, jm.state), x=x, y=y, steps=STEPS,
        batch=LOCAL_BATCH), tmp_path)

    JEngine.init()
    jlosses = {}

    def end(state):
        if state["neval"] > 1:
            jlosses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    jopt = JOptimizer(jm, JDataSet.array(
        [JSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        jnn.CrossEntropyCriterion(), batch_size=2 * LOCAL_BATCH)
    jopt.set_optim_method(JSGD(0.1, momentum=0.9, weight_decay=1e-4))
    jopt.set_end_when(JTrigger(end, "steps")).optimize()

    ranks = wait()
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 for r in ranks)
    # each step: one all-reduce per BatchNorm in each direction, one for
    # the gradients and the loss
    n_bn = sum(isinstance(m, tnn.BatchNormalization)
               for m in _small_resnet(tresnet, tnn, fuse).modules())
    assert ranks[0]["all_reduces"] == {
        "bn_stats": n_bn * STEPS, "bn_grad_stats": n_bn * STEPS,
        "grads": STEPS}
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"]
    for a, b in zip(_leaves((r0["params"], r0["state"])),
                    _leaves((r1["params"], r1["state"]))):
        assert np.array_equal(a, b)
    assert sorted(r0["losses"]) == sorted(jlosses) == [1, 2, 3]
    for k in jlosses:
        assert abs(r0["losses"][k] - jlosses[k]) <= TRAIN_TOL, (
            r0["losses"], jlosses)
    got = _leaves((r0["params"], r0["state"]))
    ref = _leaves((jm.params, jm.state))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    assert any(np.abs(s).max() > 0 for s in _leaves(r0["state"]))


# -- (e) a world of one against one device -------------------------------------

def _train(model, samples, distributed):
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    Optimizer(model, DataSet.array(samples, distributed=distributed),
              tnn.CrossEntropyCriterion(), batch_size=2 * LOCAL_BATCH,
              device="cpu") \
        .set_optim_method(SGD(0.1, momentum=0.9)) \
        .set_end_when(Trigger(end, "steps")).optimize()
    return [losses[k] for k in sorted(losses)]


def test_world_of_one_trains_like_one_device():
    """``Optimizer`` under a gloo world of one (sync-BN, the gradient
    all-reduce) against the single-device ``Optimizer`` (B1/B2) on the same
    rows, fused model, float32 with no wire."""
    saved = get_policy()
    set_policy(DTypePolicy(wire_dtype=None))
    try:
        x, y = _data()
        samples = [Sample.from_ndarray(x[i], y[i]) for i in range(len(x))]
        single = _small_resnet(tresnet, tnn, True).build(
            "cpu", torch.Generator().manual_seed(1))
        dp = _small_resnet(tresnet, tnn, True).build(
            "cpu", torch.Generator().manual_seed(1))
        ref = _train(single, samples, distributed=False)
        Engine.init(device="cpu")
        got = _train(dp, samples, distributed=True)
        assert Engine.all_reduces["grads"] == STEPS
        assert Engine.all_reduces["bn_stats"] > 0
    finally:
        set_policy(saved)
    assert np.abs(np.array(got) - np.array(ref)).max() <= F32, (got, ref)
    for a, b in zip(list(dp.parameters()) + list(dp.buffers()),
                    list(single.parameters()) + list(single.buffers())):
        _close(a, b.detach().numpy())


# -- (f) sharding, and what is not ported ------------------------------------

def test_distributed_dataset_shards_with_equal_steps(monkeypatch):
    """Each rank yields its stride of one seeded permutation, truncated to
    len // world: the shards are disjoint, the same size, and every rank
    runs the same number of batches.  The rank and world are the Engine's,
    here posed for each of three ranks."""
    records = [Sample.from_ndarray(np.full((2,), i, np.float32), np.int32(0))
               for i in range(11)]
    shards = []
    for rank in range(3):
        monkeypatch.setattr(Engine, "data_shard_info",
                            classmethod(lambda cls, r=rank: (r, 3)))
        ds = DistributedDataSet(records, seed=4)
        ds.shuffle()
        shards.append([int(s.feature[0]) for s in ds.data(train=True)])
        assert ds.size() == 11 and ds.local_size() == 3
        batches = list(ds.transform(SampleToMiniBatch(2, drop_last=True))
                       .data(train=True))
        assert len(batches) == 1
    assert all(len(s) == 3 for s in shards)
    assert len(set(sum(shards, []))) == 9
    perm = np.arange(11)
    np.random.default_rng(4).shuffle(perm)
    assert shards[1] == perm[1::3][:3].tolist()
    monkeypatch.undo()
    # without a group a process is a world of one: every record, in order
    ds = DataSet.array(records, distributed=True, seed=4)
    assert isinstance(ds, DistributedDataSet)
    assert isinstance(DataSet.rdd(records), DistributedDataSet)
    ds.shuffle()
    assert [int(s.feature[0]) for s in ds.data(train=True)] == perm.tolist()


def test_engine_contract(monkeypatch):
    """``Engine.init()`` needs CUDA unless it is told ``device='cpu'``; a
    world of one needs no coordinator; reset destroys the group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine.init()
    assert Engine.group() is None
    assert Engine.data_shard_info() == (0, 1)
    group = Engine.init(device="cpu")
    assert Engine.init(device="cpu") is group is Engine.mesh()
    assert (Engine.rank(), Engine.world(), Engine.data_parallel_size(),
            Engine.device_count()) == (0, 1, 1, 1)
    assert Engine.device() == torch.device("cpu")
    Engine.reset()
    assert Engine.group() is None
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("BIGDL_TORCH_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="COORDINATOR"):
        Engine.init(device="cpu")


def test_unported_and_misused_strategies(monkeypatch):
    """The mesh strategies construct (their rule, model and layout kept;
    ``LayoutSharding`` needs the model its roles live on); the rest
    refuses as before."""
    assert TensorParallel().rule is None
    lin = tnn.Linear(4, 3)
    assert LayoutSharding(lin).model is lin
    with pytest.raises(TypeError):
        LayoutSharding()
    assert ShardedDataParallel().min_size == 2 ** 14
    samples = [Sample.from_ndarray(np.zeros((4,), np.float32), np.int32(0))]
    with pytest.raises(RuntimeError, match="Engine.init"):
        Optimizer(tnn.Linear(4, 3), samples, tnn.CrossEntropyCriterion(),
                  device="cpu", strategy=DataParallel())
    with pytest.raises(ValueError, match="sync_axis"):
        tnn.SpatialBatchNormalization(4, sync_axis="model")
    bn = tnn.SpatialBatchNormalization(4, sync_axis="data").build("cpu")
    with pytest.raises(RuntimeError, match="Engine.init"):
        bn(torch.zeros((2, 3, 3, 4)))
    Engine.init(device="cpu")
    assert isinstance(Optimizer(tnn.Linear(4, 3), samples,
                                tnn.CrossEntropyCriterion()).strategy,
                      DataParallel)
    y = bn(torch.randn((2, 3, 3, 4)))
    assert y.shape == (2, 3, 3, 4)
    assert Engine.all_reduces["bn_stats"] == 1
