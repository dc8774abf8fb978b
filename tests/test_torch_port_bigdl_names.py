"""The Optimizer's and Engine's BigDL names, ``Table`` / ``T``,
``RandomGenerator`` and the zoo CLI's autoencoder against the JAX
package, on the CPU.

- ``DistriOptimizer`` and ``LocalOptimizer`` train a small classifier 3
  steps from the reference's weights: every loss within 2e-3 of the JAX
  package's class of the same name (the roadmap's training bound; float32
  sums in another order and the bf16 gradient wire).  ``LocalOptimizer``
  refuses a strategy and a group of several ranks.
- ``Optimizer.set_strategy`` is checked as the constructor checks a
  strategy.
- ``Engine.node_number()`` is the group's process count, as the
  reference's; ``core_number()`` the CUDA devices this process sees, 1
  (the host) without any.
- ``DistributedDataSet(records, seed, process_index, process_count)``
  yields the reference's records in the reference's order, with the
  explicit shard overriding the Engine's.
- ``Table`` / ``T`` keys, ``insert`` and ``repr`` equal the reference's.
- ``RandomGenerator``: a seed repeats its stream; each distribution's
  sample moments lie near the expected ones, as the reference's do (the
  bit streams differ).
- ``--model autoencoder`` (``"mse"``): the reference's library trains
  one epoch with a checkpoint as its CLI would, with the target flattened
  (the JAX package's CLI passes it unflattened and fails); the reference
  and the port's CLI resume from it for a second epoch, and the port's
  losses stay within 2e-3 of the reference's; ``test --snapshot`` runs
  on the saved model.
"""

import os

import numpy as np
import pytest
import torch

import jax
import bigdl_tpu as jtpu
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DistributedDataSet as JDistributed
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import run as jrun
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import DistriOptimizer as JDistri
from bigdl_tpu.optim import LocalOptimizer as JLocal
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch
import bigdl_torch.nn as tnn
from bigdl_torch import Engine
from bigdl_torch.dataset import DistributedDataSet, Sample
from bigdl_torch.models import run as trun
from bigdl_torch.optim import (SGD, DistriOptimizer, LocalOptimizer,
                               Optimizer, Trigger)
from bigdl_torch.parallel import DataParallel, ShardedDataParallel
from bigdl_torch.utils import file_io
from bigdl_torch.utils.convert import load_reference_tree
from bigdl_torch.visualization.reader import read_scalar

TRAIN_TOL = 2e-3
STEPS = 3


@pytest.fixture(autouse=True)
def _engines():
    Engine.reset()
    yield
    Engine.reset()
    JEngine.reset()


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


def _model(nn):
    return nn.Sequential().add(nn.Linear(6, 8)).add(nn.Tanh()) \
        .add(nn.Linear(8, 3))


def _data(sample_cls):
    rs = np.random.RandomState(0)
    xs = rs.standard_normal((8 * STEPS, 6)).astype(np.float32)
    ys = rs.randint(0, 3, 8 * STEPS).astype(np.int32)
    return [sample_cls.from_ndarray(a, b) for a, b in zip(xs, ys)]


@pytest.mark.parametrize("name", ["DistriOptimizer", "LocalOptimizer"])
def test_bigdl_names_train_like_reference(name):
    jcls, tcls = {"DistriOptimizer": (JDistri, DistriOptimizer),
                  "LocalOptimizer": (JLocal, LocalOptimizer)}[name]
    assert issubclass(tcls, Optimizer)
    jm = _model(jnn).build(jax.random.key(0))
    tm = _model(tnn).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    jl, tl = {}, {}
    JEngine.init(devices=jax.devices()[:2])
    jcls(jm, _data(JSample), jnn.CrossEntropyCriterion(), batch_size=8) \
        .set_optim_method(JSGD(0.1)) \
        .set_end_when(_recorder(JTrigger, jl)).optimize()
    tcls(tm, _data(Sample), tnn.CrossEntropyCriterion(), batch_size=8,
         device="cpu").set_optim_method(SGD(0.1)) \
        .set_end_when(_recorder(Trigger, tl)).optimize()
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    for k in jl:
        assert abs(tl[k] - jl[k]) <= TRAIN_TOL, (tl, jl)


def test_local_optimizer_refuses_a_group_strategy(monkeypatch):
    args = (tnn.Linear(6, 3), _data(Sample), tnn.CrossEntropyCriterion())
    with pytest.raises(ValueError, match="one device"):
        LocalOptimizer(*args, 8, None, DataParallel(), device="cpu")
    opt = LocalOptimizer(*args, batch_size=8, device="cpu")
    with pytest.raises(ValueError, match="one device"):
        opt.set_strategy(DataParallel())
    # a group of two processes is refused; a logical world of two (the
    # elastic topology, no group) trains one device and is not
    monkeypatch.setattr(Engine, "group_size", classmethod(lambda cls: 2))
    with pytest.raises(RuntimeError, match="2 ranks"):
        LocalOptimizer(*args, batch_size=8, device="cpu")
    monkeypatch.setattr(Engine, "group_size", classmethod(lambda cls: 1))
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_WORLD", "2")
    assert Engine.world() == 2
    LocalOptimizer(*args, batch_size=8, device="cpu")


def test_set_strategy():
    """Without the Engine's group a strategy is refused, as in the
    constructor; under a group of one it is taken, None meaning
    DataParallel."""
    args = (tnn.Linear(6, 3), _data(Sample), tnn.CrossEntropyCriterion())
    opt = Optimizer(*args, batch_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="data group"):
        opt.set_strategy(DataParallel())
    Engine.init(device="cpu")
    opt = Optimizer(*args, 8, None, ShardedDataParallel(), device="cpu")
    assert isinstance(opt.strategy, ShardedDataParallel)
    assert opt.set_strategy(None) is opt
    assert type(opt.strategy) is DataParallel
    opt.set_strategy(ShardedDataParallel())
    assert isinstance(opt.strategy, ShardedDataParallel)
    losses = {}
    opt.set_optim_method(SGD(0.1)).set_end_when(
        _recorder(Trigger, losses)).optimize()
    assert sorted(losses) == [1, 2, 3]


def test_engine_node_and_core_number():
    JEngine.init()
    assert Engine.node_number() == JEngine.node_number() == 1
    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert Engine.core_number() == want
    Engine.init(device="cpu")
    assert Engine.node_number() == 1


@pytest.mark.parametrize("shard", [(None, None), (0, 2), (1, 2), (2, 3),
                                   (1, None)])
@pytest.mark.parametrize("train", [False, True])
def test_distributed_dataset_shards_like_reference(shard, train):
    records = list(range(23))
    j = JDistributed(records, 5, *shard)
    t = DistributedDataSet(records, 5, *shard)
    if train:
        j.shuffle()
        t.shuffle()
    assert (t.process_index, t.process_count) == (j.process_index,
                                                  j.process_count)
    assert t.size() == j.size() and t.local_size() == j.local_size()
    assert list(t.data(train)) == list(j.data(train))


def test_table():
    for pkg in (bigdl_torch, bigdl_torch.utils):
        assert pkg.T is bigdl_torch.utils.table.T
    a = bigdl_torch.T(1, "b", k=3).insert(4)
    b = jtpu.T(1, "b", k=3).insert(4)
    assert dict(a) == dict(b) and repr(a) == repr(b)
    assert isinstance(a, bigdl_torch.Table)


def test_random_generator():
    from bigdl_torch.utils.rng import RNG, RandomGenerator
    assert bigdl_torch.RNG is RNG and bigdl_torch.RandomGenerator is \
        RandomGenerator
    g = RandomGenerator(3)
    first = g.normal(0.0, 1.0, (5,))
    assert torch.equal(g.set_seed(3).normal(0.0, 1.0, (5,)), first)
    assert g.get_seed() == 3
    n = (20000,)
    for gen in (RandomGenerator(7), jtpu.RandomGenerator(7)):
        def m(v):
            return float(np.mean(np.asarray(v, np.float64)))
        assert abs(m(gen.uniform(2.0, 4.0, n)) - 3.0) < 0.03
        assert abs(m(gen.normal(1.0, 2.0, n)) - 1.0) < 0.06
        assert abs(m(gen.exponential(2.0, n)) - 0.5) < 0.02
        assert abs(float(np.median(np.asarray(gen.cauchy(1.0, 0.5, n))))
                   - 1.0) < 0.03
        ln = np.asarray(gen.log_normal(1.0, 0.5, n), np.float64)
        assert abs(ln.mean() - 1.0) < 0.02 and abs(ln.std() - 0.5) < 0.03
        geo = np.asarray(gen.geometric(0.25, n))
        assert geo.min() >= 1 and abs(geo.mean() - 4.0) < 0.15
        assert abs(m(gen.bernoulli(0.3, n)) - 0.3) < 0.02


def _losses(summary_dir):
    (app,) = os.listdir(summary_dir)
    path = os.path.join(summary_dir, app, "train")
    return [v for _, v, _ in sorted(read_scalar(path, "Loss"))]


def _reference_autoencoder(ckpt, summary, max_epoch, resume=None):
    """What the zoo CLI's ``train --model autoencoder --synthetic`` does,
    on the JAX package's library, with the target flattened as
    ``models/autoencoder/Train.scala`` builds it (the JAX package's CLI
    passes it unflattened, which its MSECriterion cannot broadcast)."""
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
    from bigdl_tpu.models.autoencoder import Autoencoder as JAutoencoder
    from bigdl_tpu.optim import Optimizer as JOptimizer
    from bigdl_tpu.visualization import TrainSummary as JTrainSummary
    JEngine.init()
    samples = [JSample(s.feature, np.reshape(s.feature, -1))
               for s in jrun._synthetic((28, 28, 1), 10)]
    opt = JOptimizer(JAutoencoder(32), JDataSet.array(samples).transform(
        JToBatch(64, drop_last=True)), jnn.MSECriterion()) \
        .set_optim_method(JSGD(0.5, momentum=0.9, weight_decay=0.0)) \
        .set_end_when(JTrigger.max_epoch(max_epoch))
    if resume:
        opt.resume_from(*resume)
    if ckpt:
        opt.set_checkpoint(ckpt, JTrigger.every_epoch())
    if summary:
        opt.set_train_summary(JTrainSummary(summary, "bigdl_tpu"))
    opt.optimize()
    return opt


def test_cli_autoencoder_resumed_from_reference(tmp_path, capsys):
    """The reference trains the autoencoder one epoch with a checkpoint;
    it and the port's CLI resume from it for a second epoch."""
    from bigdl_tpu.common import get_default_rng
    state = get_default_rng().get_state()
    try:
        ckpt = str(tmp_path / "ckpt")
        _reference_autoencoder(ckpt, None, 1)
        mp, op, n = file_io.latest_checkpoint(ckpt)
        assert n == 8
        jopt = _reference_autoencoder(None, str(tmp_path / "j"), 2,
                                      (mp, op))
        saved = str(tmp_path / "ae.bigdl")
        topt = trun.main([
            "train", "--model", "autoencoder", "--synthetic",
            "--batch-size", "64", "--learning-rate", "0.5", "--max-epoch",
            "2", "--model-snapshot", mp, "--state-snapshot", op,
            "--summary-dir", str(tmp_path / "t"), "--device", "cpu",
            "--model-save", saved])
    finally:
        get_default_rng().set_state(state)
    assert isinstance(topt.criterion, tnn.MSECriterion)
    assert topt.validation_trigger is None
    jopt.train_summary.flush()
    topt.train_summary.flush()
    want, got = _losses(str(tmp_path / "j")), _losses(str(tmp_path / "t"))
    assert len(got) == len(want) == 8
    assert np.max(np.abs(np.subtract(got, want))) <= TRAIN_TOL, (got, want)
    trun.main(["test", "--model", "autoencoder", "--synthetic",
               "--batch-size", "64", "--snapshot", saved, "--device",
               "cpu"])
    assert "Top1Accuracy" in capsys.readouterr().out
