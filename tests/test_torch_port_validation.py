"""Validation and bulk inference of the port against the JAX package.

- Every validation method on the same numpy arrays: counts exact, sums
  within 1e-6, and ``+`` of two batches' results as the reference's.
- ``Evaluator.test``, ``Validator.test``, ``Module.evaluate``,
  ``Predictor.predict`` and ``predict_class`` (over a DataSet and over a
  list of Samples) against the reference's on a small bottleneck ResNet and
  a small TransformerLM with the same weights, 21 samples at batch 8, so the
  last batch is padded from 5 valid rows.
- ``Optimizer.set_validation``: both packages' ``Optimizer`` train the
  small ResNet 2 epochs of 2 steps and validate at every epoch's end;
  the driver state's results per epoch agree, and the port's validation
  leaves the model as it found it (training mode, running statistics bit
  for bit, the Dropout generator not drawn from).
- Under a group of two gloo ranks, each scoring its own rows of a
  ``DistributedDataSet``, the summed results equal one process's.

Tolerances: accuracy counts exact; float32 outputs and losses of the same
weights within 1e-5 (summation order only); after training, validation
losses within 1e-5 of the reference's (SGD at lr 0.01 keeps the two
trajectories within float32 rounding of each other).
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
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Evaluator as JEvaluator
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Predictor as JPredictor
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import Validator as JValidator
from bigdl_tpu.optim import validation as jval

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.dataset import SampleToMiniBatch as TSampleToMiniBatch
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Evaluator as TEvaluator
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Predictor as TPredictor
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.optim import Validator as TValidator
from bigdl_torch.optim import validation as tval
from bigdl_torch.utils.convert import load_reference_tree

SUM_TOL = 1e-6
OUT_TOL = 1e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    """The JAX Optimizer draws keys from the JAX package's default stream;
    put it back for the tests after this file."""
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


# -- the methods on the same arrays ------------------------------------------

def _method_cases(v, nn):
    return {
        "top1": (v.Top1Accuracy(), "cls"),
        "top1_one_based": (v.Top1Accuracy(one_based=True), "cls1"),
        "top5": (v.Top5Accuracy(), "cls"),
        "loss_nll": (v.Loss(), "logp"),
        "loss_cross_entropy": (v.Loss(nn.CrossEntropyCriterion()), "cls"),
        "loss_time_distributed": (v.Loss(nn.TimeDistributedCriterion(
            nn.ClassNLLCriterion(), size_average=True)), "seq"),
        "perplexity": (v.Perplexity(), "seq"),
        "mae": (v.MAE(), "cls"),
        "hit_ratio": (v.HitRatio(k=3), "rank"),
        "ndcg": (v.NDCG(k=3), "rank"),
        "tree_nn": (v.TreeNNAccuracy(), "tree"),
    }


def _arrays(kind, seed):
    rs = np.random.RandomState(seed)
    if kind in ("cls", "cls1", "logp"):
        o = rs.standard_normal((13, 10)).astype(np.float32)
        if kind == "logp":
            o = o - np.log(np.exp(o).sum(-1, keepdims=True))
        t = rs.randint(0, 10, 13).astype(np.int32) + (kind == "cls1")
        return o, t
    if kind == "seq":
        o = rs.standard_normal((3, 5, 11)).astype(np.float32)
        o = o - np.log(np.exp(o).sum(-1, keepdims=True))
        t = rs.randint(0, 11, (3, 5)).astype(np.int32)
        t[0, 4] = -1                                   # a padded step
        return o, t
    if kind == "rank":
        return (rs.standard_normal(20).astype(np.float32),
                (rs.rand(20) < 0.2).astype(np.float32))
    o = rs.standard_normal((6, 4, 3)).astype(np.float32)    # tree
    return o, rs.randint(0, 3, 6).astype(np.int32)


def _fields(res):
    return {k: v for k, v in vars(res).items()}


def _same_result(got, want):
    gf, wf = _fields(got), _fields(want)
    assert sorted(gf) == sorted(wf) and type(got).__name__ == \
        type(want).__name__
    for k in wf:
        if k == "count" or k == "correct":
            assert gf[k] == wf[k], (k, gf, wf)
        else:
            assert abs(gf[k] - wf[k]) <= SUM_TOL * max(1.0, abs(wf[k])), \
                (k, gf, wf)
    g, w = got.result(), want.result()
    assert g[1] == w[1] and abs(g[0] - w[0]) <= SUM_TOL * max(1.0, abs(w[0]))


@pytest.mark.parametrize("name", sorted(_method_cases(tval, tnn)))
def test_validation_method_like_reference(name):
    tm, kind = _method_cases(tval, tnn)[name]
    jm, _ = _method_cases(jval, jnn)[name]
    parts = [_arrays(kind, s) for s in (0, 1)]
    results = []
    for o, t in parts:
        got, want = tm(o, t), jm(o, t)
        _same_result(got, want)
        results.append((got, want))
    _same_result(results[0][0] + results[1][0],
                 results[0][1] + results[1][1])
    assert tm.name == jm.name and repr(tm) == repr(jm)


# -- Evaluator, Validator, Module.evaluate, Predictor --------------------------

N, BATCH = 21, 8


def _small_resnet(mod, nn):
    m = nn.Sequential()
    m.add(mod._conv(3, 8, 3, 3, 2, 2, 1, 1))
    m.add(nn.SpatialBatchNormalization(8)).add(nn.ReLU())
    b1, ch = mod._bottleneck(8, 4, 2, "B")
    m.add(nn.Sequential().add(b1))
    m.add(nn.SpatialAveragePooling(4, 4, 1, 1))
    m.add(nn.Reshape((ch,))).add(nn.Linear(ch, 10))
    return m


LM_CFG = dict(vocab_size=53, max_len=12, d_model=32, num_heads=4,
              num_layers=2)


def _pair(kind):
    """(JAX model, port model on the CPU with its weights, samples as
    (x, y) arrays)."""
    rs = np.random.RandomState(5)
    if kind == "resnet":
        jm = _small_resnet(jresnet, jnn)
        jm.build(jax.random.key(1))
        tm = _small_resnet(tresnet, tnn).build("cpu")
        x = rs.standard_normal((N, 16, 16, 3)).astype(np.float32)
        y = rs.randint(0, 10, N).astype(np.int32)
    else:
        jm = jlm.TransformerLM(**LM_CFG).build(jax.random.key(1))
        tm = tlm.TransformerLM(**LM_CFG).build("cpu")
        toks = rs.randint(0, LM_CFG["vocab_size"],
                          (N, LM_CFG["max_len"] + 1)).astype(np.int32)
        x, y = toks[:, :-1], toks[:, 1:]
    # running statistics other than (0, 1), so eval mode reads them
    state = jax.tree.map(
        lambda a: np.asarray(a) + rs.uniform(0.1, 0.5, a.shape).astype(
            np.asarray(a).dtype), jm.state)
    jm.state = jax.tree.map(jnp.asarray, state)
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params), state)
    return jm, tm, x, y


def _methods(v, nn, kind):
    if kind == "resnet":
        return [v.Top1Accuracy(), v.Top5Accuracy(),
                v.Loss(nn.CrossEntropyCriterion())]
    return [v.Loss(nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                               size_average=True)),
            v.Perplexity()]


def _samples(Sample, x, y):
    return [Sample.from_ndarray(x[i], y[i]) for i in range(len(x))]


@pytest.mark.parametrize("kind", ["resnet", "lm"])
def test_evaluation_entry_points_like_reference(kind):
    jm, tm, x, y = _pair(kind)
    JEngine.init()
    want = JEvaluator(jm).test(JDataSet.array(_samples(JSample, x, y)),
                               _methods(jval, jnn, kind), BATCH)
    runs = {
        "evaluator": TEvaluator(tm, device="cpu").test(
            TDataSet.array(_samples(TSample, x, y)),
            _methods(tval, tnn, kind), BATCH),
        "evaluator_batches": TEvaluator(tm, device="cpu").test(
            TDataSet.array(_samples(TSample, x, y)).transform(
                TSampleToMiniBatch(BATCH, pad_last=True)),
            _methods(tval, tnn, kind)),
        "validator": TValidator(tm, _samples(TSample, x, y),
                                device="cpu").test(
            _methods(tval, tnn, kind), BATCH),
        "module_evaluate": tm.evaluate(_samples(TSample, x, y),
                                       _methods(tval, tnn, kind), BATCH),
    }
    jv = JValidator(jm, _samples(JSample, x, y)).test(
        _methods(jval, jnn, kind), BATCH)
    for name, got in runs.items():
        assert len(got) == len(want)
        for (gm, gr), (wm, wr), (_, vr) in zip(got, want, jv):
            assert gm.name == wm.name
            assert gr.count == wr.count == vr.count
            for k, v in _fields(wr).items():
                if k == "correct":
                    assert _fields(gr)[k] == v, (name, gm, gr, wr)
                elif k != "count":
                    assert abs(_fields(gr)[k] - v) <= OUT_TOL * max(1, abs(v))
    # eval mode stays, as the reference's evaluate leaves it
    assert not tm.training
    tm.train()
    assert tm.evaluate() is tm and not tm.training


@pytest.mark.parametrize("kind", ["resnet", "lm"])
def test_prediction_like_reference(kind):
    jm, tm, x, y = _pair(kind)
    JEngine.init()
    want = np.asarray(JPredictor(jm, batch_size=BATCH).predict(
        JDataSet.array(_samples(JSample, x, y))))
    assert want.shape[0] == N
    pred = TPredictor(tm, batch_size=BATCH, device="cpu")
    for got in (pred.predict(TDataSet.array(_samples(TSample, x, y))),
                pred.predict(_samples(TSample, x, y)),
                tm.predict(_samples(TSample, x, y), batch_size=BATCH),
                pred.predict(x)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    wc = np.asarray(JPredictor(jm, batch_size=BATCH).predict_class(
        JDataSet.array(_samples(JSample, x, y))))
    for got in (pred.predict_class(_samples(TSample, x, y)),
                tm.predict_class(_samples(TSample, x, y), batch_size=BATCH)):
        np.testing.assert_array_equal(got, wc)


def test_pad_last_batches():
    from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
    x = np.arange(21 * 2, dtype=np.float32).reshape(21, 2)
    y = np.arange(21, dtype=np.int32)
    got = list(TSampleToMiniBatch(8, pad_last=True)(
        iter(_samples(TSample, x, y))))
    want = list(JSampleToMiniBatch(8, pad_last=True)(
        iter(_samples(JSample, x, y))))
    assert [b.valid for b in got] == [b.valid for b in want] == [8, 8, 5]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.get_input(), w.get_input())
        # the reference keeps a scalar label as a (1,) array
        np.testing.assert_array_equal(g.get_target(),
                                      w.get_target().reshape(-1))


# -- set_validation inside the Optimizer --------------------------------------

EPOCHS, TRAIN_N, TRAIN_BATCH = 2, 16, 8


def _epoch_recorder(Trigger, seen):
    """End trigger after EPOCHS epochs recording, at each epoch's start,
    the validation fields of the driver state."""
    def fn(state):
        if "val_obs" in state and state["epoch"] - 1 not in seen:
            seen[state["epoch"] - 1] = {
                k: state[k] for k in ("val_obs", "score", "val_loss",
                                      "Top1Accuracy", "Top5Accuracy",
                                      "Loss")}
        return state["epoch"] > EPOCHS
    return Trigger(fn, "epochs")


def test_set_validation_like_reference():
    jm, tm, _, _ = _pair("resnet")
    rs = np.random.RandomState(9)
    x = rs.standard_normal((TRAIN_N, 16, 16, 3)).astype(np.float32)
    y = rs.randint(0, 10, TRAIN_N).astype(np.int32)
    vx = rs.standard_normal((N, 16, 16, 3)).astype(np.float32)
    vy = rs.randint(0, 10, N).astype(np.int32)
    JEngine.init()
    jseen, tseen = {}, {}
    jopt = JOptimizer(jm, JDataSet.array(_samples(JSample, x, y)),
                      jnn.CrossEntropyCriterion(), batch_size=TRAIN_BATCH)
    jopt.set_optim_method(JSGD(0.01, momentum=0.9))
    jopt.set_validation(JTrigger.every_epoch(), _samples(JSample, vx, vy),
                        _methods(jval, jnn, "resnet"), BATCH)
    jopt.set_end_when(_epoch_recorder(JTrigger, jseen)).optimize()

    topt = TOptimizer(tm, TDataSet.array(_samples(TSample, x, y)),
                      tnn.CrossEntropyCriterion(), batch_size=TRAIN_BATCH,
                      device="cpu")
    topt.set_optim_method(TSGD(0.01, momentum=0.9))
    topt.set_validation(TTrigger.every_epoch(), _samples(TSample, vx, vy),
                        _methods(tval, tnn, "resnet"), BATCH)
    # the validation forward must leave the model as it found it
    checks = []
    run = topt._run_validation

    def watched():
        before = [b.clone() for b in tm.buffers()]
        out = run()
        checks.append((tm.training,
                       all(torch.equal(a, b)
                           for a, b in zip(before, tm.buffers()))))
        return out
    topt._run_validation = watched
    topt.set_end_when(_epoch_recorder(TTrigger, tseen)).optimize()

    assert sorted(tseen) == sorted(jseen) == list(range(1, EPOCHS + 1))
    for e in jseen:
        g, w = tseen[e], jseen[e]
        assert g["val_obs"] == w["val_obs"] == e
        for k in ("score", "Top1Accuracy", "Top5Accuracy"):
            assert g[k] == w[k], (e, k, g, w)
        for k in ("val_loss", "Loss"):
            assert abs(g[k] - w[k]) <= OUT_TOL, (e, k, g, w)
    assert checks == [(True, True)] * EPOCHS


def test_validation_leaves_dropout_generator_alone():
    """A validation forward in the middle of training draws no Dropout
    mask: the losses after it equal a run without validation."""
    def run(validate):
        torch.manual_seed(0)
        m = tlm.TransformerLM(**LM_CFG, dropout=0.2).build(
            "cpu", torch.Generator().manual_seed(4))
        rs = np.random.RandomState(2)
        toks = rs.randint(0, LM_CFG["vocab_size"], (16, 13)).astype(np.int32)
        samples = _samples(TSample, toks[:, :-1], toks[:, 1:])
        losses = []

        def end(state):
            if state["neval"] > 1:
                losses.append(state["loss"])
            return state["neval"] > 4
        opt = TOptimizer(m, TDataSet.array(samples),
                         tnn.TimeDistributedCriterion(
                             tnn.ClassNLLCriterion(), size_average=True),
                         batch_size=4, device="cpu")
        opt.set_optim_method(TSGD(0.05))
        if validate:
            opt.set_validation(TTrigger.several_iteration(1), samples[:6],
                               [tval.Perplexity()], 4)
        opt.set_end_when(TTrigger(end)).optimize()
        return losses
    assert run(True) == run(False)


_GROUP_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import torch
    import bigdl_torch.nn as nn
    from bigdl_torch import Engine
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.optim import (Optimizer, SGD, Trigger, Top1Accuracy,
                                   Top5Accuracy, Loss)

    def model():
        return (nn.Sequential().add(nn.Linear(6, 16)).add(nn.ReLU())
                .add(nn.Linear(16, 5)))

    def run(distributed):
        rs = np.random.RandomState(0)
        x = rs.standard_normal((32, 6)).astype(np.float32)
        y = rs.randint(0, 5, 32).astype(np.int32)
        vx = rs.standard_normal((22, 6)).astype(np.float32)
        vy = rs.randint(0, 5, 22).astype(np.int32)
        s = lambda a, b: [Sample(a[i], b[i]) for i in range(len(a))]
        m = model().build("cpu", torch.Generator().manual_seed(1))
        opt = Optimizer(m, DataSet.array(s(x, y), distributed=distributed),
                        nn.CrossEntropyCriterion(),
                        batch_size=8 if distributed else 16, device="cpu")
        opt.set_optim_method(SGD(0.1))
        opt.set_validation(Trigger.every_epoch(),
                           DataSet.array(s(vx, vy), distributed=distributed),
                           [Top1Accuracy(), Top5Accuracy(),
                            Loss(nn.CrossEntropyCriterion())], 4)
        opt.set_end_when(Trigger.max_epoch(1)).optimize()
        return [(type(r).__name__, vars(r)) for _, r in opt.last_validation]

    if sys.argv[2] == "group":
        Engine.init(device="cpu")
        out = run(True)
        Engine.reset()
    else:
        out = run(False)
    pickle.dump(out, open(sys.argv[1], "wb"))
''')


def test_validation_sums_over_a_group(tmp_path):
    """Two gloo ranks each score their 11 rows of 22 (batches of 4, the
    last padded) and sum the results in one all-reduce: the counts are one
    process's over all 22 rows, the loss sum the same within float32
    order."""
    (tmp_path / "worker.py").write_text(_GROUP_WORKER)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp_path / 'store'}",
           "BIGDL_TORCH_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"),
         str(tmp_path / f"out.{i}"), "group"],
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    procs.append(subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"),
         str(tmp_path / "out.single"), "single"],
        env={**os.environ, "PYTHONPATH": _REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    got = [pickle.load(open(tmp_path / f"out.{i}", "rb")) for i in range(2)]
    single = pickle.load(open(tmp_path / "out.single", "rb"))
    assert got[0] == got[1]
    for (gn, g), (sn, s) in zip(got[0], single):
        assert gn == sn and g["count"] == s["count"] == 22
        if "correct" in s:
            assert isinstance(g["correct"], float)
            assert g["correct"] == s["correct"]
        else:
            assert abs(g["loss"] - s["loss"]) <= OUT_TOL * abs(s["loss"])
