"""Resume of the port against the JAX package, both ways.

- The JAX ``Optimizer`` trains 2 steps and checkpoints; then the port and
  the JAX package each ``resume_from`` that pair and train 3 more steps.
  The losses agree within 2e-3, the training-parity bound (``ROADMAP.md``
  conventions).  Run for a small ResNet (SGD with momentum and weight
  decay, an ``L2Regularizer`` on its head) and for a small TransformerLM
  (Adam with L2-norm clipping at 0.5).
- The port writes the pair and the JAX package resumes, likewise.
- In the port alone: a run resumed from its own pair gives the
  uninterrupted run's losses bit for bit on the CPU, the Dropout
  generator's state included (an LM with dropout 0.2).
- A corrupt newest pair is quarantined and resume falls back to the older
  one, loudly; with no valid pair the error propagates; nothing changes
  in the model before both blobs have been read and checked.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Adam as JAdam
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import regularizer as jreg
from bigdl_tpu.utils import file_io as jio

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Adam as TAdam
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.optim import regularizer as treg
from bigdl_torch.utils import file_io as tio
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

TOL = 2e-3
FIRST, MORE, BATCH = 2, 3, 8


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _small_resnet(mod, nn, reg):
    m = nn.Sequential()
    m.add(mod._conv(3, 8, 3, 3, 2, 2, 1, 1))
    m.add(nn.SpatialBatchNormalization(8)).add(nn.ReLU())
    b1, ch = mod._bottleneck(8, 4, 2, "B")
    m.add(nn.Sequential().add(b1))
    m.add(nn.SpatialAveragePooling(4, 4, 1, 1))
    m.add(nn.Reshape((ch,)))
    m.add(nn.Linear(ch, 10, w_regularizer=reg.L2Regularizer(1e-2)))
    return m


LM_CFG = dict(vocab_size=53, max_len=12, d_model=32, num_heads=4,
              num_layers=2)


def _case(kind):
    """(make a JAX model, make a port model, criterion maker, method maker
    per package, clip norm, (x, y))."""
    rs = np.random.RandomState(3)
    if kind == "resnet":
        x = rs.standard_normal((16, 16, 16, 3)).astype(np.float32)
        y = rs.randint(0, 10, 16).astype(np.int32)
        return (lambda: _small_resnet(jresnet, jnn, jreg),
                lambda: _small_resnet(tresnet, tnn, treg),
                lambda nn: nn.CrossEntropyCriterion(),
                lambda SGD, Adam: SGD(0.1, momentum=0.9, weight_decay=1e-4),
                None, (x, y))
    toks = rs.randint(0, LM_CFG["vocab_size"],
                      (16, LM_CFG["max_len"] + 1)).astype(np.int32)
    return (lambda: jlm.TransformerLM(**LM_CFG),
            lambda: tlm.TransformerLM(**LM_CFG),
            lambda nn: nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                   size_average=True),
            lambda SGD, Adam: Adam(3e-3), 0.5, (toks[:, :-1], toks[:, 1:]))


def _recorder(Trigger, losses, last):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > last
    return Trigger(fn, "record")


def _jax_opt(kind, model):
    _, _, crit, meth, clip, (x, y) = _case(kind)
    opt = JOptimizer(model, JDataSet.array(
        [JSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        crit(jnn), batch_size=BATCH)
    opt.set_optim_method(meth(JSGD, JAdam))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    return opt


def _port_opt(kind, model):
    _, _, crit, meth, clip, (x, y) = _case(kind)
    opt = TOptimizer(model, TDataSet.array(
        [TSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        crit(tnn), batch_size=BATCH, device="cpu")
    opt.set_optim_method(meth(TSGD, TAdam))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    return opt


def _resume_both(kind, pair):
    """Resume a JAX and a port Optimizer from ``pair``, MORE steps each;
    returns their losses by iteration."""
    jl, tl = {}, {}
    jm = _case(kind)[0]()
    jopt = _jax_opt(kind, jm).resume_from(*pair[:2])
    jopt.set_end_when(_recorder(JTrigger, jl, FIRST + MORE)).optimize()
    tm = _case(kind)[1]()
    topt = _port_opt(kind, tm).resume_from(*pair[:2])
    topt.set_end_when(_recorder(TTrigger, tl, FIRST + MORE)).optimize()
    return jl, tl


def _agree(jl, tl):
    # iteration FIRST's loss is the one the snapshot's driver state holds
    want = list(range(FIRST, FIRST + MORE + 1))
    assert sorted(jl) == sorted(tl) == want, (jl, tl)
    for k in want:
        assert np.isfinite(tl[k]) and abs(tl[k] - jl[k]) <= TOL, (k, tl, jl)


@pytest.mark.parametrize("kind", ["resnet", "lm"])
def test_port_resumes_a_reference_pair(kind, tmp_path, caplog):
    JEngine.init()
    jm = _case(kind)[0]()
    jm.build(jax.random.key(0))
    first = {}
    opt = _jax_opt(kind, jm)
    opt.set_checkpoint(str(tmp_path), JTrigger.several_iteration(1))
    opt.set_end_when(_recorder(JTrigger, first, FIRST)).optimize()
    pair = jio.latest_checkpoint(str(tmp_path))
    assert pair[2] == FIRST
    with caplog.at_level(logging.INFO, logger="bigdl_torch"):
        jl, tl = _resume_both(kind, pair)
    assert "no torch counterpart" in caplog.text
    _agree(jl, tl)


@pytest.mark.parametrize("kind", ["resnet", "lm"])
def test_reference_resumes_a_port_pair(kind, tmp_path):
    JEngine.init()
    jm = _case(kind)[0]()
    jm.build(jax.random.key(0))
    tm = _case(kind)[1]().build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    first = {}
    opt = _port_opt(kind, tm)
    opt.set_checkpoint(str(tmp_path), TTrigger.several_iteration(1))
    opt.set_end_when(_recorder(TTrigger, first, FIRST)).optimize()
    pair = tio.latest_checkpoint(str(tmp_path))
    assert pair[2] == FIRST
    jl, tl = _resume_both(kind, pair)
    _agree(jl, tl)


# -- the port alone: resumed equals uninterrupted ------------------------------

def _every_two_done():
    """Once after every 2nd finished iteration (``several_iteration(2)``
    reads the driver's neval, one ahead of the iterations done, and asks
    again at an epoch's end)."""
    box = {"last": None}

    def fn(state):
        done = state["neval"] - 1
        if done % 2 or done == box["last"]:
            return False
        box["last"] = done
        return True
    return TTrigger(fn, "everyTwoDone")


def _dropout_lm_run(path, last, resume=None, shuffles=0):
    m = tlm.TransformerLM(**LM_CFG, dropout=0.2).build(
        "cpu", torch.Generator().manual_seed(1))
    _, _, crit, _, _, (x, y) = _case("lm")
    ds = TDataSet.array([TSample.from_ndarray(x[i], y[i])
                         for i in range(len(x))])
    for _ in range(shuffles):
        ds.shuffle()
    opt = TOptimizer(m, ds, crit(tnn), batch_size=BATCH, device="cpu")
    opt.set_optim_method(TAdam(3e-3)).set_gradient_clipping_by_l2_norm(0.5)
    opt.set_checkpoint(path, _every_two_done())
    if resume is not None:
        opt.resume_from(*resume[:2])
    losses = {}
    opt.set_end_when(_recorder(TTrigger, losses, last)).optimize()
    return losses, m


def test_resume_equals_uninterrupted_run(tmp_path):
    """Two batches an epoch, a snapshot every 2 iterations: the pair of
    iteration 2 ends epoch 1.  The resumed run's dataset is shuffled once
    first (its permutation is not in the snapshot, as in the reference),
    so iterations 3 and 4 see the batches the uninterrupted run saw."""
    full, fm = _dropout_lm_run(str(tmp_path / "a"), 4)
    pair = (str(tmp_path / "a" / "model.2"),
            str(tmp_path / "a" / "optimMethod.2"))
    resumed, rm = _dropout_lm_run(str(tmp_path / "b"), 4, pair, shuffles=1)
    assert sorted(resumed) == [2, 3, 4]
    assert [resumed[k] for k in (3, 4)] == [full[k] for k in (3, 4)]
    for a, b in zip(jax.tree.leaves(to_reference_tree(rm)),
                    jax.tree.leaves(to_reference_tree(fm))):
        assert np.array_equal(a, b)
    # without the generator's state the masks, and the losses, differ
    oblob = tio.load(pair[1])
    oblob["torch_rng_state"] = oblob["torch_rng_states"] = None
    tio.save(oblob, str(tmp_path / "optimMethod.2"))
    fresh, _ = _dropout_lm_run(str(tmp_path / "c"), 4,
                               (pair[0], str(tmp_path / "optimMethod.2")),
                               shuffles=1)
    assert fresh[3] != full[3]


def test_corrupt_pair_falls_back_to_the_older(tmp_path, caplog):
    d = str(tmp_path)
    full, _ = _dropout_lm_run(d, 4)
    assert [n for _, _, n in tio.checkpoint_lineage(d)] == [4, 2]
    mp4 = os.path.join(d, "model.4")
    data = open(mp4, "rb").read()
    open(mp4, "wb").write(data[:100] + bytes([data[100] ^ 1]) + data[101:])
    m = tlm.TransformerLM(**LM_CFG, dropout=0.2).build("cpu")
    before = [p.detach().clone() for p in m.parameters()]
    opt = _port_lm(m)
    with caplog.at_level(logging.WARNING, logger="bigdl_torch"):
        opt.resume_from(mp4, os.path.join(d, "optimMethod.4"))
    assert "quarantining" in caplog.text
    assert os.path.exists(mp4 + ".corrupt")
    assert os.path.exists(os.path.join(d, "optimMethod.4.corrupt"))
    assert opt._resume_state["neval"] == 3          # the pair of iteration 2
    assert not all(torch.equal(a, b) for a, b in zip(before, m.parameters()))
    # no valid pair left: the error propagates, the model unchanged
    mp2 = os.path.join(d, "model.2")
    open(mp2, "wb").write(open(mp2, "rb").read()[:-30])
    m2 = tlm.TransformerLM(**LM_CFG, dropout=0.2).build("cpu")
    before = [p.detach().clone() for p in m2.parameters()]
    with pytest.raises(tio.CorruptCheckpoint):
        _port_lm(m2).resume_from(mp2, os.path.join(d, "optimMethod.2"))
    assert os.path.exists(mp2 + ".corrupt")
    assert all(torch.equal(a, b) for a, b in zip(before, m2.parameters()))


def test_resume_checks_both_blobs_before_changing_anything(tmp_path):
    d = str(tmp_path)
    _dropout_lm_run(d, 2)
    m = tlm.TransformerLM(**LM_CFG, dropout=0.2).build("cpu")
    before = [p.detach().clone() for p in m.parameters()]
    opt = _port_lm(m)
    opt.set_optim_method(TSGD(0.1, momentum=0.9))     # another method's slots
    with pytest.raises(ValueError, match="slots"):
        opt.resume_from(os.path.join(d, "model.2"),
                        os.path.join(d, "optimMethod.2"))
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))
    # a model of another shape
    other = tlm.TransformerLM(**{**LM_CFG, "d_model": 16},
                              dropout=0.2).build("cpu")
    with pytest.raises(ValueError, match="shape"):
        _port_lm(other).resume_from(os.path.join(d, "model.2"))


def _port_lm(model):
    _, _, crit, _, _, (x, y) = _case("lm")
    opt = TOptimizer(model, TDataSet.array(
        [TSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        crit(tnn), batch_size=BATCH, device="cpu")
    return opt.set_optim_method(TAdam(3e-3))
