"""The port's recurrent layers and sequence models against the JAX
package.

- Each dense cell under ``Recurrent``, with its input half hoisted into one
  gemm and with it left in the loop (the reference's hoist cap set to 1 on
  both sides), a bare cell's single step, ``TimeDistributed`` and
  ``BiRecurrent`` under both merges: forward, input gradient and parameter
  gradients in float32 within 1e-5 of the larger of 1 and the reference's
  magnitude, and the forward in bf16 (dtype and 0.05 absolute + 0.02
  relative), as ``torch_port_harness.py`` states.
- ``PTBModel`` at the ``lstm`` config's full width (vocab 10000, embed and
  hidden 200, two layers) on B 2, T 35: the forward within 1e-5.
- A small ``PTBModel`` and ``SimpleRNN`` trained 5 steps by both packages'
  ``Optimizer`` from the same weights and batches: every loss within
  2e-3, the roadmap's training-parity bound.
- Variational dropout: one mask of shape (B,) + x.shape[2:] for every
  step, repeatable under one generator, none without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import rnn as jrnn
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import rnn as trnn
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.utils.convert import load_reference_tree
from torch_port_harness import (build_pair, close, module_bf16,
                                module_parity, x)

TRAIN_TOL = 2e-3
STEPS = 5

CELLS = {
    "RnnCell": lambda nn: nn.RnnCell(5, 6),
    "RnnCell_relu": lambda nn: nn.RnnCell(
        5, 6, jax.nn.relu if nn is jnn else torch.relu),
    "LSTM": lambda nn: nn.LSTM(5, 6),
    "LSTMPeephole": lambda nn: nn.LSTMPeephole(5, 6),
    "GRU": lambda nn: nn.GRU(5, 6),
}


@pytest.fixture(params=["hoisted", "per_step"])
def hoist(request, monkeypatch):
    if request.param == "per_step":
        monkeypatch.setenv("BIGDL_TPU_RNN_HOIST_MAX_ELEMENTS", "1")
        monkeypatch.setenv("BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS", "1")
    return request.param


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_recurrent_matches_reference(cell, hoist):
    make = CELLS[cell]
    tm = module_parity(jnn.Recurrent(make(jnn)), tnn.Recurrent(make(tnn)),
                       x((3, 4, 5)))
    proj = tm.layers[0].project_inputs(torch.zeros((4, 3, 5)))
    assert (proj is None) == (hoist == "per_step")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_recurrent_bf16(cell):
    make = CELLS[cell]
    module_bf16(jnn.Recurrent(make(jnn)), tnn.Recurrent(make(tnn)),
                x((3, 4, 5)))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bare_cell_is_one_step(cell):
    """A cell on (batch, features): one step from the zero state."""
    make = CELLS[cell]
    module_parity(make(jnn), make(tnn), x((3, 5)))


@pytest.mark.parametrize("merge", ["sum", "concat"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_birecurrent_matches_reference(cell, merge):
    make = CELLS[cell]
    tm = module_parity(jnn.BiRecurrent(make(jnn), merge),
                       tnn.BiRecurrent(make(tnn), merge), x((2, 5, 5)))
    assert tm.layers[0].layers[0] is not tm.layers[1].layers[0]


def test_time_distributed_matches_reference():
    module_parity(jnn.TimeDistributed(jnn.Linear(5, 3)),
                  tnn.TimeDistributed(tnn.Linear(5, 3)), x((2, 4, 5)))


def test_return_state():
    """``_return_state`` gives (outputs, the last hidden state)."""
    m = tnn.Recurrent(tnn.LSTM(5, 6)).build("cpu")
    out = m(torch.from_numpy(x((3, 4, 5))))
    m._return_state = True
    out2, (h, c) = m(torch.from_numpy(x((3, 4, 5))))
    assert torch.equal(out, out2) and torch.equal(h, out[:, -1])
    assert c.shape == (3, 6)


def test_ptb_model_full_width_forward():
    """The ``lstm`` config's model (vocab 10000, 200, 200, two layers) on
    B 2, T 35 from the reference's weights."""
    jm, tm = build_pair(jrnn.PTBModel(10000, 200, 200),
                        trnn.PTBModel(10000, 200, 200))
    toks = np.random.RandomState(0).randint(0, 10000, (2, 35)).astype(
        np.int32)
    jy, _ = jm.apply(jm.params, jm.state, jnp.asarray(toks), training=False)
    with torch.inference_mode():
        ty = tm.eval()(torch.from_numpy(toks))
    assert ty.shape == (2, 35, 10000)
    close(ty, jy)


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


def _train_both(jm, tm, xs, ys, jcrit, tcrit, batch):
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    jlosses, tlosses = {}, {}
    JEngine.init(devices=jax.devices()[:2])
    try:
        JOptimizer(jm, JDataSet.array([JSample.from_ndarray(a, b)
                                       for a, b in zip(xs, ys)]),
                   jcrit, batch_size=batch) \
            .set_optim_method(JSGD(0.1)) \
            .set_end_when(_recorder(JTrigger, jlosses)).optimize()
    finally:
        JEngine.reset()
    Optimizer(tm, DataSet.array([Sample.from_ndarray(a, b)
                                 for a, b in zip(xs, ys)]),
              tcrit, batch_size=batch, device="cpu") \
        .set_optim_method(SGD(0.1)) \
        .set_end_when(_recorder(Trigger, tlosses)).optimize()
    assert sorted(tlosses) == sorted(jlosses) == list(range(1, STEPS + 1))
    for k in jlosses:
        assert np.isfinite(tlosses[k])
        assert abs(tlosses[k] - jlosses[k]) <= TRAIN_TOL, (k, tlosses,
                                                           jlosses)
    assert tlosses[STEPS] != tlosses[1]


def test_small_ptb_trains_like_reference():
    jm = jrnn.PTBModel(61, 12, 16).build(jax.random.key(0))
    tm = trnn.PTBModel(61, 12, 16).build("cpu")
    toks = np.random.RandomState(1).randint(0, 61, (4 * STEPS, 9))
    toks = toks.astype(np.int32)
    _train_both(jm, tm, toks[:, :-1], toks[:, 1:],
                jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), True),
                tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(), True),
                batch=4)


def test_simple_rnn_trains_like_reference():
    """SimpleRNN on one-hot characters with
    TimeDistributedCriterion(CrossEntropyCriterion()), the reference's
    char-LM pairing."""
    V = 11
    jm = jrnn.SimpleRNN(V, 16, V).build(jax.random.key(2))
    tm = trnn.SimpleRNN(V, 16, V).build("cpu")
    toks = np.random.RandomState(3).randint(0, V, (4 * STEPS, 8))
    xs = np.eye(V, dtype=np.float32)[toks[:, :-1]]
    ys = toks[:, 1:].astype(np.int32)
    _train_both(jm, tm, xs, ys,
                jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(),
                                             True),
                tnn.TimeDistributedCriterion(tnn.CrossEntropyCriterion(),
                                             True), batch=4)


def test_variational_dropout_mask():
    """One keep-mask of shape (B,) + x.shape[2:] for every step, scaled by
    1 / keep; the same under one generator state; none in eval or without
    a generator (the reference without a key)."""
    m = tnn.Recurrent(tnn.LSTM(6, 4, p=0.5)).build("cpu").train()
    xt = torch.ones((8, 5, 6))
    with tnn.dropout_rng(torch.Generator().manual_seed(1)):
        d1 = m._dropped(xt)
    with tnn.dropout_rng(torch.Generator().manual_seed(1)):
        d2 = m._dropped(xt)
    assert torch.equal(d1, d2)
    assert torch.equal(d1, d1[:, :1].expand_as(d1))
    assert set(d1.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(m._dropped(xt), xt)
    with tnn.dropout_rng(torch.Generator().manual_seed(1)):
        assert torch.equal(m.eval()._dropped(xt), xt)
        m.train()
        y1 = m(xt)
    with tnn.dropout_rng(torch.Generator().manual_seed(1)):
        assert torch.equal(m(xt), y1)


def test_simple_rnn_save_load(tmp_path):
    """The port's module file keeps the cell's activation."""
    m = trnn.SimpleRNN(5, 6, 3).build("cpu")
    m.save(str(tmp_path / "rnn.bigdl"))
    back = tnn.Module.load(str(tmp_path / "rnn.bigdl"), device="cpu")
    xt = torch.from_numpy(x((2, 4, 5)))
    assert torch.equal(back(xt), m(xt))
