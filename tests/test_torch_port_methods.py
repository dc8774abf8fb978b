"""The optimization methods, schedules, regularizers, triggers and gradient
clipping of the port against the JAX package.

- Every method (``SGD`` with its options, ``Adam``, ``Adagrad``,
  ``Adadelta``, ``Adamax``, ``RMSprop``): 5 updates from the same params and
  the same numpy-seeded gradients, on a small bottleneck ResNet's tree and a
  small TransformerLM's, the learning rate read from each package's own
  ``get_learning_rate`` at every step.  The port's per-parameter state lists
  are mapped to the reference's trees (``utils/convert.py``) and compared
  leaf by leaf, Adam's and Adamax's int32 step count exactly.
- Every schedule: its lr at 30 iterations spread over 4 epochs, as cases of
  one test, each package driving its own state dict (``Plateau`` writes to
  it).
- The regularizers' gradients, ``apply_regularizer_grads`` over a model
  with regularized layers, and the Optimizer's constant and L2-norm
  clipping against the reference's expressions (``bigdl_tpu/optim/
  optimizer.py:845-852``).
- The new triggers over one sequence of driver states; the host-side
  ``optimize(feval, x)`` and ``state_dict`` round trip.

Tolerances, float32: params and state within 1e-6 relative to each leaf's
largest magnitude (both packages take every elementwise operation in
float32 in the same order; the bias corrections are float32 scalars that
may differ in one ulp from ``np.power`` against XLA's); lrs within 1e-7
relative (both compute in double on the host); regularizer and clipping
outputs within 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu.optim import method as jmethod
from bigdl_tpu.optim import regularizer as jreg
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim.trigger import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.nn.module import Container
from bigdl_torch.optim import method as tmethod
from bigdl_torch.optim import regularizer as treg
from bigdl_torch.optim import schedules as tsched
from bigdl_torch.optim.optimizer import Optimizer as TOptimizer
from bigdl_torch.optim.trigger import Trigger as TTrigger
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.utils.convert import to_reference_opt_state, to_reference_tree

TOL = 1e-6
LR_TOL = 1e-7
STEPS = 5


def _small_resnet():
    m = tnn.Sequential()
    m.add(tresnet._conv(3, 16, 7, 7, 2, 2, 3, 3))
    m.add(tnn.SpatialBatchNormalization(16)).add(tnn.ReLU())
    b1, ch = tresnet._bottleneck(16, 4, 1, "B")
    m.add(tnn.Sequential().add(b1))
    m.add(tnn.Reshape((ch,))).add(tnn.Linear(ch, 10))
    return m


def _small_lm():
    return tlm.TransformerLM(vocab_size=97, max_len=16, d_model=32,
                             num_heads=4, num_layers=2)


MODELS = {"resnet": _small_resnet, "lm": _small_lm}


def _tree_of(model, tensors):
    """The param-shaped tree of ``tensors`` (aligned with
    ``model.parameters()``), built by name: a container's tree is the list
    of its children's, a leaf's a dict by parameter name."""
    index = {id(p): i for i, p in enumerate(model.parameters())}

    def walk(m):
        if isinstance(m, Container):
            return [walk(c) for c in m.layers]
        return {n: tensors[index[id(getattr(m, n))]].detach().numpy()
                for n in m.param_names}
    return walk(model)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


METHODS = {
    "sgd": lambda m: m.SGD(0.1),
    "sgd_momentum_wd": lambda m: m.SGD(0.1, momentum=0.9, weight_decay=1e-4),
    "sgd_nesterov": lambda m: m.SGD(0.05, momentum=0.9, dampening=0.0,
                                    nesterov=True, weight_decay=1e-3),
    "sgd_dampening_decay": lambda m: m.SGD(0.05, learning_rate_decay=0.1,
                                           momentum=0.5, dampening=0.1),
    "adam": lambda m: m.Adam(1e-3),
    "adam_options": lambda m: m.Adam(1e-2, learning_rate_decay=0.05,
                                     beta1=0.8, beta2=0.99, epsilon=1e-6),
    "adagrad": lambda m: m.Adagrad(1e-2),
    "adagrad_wd_decay": lambda m: m.Adagrad(1e-2, learning_rate_decay=0.1,
                                            weight_decay=1e-3),
    "adadelta": lambda m: m.Adadelta(),
    "adadelta_options": lambda m: m.Adadelta(0.95, 1e-6),
    "adamax": lambda m: m.Adamax(),
    "adamax_options": lambda m: m.Adamax(1e-2, 0.85, 0.99),
    "rmsprop": lambda m: m.RMSprop(),
    "rmsprop_options": lambda m: m.RMSprop(1e-3, learning_rate_decay=0.05,
                                           decay_rate=0.9, epsilon=1e-6),
}


@pytest.mark.parametrize("tree", sorted(MODELS))
@pytest.mark.parametrize("name", sorted(METHODS))
def test_method_updates_like_reference(name, tree):
    model = MODELS[tree]().build("cpu", torch.Generator().manual_seed(3))
    params = list(model.parameters())
    # copies: on the CPU the numpy leaves share the live tensors' memory
    jparams = jax.tree.map(lambda a: jnp.asarray(a.copy()),
                           to_reference_tree(model)[0])
    tm, jm = METHODS[name](tmethod), METHODS[name](jmethod)
    tstate, jstate = tm.init_state(params), jm.init_state(jparams)
    rs = np.random.RandomState(7)
    for k in range(STEPS):
        grads = [torch.from_numpy(rs.standard_normal(tuple(p.shape))
                                  .astype(np.float32) * 0.1) for p in params]
        driver = {"evalCounter": k, "epoch": 1, "neval": k + 1}
        tlr = tm.get_learning_rate(dict(driver))
        jlr = jm.get_learning_rate(dict(driver))
        assert math.isclose(tlr, jlr, rel_tol=LR_TOL), (k, tlr, jlr)
        tstate = tm.update(grads, params, tstate, tlr)
        jparams, jstate = jm.update(
            jax.tree.map(jnp.asarray, _tree_of(model, grads)), jparams,
            jstate, jnp.float32(jlr))
    got = to_reference_tree(model)[0]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        _close(a, b, what=f"{name} params")
    gstate = to_reference_opt_state(model, tm, tstate)
    assert sorted(gstate) == sorted(jstate)
    for key in jstate:
        gl, jl = jax.tree.leaves(gstate[key]), jax.tree.leaves(jstate[key])
        assert len(gl) == len(jl), key
        for a, b in zip(gl, jl):
            if key == "t":
                assert a.dtype == np.int32 and int(a) == int(b) == STEPS
            else:
                _close(a, b, what=f"{name} {key}")


def test_adam_step_count_stays_int32():
    p = [torch.zeros(3)]
    m = tmethod.Adam(1e-3)
    st = m.init_state(p)
    for _ in range(3):
        st = m.update([torch.ones(3)], p, st, 1e-3)
    assert isinstance(st["t"], np.int32) and st["t"] == 3


def test_host_optimize_and_state_dict_like_reference():
    """``optimize(feval, x)`` on a quadratic, 4 calls, against the
    reference's; then ``state_dict`` / ``load_state_dict`` restore the
    trajectory and the hyper-parameters."""
    target = np.linspace(-1, 1, 6).astype(np.float32)

    def tfeval(x):
        d = x[0] - torch.from_numpy(target)
        return float((d * d).sum()), [2 * d]

    def jfeval(x):
        d = x["w"] - target
        return float(jnp.sum(d * d)), {"w": 2 * d}

    tm, jm = tmethod.Adam(0.1), jmethod.Adam(0.1)
    tx, jx = [torch.zeros(6)], {"w": jnp.zeros(6)}
    for _ in range(4):
        tx, tl = tm.optimize(tfeval, tx)
        jx, jl = jm.optimize(jfeval, jx)
        assert math.isclose(tl[0], jl[0], rel_tol=TOL)
    _close(tx[0].numpy(), jx["w"])
    d = tm.state_dict()
    assert d["hyper"]["evalCounter"] == 4 and d["learning_rate"] == 0.1
    again = tmethod.Adam(0.5)
    again.load_state_dict(d)
    assert again.learning_rate == 0.1 and again.hyper == tm.hyper
    for key in ("m", "v"):
        np.testing.assert_array_equal(again._opt_state[key][0].numpy(),
                                      tm._opt_state[key][0].numpy())
    assert again._opt_state["t"] == 4
    assert tm.get_hyper_parameter() == {"learningRate": 0.1}
    tm.load_hyper({"epoch": 3})
    assert tm.hyper["epoch"] == 3
    fresh = tmethod.Adam(0.1)
    fresh.optimize(tfeval, [torch.zeros(6)])
    fresh.load_state_dict({"hyper": {}, "learning_rate": 0.2})
    assert not hasattr(fresh, "_opt_state")


# -- schedules ----------------------------------------------------------------

SCHEDULES = {
    "default": lambda s: s.Default(),
    "poly": lambda s: s.Poly(0.5, 25),
    "step": lambda s: s.Step(7, 0.5),
    "multistep": lambda s: s.MultiStep([5, 12, 20], 0.3),
    "epoch_decay": lambda s: s.EpochDecay(lambda e: e // 2),
    "epoch_step": lambda s: s.EpochStep(2, 0.5),
    "natural_exp": lambda s: s.NaturalExp(6, 0.2),
    "exponential": lambda s: s.Exponential(10, 0.8),
    "exponential_stair": lambda s: s.Exponential(10, 0.8, stair_case=True),
    "epoch_schedule": lambda s: s.EpochSchedule([
        s.Regime(1, 2, {"learningRate": 0.05}),
        s.Regime(3, 4, {"learningRate": 0.01, "weightDecay": 1e-3})]),
    "plateau": lambda s: s.Plateau(monitor="loss", factor=0.5, patience=1),
    "plateau_max_cooldown": lambda s: s.Plateau(
        monitor="score", factor=0.3, patience=1, mode="max", cooldown=1,
        min_lr=0.02),
    "cosine": lambda s: s.CosineDecay(20, 0.1),
    "warmup": lambda s: s.Warmup(0.01, 5),
    "warmup_cosine": lambda s: s.Warmup(0.01, 5, after=s.CosineDecay(20)),
    "sequential": lambda s: s.SequentialSchedule()
    .add(s.Warmup(0.01, 5), 5).add(s.Poly(1.0, 20), 20),
    "sequential_plateau": lambda s: s.SequentialSchedule()
    .add(s.Step(3, 0.9), 10).add(s.Plateau(monitor="loss", patience=1), 30),
}

#: the monitored values per epoch: a loss that stalls, a score that stalls
LOSSES = [1.0, 0.9, 0.95, 0.96]
SCORES = [0.5, 0.6, 0.6, 0.55]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_like_reference(name):
    tsgd = tmethod.SGD(0.1, learning_rate_decay=0.01,
                       learning_rate_schedule=SCHEDULES[name](tsched))
    jsgd = jmethod.SGD(0.1, learning_rate_decay=0.01,
                       learning_rate_schedule=SCHEDULES[name](jsched))
    tstate, jstate = {}, {}
    for i in range(30):
        epoch = 1 + i * 4 // 30
        for st in (tstate, jstate):
            st.update(evalCounter=i, neval=i + 1, epoch=epoch,
                      loss=LOSSES[epoch - 1], score=SCORES[epoch - 1])
        got = tsgd.get_learning_rate(tstate)
        want = jsgd.get_learning_rate(jstate)
        assert math.isclose(got, want, rel_tol=LR_TOL, abs_tol=1e-12), \
            (name, i, got, want)
        assert tsgd.weight_decay == jsgd.weight_decay
    assert tstate == jstate


# -- regularizers and clipping ----------------------------------------------

REGULARIZERS = {
    "l1": lambda r: r.L1Regularizer(1e-3),
    "l2": lambda r: r.L2Regularizer(1e-2),
    "l1l2": lambda r: r.L1L2Regularizer(1e-3, 1e-2),
}


@pytest.mark.parametrize("name", sorted(REGULARIZERS))
def test_regularizer_like_reference(name):
    w = np.random.RandomState(1).standard_normal((5, 7)).astype(np.float32)
    w[0, 0] = 0.0
    treg_, jreg_ = REGULARIZERS[name](treg), REGULARIZERS[name](jreg)
    _close(treg_.grad(torch.from_numpy(w)).numpy(),
           jreg_.grad(jnp.asarray(w)))
    assert math.isclose(float(treg_.loss(torch.from_numpy(w))),
                        float(jreg_.loss(jnp.asarray(w))), rel_tol=TOL)


def _regularized(nn, reg):
    return (nn.Sequential()
            .add(nn.LookupTable(11, 6, w_regularizer=reg.L2Regularizer(1e-2)))
            .add(nn.Reshape((4 * 6,)))
            .add(nn.Linear(24, 8, w_regularizer=reg.L1Regularizer(1e-3),
                           b_regularizer=reg.L2Regularizer(1e-1)))
            .add(nn.ReLU())
            .add(nn.Linear(8, 5))
            .add(nn.Reshape((1, 1, 5)))
            .add(nn.SpatialConvolution(
                5, 3, 1, 1, w_regularizer=reg.L1L2Regularizer(1e-3, 1e-2),
                b_regularizer=reg.L1Regularizer(1e-2))))


def test_apply_regularizer_grads_like_reference():
    tm = _regularized(tnn, treg).build("cpu",
                                       torch.Generator().manual_seed(0))
    jm = _regularized(jnn, jreg)
    params = list(tm.parameters())
    rs = np.random.RandomState(2)
    grads = [torch.from_numpy(rs.standard_normal(tuple(p.shape))
                              .astype(np.float32)) for p in params]
    got = treg.apply_regularizer_grads(tm, params, grads)
    jp = jax.tree.map(jnp.asarray, to_reference_tree(tm)[0])
    want = jreg.apply_regularizer_grads(
        jm, jp, jax.tree.map(jnp.asarray, _tree_of(tm, grads)))
    gl, wl = jax.tree.leaves(_tree_of(tm, got)), jax.tree.leaves(want)
    assert len(gl) == len(wl) == len(params)
    moved = 0
    for a, b, g in zip(gl, wl, jax.tree.leaves(_tree_of(tm, grads))):
        _close(a, b)
        moved += not np.array_equal(a, g)
    assert moved == 5       # every regularized leaf, and no other


def _clipper(const=None, norm=None):
    opt = TOptimizer(tnn.Linear(2, 2), TDataSet.array(
        [TSample(np.zeros(2, np.float32), np.int32(0))]),
        tnn.ClassNLLCriterion(), device="cpu")
    if const is not None:
        opt.set_constant_gradient_clipping(*const)
    if norm is not None:
        opt.set_gradient_clipping_by_l2_norm(norm)
    return opt


def _reference_clip(grads, const=None, norm=None):
    """The reference step's clipping, expression for expression
    (``bigdl_tpu/optim/optimizer.py:845-852``)."""
    if const is not None:
        lo, hi = const
        grads = jax.tree.map(lambda g: jnp.clip(g, lo, hi), grads)
    if norm is not None:
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                             for g in jax.tree.leaves(grads)))
        scale = jnp.minimum(1.0, norm / (gnorm + 1e-12))
        grads = jax.tree.map(lambda g: g * scale, grads)
    return grads


@pytest.mark.parametrize("const,norm", [
    ((-0.5, 0.3), None), (None, 1.0), (None, 100.0), ((-0.5, 0.3), 0.7)],
    ids=["constant", "norm", "norm_inactive", "both"])
def test_clipping_like_reference(const, norm):
    rs = np.random.RandomState(4)
    arrays = [rs.standard_normal(s).astype(np.float32)
              for s in ((3, 5), (5,), (4, 4, 2))]
    got = _clipper(const, norm)._clip([torch.from_numpy(a) for a in arrays])
    want = _reference_clip([jnp.asarray(a) for a in arrays], const, norm)
    for a, b in zip(got, want):
        _close(a.numpy(), b)


# -- triggers -------------------------------------------------------------------

TRIGGERS = {
    "max_score": lambda T: T.max_score(0.7),
    "min_loss": lambda T: T.min_loss(0.35),
    "plateau": lambda T: T.plateau(patience=2),
    "plateau_max_no_counter": lambda T: T.plateau(
        monitor="score", patience=1, mode="max", counter=None),
    "and": lambda T: T.and_(T.min_loss(0.6), T.max_score(0.5)),
    "or": lambda T: T.or_(T.max_epoch(3), T.max_score(0.9)),
}


@pytest.mark.parametrize("name", sorted(TRIGGERS))
def test_trigger_like_reference(name):
    tt, jt = TRIGGERS[name](TTrigger), TRIGGERS[name](JTrigger)
    losses = [0.9, 0.7, 0.5, 0.5, 0.4, 0.3, 0.31, 0.32]
    scores = [0.2, 0.4, 0.6, 0.6, 0.65, 0.8, 0.8, 0.75]
    got, want = [], []
    for i, (loss, score) in enumerate(zip(losses, scores)):
        state = {"epoch": 1 + i // 3, "neval": i + 1, "loss": loss,
                 "score": score, "val_loss": loss, "val_obs": i // 2}
        got.append(tt(dict(state)))
        want.append(jt(dict(state)))
    assert got == want
