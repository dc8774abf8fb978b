"""``EMA`` and ``LBFGS`` of the port against the JAX package, on the CPU
(the reference's ``tests/test_optim.py:110-330`` cases, and more).

- ``EMA``: the update arithmetic on a two-element vector exactly as the
  reference's test states it; 5 updates of ``EMA(Adam)`` and ``EMA(SGD)``
  on a small ResNet's and a small TransformerLM's trees, params and every
  state leaf (the shadow and the inner method's) within 1e-6 of each
  leaf's magnitude; the shadow a copy, never an alias; ``apply_to`` copies
  the shadow and the BatchNorm buffers; an ``EMA(Adam)`` LeNet-5 run
  through both ``Optimizer``\\ s, losses within 2e-3, shadows within
  1e-4.
- ``LBFGS``: 5 fixed-step updates on both trees, params and state within
  1e-5 (of the weights' scale for the steps, of the gradients' for their
  changes; rho = 1 / yᵀs within 1e-4 relative: the port's dot products
  sum per parameter, the reference's over one raveled vector); the raveled history in the reference's leaf order
  (sorted within a leaf, unlike the port's registration order); the
  Rosenbrock cases of the reference (fixed step improves, the line search
  converges) with the same float64 ``feval`` in both packages, losses
  equal.
- Snapshots: a reference state loads into the port and the port's into
  the reference, for both methods, and the next updates agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bigdl_tpu.optim import method as jmethod

import bigdl_torch.nn as tnn
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.nn.module import Container
from bigdl_torch.optim import method as tmethod
from bigdl_torch.utils.convert import (load_reference_opt_state,
                                       to_reference_opt_state,
                                       to_reference_tree)

TOL = 1e-6
LBFGS_TOL = 1e-5
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
    index = {id(p): i for i, p in enumerate(model.parameters())}

    def walk(m):
        if isinstance(m, Container):
            return [walk(c) for c in m.layers]
        return {n: tensors[index[id(getattr(m, n))]].detach().numpy()
                for n in m.param_names}
    return walk(model)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _close_trees(got, want, tol, what):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == \
        jax.tree.structure(jax.tree.map(np.asarray, want)), what
    for a, b in zip(gl, wl):
        if np.asarray(b).dtype == np.int32:
            assert int(a) == int(b), what
        else:
            _close(a, b, tol, what)


def _grads(params, rs):
    return [torch.from_numpy(rs.standard_normal(tuple(p.shape))
                             .astype(np.float32) * 0.1) for p in params]


def _run_both(make, tree, steps=STEPS, seed=7, lr=None):
    """``steps`` updates of the port's and the reference's method from
    the same params and the same gradients: (model, port state, reference
    params, reference state, port method, reference method)."""
    model = MODELS[tree]().build("cpu", torch.Generator().manual_seed(3))
    params = list(model.parameters())
    jparams = jax.tree.map(lambda a: jnp.asarray(a.copy()),
                           to_reference_tree(model)[0])
    tm, jm = make(tmethod), make(jmethod)
    tstate, jstate = tm.init_state(params), jm.init_state(jparams)
    rs = np.random.RandomState(seed)
    for k in range(steps):
        grads = _grads(params, rs)
        driver = {"evalCounter": k, "epoch": 1, "neval": k + 1}
        rate = tm.get_learning_rate(dict(driver)) if lr is None else lr
        tstate = tm.update(grads, params, tstate, rate)
        jparams, jstate = jm.update(
            jax.tree.map(jnp.asarray, _tree_of(model, grads)), jparams,
            jstate, jnp.float32(rate))
    return model, tstate, jparams, jstate, tm, jm


# -- EMA ---------------------------------------------------------------------

def test_ema_update_math_like_reference():
    """shadow = d·shadow + (1 − d)·params after each inner update, the
    reference's ``test_ema_update_math`` in both packages."""
    outs = []
    for mod, arr in ((jmethod, jnp.asarray), (tmethod, torch.tensor)):
        ema = mod.EMA(mod.SGD(learning_rate=0.5), decay=0.9)
        p = [arr([1.0, 2.0])] if mod is tmethod else {"w": arr([1.0, 2.0])}
        g = [arr([1.0, 1.0])] if mod is tmethod else {"w": arr([1.0, 1.0])}
        st = ema.init_state(p)
        for _ in range(2):
            if mod is tmethod:
                st = ema.update(g, p, st, 0.5)
                outs.append((p[0].numpy().copy(),
                             st["shadow"][0].numpy().copy()))
            else:
                p, st = ema.update(g, p, st, jnp.float32(0.5))
                outs.append((np.asarray(p["w"]), np.asarray(st["shadow"]["w"])))
    (jp1, js1), (jp2, js2), (tp1, ts1), (tp2, ts2) = outs
    np.testing.assert_allclose(tp1, [0.5, 1.5])
    np.testing.assert_allclose(ts1, 0.9 * np.array([1.0, 2.0])
                               + 0.1 * np.array([0.5, 1.5]), rtol=1e-6)
    for a, b in ((tp1, jp1), (ts1, js1), (tp2, jp2), (ts2, js2)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


EMA_CASES = {"adam": lambda m: m.EMA(m.Adam(1e-3), 0.9),
             "sgd_momentum": lambda m: m.EMA(m.SGD(0.1, momentum=0.9),
                                             0.999)}


@pytest.mark.parametrize("tree", sorted(MODELS))
@pytest.mark.parametrize("name", sorted(EMA_CASES))
def test_ema_updates_like_reference(name, tree):
    model, tstate, jparams, jstate, tm, _ = _run_both(EMA_CASES[name], tree)
    _close_trees(to_reference_tree(model)[0], jparams, TOL, "params")
    _close_trees(to_reference_opt_state(model, tm, tstate), jstate, TOL,
                 "state")


def test_ema_shadow_is_a_copy_and_apply_to_moves_buffers():
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.optim import Optimizer, Trigger
    model = _small_resnet().build("cpu", torch.Generator().manual_seed(3))
    ema = tmethod.EMA(tmethod.SGD(0.1), 0.5)
    state = ema.init_state(list(model.parameters()))
    for s, p in zip(state["shadow"], model.parameters()):
        assert s.data_ptr() != p.data_ptr() and torch.equal(s, p)
    rs = np.random.RandomState(0)
    samples = [Sample(rs.standard_normal((2, 2, 3)).astype(np.float32),
                      np.int32(i % 10)) for i in range(8)]
    opt = Optimizer(model, DataSet.array(samples),
                    tnn.CrossEntropyCriterion(), batch_size=4, device="cpu")
    opt.set_optim_method(ema).set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    shadow = ema.ema_params(opt.final_opt_state)
    assert not all(torch.equal(s, p) for s, p in
                   zip(shadow, model.parameters()))
    fresh = _small_resnet().build("cpu", torch.Generator().manual_seed(9))
    tmethod.EMA.apply_to(fresh, opt)
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), shadow))
    assert all(torch.equal(a, b) for a, b in
               zip(fresh.buffers(), model.buffers()))


def test_ema_lenet_training_like_reference():
    """``EMA(Adam)`` through both Optimizers on LeNet-5 (the reference's
    ``test_ema_through_optimizer_training`` setting, 8 steps): losses
    within 2e-3, the shadows within 1e-4 of their largest magnitude (8
    trained steps of two forwards' rounding)."""
    from bigdl_tpu import Engine as JEngine
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu.optim import Optimizer as JOptimizer
    from bigdl_tpu.optim import Trigger as JTrigger
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models import LeNet5
    from bigdl_torch.optim import Optimizer, Trigger
    from bigdl_torch.utils.convert import load_reference_tree

    from bigdl_tpu.common import get_default_rng
    saved = get_default_rng().get_state()
    JEngine.init()
    rs = np.random.RandomState(0)
    x = rs.normal(0, 0.1, (64, 28, 28)).astype(np.float32)
    y = rs.randint(0, 10, 64).astype(np.int32)
    jm = JLeNet5(10).build(jax.random.key(0))
    tm = LeNet5(10).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    losses = ({}, {})

    def rec(Trigger, out):
        def fn(state):
            if state["neval"] > 1:
                out[state["neval"] - 1] = state["loss"]
            return state["neval"] > 8
        return Trigger(fn, "rec")
    jopt = JOptimizer(jm, JDataSet.array([JSample.from_ndarray(x[i], y[i])
                                          for i in range(64)]),
                      jnn_crit(), batch_size=16)
    jopt.set_optim_method(jmethod.EMA(jmethod.Adam(1e-3), 0.9))
    jopt.set_end_when(rec(JTrigger, losses[0])).optimize()
    topt = Optimizer(tm, DataSet.array([Sample.from_ndarray(x[i], y[i])
                                        for i in range(64)]),
                     tnn.ClassNLLCriterion(), batch_size=16, device="cpu")
    topt.set_optim_method(tmethod.EMA(tmethod.Adam(1e-3), 0.9))
    topt.set_end_when(rec(Trigger, losses[1])).optimize()
    get_default_rng().set_state(saved)
    assert sorted(losses[0]) == sorted(losses[1]) == list(range(1, 9))
    for k in losses[0]:
        assert abs(losses[0][k] - losses[1][k]) <= 2e-3, losses
    _close_trees(to_reference_opt_state(tm, topt.optim_method,
                                        topt.final_opt_state)["shadow"],
                 jopt._final_opt_state["shadow"], 1e-4, "shadow")


def jnn_crit():
    import bigdl_tpu.nn as jnn
    return jnn.ClassNLLCriterion()


# -- LBFGS -------------------------------------------------------------------

@pytest.mark.parametrize("tree", sorted(MODELS))
def test_lbfgs_updates_like_reference(tree):
    model, tstate, jparams, jstate, tm, _ = _run_both(
        lambda m: m.LBFGS(learning_rate=0.05, history_size=3), tree,
        lr=0.05)
    _close_trees(to_reference_tree(model)[0], jparams, LBFGS_TOL, "params")
    got = to_reference_opt_state(model, tm, tstate)
    assert sorted(got) == sorted(jstate)
    assert got["count"].dtype == np.int32
    assert int(got["count"]) == int(jstate["count"]) == STEPS
    # rho = 1 / yᵀs sums products of weight differences: 1e-4 relative
    np.testing.assert_allclose(got["rho"], np.asarray(jstate["rho"]),
                               rtol=1e-4, err_msg="rho")
    # a step is a difference of weights, and the weights may part in
    # their last bit: s and prev_flat are held to the weights' scale,
    # y and prev_grad to the gradients'
    for keys, ref in ((("s", "prev_flat"), "prev_flat"),
                      (("y", "prev_grad"), "prev_grad")):
        scale = float(np.abs(np.asarray(jstate[ref])).max())
        for key in keys:
            np.testing.assert_allclose(got[key], np.asarray(jstate[key]),
                                       rtol=0, atol=LBFGS_TOL * scale,
                                       err_msg=key)


def test_lbfgs_ravel_order_is_the_references():
    """The raveled prev_flat is the reference's ``ravel_pytree`` of the
    params: within a leaf the bias comes before the weight."""
    from jax.flatten_util import ravel_pytree
    model = _small_lm().build("cpu", torch.Generator().manual_seed(3))
    m = tmethod.LBFGS()
    state = m.init_state(list(model.parameters()))
    flat = to_reference_opt_state(model, m, state)["prev_flat"]
    want, _ = ravel_pytree(to_reference_tree(model)[0])
    assert np.array_equal(flat, np.asarray(want))
    port_order = np.concatenate([p.detach().reshape(-1).numpy()
                                 for p in model.parameters()])
    assert not np.array_equal(flat, port_order)


def _rosen(w):
    return (1 - w[0]) ** 2 + 100 * (w[1] - w[0] ** 2) ** 2


def _rosen_grad(w):
    return np.array([-2 * (1 - w[0]) - 400 * w[0] * (w[1] - w[0] ** 2),
                     200 * (w[1] - w[0] ** 2)])


def test_lbfgs_line_search_like_reference():
    """The reference's Wolfe line-search Rosenbrock case, with one float64
    ``feval`` in both packages: the losses of every probe are equal, and
    both reach (1, 1)."""
    jm = jmethod.LBFGS(learning_rate=1.0, max_iter=20, history_size=10)
    tm = tmethod.LBFGS(learning_rate=1.0, max_iter=20, history_size=10)

    def jfeval(p):
        w = np.asarray(p["w"], np.float64)
        return _rosen(w), {"w": jnp.asarray(_rosen_grad(w))}

    def tfeval(x):
        w = x[0].numpy().astype(np.float64)
        return _rosen(w), [torch.from_numpy(_rosen_grad(w).astype(np.float32))]

    jp = {"w": jnp.asarray([-1.0, 1.0])}
    tp = [torch.tensor([-1.0, 1.0])]
    for _ in range(10):
        jp, jl = jm.optimize(jfeval, jp)
        tp, tl = tm.optimize(tfeval, tp)
        np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-12)
    assert tl[-1] < 1e-6
    np.testing.assert_allclose(tp[0].numpy(), [1.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["w"]),
                               atol=1e-6)


def test_lbfgs_fixed_step_rosenbrock_improves():
    m = tmethod.LBFGS(learning_rate=2e-3, history_size=10)
    w = torch.tensor([-1.0, 1.0])
    state = m.init_state([w])
    f0 = _rosen(w.numpy())
    for _ in range(200):
        state = m.update([torch.from_numpy(
            _rosen_grad(w.numpy().astype(np.float64)).astype(np.float32))],
            [w], state, 2e-3)
    assert _rosen(w.numpy()) < f0 * 0.5


# -- snapshots across packages ------------------------------------------------

SNAP_CASES = {"ema_adam": lambda m: m.EMA(m.Adam(1e-3), 0.9),
              "lbfgs": lambda m: m.LBFGS(learning_rate=0.05,
                                         history_size=3)}


@pytest.mark.parametrize("name", sorted(SNAP_CASES))
def test_state_loads_across_packages(name):
    """After 3 updates each package's state goes into the other, and 2
    more updates from it agree with the other package's own."""
    make = SNAP_CASES[name]
    model, tstate, jparams, jstate, tm, jm = _run_both(make, "resnet", 3,
                                                       lr=0.05)
    params = list(model.parameters())
    jstate_np = jax.tree.map(np.asarray, jstate)
    # the reference's state into the port, the port's into the reference
    port_from_ref = load_reference_opt_state(model, tm, jstate_np)
    ref_from_port = jax.tree.map(jnp.asarray,
                                 to_reference_opt_state(model, tm, tstate))
    _close_trees(to_reference_opt_state(model, tm, port_from_ref),
                 jstate_np, 0, "round trip")
    rs = np.random.RandomState(11)
    snap = [p.detach().clone() for p in params]
    j2, j2p = jstate, jparams
    r2, r2p = ref_from_port, jparams
    for _ in range(2):
        grads = _grads(params, rs)
        jg = jax.tree.map(jnp.asarray, _tree_of(model, grads))
        port_from_ref = tm.update(grads, params, port_from_ref, 0.05)
        j2p, j2 = jm.update(jg, j2p, j2, jnp.float32(0.05))
        r2p, r2 = jm.update(jg, r2p, r2, jnp.float32(0.05))
    tol = LBFGS_TOL if name == "lbfgs" else TOL
    _close_trees(to_reference_tree(model)[0], j2p, tol, "port from ref")
    _close_trees(r2p, j2p, tol, "ref from port")
    with torch.no_grad():
        for p, s in zip(params, snap):
            p.copy_(s)
