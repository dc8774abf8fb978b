"""Gradient accumulation, remat and the layer-wise scales of the port
against the JAX package, on the CPU.

- Accumulation 2 and 4 on a small bottleneck ResNet with BatchNorm: one
  step's gradients (the port's ``Optimizer._step``, the reference's
  ``_accumulated_grads``) within 1e-5 of the largest gradient, the
  BatchNorm buffers after the step within 1e-5 of the largest buffer;
  5-step losses of the two ``Optimizer`` runs within 2e-3 (the
  training-parity bound); a batch the steps do not divide is rejected at
  ``optimize()`` by both.
- Remat: every policy (``"full"``, ``"conv_out"``, a callable) gives the
  run without remat's losses, parameters and buffers bit for bit, for a
  fused and an unfused ResNet (BatchNorm) and a dropout TransformerLM;
  each policy's gradients within 1e-5 of the reference's remat gradients
  (``jax.checkpoint`` of the same policy) on the ResNet and a dropout-free
  LM.  Both traps are shown: a bare ``torch.utils.checkpoint`` over the
  dropout LM does not give the unremat gradients, nor the unremat running
  statistics over the ResNet.
- Accumulation with remat, and the scales: the reference's
  ``tests/test_optim.py:463-504`` cases (per-layer scale_w / scale_b,
  propagation from containers, a frozen model staying bit-equal with its
  weight decay) through both ``Optimizer`` runs.
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
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim.optimizer import _accumulated_grads

import bigdl_torch.nn as tnn
from bigdl_torch.common import DTypePolicy, get_policy, set_policy
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.nn.dropout import dropout_rng
from bigdl_torch.nn.module import Container
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Adam as TAdam
from bigdl_torch.optim import ConfigurationError
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.optim import regularizer as treg
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

GRAD_TOL = 1e-5
LOSS_TOL = 2e-3
BATCH = 8
LM_CFG = dict(vocab_size=53, max_len=12, d_model=32, num_heads=4,
              num_layers=2)


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _resnet(mod, nn, fuse=False):
    m = nn.Sequential()
    m.add(mod._conv(3, 8, 3, 3, 2, 2, 1, 1))
    m.add(nn.SpatialBatchNormalization(8)).add(nn.ReLU())
    b1, ch = mod._bottleneck(8, 4, 2, "B")
    m.add(nn.Sequential().add(b1))
    m.add(nn.SpatialAveragePooling(4, 4, 1, 1))
    m.add(nn.Reshape((ch,))).add(nn.Linear(ch, 10))
    if fuse:
        nn.fuse_conv_bn(m)
    return m


def _data(kind, n=16, seed=3):
    rs = np.random.RandomState(seed)
    if kind == "resnet":
        return (rs.standard_normal((n, 16, 16, 3)).astype(np.float32),
                rs.randint(0, 10, n).astype(np.int32))
    toks = rs.randint(0, LM_CFG["vocab_size"],
                      (n, LM_CFG["max_len"] + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _pair(kind, fuse=False, dropout=0.0):
    """(JAX model built from key 0, port model with the same weights)."""
    JEngine.init()
    if kind == "resnet":
        jm, tm = _resnet(jresnet, jnn, fuse), _resnet(tresnet, tnn, fuse)
    else:
        jm = jlm.TransformerLM(**LM_CFG, dropout=dropout)
        tm = tlm.TransformerLM(**LM_CFG, dropout=dropout)
    jm.build(jax.random.key(0))
    tm.build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


def _crit(kind, nn):
    if kind == "resnet":
        return nn.CrossEntropyCriterion()
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


def _tree_of(model, tensors):
    index = {id(p): i for i, p in enumerate(model.parameters())}

    def walk(m):
        if isinstance(m, Container):
            return [walk(c) for c in m.layers]
        return {n: tensors[index[id(getattr(m, n))]].detach().numpy()
                for n in m.param_names}
    return walk(model)


def _close(got, want, tol, what=""):
    """Every leaf within ``tol`` of the largest magnitude in the whole
    tree: a leaf whose exact value is 0 (a conv bias before BatchNorm has
    a zero gradient) holds only rounding noise, which no per-leaf scale
    can bound."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    scale = max(float(np.abs(np.asarray(b)).max()) for b in want)
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=what)


class _Capture(TSGD):
    """A method that keeps the step's final gradients and updates
    nothing."""

    def update(self, grads, params, state, lr):
        self.grads = [g.detach().clone() for g in grads]
        return state


def _port_grads(tm, kind, x, y, accum=1, remat=None, rng=None):
    """One ``_step``'s loss and gradients, before the bf16 wire (the
    reference's ``_accumulated_grads`` returns them before it too)."""
    opt = TOptimizer(tm, [TSample(x[0], y[0])], _crit(kind, tnn),
                     device="cpu")
    cap = _Capture()
    opt.set_optim_method(cap).set_remat(remat)
    opt.grad_accum_steps = accum
    params = list(tm.parameters())
    tm.train()
    policy = get_policy()
    set_policy(DTypePolicy(policy.param_dtype, policy.compute_dtype, None))
    try:
        loss, _ = opt._step(params, {}, torch.from_numpy(x),
                            torch.from_numpy(y), 0.0, rng)
    finally:
        set_policy(policy)
    return float(loss), _tree_of(tm, cap.grads)


def _reference_grads(jm, kind, x, y, accum=1, remat=None):
    if remat == "full":
        apply = jax.checkpoint
    elif remat == "conv_out":
        def apply(fn):
            return jax.checkpoint(
                fn, policy=jax.checkpoint_policies.save_only_these_names(
                    "conv_out"))
    else:
        def apply(fn):
            return fn
    loss, ns, grads = _accumulated_grads(
        jm, _crit(kind, jnn), lambda ns: 0.0, apply, accum, jm.params,
        jm.state, jnp.asarray(x), jnp.asarray(y), jax.random.key(1))
    return float(loss), grads, ns


# -- accumulation -------------------------------------------------------------

@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_like_reference(accum):
    jm, tm = _pair("resnet")
    x, y = _data("resnet", BATCH)
    tl, tg = _port_grads(tm, "resnet", x, y, accum)
    jl, jg, jns = _reference_grads(jm, "resnet", x, y, accum)
    assert abs(tl - jl) <= GRAD_TOL * max(abs(jl), 1.0)
    _close(tg, jg, GRAD_TOL, "gradients")
    # each microbatch advanced the running statistics, in order
    _close(to_reference_tree(tm)[1], jns, GRAD_TOL, "BatchNorm buffers")


def _recorder(Trigger, losses, last):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > last
    return Trigger(fn, "record")


def _samples(Sample, x, y):
    return [Sample.from_ndarray(x[i], y[i]) for i in range(len(x))]


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_run_like_reference(accum):
    jm, tm = _pair("resnet")
    x, y = _data("resnet", 32)
    jl, tl = {}, {}
    jopt = JOptimizer(jm, JDataSet.array(_samples(JSample, x, y)),
                      _crit("resnet", jnn), batch_size=BATCH)
    jopt.set_optim_method(JSGD(0.05, momentum=0.9))
    jopt.set_gradient_accumulation(accum)
    jopt.set_end_when(_recorder(JTrigger, jl, 5)).optimize()
    topt = TOptimizer(tm, TDataSet.array(_samples(TSample, x, y)),
                      _crit("resnet", tnn), batch_size=BATCH, device="cpu")
    topt.set_optim_method(TSGD(0.05, momentum=0.9))
    topt.set_gradient_accumulation(accum)
    topt.set_end_when(_recorder(TTrigger, tl, 5)).optimize()
    assert sorted(jl) == sorted(tl) == [1, 2, 3, 4, 5]
    for k in jl:
        assert abs(tl[k] - jl[k]) <= LOSS_TOL, (k, tl, jl)


def test_indivisible_batch_rejected_like_reference():
    jm, tm = _pair("resnet")
    x, y = _data("resnet", 16)
    jopt = JOptimizer(jm, JDataSet.array(_samples(JSample, x, y)),
                      _crit("resnet", jnn), batch_size=BATCH)
    jopt.set_gradient_accumulation(3)
    with pytest.raises(ValueError, match="not divisible"):
        jopt.optimize()
    topt = TOptimizer(tm, TDataSet.array(_samples(TSample, x, y)),
                      _crit("resnet", tnn), batch_size=BATCH, device="cpu")
    topt.set_gradient_accumulation(3)
    before = [p.detach().clone() for p in tm.parameters()]
    with pytest.raises(ConfigurationError, match="not divisible"):
        topt.optimize()
    assert all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))
    with pytest.raises(ValueError):
        topt.set_gradient_accumulation(0)


# -- remat ----------------------------------------------------------------------

def _save_matmuls(ctx, op, *args, **kwargs):
    """A selective-checkpoint policy: keep the matrix products."""
    return op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


POLICIES = {"full": "full", "conv_out": "conv_out",
            "callable": _save_matmuls}


def _port_run(kind, policy, fuse=False, dropout=0.0, accum=1, steps=3):
    """Losses, and every parameter and buffer after ``steps`` steps."""
    if kind == "resnet":
        m = _resnet(tresnet, tnn, fuse)
        meth = TSGD(0.1, momentum=0.9)
    else:
        m = tlm.TransformerLM(**LM_CFG, dropout=dropout)
        meth = TAdam(3e-3)
    m.build("cpu", torch.Generator().manual_seed(1))
    x, y = _data(kind)
    opt = TOptimizer(m, TDataSet.array(_samples(TSample, x, y)),
                     _crit(kind, tnn), batch_size=BATCH, device="cpu")
    opt.set_optim_method(meth).set_remat(policy)
    opt.set_end_when(TTrigger.max_iteration(steps))
    if accum > 1:
        opt.set_gradient_accumulation(accum)
    losses = {}
    opt.set_end_when(_recorder(TTrigger, losses, steps)).optimize()
    return ([losses[k] for k in sorted(losses)],
            [t.detach().clone() for t in
             list(m.parameters()) + list(m.buffers())])


MODEL_CASES = {"resnet": ("resnet", False, 0.0),
               "resnet_fused": ("resnet", True, 0.0),
               "lm_dropout": ("lm", False, 0.2)}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_remat_bit_equal_to_none(policy, case):
    kind, fuse, p = MODEL_CASES[case]
    base = _port_run(kind, None, fuse, p)
    got = _port_run(kind, POLICIES[policy], fuse, p)
    assert got[0] == base[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], base[1]))


def test_accumulation_with_remat_bit_equal():
    base = _port_run("resnet", None, accum=2)
    got = _port_run("resnet", "full", accum=2)
    assert got[0] == base[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], base[1]))


@pytest.mark.parametrize("kind", ["resnet", "lm"])
@pytest.mark.parametrize("policy", ["full", "conv_out"])
def test_remat_gradients_like_reference(policy, kind):
    jm, tm = _pair(kind)
    x, y = _data(kind, BATCH)
    tl, tg = _port_grads(tm, kind, x, y, remat=policy)
    jl, jg, _ = _reference_grads(jm, kind, x, y, remat=policy)
    assert abs(tl - jl) <= GRAD_TOL * max(abs(jl), 1.0)
    _close(tg, jg, GRAD_TOL, f"{policy} gradients")


def test_unknown_policy_raises():
    opt = TOptimizer(tnn.Linear(2, 2), [TSample(np.zeros(2, np.float32),
                                                np.int32(0))],
                     tnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        opt.set_remat("conv-out")


def _grads_of(model, loss_fn):
    for p in model.parameters():
        p.grad = None
    loss_fn().backward()
    return [p.grad.clone() for p in model.parameters()]


def test_bare_checkpoint_shows_both_traps():
    """What ``utils/remat.py`` closes: a bare non-reentrant checkpoint
    redraws Dropout's masks from the Optimizer's generator in the
    recompute (other gradients), and updates BatchNorm's running
    statistics a second time."""
    from torch.utils.checkpoint import checkpoint
    lm = tlm.TransformerLM(**LM_CFG, dropout=0.2).build(
        "cpu", torch.Generator().manual_seed(1))
    x, y = (torch.from_numpy(a) for a in _data("lm", BATCH))
    crit = _crit("lm", tnn)

    def lm_loss(gen):
        def fn(a, b):
            with dropout_rng(gen):
                return crit(lm(a), b)
        return fn
    plain = _grads_of(lm, lambda: lm_loss(
        torch.Generator().manual_seed(5))(x, y))
    bare = _grads_of(lm, lambda: checkpoint(
        lm_loss(torch.Generator().manual_seed(5)), x, y,
        use_reentrant=False))
    assert not all(torch.equal(a, b) for a, b in zip(plain, bare))

    net = _resnet(tresnet, tnn).build("cpu",
                                      torch.Generator().manual_seed(1))
    xr, yr = (torch.from_numpy(a) for a in _data("resnet", BATCH))
    rcrit = _crit("resnet", tnn)
    start = [b.clone() for b in net.buffers()]
    _grads_of(net, lambda: rcrit(net(xr), yr))
    once = [b.clone() for b in net.buffers()]
    for b, s in zip(net.buffers(), start):
        b.copy_(s)
    _grads_of(net, lambda: checkpoint(lambda a: rcrit(net(a), yr), xr,
                                      use_reentrant=False))
    assert not all(torch.equal(a, b) for a, b in zip(once, net.buffers()))


# -- the layer-wise scales ---------------------------------------------------------

def _two_layer(nn):
    return nn.Sequential(nn.Linear(4, 3), nn.Linear(3, 2), nn.LogSoftMax())


def _scale_runs(set_scales, reg=None):
    """Two SGD steps of each package on the same weights and data with the
    scales ``set_scales`` applies; returns (reference, port) weight deltas
    per leaf, in the reference's order."""
    JEngine.init()
    rs = np.random.RandomState(0)
    x = rs.standard_normal((8, 4)).astype(np.float32)
    y = rs.randint(0, 2, 8).astype(np.int32)
    jm, tm = _two_layer(jnn), _two_layer(tnn)
    if reg is not None:
        from bigdl_tpu.optim import regularizer as jreg
        jm.modules[0].w_regularizer = jreg.L2Regularizer(reg)
        tm.layers[0].w_regularizer = treg.L2Regularizer(reg)
    jm.build(jax.random.key(0))
    tm.build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    w0 = [np.asarray(a).copy() for a in jax.tree.leaves(jm.params)]
    set_scales(jm)
    set_scales(tm)
    jopt = JOptimizer(jm, _samples(JSample, x, y), jnn.ClassNLLCriterion(),
                      batch_size=8)
    jopt.set_optim_method(JSGD(0.5)).set_end_when(JTrigger.max_iteration(2))
    jopt.optimize()
    topt = TOptimizer(tm, _samples(TSample, x, y), tnn.ClassNLLCriterion(),
                      batch_size=8, device="cpu")
    topt.set_optim_method(TSGD(0.5)).set_end_when(TTrigger.max_iteration(2))
    topt.optimize()
    jd = [np.asarray(a) - b for a, b in zip(jax.tree.leaves(jm.params), w0)]
    td = [a - b for a, b in
          zip(jax.tree.leaves(to_reference_tree(tm)[0]), w0)]
    return jd, td


SCALES = {
    "layer0_w3_b2": lambda m: _kids(m)[0].set_scale_w(3.0).set_scale_b(2.0),
    "container_w2_b3": lambda m: m.set_scale_w(2.0).set_scale_b(3.0),
    "layer1_frozen": lambda m: _kids(m)[1].set_scale_w(0.0).set_scale_b(0.0),
}


def _kids(m):
    return m.layers if hasattr(m, "layers") else m.modules


@pytest.mark.parametrize("name", sorted(SCALES))
def test_scales_like_reference(name):
    jd, td = _scale_runs(SCALES[name])
    _close(td, jd, GRAD_TOL, name)


def test_frozen_layer_keeps_its_weight_decay_out():
    """scale_w = 0 multiplies after the regularizer: the layer stays bit
    for bit (``bigdl_tpu/optim/optimizer.py:826-834``)."""
    jd, td = _scale_runs(lambda m: _kids(m)[0].set_scale_w(0.0)
                         .set_scale_b(0.0), reg=0.1)
    for d in (jd, td):
        assert not np.any(d[0]) and not np.any(d[1])
    _close(td, jd, GRAD_TOL, "frozen with L2")


def test_grad_scales_follow_parameters_and_propagate():
    m = tnn.Sequential(tnn.Linear(4, 3), tnn.Sequential(tnn.Linear(3, 2)))
    m.build("cpu")
    assert m._grad_scales() is None
    m.set_scale_w(2.0).set_scale_b(3.0)
    assert m.layers[1].layers[0].scale_b == 3.0
    names = [n for n, _ in m.named_parameters()]
    assert m._grad_scales() == [3.0 if n.endswith("bias") else 2.0
                                for n in names]
