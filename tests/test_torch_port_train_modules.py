"""Per-module parity of the training slice against the JAX package:
convolution, pooling, BatchNorm (training, eval and the running EMA), the
fused ConvBN / ConvBNAddReLU, the criteria, SGD, the float32-accumulating
matmul's backward, triggers and the dataset's shuffle order.

Each pair is built from the JAX module's params, carried over with
``bigdl_torch.utils.convert``; inputs and cotangents come from numpy's
RandomState.  Where the JAX module reaches a Pallas kernel (BatchNorm in
training mode, the fused conv-BN) it runs in interpret mode
(``BIGDL_TPU_BN_IMPL=pallas_interpret``, as tests/test_bn_pallas.py and
tests/test_convbn.py run it); the port's wrappers compute their plain
versions on the CPU.

Tolerances: float32 forward outputs and gradients within 1e-5 relative to
the compared tensor's largest magnitude (at least 1): both sides compute in
float32 and differ in summation order.  bfloat16 compute is checked for
the output dtype and within 0.05 absolute + 0.02 relative, as in
tests/test_torch_port_modules.py: both round to bf16 (2^-8 relative) at
different places.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu.common import DTypePolicy as JPolicy
from bigdl_tpu.common import get_policy as jget_policy
from bigdl_tpu.common import set_policy as jset_policy
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.common import DTypePolicy as TPolicy
from bigdl_torch.common import get_policy as tget_policy
from bigdl_torch.common import set_policy as tset_policy
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.nn.linear import matmul_f32
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

F32 = 1e-5
BF16_TOL = dict(atol=5e-2, rtol=2e-2)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_BN_IMPL", "pallas_interpret")


@pytest.fixture
def bf16_policy():
    jold, told = jget_policy(), tget_policy()
    jset_policy(JPolicy(compute_dtype=jnp.bfloat16))
    tset_policy(TPolicy(compute_dtype=torch.bfloat16))
    try:
        yield
    finally:
        jset_policy(jold)
        tset_policy(told)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(port, ref, tol=F32):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _trees_close(port_tree, ref_tree, tol=F32):
    pl, rl = jax.tree.leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        _close(p, r, tol)


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _pair(jmod, tmod, seed=0):
    jmod.build(jax.random.key(seed))
    tmod.build("cpu")
    load_reference_tree(tmod, jax.tree.map(np.asarray, jmod.params),
                        jax.tree.map(np.asarray, jmod.state))
    return jmod, tmod


def _grad_tree(module):
    if isinstance(module, tnn.Container):
        return [_grad_tree(m) for m in module.layers]
    return {n: getattr(module, n).grad for n in module.param_names}


def _vjp_pair(jm, tm, x, ct, training):
    """Forward and VJP of both modules on x with cotangent ct: returns
    (jax out, jax param grads, jax x grad, jax new state) and the port's
    (out, param grads, x grad)."""
    def f(p, x_):
        return jm.apply(p, jm.state, x_, training=training)

    jy, vjp, jstate = jax.vjp(f, jm.params, jnp.asarray(x), has_aux=True)
    jgp, jgx = vjp(jnp.asarray(ct).astype(jy.dtype))
    tm.train(training)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    ty.backward(torch.from_numpy(ct).to(ty.dtype))
    return (jy, jgp, jgx, jstate), (ty, _grad_tree(tm), tx.grad)


# -- convolution and pooling --------------------------------------------------

CONVS = {"1x1": (16, 24, 1, 1, 1, 1, 0, 0),
         "3x3s2p1": (8, 12, 3, 3, 2, 2, 1, 1),
         "7x7s2p3": (3, 16, 7, 7, 2, 2, 3, 3)}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_spatial_convolution(name):
    args = CONVS[name]
    jm, tm = _pair(jnn.SpatialConvolution(*args),
                   tnn.SpatialConvolution(*args), seed=3)
    x = _x((2, 13, 13, args[0]), seed=4)
    (jy, jgp, jgx, _), (ty, tgp, tgx) = _vjp_pair(
        jm, tm, x, _x(jm.apply(jm.params, jm.state, jnp.asarray(x))[0].shape,
                      5), training=True)
    _close(ty, jy)
    _close(tgx, jgx)
    _trees_close(tgp, jgp)


def test_spatial_convolution_bf16(bf16_policy):
    jm, tm = _pair(jnn.SpatialConvolution(8, 12, 3, 3, 2, 2, 1, 1),
                   tnn.SpatialConvolution(8, 12, 3, 3, 2, 2, 1, 1), seed=6)
    x = _x((2, 9, 9, 8), seed=7)
    jy, _ = jm.apply(jm.params, jm.state, jnp.asarray(x))
    ty = tm(torch.from_numpy(x))
    assert ty.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
    assert ty.is_contiguous()
    np.testing.assert_allclose(_np(ty), _np(jy), **BF16_TOL)


POOLS = {
    "max3s2p1": lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
    "max3s2ceil": lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
    "max2s3ceilp1": lambda nn: nn.SpatialMaxPooling(2, 2, 3, 3, 1, 1).ceil(),
    "avg7": lambda nn: nn.SpatialAveragePooling(7, 7, 1, 1),
    "avg3s2p1": lambda nn: nn.SpatialAveragePooling(3, 3, 2, 2, 1, 1),
    "avg3s2p1_excl": lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, count_include_pad=False),
    "avg3s2ceil": lambda nn: nn.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                                      ceil_mode=True),
    "avg_global": lambda nn: nn.SpatialAveragePooling(
        1, 1, global_pooling=True),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pooling(name):
    jm, tm = _pair(POOLS[name](jnn), POOLS[name](tnn))
    x = _x((2, 10, 10, 5), seed=8)
    jy = jm.apply(jm.params, jm.state, jnp.asarray(x))[0]
    (jy, _, jgx, _), (ty, _, tgx) = _vjp_pair(
        jm, tm, x, _x(jy.shape, 9), training=True)
    _close(ty, jy)
    _close(tgx, jgx)


# -- BatchNorm ----------------------------------------------------------------

def test_batchnorm_train_eval_and_ema(pallas):
    """Two training steps (B1 forward, B2 backward) then eval: outputs,
    grads and the running statistics after each step."""
    jm, tm = _pair(jnn.SpatialBatchNormalization(6),
                   tnn.SpatialBatchNormalization(6))
    jm.params = {"weight": jnp.linspace(0.5, 1.5, 6, dtype=jnp.float32),
                 "bias": jnp.linspace(-1.0, 1.0, 6, dtype=jnp.float32)}
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params))
    for step in range(2):
        x = _x((4, 5, 5, 6), seed=10 + step) * 3 + 1
        (jy, jgp, jgx, jstate), (ty, tgp, tgx) = _vjp_pair(
            jm, tm, x, _x((4, 5, 5, 6), 20 + step), training=True)
        _close(ty, jy)
        _close(tgx, jgx)
        _trees_close(tgp, jgp)
        jm.state = jstate
        _trees_close(to_reference_tree(tm)[1], jstate)
        for p in tm.parameters():
            p.grad = None
    x = _x((3, 4, 4, 6), seed=30)
    jy, _ = jm.apply(jm.params, jm.state, jnp.asarray(x), training=False)
    with torch.no_grad():
        ty = tm.eval()(torch.from_numpy(x))
    _close(ty, jy)


def test_batchnorm_bf16(pallas, bf16_policy):
    jm, tm = _pair(jnn.SpatialBatchNormalization(8),
                   tnn.SpatialBatchNormalization(8))
    x = _x((4, 3, 3, 8), seed=31)
    jy, jstate = jm.apply(jm.params, jm.state,
                          jnp.asarray(x).astype(jnp.bfloat16), training=True)
    ty = tm.train()(torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), _np(jy), **BF16_TOL)
    _trees_close(to_reference_tree(tm)[1], jstate)


# -- fused conv-BN ------------------------------------------------------------

def _convbn(nn):
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(8, 12, 1, 1))
    m.add(nn.SpatialBatchNormalization(12))
    m.add(nn.ReLU())
    m.add(nn.SpatialConvolution(12, 12, 3, 3, 1, 1, 1, 1))  # not fusable
    m.add(nn.SpatialBatchNormalization(12))
    nn.fuse_conv_bn(m)
    return m


def _tail(nn):
    branch = (nn.Sequential()
              .add(nn.SpatialConvolution(8, 4, 1, 1, with_bias=False))
              .add(nn.SpatialBatchNormalization(4)).add(nn.ReLU())
              .add(nn.SpatialConvolution(4, 16, 1, 1))
              .add(nn.SpatialBatchNormalization(16)))
    shortcut = (nn.Sequential().add(nn.SpatialConvolution(8, 16, 1, 1))
                .add(nn.SpatialBatchNormalization(16)))
    m = (nn.Sequential()
         .add(nn.ConcatTable().add(branch).add(shortcut))
         .add(nn.CAddTable()).add(nn.ReLU()))
    nn.fuse_conv_bn(m)
    return m


@pytest.mark.parametrize("build", [_convbn, _tail], ids=["convbn", "tail"])
def test_fused_modules_train_and_eval(build, pallas):
    """ConvBN / ConvBNAddReLU in training (the fused kernels' plain
    versions vs interpret-mode Pallas): output, every param grad, the input
    grad and the BN running statistics; then eval (the children's unfused
    composition)."""
    jm, tm = _pair(build(jnn), build(tnn), seed=12)
    kinds = {type(m).__name__ for m in tm.modules()}
    assert "ConvBN" in kinds or "ConvBNAddReLU" in kinds
    x = _x((2, 5, 5, 8), seed=13)
    jy = jm.apply(jm.params, jm.state, jnp.asarray(x), training=True)[0]
    (jy, jgp, jgx, jstate), (ty, tgp, tgx) = _vjp_pair(
        jm, tm, x, _x(jy.shape, 14), training=True)
    _close(ty, jy)
    _close(tgx, jgx)
    _trees_close(tgp, jgp)
    _trees_close(to_reference_tree(tm)[1], jstate)
    jy, _ = jm.apply(jm.params, jstate, jnp.asarray(x), training=False)
    with torch.no_grad():
        ty = tm.eval()(torch.from_numpy(x))
    _close(ty, jy)


def test_fuse_conv_bn_after_build_raises():
    m = tnn.Sequential(tnn.SpatialConvolution(4, 8, 1, 1),
                       tnn.SpatialBatchNormalization(8)).build("cpu")
    with pytest.raises(ValueError, match="before build"):
        tnn.fuse_conv_bn(m)


# -- criteria -----------------------------------------------------------------

CRITERIA = {
    "ce": lambda nn: nn.CrossEntropyCriterion(),
    "ce_sum": lambda nn: nn.CrossEntropyCriterion(size_average=False),
    "ce_smooth": lambda nn: nn.CrossEntropyCriterion(label_smoothing=0.1),
    "ce_weights": lambda nn: nn.CrossEntropyCriterion(
        weights=np.linspace(0.5, 2.0, 7).astype(np.float32)),
    "nll_one_based": lambda nn: nn.ClassNLLCriterion(one_based=True),
}


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion(name):
    logits = _x((9, 7), seed=15) * 2
    labels = np.random.RandomState(16).randint(0, 7, 9).astype(np.int32)
    labels[2] = -1  # padding row
    if name == "nll_one_based":
        labels = labels + 1
        logits = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    jc, tc = CRITERIA[name](jnn), CRITERIA[name](tnn)
    jl, jg = jax.value_and_grad(lambda o: jc.loss(o, jnp.asarray(labels)))(
        jnp.asarray(logits))
    to = torch.from_numpy(logits).requires_grad_()
    tl = tc(to, torch.from_numpy(labels))
    tl.backward()
    _close(tl, jl)
    _close(to.grad, jg)
    _close(tc.backward(torch.from_numpy(logits), torch.from_numpy(labels)),
           jg)


# -- SGD, triggers, dataset ---------------------------------------------------

SGDS = {
    "plain": dict(learning_rate=0.1),
    "momentum_wd": dict(learning_rate=0.05, momentum=0.9,
                        weight_decay=1e-3),
    "dampening": dict(learning_rate=0.05, momentum=0.9, dampening=0.5),
    "nesterov": dict(learning_rate=0.05, momentum=0.9, dampening=0.0,
                     nesterov=True, weight_decay=5e-4),
    "decay": dict(learning_rate=0.1, learning_rate_decay=0.5),
}


@pytest.mark.parametrize("name", sorted(SGDS))
def test_sgd_matches_reference(name):
    """Four updates from the same grads: params, velocity and the
    schedule's lr per iteration."""
    rs = np.random.RandomState(17)
    params = [rs.standard_normal(s).astype(np.float32)
              for s in ((5, 3), (3,), (2, 2, 4))]
    jopt, topt = JSGD(**SGDS[name]), TSGD(**SGDS[name])
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jopt.init_state(jp), topt.init_state(tp)
    for it in range(4):
        grads = [rs.standard_normal(p.shape).astype(np.float32)
                 for p in params]
        state = {"evalCounter": it, "epoch": 1}
        jlr, tlr = jopt.get_learning_rate(state), topt.get_learning_rate(state)
        assert jlr == tlr
        jp, jstate = jopt.update([jnp.asarray(g) for g in grads], jp, jstate,
                                 jnp.float32(jlr))
        tstate = topt.update([torch.from_numpy(g) for g in grads], tp,
                             tstate, tlr)
        for a, b in zip(tp, jp):
            _close(a, b)
    if "velocity" in jstate:
        for a, b in zip(tstate["velocity"], jstate["velocity"]):
            _close(a, b)


def test_nesterov_needs_momentum():
    with pytest.raises(ValueError, match="Nesterov"):
        TSGD(0.1, nesterov=True)


def test_unported_options_raise():
    """Options of the reference that this slice does not port refuse to
    run rather than compute something else."""
    with pytest.raises(NotImplementedError, match="affine"):
        tnn.SpatialBatchNormalization(4, affine=False)
    with pytest.raises(NotImplementedError, match="sync"):
        tnn.SpatialBatchNormalization(4, sync_axis="data")
    with pytest.raises(NotImplementedError, match="SAME"):
        tnn.SpatialConvolution(3, 4, 3, 3, pad_w=-1, pad_h=-1)
    with pytest.raises(NotImplementedError, match="distributed"):
        TDataSet.array([1, 2], distributed=True)


def test_triggers_match_reference():
    for make in ("max_epoch", "max_iteration", "several_iteration"):
        jt, tt = getattr(JTrigger, make)(3), getattr(TTrigger, make)(3)
        for e in range(1, 6):
            for n in range(1, 8):
                s = {"epoch": e, "neval": n}
                assert jt(s) == tt(s), (make, s)
    jt, tt = JTrigger.every_epoch(), TTrigger.every_epoch()
    for e in (1, 1, 2, 2, 3, 5):
        assert jt({"epoch": e}) == tt({"epoch": e})


def test_dataset_shuffle_order_matches_reference():
    records = list(range(23))
    jd, td = JDataSet.array(records, seed=5), TDataSet.array(records, seed=5)
    for _ in range(3):
        jd.shuffle()
        td.shuffle()
        assert list(jd.data(train=True)) == list(td.data(train=True))
    assert list(td.data(train=False)) == records


# -- the float32-accumulating matmul ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_f32_backward(dtype):
    """``matmul_f32``'s gradients are the float32 products of the operands
    (and the cotangent) rounded to the operands' dtype."""
    rs = np.random.RandomState(18)
    a = torch.from_numpy(rs.standard_normal((2, 5, 8)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((8, 3)).astype(np.float32))
    g = torch.from_numpy(rs.standard_normal((2, 5, 3)).astype(np.float32))
    a, b = a.to(dtype).requires_grad_(), b.to(dtype).requires_grad_()
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    af, bf, gf = a.detach().float(), b.detach().float(), g.to(dtype).float()
    ga = (gf @ bf.t()).to(dtype)
    gb = (af.reshape(-1, 8).t() @ gf.reshape(-1, 3)).to(dtype)
    assert a.grad.dtype == b.grad.dtype == dtype
    _close(a.grad, ga)
    _close(b.grad, gb)
    _close(out, af @ bf)
