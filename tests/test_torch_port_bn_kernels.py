"""The port's BatchNorm and conv-BN kernels (B1, B2, B4, B5) against the
JAX package's Pallas kernels.

On the CPU each wrapper of ``bigdl_torch.ops`` computes its plain version;
here those are held to the reference's Pallas kernels run in interpret
mode, on inputs made with numpy.  The CUDA kernels themselves run only on
the card: ``chip_smoke.py`` holds them against the same plain versions
there.

Tolerances, as a bound on max|port − reference| relative to the largest
|reference| value of the compared output (``_close``):
- float32: 1e-5.  Both sides compute in float32 and differ in summation
  order (blocked sums in the kernel, one reduction in torch), which moves
  sums over 10^3 rows by a few float32 ulps of their magnitude.
- bfloat16 inputs: the statistics and sums are float32 over the same
  bf16 values, so they keep 1e-5.  Outputs stored in bf16 (y, dx, z) are
  rounded once on each side from float32 values that may differ in the
  last float32 bits (a fused multiply-add against two roundings), so a
  value can land one bf16 step (2^-8 relative) apart: 2^-7 relative to the
  output's magnitude.  The fused conv-BN functions compute their
  elementwise tail in bf16, as the reference does, op by op; each op can
  round one step apart, so their outputs and grads get 2^-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bigdl_tpu.ops import batchnorm as jbn
from bigdl_tpu.ops import convbn as jcb

from bigdl_torch.ops import batchnorm as tbn
from bigdl_torch.ops import convbn as tcb

EPS = 1e-5
F32 = 1e-5
BF16_OUT = 2.0 ** -7
BF16_TAIL = 2.0 ** -5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(port, ref, tol):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _pair(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _bn_inputs(R, C, seed):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((R, C)) * 2 + 0.5).astype(np.float32)
    dy = rs.standard_normal((R, C)).astype(np.float32)
    w = (rs.rand(C) + 0.5).astype(np.float32)
    b = rs.standard_normal(C).astype(np.float32)
    return x, dy, w, b


SHAPES = [(1000, 3), (1000, 64), (1000, 130)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", SHAPES)
def test_bn_forward_matches_pallas(R, C, dtype):
    """B1: (y, mean, var) of the plain version vs ``_bn_fwd_pallas``."""
    x, _, w, b = _bn_inputs(R, C, seed=C)
    jx, tx = _pair(x, dtype)
    jy, jm, jv = jbn.bn_train(jx, jnp.asarray(w), jnp.asarray(b), EPS, 256,
                              True)
    ty, tm, tv = tbn.bn_forward(tx, torch.from_numpy(w), torch.from_numpy(b),
                                EPS)
    assert ty.dtype == tx.dtype and tm.dtype == tv.dtype == torch.float32
    _close(ty, jy, F32 if dtype == "float32" else BF16_OUT)
    _close(tm, jm, F32)
    _close(tv, jv, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", SHAPES)
def test_bn_train_vjp_matches_pallas(R, C, dtype):
    """B2 through the autograd Function: dx, dγ, dβ vs ``jax.vjp`` of the
    reference's ``bn_train`` (whose backward is ``_bn_bwd_pallas``)."""
    x, dy, w, b = _bn_inputs(R, C, seed=C + 1)
    jx, tx = _pair(x, dtype)
    jdy, tdy = _pair(dy, dtype)
    (jy, _, _), vjp = jax.vjp(
        lambda x_, w_, b_: jbn.bn_train(x_, w_, b_, EPS, 256, True),
        jx, jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp((jdy, jnp.zeros(C), jnp.zeros(C)))
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tx.requires_grad_()
    ty, tm, tv = tbn.bn_train(tx, tw, tb, EPS)
    assert not tm.requires_grad and not tv.requires_grad
    ty.backward(tdy)
    out_tol = F32 if dtype == "float32" else BF16_OUT
    _close(ty, jy, out_tol)
    assert tx.grad.dtype == tx.dtype
    _close(tx.grad, jdx, out_tol)
    _close(tw.grad, jdw, F32)
    _close(tb.grad, jdb, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", SHAPES)
def test_bn_grad_stats_matches_pallas(R, C, dtype):
    """B4: (Σdy, Σdy·x̂) vs ``_bn_grad_stats_pallas``."""
    x, dy, _, _ = _bn_inputs(R, C, seed=C + 2)
    mean = x.mean(0).astype(np.float32)
    inv = (1.0 / np.sqrt(x.var(0) + EPS)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdy, tdy = _pair(dy, dtype)
    js, jsx = jbn._bn_grad_stats_pallas(jx, jdy, jnp.asarray(mean),
                                        jnp.asarray(inv), block_r=256,
                                        interpret=True)
    ts, tsx = tbn.bn_grad_stats(tx, tdy, torch.from_numpy(mean),
                                torch.from_numpy(inv))
    _close(ts, js, F32)
    _close(tsx, jsx, F32)


def test_bn_backward_plain_is_the_kernels_sums():
    """B2's sums are B4's: the backward's (Σdy, Σdy·x̂) equal the
    grad-stat pass bit for bit."""
    x, dy, w, _ = _bn_inputs(500, 7, seed=3)
    tx, tdy, tw = (torch.from_numpy(a) for a in (x, dy, w))
    mean, inv = tx.mean(0), torch.rsqrt(tx.var(0, unbiased=False) + EPS)
    _, s, sx = tbn.bn_backward(tx, tdy, mean, inv, tw)
    s2, sx2 = tbn.bn_grad_stats(tx, tdy, mean, inv)
    assert torch.equal(s, s2) and torch.equal(sx, sx2)


MM_SHAPES = [(300, 70, 130), (37, 19, 3), (256, 64, 64)]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,K,C", MM_SHAPES)
def test_matmul_stats_matches_pallas(R, K, C, dtype, bias):
    """B5: (y, Σy, Σy²) vs ``matmul_stats(interpret=True)``, ragged R, K
    and C included."""
    rs = np.random.RandomState(R + K + C)
    x = rs.standard_normal((R, K)).astype(np.float32)
    w = (rs.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32)
    b = rs.standard_normal(C).astype(np.float32) if bias else None
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jy, js, jss = jcb.matmul_stats(jx, jw, None if b is None
                                   else jnp.asarray(b), interpret=True)
    ty, ts, tss = tcb.matmul_stats(tx, tw, None if b is None
                                   else torch.from_numpy(b))
    assert ty.dtype == tx.dtype and ts.dtype == tss.dtype == torch.float32
    _close(ty, jy, F32 if dtype == "float32" else BF16_OUT)
    _close(ts, js, F32)
    _close(tss, jss, F32)


def _fused_inputs(R, K, C, dtype, seed):
    rs = np.random.RandomState(seed)
    arrays = dict(
        x2=rs.standard_normal((R, K)).astype(np.float32),
        w2=(rs.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32),
        bias=rs.standard_normal(C).astype(np.float32),
        gamma=(rs.rand(C) + 0.5).astype(np.float32),
        beta=rs.standard_normal(C).astype(np.float32),
        resid=rs.standard_normal((R, C)).astype(np.float32),
        dz=rs.standard_normal((R, C)).astype(np.float32))
    jdt, tdt = DTYPES[dtype]
    low = ("x2", "w2", "resid", "dz")  # compute dtype; the rest float32
    j = {k: jnp.asarray(v).astype(jdt if k in low else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(tdt if k in low else torch.float32)
         for k, v in arrays.items()}
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("add_relu", [False, True])
def test_fused_conv_bn_matches_reference(add_relu, dtype):
    """``fused_conv_bn_train`` / ``fused_conv_bn_add_relu_train``: the
    forward (z, mean, var) and the grads of x2, w2, γ, β (and resid) vs
    the reference's custom VJPs with interpret-mode kernels; the conv-bias
    grad is exactly zero."""
    R, K, C = 200, 24, 40
    j, t = _fused_inputs(R, K, C, dtype, seed=11 + add_relu)
    names = ["x2", "w2", "bias", "gamma", "beta"] + (["resid"] if add_relu
                                                      else [])
    if add_relu:
        def jfn(x2, w2, bias, gamma, beta, resid):
            return jcb.fused_conv_bn_add_relu_train(x2, w2, bias, gamma,
                                                    beta, resid, EPS, True)
        tfn = tcb.fused_conv_bn_add_relu_train
    else:
        def jfn(x2, w2, bias, gamma, beta):
            return jcb.fused_conv_bn_train(x2, w2, bias, gamma, beta, EPS,
                                           True)
        tfn = tcb.fused_conv_bn_train
    (jz, jm, jv), vjp = jax.vjp(jfn, *(j[n] for n in names))
    jgrads = vjp((j["dz"], jnp.zeros(C), jnp.zeros(C)))
    targs = [t[n].clone().requires_grad_() for n in names]
    args = targs[:5] + ([targs[5]] if add_relu else []) + [EPS]
    tz, tm, tv = tfn(*args)
    tz.backward(t["dz"])
    tol = F32 if dtype == "float32" else BF16_TAIL
    assert tz.dtype == t["x2"].dtype
    _close(tz, jz, tol)
    _close(tm, jm, F32)
    _close(tv, jv, F32)
    for name, ta, jg in zip(names, targs, jgrads):
        if name == "bias":
            assert torch.count_nonzero(ta.grad) == 0
            continue
        _close(ta.grad, jg, tol)


@pytest.mark.parametrize("name", ["bn_forward", "bn_backward",
                                  "bn_grad_stats", "matmul_stats"])
def test_wrappers_have_no_other_route(name):
    """Only CPU tensors take the plain version; a tensor on any other
    non-CUDA device is refused, not computed some other way."""
    x = torch.empty((8, 4), device="meta")
    v = torch.empty((4,), device="meta")
    calls = {"bn_forward": lambda: tbn.bn_forward(x, v, v, EPS),
             "bn_backward": lambda: tbn.bn_backward(x, x, v, v, v),
             "bn_grad_stats": lambda: tbn.bn_grad_stats(x, x, v, v),
             "matmul_stats": lambda: tcb.matmul_stats(x, x.t())}
    fn = getattr(tbn, name, None) or getattr(tcb, name)
    launches = fn.launches
    with pytest.raises(ValueError, match="no route"):
        calls[name]()
    assert fn.launches == launches
