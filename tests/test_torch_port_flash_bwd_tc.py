"""The log-sum-exp contract between the flash forward (B6) and backward
(B7), and the arithmetic of B7's bf16 route ``"tc"``, on the CPU.

- ``flash_lse_reference`` (the plain version of the log-sum-exp B6 writes
  for training) against ``jax.nn.logsumexp`` of the scores the JAX
  package's ``mha_reference`` takes, with the same masks; the softmax
  rebuilt from it against the reference's.  Tolerance: float32, 1e-5
  absolute (both sides take the same float32 scores and differ in
  summation order only); a row whose every key is masked gives exactly 0.
- ``_tc_bwd_emulation``: the ``"tc"`` kernels' arithmetic in plain
  PyTorch (the forward's log-sum-exp, the exp2 domain, P and dS rounded to
  bf16 before the dv, dk and dq products, 128-row items and 64-row
  streamed tiles), held to ``flash_bwd_reference`` within chip_smoke.py's
  ``B7_TOL[bf16]``, (2e-2, 1e-2): the design's rounding fits the tolerance
  the card holds the kernel to.
- The wrapper's rules: the bf16 route, and the refusal of a missing or
  misshapen log-sum-exp before any launch (a check the CPU can call).

None of these runs a kernel: CUDA kernels run only on the card, where
chip_smoke.py holds them against the plain versions.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bigdl_tpu.ops import attention as jattn

from bigdl_torch.ops import attention as tattn

LSE_TOL = 1e-5
B7_TOL_BF16 = (2e-2, 1e-2)


def _arrays(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_scores(q, k, causal, q_offset=0, k_offset=0):
    """The scores the JAX package's mha_reference takes, with its mask."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST) * scale
    if causal:
        qi = q_offset + jnp.arange(q.shape[2])[:, None]
        kj = k_offset + jnp.arange(k.shape[2])[None, :]
        s = jnp.where(kj > qi, -jnp.inf, s)
    return s


@pytest.mark.parametrize("Tq,Tk", [(64, 64), (37, 200), (200, 37)])
@pytest.mark.parametrize("causal", [False, True])
def test_lse_reference_matches_jax_logsumexp(causal, Tq, Tk):
    q, k = _arrays([(2, 2, Tq, 32), (2, 2, Tk, 32)], seed=Tq + Tk + causal)
    s = _jax_scores(q, k, causal)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = tattn.flash_lse_reference(torch.from_numpy(q),
                                    torch.from_numpy(k), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, 2, Tq)
    np.testing.assert_allclose(got.numpy(), want, atol=LSE_TOL, rtol=0)
    # exp(s - lse) is the reference's softmax
    p = np.exp(np.asarray(s) - got.numpy()[..., None])
    np.testing.assert_allclose(p, np.asarray(jax.nn.softmax(s, axis=-1)),
                               atol=LSE_TOL, rtol=0)


def test_lse_reference_fully_masked_rows_are_zero():
    """Keys placed after half the queries: those rows have every key
    masked; the reference's logsumexp gives -inf there, the port 0."""
    q, k = _arrays([(1, 2, 8, 32), (1, 2, 8, 32)], seed=5)
    s = _jax_scores(q, k, True, q_offset=4, k_offset=8)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = tattn.flash_lse_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    causal=True, q_offset=4, k_offset=8)
    assert np.isneginf(want[:, :, :4]).all()
    assert torch.equal(got[:, :, :4], torch.zeros((1, 2, 4)))
    np.testing.assert_allclose(got[:, :, 4:].numpy(), want[:, :, 4:],
                               atol=LSE_TOL, rtol=0)


def test_with_lse_on_cpu_is_the_plain_pair():
    """flash_attention_with_lse on the CPU: mha_reference and
    flash_lse_reference, no kernel launched, no autograd graph."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _arrays(
        [(1, 2, 37, 32), (1, 2, 50, 32), (1, 2, 50, 32)], seed=3))
    before = tattn.flash_attention.launches
    o, lse = tattn.flash_attention_with_lse(q, k, v, causal=True)
    assert tattn.flash_attention.launches == before
    assert o.grad_fn is None and lse.grad_fn is None
    assert torch.equal(o, tattn.mha_reference(q, k, v, causal=True).detach())
    assert torch.equal(lse, tattn.flash_lse_reference(q, k, causal=True))


# -- the "tc" route's arithmetic ----------------------------------------------

def _tc_bwd_emulation(q, k, v, o, do, lse, causal):
    """(dq, dk, dv) as the "tc" kernels compute them, in plain PyTorch:
    launch 1 over items of 128 query rows and streamed tiles of 64 keys
    (S, dP, then dq += bf16(dS) K), launch 2 over items of 128 keys and
    streamed tiles of 64 queries (S^T, dP^T, then dv += bf16(P^T) dO and
    dk += bf16(dS^T) Q); P = exp2(S scale log2 e - lse log2 e) with the
    forward's log-sum-exp, delta = rowsum(do * o) from the bf16 o; float32
    sums; outputs rounded to bf16 once."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    c2 = scale * math.log2(math.e)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    lse2 = lse * math.log2(math.e)
    delta = (gf * o.float()).sum(-1)
    bf = torch.bfloat16

    def p_tile(s, rows, cols, lse_rows):
        p = torch.exp2(s * c2 - lse_rows)
        if causal:
            p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
        return p

    dq = torch.zeros((B, H, Tq, D))
    for q0 in range(0, Tq, 128):
        rows = torch.arange(q0, min(q0 + 128, Tq))
        qi, gi = qf[:, :, rows], gf[:, :, rows]
        end = min(Tk, q0 + 128) if causal else Tk
        for k0 in range(0, end, 64):
            cols = torch.arange(k0, min(k0 + 64, Tk))
            kt, vt = kf[:, :, cols], vf[:, :, cols]
            p = p_tile(torch.einsum("bhqd,bhkd->bhqk", qi, kt), rows, cols,
                       lse2[:, :, rows, None])
            dp = torch.einsum("bhqd,bhkd->bhqk", gi, vt)
            ds = p * (dp - delta[:, :, rows, None])
            dq[:, :, rows] += torch.einsum(
                "bhqk,bhkd->bhqd", ds.to(bf).float(), kt)
    dk = torch.zeros((B, H, Tk, D))
    dv = torch.zeros((B, H, Tk, D))
    for k0 in range(0, Tk, 128):
        keys = torch.arange(k0, min(k0 + 128, Tk))
        kt, vt = kf[:, :, keys], vf[:, :, keys]
        for qt in range(k0 if causal else 0, Tq, 64):
            cols = torch.arange(qt, min(qt + 64, Tq))
            qi, gi = qf[:, :, cols], gf[:, :, cols]
            st = torch.einsum("bhkd,bhqd->bhkq", kt, qi)
            pt = torch.exp2(st * c2 - lse2[:, :, None, cols])
            if causal:
                pt = pt.masked_fill(keys[:, None] > cols[None, :], 0.0)
            dpt = torch.einsum("bhkd,bhqd->bhkq", vt, gi)
            dst = pt * (dpt - delta[:, :, None, cols])
            dv[:, :, keys] += torch.einsum(
                "bhkq,bhqd->bhkd", pt.to(bf).float(), gi)
            dk[:, :, keys] += torch.einsum(
                "bhkq,bhqd->bhkd", dst.to(bf).float(), qi)
    return (dq * scale).to(bf), (dk * scale).to(bf), dv.to(bf)


@pytest.mark.parametrize("B,H,Tq,Tk,D,causal", [
    (2, 2, 512, 512, 64, True),    # the LM step's call, cut in B and H
    (2, 2, 200, 200, 64, False),
    (1, 2, 37, 200, 32, False),
    (1, 2, 200, 37, 32, True),
    (1, 2, 200, 37, 128, False),
    (1, 2, 130, 200, 128, True),
])
def test_tc_bwd_rounding_fits_the_bf16_tolerance(B, H, Tq, Tk, D, causal):
    """Rounding P and dS to bf16 for the three products, and taking P from
    the forward's log-sum-exp in the exp2 domain, stays within B7_TOL[bf16]
    of flash_bwd_reference (float32 throughout) on bf16 operands."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(
        [(B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D), (B, H, Tq, D)],
        seed=Tq * 3 + Tk + D + causal))
    o, lse = tattn.flash_attention_with_lse(q, k, v, causal=causal)
    got = _tc_bwd_emulation(q, k, v, o, do, lse, causal)
    want = tattn.flash_bwd_reference(q, k, v, do, causal=causal)
    atol, rtol = B7_TOL_BF16
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert bool(((g - w).abs() <= atol + rtol * w.abs()).all()), \
            float((g - w).abs().max())


# -- the wrapper's rules --------------------------------------------------------

def test_bf16_backward_takes_the_tc_route():
    assert tattn.bwd_route(torch.bfloat16) == "tc"
    assert tattn.bwd_route(torch.float32) == "f32"
    assert set(tattn.flash_attention_bwd.route_launches) == {"f32", "tc"}
    q = torch.zeros((2, 8, 64, 64), dtype=torch.bfloat16)
    lse = torch.zeros((2, 8, 64))
    assert tattn._check_bwd(q, q, q, q, q, lse) == "tc"
    assert tattn._check_bwd(q.float(), q.float(), q.float(), q.float(),
                            q.float(), lse) == "f32"


@pytest.mark.parametrize("bad", [
    "missing", "shape", "dtype", "strided", "o_dtype",
])
def test_backward_refuses_a_missing_or_misshapen_lse(bad):
    """What the CUDA route refuses before any launch: no log-sum-exp (the
    kernels never recompute it), one of another shape, type or layout,
    and an o that does not match q."""
    q = torch.zeros((2, 4, 37, 64), dtype=torch.bfloat16)
    o = q
    lse = {"missing": None,
           "shape": torch.zeros((8, 37)),
           "dtype": torch.zeros((2, 4, 37), dtype=torch.bfloat16),
           "strided": torch.zeros((2, 4, 74))[..., ::2],
           "o_dtype": torch.zeros((2, 4, 37))}[bad]
    if bad == "o_dtype":
        o = q.float()
    with pytest.raises(ValueError):
        tattn._check_bwd(q, q, q, o, q, lse)


def test_cpu_backward_ignores_lse():
    """On the CPU the backward is flash_bwd_reference whatever lse is
    given (and without one)."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(
        [(1, 2, 20, 32), (1, 2, 30, 32), (1, 2, 30, 32), (1, 2, 20, 32)],
        seed=11))
    want = tattn.flash_bwd_reference(q, k, v, g, causal=True)
    for lse in (None, torch.full((1, 2, 20), 7.0)):
        got = tattn.flash_attention_bwd(q, k, v, g, g, lse=lse, causal=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tattn.flash_attention_bwd.launches == 0
