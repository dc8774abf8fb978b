"""The port's BatchNorm and conv-BN kernels (B1 to B5) against the JAX
package's Pallas kernels, and the layout of their ``"vec"`` route.

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


# (R, K, C) of the 12 distinct B5 calls of a fused ResNet-50 step at batch
# 256, 224x224 (chip_smoke.py records them on the card)
RESNET50_B5_SHAPES = [
    (802816, 64, 64), (802816, 64, 256), (802816, 256, 64),
    (802816, 256, 128), (200704, 128, 512), (200704, 512, 128),
    (200704, 512, 256), (50176, 256, 1024), (50176, 1024, 256),
    (50176, 1024, 512), (12544, 512, 2048), (12544, 2048, 512)]


def _operands(R, K, C, dtype):
    """[R, K] and [K, C] operands without R·K elements of memory: route
    selection reads dtype, shapes and the bases' alignment only."""
    return (torch.empty((1, K), dtype=dtype).expand(R, K),
            torch.empty((K, C), dtype=dtype))


@pytest.mark.parametrize("R,K,C", RESNET50_B5_SHAPES)
def test_resnet50_b5_shapes_take_the_tc_route(R, K, C):
    """Every B5 call of the training step goes to the wgmma kernel in
    bf16, and to the CUDA-core kernel in float32."""
    assert tcb.route(*_operands(R, K, C, torch.bfloat16)) == "tc"
    assert tcb.route(*_operands(R, K, C, torch.float32)) == "f32"


def test_operands_tma_cannot_describe_take_mma_sync():
    """bf16 operands whose rows are no multiple of 16 bytes (chip_smoke's
    ragged (37, 19, 70)) or whose base is not 16-byte aligned go to the
    mma.sync kernel, chosen before any launch."""
    assert tcb.route(*_operands(37, 19, 70, torch.bfloat16)) == "mma_sync"
    assert tcb.route(*_operands(300, 64, 70, torch.bfloat16)) == "mma_sync"
    flat = torch.zeros(8 + 100 * 64, dtype=torch.bfloat16)
    x = flat[1:1 + 100 * 64].view(100, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w = torch.zeros((64, 64), dtype=torch.bfloat16)
    assert tcb.route(x, w) == "mma_sync"
    assert tcb.route(flat[8:].view(100, 64), w) == "tc"


# (R, C) of the B4 calls of a fused ResNet-50 step at batch 256, 224x224,
# and of the data-parallel step's unfused stem (3211264, 64); the 8 B2
# shapes of the step are among them (chip_smoke.py records both on the card)
RESNET50_B4_SHAPES = [
    (802816, 64), (802816, 128), (802816, 256), (200704, 128),
    (200704, 256), (200704, 512), (50176, 256), (50176, 512),
    (50176, 1024), (12544, 512), (12544, 2048), (3211264, 64)]
RESNET50_B2_SHAPES = [
    (3211264, 64), (802816, 64), (200704, 128), (200704, 512),
    (50176, 256), (50176, 1024), (12544, 512), (12544, 2048)]
BN_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rows(R, C, dtype):
    """An [R, C] operand without R·C elements of memory: the route reads
    dtype, C and the base's alignment only."""
    return torch.empty((1, C), dtype=dtype).expand(R, C)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", RESNET50_B4_SHAPES)
def test_resnet50_bn_shapes_take_the_vec_route(R, C, dtype):
    """Every B4 and B2 call of the training step goes to the streaming
    kernel, in bf16 and in float32."""
    assert set(RESNET50_B2_SHAPES) <= set(RESNET50_B4_SHAPES)
    x = _rows(R, C, BN_TORCH_DTYPES[dtype])
    assert tbn.route(x, _rows(R, C, BN_TORCH_DTYPES[dtype])) == "vec"


def test_ragged_or_misaligned_operands_take_scalar():
    """Rows that are no whole number of 16-byte pieces (chip_smoke's
    (1000, 3) and (1000, 130) in bf16) and views whose base is not 16-byte
    aligned go to the one-element-a-thread kernel, chosen before any
    launch."""
    for R, C in [(1000, 3), (1000, 130)]:
        x = _rows(R, C, torch.bfloat16)
        assert tbn.route(x, x) == "scalar"
    assert tbn.route(*[_rows(1000, 130, torch.float32)] * 2) == "scalar"
    flat = torch.zeros(8 + 100 * 64, dtype=torch.bfloat16)
    odd = flat[1:1 + 100 * 64].view(100, 64)
    even = flat[8:].view(100, 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    assert tbn.route(odd, even) == tbn.route(even, odd) == "scalar"
    assert tbn.route(even, even) == "vec"


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("R,C", RESNET50_B4_SHAPES + [(500, 64), (300, 256),
                                                      (1000, 24), (7, 64)])
def test_vec_chunks_cover_every_row_once(R, C, itemsize):
    """Route "vec"'s (row chunk x column tile) grid: chunks are whole row
    steps of the block, cover [0, R) with no empty chunk, fill about two
    blocks a SM, and are a function of the shape and SM count alone."""
    pt, rl, tiles, w = tbn._vec_layout(C, itemsize, tbn._VEC_PIECES)
    assert pt * rl <= 256 and w == pt * 16 // itemsize
    assert tiles * w >= C > (tiles - 1) * w
    n, rows = tbn._vec_chunks(R, C, itemsize, 132, tbn._VEC_PIECES)
    assert (n, rows) == tbn._vec_chunks(R, C, itemsize, 132,
                                        tbn._VEC_PIECES)
    assert rows % rl == 0 and (n - 1) * rows < R <= n * rows
    assert n * tiles <= 2 * 132 + tiles
    if R * rl <= 10 ** 6:
        # row lane l of chunk k takes k·rows + l, + rl, ... below the
        # chunk's end: every row exactly once
        seen = np.zeros(R, np.int64)
        for k in range(n):
            for lane in range(rl):
                seen[k * rows + lane:min(R, (k + 1) * rows):rl] += 1
        assert (seen == 1).all()


def _vec_sums_emulated(x, dy, mean, inv, itemsize, sm_count=132):
    """Route "vec"'s B4 sums (Σdy, Σdy·x̂) in its own float32 order."""
    xhat = ((x - mean) * inv).astype(np.float32)
    return _vec_order_sums(dy, dy * xhat, itemsize, tbn._VEC_PIECES,
                           sm_count)


def _vec_order_sums(a, b, itemsize, max_pieces, sm_count=132):
    """(Σa, Σb) over the rows of the [R, C] float32 terms a, b in the
    order of route "vec"'s stats kernel with column tiles of at most
    ``max_pieces`` 16-byte pieces: each row lane of a block sums its rows
    (stride rl) in order, the block sums its row lanes in lane order into
    one partial row per chunk, and the tile's finishing block sums chunk k
    on k-lane k mod kl_n, then the k-lanes in order."""
    R, C = a.shape
    _, rl, _, w = tbn._vec_layout(C, itemsize, max_pieces)
    n, rows = tbn._vec_chunks(R, C, itemsize, sm_count, max_pieces)
    part = np.zeros((n, 2, C), np.float32)
    for k in range(n):
        block = np.zeros((2, C), np.float32)
        for lane in range(rl):
            s = np.zeros(C, np.float32)
            q = np.zeros(C, np.float32)
            for r in range(k * rows + lane, min(R, (k + 1) * rows), rl):
                s = s + a[r]
                q = q + b[r]
            block = block + np.stack([s, q])
        part[k] = block
    kl_n = 256 // (w // 2)
    lanes = [np.zeros((2, C), np.float32) for _ in range(kl_n)]
    for k in range(n):
        lanes[k % kl_n] = lanes[k % kl_n] + part[k]
    total = lanes[0]
    for lane in lanes[1:]:
        total = total + lane
    return total


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("R,C", [(500, 64), (300, 256)])
def test_vec_summation_order_matches_reference(R, C, itemsize):
    """The "vec" kernel's summation order, emulated in float32, agrees
    with the plain version within the float32 tolerance (the two differ in
    summation order only), for the bf16 and the float32 block layout."""
    x, dy, _, _ = _bn_inputs(R, C, seed=R + C + itemsize)
    mean = x.mean(0).astype(np.float32)
    inv = (1.0 / np.sqrt(x.var(0) + EPS)).astype(np.float32)
    sdy, sdyx = _vec_sums_emulated(x, dy, mean, inv, itemsize)
    rs, rsx = tbn.bn_grad_stats_reference(*(torch.from_numpy(a) for a in
                                            (x, dy, mean, inv)))
    _close(sdy, rs, F32)
    _close(sdyx, rsx, F32)


# -- route "vec" of B1 and B3 --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", RESNET50_B2_SHAPES)
def test_resnet50_b1_shapes_take_the_vec_route(R, C, dtype):
    """Every B1 call of the training step (the B2 shapes: each unfused
    BatchNorm runs B1 forward, B2 backward), and so every B3 call of the
    data-parallel step, goes to the streaming kernel, in bf16 and in
    float32.  B1 and B3 route on x alone, and agree with B4 and B2 on the
    same operands."""
    x = _rows(R, C, BN_TORCH_DTYPES[dtype])
    assert tbn.route(x) == tbn.route(x, x) == "vec"


@pytest.mark.parametrize("R,C,dtype", [(1000, 3, "bfloat16"),
                                       (1000, 130, "bfloat16"),
                                       (1000, 130, "float32"),
                                       (1000, 3, "float32")])
def test_b1_ragged_rows_take_scalar(R, C, dtype):
    """Rows that are no whole number of 16-byte pieces (chip_smoke's
    ragged cases) take the one-element-a-thread kernels for B1 and B3."""
    assert tbn.route(_rows(R, C, BN_TORCH_DTYPES[dtype])) == "scalar"


@pytest.mark.parametrize("offset,want", [(1, "scalar"), (4, "scalar"),
                                         (8, "vec")])
def test_b1_misaligned_x_takes_scalar(offset, want):
    """A view of x whose base is not 16-byte aligned takes "scalar" for B1
    and B3, chosen before any launch; an aligned one "vec"."""
    flat = torch.zeros(8 + 100 * 64, dtype=torch.bfloat16)
    x = flat[offset:offset + 100 * 64].view(100, 64)
    assert x.is_contiguous()
    assert tbn.route(x) == want


@pytest.mark.parametrize("R,C,dtype", [(802816, 64, torch.bfloat16),
                                       (50176, 256, torch.bfloat16),
                                       (12544, 2048, torch.float32),
                                       (1000, 130, torch.bfloat16)])
def test_b1_and_b3_share_one_plan(monkeypatch, R, C, dtype):
    """bn_forward (B1) and bn_stats (B3) take their route and chunking from
    one function of x alone, so for the same x they launch the same stats
    kernel over the same chunks: what makes B3's sums give B1's mean and
    var bit for bit.  On "vec" their column tile is at most 16 pieces
    (B4's and B2's 32)."""
    monkeypatch.setattr(tbn, "_device_state", lambda device: (132, None))
    x = _rows(R, C, dtype)
    rt, n, rows, _ = tbn._plan(x)
    assert rt == tbn.route(x) == tbn._plan(x, x)[0]
    want = (tbn._vec_chunks(R, C, x.element_size(), 132, tbn._VEC_X_PIECES)
            if rt == "vec" else tbn._chunks(R, C))
    assert (n, rows) == want


def _x_inputs(R, C, seed):
    return (np.random.RandomState(seed).standard_normal((R, C)) * 2
            + 0.5).astype(np.float32)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("R,C", [(500, 64), (300, 256), (1000, 24)])
def test_vec_x_sums_match_reference_and_pallas(R, C, itemsize):
    """B3's and B1's (Σx, Σx²) in route "vec"'s float32 order (the same
    kernel and order as B4's sums) agree with the plain version and with
    ``_bn_stats_pallas`` in interpret mode within 1e-5 relative (the three
    differ in summation order only)."""
    dtype = "float32" if itemsize == 4 else "bfloat16"
    x = _x_inputs(R, C, seed=R + C + itemsize)
    jx, tx = _pair(x, dtype)
    xv = tx.float().numpy()  # the values the kernel reads
    s, ss = _vec_order_sums(xv, xv * xv, itemsize, tbn._VEC_X_PIECES)
    rs, rss = tbn.bn_stats_reference(tx)
    js, jss = jbn._bn_stats_pallas(jx, block_r=256, interpret=True)
    for got, ref in [(s, rs), (ss, rss), (s, js), (ss, jss)]:
        _close(got, ref, F32)


def _finish(s, ss, n):
    """The "vec" finish's mean and var: each float32 operation rounded on
    its own (mean = Σx/R, var = Σx²/R − mean·mean)."""
    f = np.float32
    mean = (s / f(n)).astype(f)
    return mean, (ss / f(n) - (mean * mean).astype(f)).astype(f)


@pytest.mark.parametrize("R,C", [(500, 64), (1000, 24)])
def test_b1_finish_equals_b3_statistics(R, C):
    """Mean and var from the emulated "vec" sums by the kernel's finish
    equal those the data-parallel caller (and chip_smoke's
    ``b3_gives_b1_statistics``) computes from B3's sums in torch."""
    x = _x_inputs(R, C, seed=R * C)
    xv = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    s, ss = _vec_order_sums(xv, xv * xv, 2, tbn._VEC_X_PIECES)
    mean, var = _finish(s, ss, R)
    ts, tss = torch.from_numpy(s), torch.from_numpy(ss)
    n = torch.full_like(ts, R)
    m = ts / n
    assert torch.equal(torch.from_numpy(mean), m)
    assert torch.equal(torch.from_numpy(var), tss / n - m * m)


@pytest.mark.parametrize("kernel", ["b1_normalize", "b2_dx"])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("R,C", RESNET50_B2_SHAPES + [(500, 64), (300, 256),
                                                      (1000, 24), (7, 64)])
def test_vec_backward_walk_covers_every_row_once(R, C, itemsize, kernel):
    """B1's normalize and B2's dx pass, each over its kernel's chunks: the
    thread at row lane l of chunk k starts at its last row,
    r0 + l + (n − 1)·rl with n its row count, and steps back by rl n
    times; together the threads cover every row of every chunk exactly
    once, and never leave their chunk."""
    pieces = (tbn._VEC_X_PIECES if kernel == "b1_normalize"
              else tbn._VEC_PIECES)
    pt, rl, tiles, _ = tbn._vec_layout(C, itemsize, pieces)
    assert pt * rl <= 256
    n_chunks, rows = tbn._vec_chunks(R, C, itemsize, 132, pieces)
    assert rows % rl == 0 and (n_chunks - 1) * rows < R <= n_chunks * rows
    assert n_chunks * tiles <= 2 * 132 + tiles
    seen = np.zeros(R, np.int64)
    for k in range(n_chunks):
        r0, r1 = k * rows, min(R, (k + 1) * rows)
        for lane in range(rl):
            first = r0 + lane
            n = (r1 - first + rl - 1) // rl if first < r1 else 0
            walk = first + (n - 1) * rl - rl * np.arange(n)
            assert n == 0 or (walk.min() >= r0 and walk.max() < r1)
            seen[walk] += 1
    assert (seen == 1).all()
