"""The port's flash_attention against the JAX package's.

On the CPU the port's wrapper computes its plain version; here it is held
to the reference's Pallas kernel run in interpret mode (as
tests/test_parallel.py runs it) and to the reference's mha_reference, in
float32 on unit-scale inputs made with numpy.  The CUDA kernels themselves
run only on the card: chip_smoke.py holds them against the plain version
there.  What surrounds them is tested here: the route each dtype takes,
which operands are read in place, the tile sizes, and (by a plain
emulation) where the tensor-core kernel rounds.

Tolerance: 1e-5 absolute and relative.  Both sides take the scores and the
softmax in float32; they differ only in summation order (blockwise online
softmax vs one dense softmax), which moves unit-scale outputs by a few
float32 ulps.  The emulation of the bf16 kernel is held to mha_reference
in bf16 within chip_smoke.py's KERNEL_TOL[bf16], (2e-2, 1e-2)."""

import math
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bigdl_tpu.ops import attention as jattn

from bigdl_torch.ops import attention as tattn

ATOL = RTOL = 1e-5


def _qkv(B, H, Tq, Tk, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, H, Tq, D)).astype(np.float32),
            rs.standard_normal((B, H, Tk, D)).astype(np.float32),
            rs.standard_normal((B, H, Tk, D)).astype(np.float32))


def _port(q, k, v, **kw):
    out = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                **kw)
    return out.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [16, 37, 64])
@pytest.mark.parametrize("D", [16, 32])
def test_flash_matches_pallas_interpret(causal, T, D):
    q, k, v = _qkv(1, 2, T, T, D, seed=T * D + causal)
    pallas = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   use_pallas=True, interpret=True,
                                   block_q=16, block_k=16)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal)
    out = _port(q, k, v, causal=causal)
    assert out.dtype == np.float32 and out.shape == (1, 2, T, D)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_query_shorter_than_keys(causal):
    q, k, v = _qkv(2, 2, 16, 37, 16, seed=7 + causal)
    pallas = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   use_pallas=True, interpret=True,
                                   block_q=16, block_k=16)
    out = _port(q, k, v, causal=causal)
    assert out.shape == (2, 2, 16, 16)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL, rtol=RTOL)


def test_fully_masked_rows_are_exact_zero():
    """Keys placed wholly after the queries (k_offset past every q): every
    row is masked, and both versions give exactly 0, not NaN."""
    q, k, v = _qkv(1, 2, 8, 8, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = tattn.mha_reference(tq, tk, tv, causal=True, q_offset=0,
                              k_offset=8).numpy()
    ref = np.asarray(jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         q_offset=0, k_offset=8))
    assert np.array_equal(out, np.zeros_like(out))
    assert np.array_equal(ref, np.zeros_like(ref))
    # half the rows see keys, half see none: the masked half is exact 0
    out = tattn.mha_reference(tq, tk, tv, causal=True, q_offset=4,
                              k_offset=8).numpy()
    ref = np.asarray(jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         q_offset=4, k_offset=8))
    assert np.array_equal(out[:, :, :4], np.zeros_like(out[:, :, :4]))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_default_scale_and_explicit_scale():
    q, k, v = _qkv(1, 1, 9, 9, 16, seed=11)
    a = _port(q, k, v, causal=True)
    b = _port(q, k, v, causal=True, sm_scale=0.25)  # 1/sqrt(16)
    np.testing.assert_array_equal(a, b)
    c = _port(q, k, v, causal=True, sm_scale=0.5)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, sm_scale=0.5)
    np.testing.assert_allclose(c, np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_cpu_route_launches_no_kernel():
    before = tattn.flash_attention.launches
    q, k, v = _qkv(1, 1, 4, 4, 16, seed=0)
    _port(q, k, v)
    assert tattn.flash_attention.launches == before


@pytest.mark.parametrize("shape,dtype,kw,err", [
    ((1, 2, 8, 24), torch.float32, {}, ValueError),        # no D=24 instance
    ((1, 2, 8, 64), torch.float16, {}, TypeError),         # fp16 not built
    ((1, 2, 8, 64), torch.float32, {"block_q": 256}, ValueError),
    ((1, 2, 8, 64), torch.bfloat16, {"block_k": 64}, ValueError),  # f32's
])
def test_kernel_argument_checks(shape, dtype, kw, err):
    """What the wrapper refuses before any launch: head dims and dtypes
    without a kernel instance, and tile sizes other than the route's."""
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(err):
        tattn._check_cuda(q, q, q, kw.get("block_q"), kw.get("block_k"))


@pytest.mark.parametrize("dtype,rt", [(torch.float32, "f32"),
                                      (torch.bfloat16, "tc")])
def test_route_tiles_are_accepted(dtype, rt):
    q = torch.zeros((1, 2, 8, 64), dtype=dtype)
    assert tattn._check_cuda(q, q, q) == rt
    assert tattn._check_cuda(q, q, q, tattn.BLOCK_Q[rt],
                             tattn.BLOCK_K[rt]) == rt


def test_kernel_refuses_autograd_inputs():
    """The forward-only refusal is gone now that the backward (B7) is
    ported: the kernels take operands that need a gradient, and under grad
    flash_attention returns the FlashAttention Function's output, in
    inference mode and on tensors that need none the plain call's."""
    q = torch.zeros((1, 2, 8, 64), requires_grad=True)
    assert tattn._check_cuda(q, q, q) == "f32"
    out = tattn.flash_attention(q, q, q)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.inference_mode():
        assert tattn._check_cuda(q, q, q) == "f32"
        assert tattn.flash_attention(q, q, q).grad_fn is None
    assert tattn.flash_attention(q.detach(), q.detach(),
                                 q.detach()).grad_fn is None


@pytest.mark.parametrize("T", [128, 256, 512])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_serving_shapes_take_their_route_in_place(B, T):
    """MultiHeadAttention's [B, 8, T, 64] views of [B, T, 8, 64] memory:
    bf16 goes to the tensor-core kernel and float32 to the CUDA-core one,
    both reading the views where they lie (no copy)."""
    for dtype, rt in ((torch.bfloat16, "tc"), (torch.float32, "f32")):
        q = torch.zeros((B, T, 8, 64), dtype=dtype).transpose(1, 2)
        assert tattn._check_cuda(q, q, q) == rt
        assert tattn.tma_ready(q)
        assert tattn._operand(q, rt) is q


def test_misaligned_bf16_view_is_copied():
    """A bf16 operand a tensor map cannot describe (base not 16-byte
    aligned, or a T stride that is no multiple of 16 bytes) reaches the
    tensor-core kernel as a contiguous copy with the same values."""
    base = torch.arange(2 * 2 * 16 * 64 + 1, dtype=torch.float32).to(
        torch.bfloat16)
    q = base[1:].view(2, 2, 16, 64)
    assert q.data_ptr() % 16 != 0 and not tattn.tma_ready(q)
    odd = torch.zeros((2, 2, 16, 68), dtype=torch.bfloat16)[..., :64]
    odd = odd.as_strided((2, 2, 16, 64), (2 * 16 * 68, 16 * 68, 68, 1))
    assert not tattn.tma_ready(odd)  # 136-byte rows
    for t in (q, odd):
        c = tattn._operand(t, "tc")
        assert c is not t and tattn.tma_ready(c) and torch.equal(c, t)
    # the float32 kernel reads any view with a unit last stride in place
    f = torch.zeros((2, 16, 3, 64))[1:].transpose(1, 2)
    assert tattn._operand(f, "f32") is f


def _tc_emulation(q, k, v, causal):
    """The "tc" kernel's arithmetic in plain PyTorch: scores in float32,
    an online softmax in the log2 domain over 128-key tiles, the
    un-normalised p rounded to bf16 per tile for the P.V product, l summed
    from the float32 p, and O / l rounded to bf16 at the end."""
    B, H, Tq, D = q.shape
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    rows = torch.arange(Tq)[:, None]
    o = torch.zeros((B, H, Tq, D))
    m = torch.full((B, H, Tq), float("-inf"))
    ell = torch.zeros((B, H, Tq))
    for k0 in range(0, k.shape[2], 128):
        kt, vt = k[:, :, k0:k0 + 128], v[:, :, k0:k0 + 128]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kt.float()) * scale_log2
        if causal:
            cols = k0 + torch.arange(kt.shape[2])[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        ell = ell * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vt.float())
        m = m_new
    inv = torch.where(ell == 0, 0.0, 1.0 / ell)
    return (o * inv[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Tq,Tk,D", [(2, 2, 200, 200, 64),
                                         (1, 2, 128, 512, 64)])
def test_tc_rounding_fits_the_bf16_tolerance(B, H, Tq, Tk, D, causal):
    """Rounding the un-normalised p per 128-key tile (the kernel) instead
    of the normalised p once (mha_reference) stays inside the tolerance
    chip_smoke.py holds the kernel to."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(B, H, Tq, Tk, D, seed=Tq + Tk + causal))
    out = _tc_emulation(q, k, v, causal).float()
    ref = tattn.mha_reference(q, k, v, causal=causal).float()
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= 2e-2 + 1e-2 * ref.abs()).all())


def test_library_path_tracks_headers(monkeypatch, tmp_path):
    """Every library's name hashes the shared headers too: editing
    csrc/hopper.cuh renames (so rebuilds) every library, and an unchanged
    tree keeps its names."""
    from bigdl_torch.utils import cuda_build

    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    before = {n: cuda_build._library_path(n) for n in cuda_build.SOURCES}
    assert before == {n: cuda_build._library_path(n)
                      for n in cuda_build.SOURCES}
    header = src / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._library_path(n) for n in cuda_build.SOURCES}
    assert all(after[n] != before[n] for n in cuda_build.SOURCES)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The build runs only where nvcc is; elsewhere it says so instead of
    leaving a half-built library.  Library names track the source hash."""
    from bigdl_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["flash_attention"])
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    lib = cuda_build._library_path("flash_attention")
    assert lib.startswith(str(tmp_path / "build"))
    assert lib.endswith(".so") and "libflash_attention-" in lib
