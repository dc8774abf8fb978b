"""The port's flash_attention against the JAX package's.

On the CPU the port's wrapper computes its plain version; here it is held
to the reference's Pallas kernel run in interpret mode (as
tests/test_parallel.py runs it) and to the reference's mha_reference, in
float32 on unit-scale inputs made with numpy.  The CUDA kernel itself runs
only on the card: chip_smoke.py holds it against the plain version there.

Tolerance: 1e-5 absolute and relative.  Both sides take the scores and the
softmax in float32; they differ only in summation order (blockwise online
softmax vs one dense softmax), which moves unit-scale outputs by a few
float32 ulps."""

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
    ((1, 2, 8, 16), torch.float32, {}, ValueError),        # no D=16 instance
    ((1, 2, 8, 64), torch.float16, {}, TypeError),         # fp16 not built
    ((1, 2, 8, 64), torch.float32, {"block_q": 128}, ValueError),
])
def test_kernel_argument_checks(shape, dtype, kw, err):
    """What the wrapper refuses before any launch: head dims and dtypes
    without a kernel instance, and tile sizes other than the built ones."""
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(err):
        tattn._check_cuda(q, q, q, kw.get("block_q", tattn.BLOCK_Q),
                          kw.get("block_k", tattn.BLOCK_K))


def test_kernel_refuses_autograd_inputs():
    q = torch.zeros((1, 2, 8, 64), requires_grad=True)
    with pytest.raises(NotImplementedError, match="training"):
        tattn._check_cuda(q, q, q, tattn.BLOCK_Q, tattn.BLOCK_K)
    with torch.inference_mode():
        tattn._check_cuda(q, q, q, tattn.BLOCK_Q, tattn.BLOCK_K)


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
