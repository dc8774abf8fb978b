"""KV-cache decoding in the port against the JAX package.

The cached decode attention's plain version (``ops/decode_attention.py``,
B8's counterpart on the CPU, which appends the new k and v and attends in
one call) is held to the reference's ``serve/decode._slot_attention`` and
``models/decode._cached_attention`` through one MultiHeadAttention with
carried weights, output and whole cache; ``init_kv_cache``, ``cached_generate`` and
``beam_generate`` (``models/decode.py``) to the reference's on
TransformerLM(vocab 64, max_len 64, E 32, H 2, L 2), built by the JAX
package, its params carried over with ``load_reference_tree``.  Inputs and
prompts come from numpy's ``default_rng``.

Tolerances:
- float32 attention output and updated cache: 1e-5 absolute.  Both sides
  take the projections, scores, softmax and P.V in float32 and differ
  only in summation order.
- bf16 compute (bf16 cache): 0.15 absolute, the bf16 bound of
  test_torch_port_lm.py: the frameworks round the bf16 projections at
  different places, one bf16 step at 1..2 is 2^-7.
- Stale cache rows past a slot's position, and the stale row at it (the
  append writes over it): the output is bit-identical whatever they hold
  (they get exactly zero weight, or are replaced).
- Generated tokens: identical (greedy argmax and beam top-k over float32
  log-probs that agree to about 1e-6).
- Sampling: the port matches the reference in distribution, not in the
  numbers drawn, so it is held to itself: one generator seed gives one
  row, and top_k=1 gives the greedy row.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bigdl_tpu.common import DTypePolicy as JPolicy
from bigdl_tpu.common import get_policy as jget_policy
from bigdl_tpu.common import set_policy as jset_policy
from bigdl_tpu.models import decode as jdec
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.nn.attention import MultiHeadAttention as JMHA
from bigdl_tpu.serve import decode as jserve

from bigdl_torch.common import DTypePolicy as TPolicy
from bigdl_torch.common import get_policy as tget_policy
from bigdl_torch.common import set_policy as tset_policy
from bigdl_torch.models import decode as tdec
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.nn import MultiHeadAttention as TMHA
from bigdl_torch.nn import Sequential
from bigdl_torch.nn.module import Container
from bigdl_torch.ops import decode_attention as tops
from bigdl_torch.utils.convert import load_reference_tree

CFG = dict(vocab_size=64, max_len=64, d_model=32, num_heads=2,
           num_layers=2)
F32_ATOL = 1e-5
BF16_ATOL = 0.15
GARBAGE = 1e4


@pytest.fixture(scope="module")
def pair():
    jm = jlm.TransformerLM(**CFG).build(jax.random.key(0))
    tm = tlm.TransformerLM(**CFG).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


def _prompt(shape, seed):
    return np.random.default_rng(seed).integers(1, 64, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# B8's plain version against the reference's _slot_attention
# ---------------------------------------------------------------------------

def _mha_pair(seed=0):
    jm = JMHA(32, 2, causal=True).build(jax.random.key(seed))
    params = jm.params
    tm = TMHA(32, 2, causal=True).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _attention_inputs(S, L, seed, garbage=GARBAGE):
    """x [S, 1, E], caches [S, 2, L, 16] with ``garbage`` past each
    slot's position, and mixed positions including 0 and L - 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, 1, 32)).astype(np.float32)
    k = rng.standard_normal((S, 2, L, 16)).astype(np.float32)
    v = rng.standard_normal((S, 2, L, 16)).astype(np.float32)
    pos = rng.integers(0, L, S).astype(np.int32)
    pos[0], pos[1] = 0, L - 1
    past = np.arange(L)[None, None, :, None] > pos[:, None, None, None]
    k = np.where(past, garbage, k).astype(np.float32)
    v = np.where(past, -garbage, v).astype(np.float32)
    return x, k, v, pos


def _run_both(x, k, v, pos, dtype):
    jm, params, tm = _mha_pair()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jy, jc = jserve._slot_attention(
        jm, params, jnp.asarray(x),
        {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt)},
        jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k).to(tdt),
             "v": torch.from_numpy(v).to(tdt)}
    with torch.inference_mode():
        ty = tdec._cached_attention(tm, torch.from_numpy(x), cache,
                                    torch.from_numpy(pos))
    return jy, jc, ty, cache


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_attention_matches_slot_attention(dtype):
    x, k, v, pos = _attention_inputs(S=5, L=24, seed=1)
    jold, told = jget_policy(), tget_policy()
    if dtype == "bf16":
        jset_policy(JPolicy(compute_dtype=jnp.bfloat16))
        tset_policy(TPolicy(compute_dtype=torch.bfloat16))
    try:
        jy, jc, ty, cache = _run_both(x, k, v, pos, dtype)
    finally:
        jset_policy(jold)
        tset_policy(told)
    tol = F32_ATOL if dtype == "f32" else BF16_ATOL
    want = torch.float32 if dtype == "f32" else torch.bfloat16
    assert ty.dtype == want and ty.shape == (5, 1, 32)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=tol, rtol=0)
    for n in "kv":
        assert cache[n].dtype == want
        np.testing.assert_allclose(cache[n].float().numpy(),
                                   np.asarray(jc[n], np.float32), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_attention_matches_cached_attention(dtype):
    """One position for every row, as models/decode._cached_attention."""
    x, k, v, _ = _attention_inputs(S=3, L=20, seed=3)
    p = 11
    past = np.arange(20)[None, None, :, None] > p
    k = np.where(past, GARBAGE, k).astype(np.float32)
    v = np.where(past, -GARBAGE, v).astype(np.float32)
    jm, params, tm = _mha_pair()
    jold, told = jget_policy(), tget_policy()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    if dtype == "bf16":
        jset_policy(JPolicy(compute_dtype=jnp.bfloat16))
        tset_policy(TPolicy(compute_dtype=torch.bfloat16))
    try:
        jy, jc = jdec._cached_attention(
            jm, params, jnp.asarray(x),
            {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt)}, p)
        cache = {"k": torch.from_numpy(k).to(tdt),
                 "v": torch.from_numpy(v).to(tdt)}
        with torch.inference_mode():
            ty = tdec._cached_attention(
                tm, torch.from_numpy(x), cache,
                torch.full((3,), p, dtype=torch.int32))
    finally:
        jset_policy(jold)
        tset_policy(told)
    tol = F32_ATOL if dtype == "f32" else BF16_ATOL
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=tol, rtol=0)
    for n in "kv":
        assert cache[n].dtype == tdt
        np.testing.assert_allclose(cache[n].float().numpy(),
                                   np.asarray(jc[n], np.float32), atol=tol,
                                   rtol=0)


def _new_rows(S, seed):
    """q, k_new, v_new [S, 2, 1, 16]: the strided head split the model
    gives ([S, 1, 2, 16] transposed)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((S, 1, 2, 16))
                             .astype(np.float32)).transpose(1, 2)
            for _ in range(3)]


def test_plain_attention_blind_to_stale_rows():
    outs = []
    for garbage in (GARBAGE, -3.5e3):
        _, k, v, pos = _attention_inputs(S=4, L=16, seed=2, garbage=garbage)
        # the stale row at each position is replaced by the append
        at = np.arange(16)[None, None, :, None] == pos[:, None, None, None]
        k = np.where(at, garbage, k).astype(np.float32)
        v = np.where(at, -garbage, v).astype(np.float32)
        q, kn, vn = _new_rows(4, seed=2)
        outs.append(tops.decode_attention(q, kn, vn, torch.from_numpy(k),
                                          torch.from_numpy(v),
                                          torch.from_numpy(pos)))
    assert torch.equal(outs[0], outs[1])


def _ok_operands():
    q = torch.zeros((2, 2, 1, 16))
    k = torch.zeros((2, 2, 8, 16))
    return (q, q.clone(), q.clone(), k, k.clone(),
            torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("case", [
    "q_rank", "q_rows", "head_dim", "q_dtype", "cache_dtypes", "cache_shape",
    "pos_dtype", "pos_shape", "cache_strides", "cache_length",
    "k_new_shape", "v_new_shape", "k_new_dtype", "v_new_stride",
    "k_new_device", "v_new_device"])
def test_wrapper_refuses(case):
    q, kn, vn, k, v, pos = _ok_operands()
    if case == "q_rank":
        q = q[0]
    elif case == "q_rows":
        q = torch.zeros((2, 2, 3, 16))
    elif case == "head_dim":
        q, kn, vn, k, v = (torch.zeros(t.shape[:3] + (24,))
                           for t in (q, kn, vn, k, v))
    elif case == "q_dtype":
        q = q.half()
    elif case == "cache_dtypes":
        v = v.bfloat16()
    elif case == "cache_shape":
        v = torch.zeros((2, 2, 9, 16))
    elif case == "pos_dtype":
        pos = pos.long()
    elif case == "pos_shape":
        pos = torch.zeros(3, dtype=torch.int32)
    elif case == "cache_strides":
        k = torch.zeros((2, 2, 16, 8)).transpose(2, 3)
    elif case == "cache_length":
        # a view of one element: no memory for the length past the bound
        k = v = torch.zeros(()).expand(2, 2, tops.MAX_LEN + 1, 16)
    elif case == "k_new_shape":
        kn = torch.zeros((2, 2, 2, 16))
    elif case == "v_new_shape":
        vn = torch.zeros((2, 1, 1, 16))
    elif case == "k_new_dtype":
        kn = kn.bfloat16()
    elif case == "v_new_stride":
        vn = torch.zeros((2, 2, 1, 32))[..., ::2]
    elif case == "k_new_device":
        kn = torch.zeros((2, 2, 1, 16), device="meta")
    elif case == "v_new_device":
        vn = torch.zeros((2, 2, 1, 16), device="meta")
    with pytest.raises(ValueError, match="decode_attention"):
        tops.decode_attention(q, kn, vn, k, v, pos)


def test_wrapper_counts_no_launch_on_the_cpu():
    before = (tops.decode_attention.launches,
              dict(tops.decode_attention.route_launches))
    tops.decode_attention(*_ok_operands())
    assert (tops.decode_attention.launches,
            tops.decode_attention.route_launches) == before


# ---------------------------------------------------------------------------
# init_kv_cache, cached_generate, beam_generate on the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_init_kv_cache_like_reference(pair, dtype):
    jm, tm = pair
    jc = jdec.init_kv_cache(jm, 3, 20, *([jnp.bfloat16] if dtype else []))
    tc = tdec.init_kv_cache(tm, 3, 20, torch.bfloat16 if dtype else None)
    assert len(tc) == len(jc) == CFG["num_layers"]
    for j, t in zip(jc, tc):
        assert sorted(t) == sorted(j) == ["k", "v"]
        for n in "kv":
            assert tuple(t[n].shape) == tuple(j[n].shape) == (3, 2, 20, 16)
            assert str(t[n].dtype)[6:] == str(j[n].dtype)
            assert t[n].device.type == "cpu" and not t[n].any()


@pytest.mark.parametrize("t0", [1, 4, 10])
def test_cached_generate_matches_jax_and_greedy(pair, t0):
    jm, tm = pair
    prompt = _prompt((t0,), seed=t0)
    n = 12
    ref = jdec.cached_generate(jm, prompt, n, max_len=CFG["max_len"])
    got = tdec.cached_generate(tm, prompt, n, max_len=CFG["max_len"])
    full = tlm.greedy_generate(tm, prompt, n, CFG["max_len"])
    assert got.ndim == 1 and got.shape == (t0 + n,)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, full)


def test_cached_generate_batch_matches_jax(pair):
    jm, tm = pair
    prompt = _prompt((2, 6), seed=7)
    ref = jdec.cached_generate(jm, prompt, 9, max_len=CFG["max_len"])
    got = tdec.cached_generate(tm, prompt, 9, max_len=CFG["max_len"])
    assert got.shape == (2, 15)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        got, tlm.greedy_generate(tm, prompt, 9, CFG["max_len"]))


def test_cached_generate_validation(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="empty prompt"):
        tdec.cached_generate(tm, np.zeros((1, 0), np.int32), 2, 8)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tdec.cached_generate(tm, [1, 2, 3], 6, 8)
    with pytest.raises(ValueError, match="positional"):
        tdec.cached_generate(tm, [1], 2, CFG["max_len"] + 4)
    with pytest.raises(ValueError, match="generator"):
        tdec.cached_generate(tm, [1], 2, 8, temperature=0.5)
    with pytest.raises(NotImplementedError, match="tp-sharded"):
        tdec.cached_generate(tm, [1], 2, 8, mesh=object())
    with pytest.raises(ValueError, match="pad_token"):
        tdec.beam_generate(tm, [1], 2, 8, eos_token=0, pad_token=0)


def test_sampling_is_seeded_and_top1_is_greedy(pair):
    _, tm = pair
    prompt = _prompt((2, 3), seed=11)

    def sample(seed, **kw):
        return tdec.cached_generate(
            tm, prompt, 8, 16, temperature=0.8,
            generator=torch.Generator().manual_seed(seed), **kw)

    a, b = sample(5), sample(5)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < CFG["vocab_size"])).all()
    np.testing.assert_array_equal(
        sample(6, top_k=1), tdec.cached_generate(tm, prompt, 8, 16))


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_generate_matches_jax(pair, beam):
    jm, tm = pair
    prompt = _prompt((3, 4), seed=13)
    ref = jdec.beam_generate(jm, prompt, 7, CFG["max_len"], beam_size=beam)
    got = tdec.beam_generate(tm, prompt, 7, CFG["max_len"], beam_size=beam)
    assert got.shape == (3, 11)
    np.testing.assert_array_equal(got, np.asarray(ref))
    if beam == 1:
        np.testing.assert_array_equal(
            got, tdec.cached_generate(tm, prompt, 7, CFG["max_len"]))


def test_beam_eos_pads_like_jax(pair):
    jm, tm = pair
    prompt = _prompt((1, 2), seed=17)
    # the model's own greedy next token as EOS: the top beam emits it at
    # the first scored step, and the rest of its row is padding
    eos = int(tdec.cached_generate(tm, prompt, 1, CFG["max_len"])[0, -1])
    pad = 0 if eos != 0 else 1
    ref = jdec.beam_generate(jm, prompt, 8, CFG["max_len"], beam_size=4,
                             eos_token=eos, pad_token=pad)
    got = tdec.beam_generate(tm, prompt, 8, CFG["max_len"], beam_size=4,
                             eos_token=eos, pad_token=pad)
    np.testing.assert_array_equal(got, np.asarray(ref))
    row = got[0]
    first = int(np.flatnonzero(row == eos)[0])
    assert (row[first + 1:] == pad).all()


def test_unsupported_modules_raise():
    bidir = Sequential().add(TMHA(32, 2, causal=False)).build("cpu")
    caches = tdec.init_kv_cache(bidir, 1, 4)
    x = torch.zeros((1, 1, 32))
    with pytest.raises(NotImplementedError, match="causal"):
        tdec._step(bidir, x, caches, 0, torch.zeros(1, dtype=torch.int32))

    class Other(Container):   # a container the step does not know
        pass

    with pytest.raises(NotImplementedError, match="unsupported container"):
        tdec._step(Other(), x, [], 0, torch.zeros(1, dtype=torch.int32))
