"""The whole slice: TransformerLM in the port against the JAX package.

TransformerLM(vocab 97, max_len 64, E 32, H 4, L 2), params built by the
JAX model and carried over; token batches from numpy's RandomState.

Tolerances:
- float32 log-probs: 1e-4 absolute (two layers of float32 products that
  differ only in summation order; measured about 1e-6).
- bfloat16 compute: 0.15 absolute on log-probs of magnitude ~5.  One
  bfloat16 step at 4..8 is 2^-5 = 0.031; the frameworks round at different
  places (see test_torch_port_modules.py), and two residual layers plus the
  vocab head compound that to a few steps.  The output dtype must match.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bigdl_tpu.common import DTypePolicy as JPolicy
from bigdl_tpu.common import get_policy as jget_policy
from bigdl_tpu.common import set_policy as jset_policy
from bigdl_tpu.models import transformer_lm as jlm

from bigdl_torch.common import DTypePolicy as TPolicy
from bigdl_torch.common import get_policy as tget_policy
from bigdl_torch.common import set_policy as tset_policy
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

CFG = dict(vocab_size=97, max_len=64, d_model=32, num_heads=4,
           num_layers=2)
F32_ATOL = 1e-4
BF16_ATOL = 0.15


def _pair(seed=0):
    jm = jlm.TransformerLM(**CFG).build(jax.random.key(seed))
    tm = tlm.TransformerLM(**CFG).build("cpu")
    params = jax.tree.map(np.asarray, jm.params)
    load_reference_tree(tm, params, jax.tree.map(np.asarray, jm.state))
    return jm, tm, params


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 97, (b, t)).astype(np.int32)


def _forward(jm, tm, x):
    jout, _ = jm.apply(jm.params, jm.state, jnp.asarray(x), training=False)
    with torch.inference_mode():
        tout = tm.eval()(torch.from_numpy(x))
    return jout, tout


@pytest.mark.parametrize("t", [1, 37, 64])
def test_log_probs_f32(t):
    jm, tm, _ = _pair()
    jout, tout = _forward(jm, tm, _tokens(3, t, seed=t))
    assert tout.dtype == torch.float32 and tout.shape == (3, t, 97)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=F32_ATOL, rtol=0)


def test_log_probs_bf16():
    jold, told = jget_policy(), tget_policy()
    jset_policy(JPolicy(compute_dtype=jnp.bfloat16))
    tset_policy(TPolicy(compute_dtype=torch.bfloat16))
    try:
        jm, tm, _ = _pair(seed=1)
        jout, tout = _forward(jm, tm, _tokens(2, 40, seed=2))
    finally:
        jset_policy(jold)
        tset_policy(told)
    assert str(jout.dtype) == "bfloat16" and tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32),
                               atol=BF16_ATOL, rtol=0)


def test_greedy_generate_token_identical():
    jm, tm, _ = _pair(seed=2)
    prompt = _tokens(2, 5, seed=3)
    ref = jlm.greedy_generate(jm, prompt, num_tokens=12, max_len=32)
    out = tlm.greedy_generate(tm, prompt, num_tokens=12, max_len=32)
    assert out.shape == (2, 17)
    np.testing.assert_array_equal(out, ref)
    # 1-D prompt in, 1-D sequence out
    one = tlm.greedy_generate(tm, prompt[0], num_tokens=3, max_len=32)
    np.testing.assert_array_equal(one, ref[0, :8])


def test_sampling_is_seeded_and_respects_top_k():
    _, tm, _ = _pair(seed=3)
    prompt = _tokens(1, 4, seed=4)
    a = tlm.greedy_generate(tm, prompt, 6, 16, temperature=1.0,
                            generator=torch.Generator().manual_seed(5))
    b = tlm.greedy_generate(tm, prompt, 6, 16, temperature=1.0,
                            generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, b)
    # top_k=1 reduces to greedy
    g = tlm.greedy_generate(tm, prompt, 6, 16)
    k1 = tlm.greedy_generate(tm, prompt, 6, 16, temperature=0.7, top_k=1,
                             generator=torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(g, k1)
    with pytest.raises(ValueError, match="generator"):
        tlm.greedy_generate(tm, prompt, 2, 16, temperature=1.0)
    with pytest.raises(ValueError, match="max_len"):
        tlm.greedy_generate(tm, prompt, 20, 16)


def test_sample_next_top_k_keeps_exactly_k():
    row = torch.tensor([[0.0, 5.0, 5.0, 5.0, -1.0]])
    g = torch.Generator().manual_seed(0)
    picks = {int(tlm.sample_next(row, 1.0, 2, g)[0]) for _ in range(200)}
    assert picks <= {1, 2, 3} and len(picks) == 2  # exactly k of the ties
    assert tlm.sample_next(row, 0.0, 0)[0] == 1     # argmax: first of ties


def test_reference_tree_round_trip_bit_exact():
    _, tm, params = _pair(seed=4)
    back, state = to_reference_tree(tm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jstate = jlm.TransformerLM(**CFG).build(jax.random.key(0)).state
    assert jax.tree.structure(state) == jax.tree.structure(jstate)


def test_unported_options_raise():
    """``num_experts`` builds the MoE blocks the reference builds;
    ``seq_parallel``, ported since, builds ring attention, whose forward
    raises without a ``seq`` axis, as the reference's ``shard_map``."""
    moe = tlm.TransformerLM(97, num_experts=4)
    assert sum(type(m).__name__ == "MoEFFN" for m in moe.modules()) == 4
    sp = tlm.TransformerLM(97, seq_parallel=True, num_layers=1,
                           d_model=16, num_heads=2, max_len=8).build("cpu")
    with pytest.raises(ValueError, match="'seq' axis"):
        sp(torch.zeros((1, 8), dtype=torch.long))
