"""Per-module parity of the port against the JAX package.

Each pair is built from the JAX module's params, carried over with
``bigdl_torch.utils.convert``; inputs come from numpy's RandomState.
Random init is never compared.

Tolerances, stated per policy:
- float32: 1e-5 absolute and relative.  Both compute in float32 and differ
  in summation order only.
- bfloat16 compute: the output dtype must equal JAX's, and values agree
  within 0.05 absolute + 0.02 relative.  Both round to bfloat16 (8
  significant bits, relative step 2^-8 = 0.0039) but at different places
  (JAX's elementwise ops run in bfloat16, torch's CPU kernels widen to
  float32 inside), so outputs of unit scale may differ by a few bfloat16
  steps."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu.common import DTypePolicy as JPolicy
from bigdl_tpu.common import get_policy as jget_policy
from bigdl_tpu.common import set_policy as jset_policy
from bigdl_tpu.models.transformer_lm import \
    PositionalEmbedding as JPositionalEmbedding

import bigdl_torch.nn as tnn
from bigdl_torch.common import DTypePolicy as TPolicy
from bigdl_torch.common import get_policy as tget_policy
from bigdl_torch.common import set_policy as tset_policy
from bigdl_torch.models.transformer_lm import PositionalEmbedding
from bigdl_torch.utils.convert import load_reference_tree

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=5e-2, rtol=2e-2)


@pytest.fixture(params=["float32", "bfloat16"])
def policy(request):
    """Both frameworks under the same compute dtype; restored after."""
    jold, told = jget_policy(), tget_policy()
    if request.param == "bfloat16":
        jset_policy(JPolicy(compute_dtype=jnp.bfloat16))
        tset_policy(TPolicy(compute_dtype=torch.bfloat16))
    try:
        yield request.param
    finally:
        jset_policy(jold)
        tset_policy(told)


def _pair(jmod, tmod, seed=0):
    jmod.build(jax.random.key(seed))
    tmod.build("cpu")
    load_reference_tree(tmod, jax.tree.map(np.asarray, jmod.params),
                        jax.tree.map(np.asarray, jmod.state))
    return jmod, tmod


def _run(jmod, tmod, x):
    jout, _ = jmod.apply(jmod.params, jmod.state, jnp.asarray(x),
                         training=False)
    with torch.inference_mode():
        tout = tmod.eval()(torch.from_numpy(np.asarray(x)))
    return jout, tout


def _check(jout, tout, policy):
    assert str(tout.dtype).replace("torch.", "") == str(jout.dtype)
    assert tuple(tout.shape) == tuple(jout.shape)
    tol = F32_TOL if policy == "float32" else BF16_TOL
    np.testing.assert_allclose(tout.detach().float().numpy(),
                               np.asarray(jout, np.float32), **tol)


def _x(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).standard_normal(shape).astype(dtype)


def _ids(shape, n, seed=0, low=0):
    return np.random.RandomState(seed).randint(low, n, shape).astype(np.int32)


@pytest.mark.parametrize("kw,low", [({}, 0), ({"one_based": True}, 1),
                                    ({"max_norm": 1.0}, 0)])
def test_lookup_table(policy, kw, low):
    jm, tm = _pair(jnn.LookupTable(23, 16, **kw), tnn.LookupTable(23, 16, **kw))
    jout, tout = _run(jm, tm, _ids((3, 7), 23, low=low))
    assert tout.dtype == torch.float32  # param dtype, not compute dtype
    _check(jout, tout, policy)


def test_positional_embedding(policy):
    jm, tm = _pair(JPositionalEmbedding(16, 8), PositionalEmbedding(16, 8))
    _check(*_run(jm, tm, _x((2, 10, 8))), policy)
    with pytest.raises(ValueError, match="max_len"):
        tm(torch.zeros((1, 17, 8)))


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_layer_norm(policy, dtype):
    x = _x((2, 5, 16), seed=1) * 3 + 1
    jm, tm = _pair(jnn.LayerNorm(16), tnn.LayerNorm(16))
    # non-trivial affine params, so the f32 affine path is exercised
    rs = np.random.RandomState(2)
    params = {"weight": rs.standard_normal(16).astype(np.float32),
              "bias": rs.standard_normal(16).astype(np.float32)}
    jm.params = jax.tree.map(jnp.asarray, params)
    load_reference_tree(tm, params)
    if dtype == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        jout, _ = jm.apply(jm.params, jm.state, jx)
        tout = tm(torch.from_numpy(x).to(torch.bfloat16))
        assert tout.dtype == torch.bfloat16
        _check(jout, tout, "bfloat16")
    else:
        _check(*_run(jm, tm, x), policy)


def test_linear(policy):
    jm, tm = _pair(jnn.Linear(16, 24), tnn.Linear(16, 24), seed=3)
    _check(*_run(jm, tm, _x((2, 5, 16), seed=4)), policy)


@pytest.mark.parametrize("jcls,tcls", [(jnn.GELU, tnn.GELU),
                                       (jnn.LogSoftMax, tnn.LogSoftMax)])
def test_activations(policy, jcls, tcls):
    jm, tm = _pair(jcls(), tcls())
    x = _x((4, 16), seed=5) * 2
    if policy == "bfloat16":
        jout, _ = jm.apply(jm.params, jm.state, jnp.asarray(x, jnp.bfloat16))
        tout = tm(torch.from_numpy(x).to(torch.bfloat16))
    else:
        jout, tout = _run(jm, tm, x)
    _check(jout, tout, policy)


def test_residual_table_algebra(policy):
    """ConcatTable(Linear, Identity) -> CAddTable: under bfloat16 compute
    the bfloat16 branch plus the float32 residual promotes to float32 in
    both frameworks."""
    def residual(nn):
        return (nn.Sequential()
                .add(nn.ConcatTable(nn.Linear(8, 8), nn.Identity()))
                .add(nn.CAddTable()))

    jm, tm = _pair(residual(jnn), residual(tnn), seed=6)
    jout, tout = _run(jm, tm, _x((3, 8), seed=7))
    assert tout.dtype == torch.float32
    _check(jout, tout, policy)
    # Identity and ConcatTable alone
    table = tnn.ConcatTable(tnn.Identity(), tnn.Identity()).build("cpu")
    x = torch.from_numpy(_x((2, 3)))
    a, b = table(x)
    assert a is x and b is x


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention(policy, causal):
    jm, tm = _pair(jnn.MultiHeadAttention(32, 4, causal=causal),
                   tnn.MultiHeadAttention(32, 4, causal=causal), seed=8)
    # non-zero biases so the compute-dtype bias add is exercised
    params = jax.tree.map(np.asarray, jm.params)
    rs = np.random.RandomState(9)
    for n in ("bq", "bk", "bv", "bo"):
        params[n] = 0.1 * rs.standard_normal(32).astype(np.float32)
    jm.params = jax.tree.map(jnp.asarray, params)
    load_reference_tree(tm, params)
    _check(*_run(jm, tm, _x((2, 12, 32), seed=10)), policy)


def test_unported_options_raise():
    """``seq_parallel`` builds since the sequence-parallel slice; without
    a ``seq`` axis its forward raises, as the reference's ``shard_map``."""
    m = tnn.MultiHeadAttention(32, 4, seq_parallel=True).build("cpu")
    with pytest.raises(ValueError, match="seq_parallel"):
        m(torch.zeros((1, 4, 32)))


def test_load_reference_tree_rejects_mismatch():
    tm = tnn.Linear(4, 3).build("cpu")
    with pytest.raises(ValueError, match="shape"):
        load_reference_tree(tm, {"weight": np.zeros((4, 3), np.float32),
                                 "bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="parameters"):
        load_reference_tree(tm, {"weight": np.zeros((3, 4), np.float32)})
    seq = tnn.Sequential(tnn.Linear(4, 3)).build("cpu")
    with pytest.raises(ValueError, match="list"):
        load_reference_tree(seq, {"weight": np.zeros((3, 4), np.float32)})
    with pytest.raises(ValueError, match="state"):
        load_reference_tree(seq, [{"weight": np.zeros((3, 4), np.float32),
                                   "bias": np.zeros(3, np.float32)}],
                            state=[{"running_mean": np.zeros(3)}])
    with pytest.raises(RuntimeError, match="build"):
        load_reference_tree(tnn.Linear(4, 3), {})
