"""TransformerLM training in the port against the JAX package.

- ``flash_bwd_reference`` (the plain version of the B7 kernel) against the
  reference's ``_flash_bwd_chunked`` and against ``jax.vjp`` of the
  reference's ``flash_attention(use_pallas=True, interpret=True)`` (the
  ``custom_vjp`` over the Pallas forward in interpret mode); a fully-masked
  row against ``jax.vjp`` of the reference's ``mha_reference``.
- The ``FlashAttention`` Function's CPU backward against
  ``torch.autograd`` through the port's ``mha_reference``.
- ``TimeDistributedCriterion``, ``Dropout`` (and its masks under a group
  of two gloo ranks, started with ``subprocess``), and
  ``TransformerLM(dropout)``'s reference tree.
- A small TransformerLM trained 5 steps by both packages' ``Optimizer``.

Inputs are unit-scale, made with numpy from a seed.  Tolerances:
- gradients, float32: 1e-5 absolute and relative.  Both sides take every
  product and the softmax in float32 and differ in summation order only.
- ``TimeDistributedCriterion``: 1e-6 on the loss (a mean of log-probs
  near ln 97, where one float32 ulp is 4.8e-7: a couple of ulps of
  summation order) and on its gradient.
- 5-step LM training losses: 2e-3, the roadmap's training-parity bound
  (float32 products differing in summation order, amplified by five SGD
  steps with momentum).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.ops import attention as jattn
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.ops import attention as tattn
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.utils import config
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

GRAD_TOL = 1e-5
CRIT_TOL = 1e-6
TRAIN_TOL = 2e-3
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    """The JAX Optimizer draws a key a step from the JAX package's default
    stream; put it back, so later tests in this process see the stream as
    they would without this file."""
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _arrays(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _qkvg(B, H, Tq, Tk, D, seed):
    return _arrays([(B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D),
                    (B, H, Tq, D)], seed)


def _port_bwd(q, k, v, g, **kw):
    out = tattn.flash_bwd_reference(*(torch.from_numpy(a)
                                      for a in (q, k, v, g)), **kw)
    return [t.numpy() for t in out]


def _close(got, want):
    for a, b in zip(got, want):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (37, 37), (128, 128), (200, 200),
                                   (37, 200), (200, 37)])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_chunked(causal, Tq, Tk, D):
    q, k, v, g = _qkvg(1, 2, Tq, Tk, D, seed=Tq * 7 + Tk + D + causal)
    scale = 1.0 / np.sqrt(D)
    want = jattn._flash_bwd_chunked(*map(jnp.asarray, (q, k, v, g)),
                                    causal=causal, sm_scale=scale,
                                    block_q=128)
    _close(_port_bwd(q, k, v, g, causal=causal), want)


@pytest.mark.parametrize("Tq,Tk,D", [(1, 1, 32), (37, 37, 32),
                                     (128, 128, 64), (200, 200, 32),
                                     (37, 200, 32), (200, 37, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_pallas_vjp(causal, Tq, Tk, D):
    """jax.vjp through the reference's custom_vjp over its Pallas forward
    (interpret mode), whose backward is _flash_bwd_chunked."""
    q, k, v, g = _qkvg(1, 1, Tq, Tk, D, seed=Tq + Tk * 3 + D + causal)

    def fwd(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     use_pallas=True, interpret=True)

    _, vjp = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    _close(_port_bwd(q, k, v, g, causal=causal), want)


def test_fully_masked_rows_get_zero_gradient():
    """Keys placed after half the queries (k_offset): those rows have
    every key masked, and both packages give them zero gradient, against
    jax.vjp of the reference's mha_reference with the same offsets."""
    q, k, v, g = _qkvg(1, 2, 8, 8, 32, seed=5)

    def fwd(q_, k_, v_):
        return jattn.mha_reference(q_, k_, v_, causal=True, q_offset=4,
                                   k_offset=8)

    _, vjp = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _port_bwd(q, k, v, g, causal=True, q_offset=4, k_offset=8)
    assert np.array_equal(got[0][:, :, :4], np.zeros_like(got[0][:, :, :4]))
    assert np.array_equal(np.asarray(want[0])[:, :, :4],
                          np.zeros((1, 2, 4, 32), np.float32))
    assert all(np.isfinite(a).all() for a in got)
    _close(got, want)


@pytest.mark.parametrize("Tq,Tk,D", [(37, 37, 32), (64, 200, 64),
                                     (200, 64, 16), (1, 5, 8)])
@pytest.mark.parametrize("causal", [False, True])
def test_function_cpu_backward_matches_autograd(causal, Tq, Tk, D):
    """flash_attention under grad goes through FlashAttention, whose CPU
    backward (flash_bwd_reference) equals torch.autograd through the port's
    mha_reference."""
    q, k, v, g = (torch.from_numpy(a)
                  for a in _qkvg(2, 2, Tq, Tk, D, seed=Tq + D + causal))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.flash_attention(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = tattn.mha_reference(*ref_leaves, causal=causal)
    want = torch.autograd.grad(ref_out, ref_leaves, g)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref_out.detach().numpy())
    _close([t.numpy() for t in got], [t.numpy() for t in want])


def test_backward_without_keys_or_rows_is_zero():
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(1, 2, 5, 0, 32, seed=1))
    dq, dk, dv = tattn.flash_attention_bwd(q, k, v, g, g)
    assert torch.equal(dq, torch.zeros_like(q)) and dk.shape == k.shape
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(1, 2, 0, 5, 32, seed=1))
    dq, dk, dv = tattn.flash_attention_bwd(q, k, v, g, g)
    assert dq.shape == q.shape and torch.equal(dk, torch.zeros_like(k))
    assert tattn.flash_attention_bwd.launches == 0


def test_bwd_routes_and_gradient_layout():
    """bf16 and float32 take their backward route, other dtypes none; the
    gradients come back as [B, H, T, D] views of [B, T, H, D] memory, the
    layout MultiHeadAttention's head merge reads without a copy."""
    assert tattn.bwd_route(torch.float32) == "f32"
    assert tattn.bwd_route(torch.bfloat16) == "tc"
    with pytest.raises(TypeError):
        tattn.bwd_route(torch.float16)
    g = tattn._bhtd_like(torch.zeros((2, 8, 5, 64), dtype=torch.bfloat16))
    assert g.shape == (2, 8, 5, 64)
    assert g.transpose(1, 2).is_contiguous()
    # the tensor-core route reads MultiHeadAttention's views in place and
    # copies what it cannot load 16 bytes at a time
    assert tattn._operand(g, "tc") is g
    odd = torch.zeros((2, 8, 5, 68), dtype=torch.bfloat16)[..., :64]
    assert not tattn.tma_ready(odd)
    copy = tattn._operand(odd, "tc")
    assert tattn.tma_ready(copy) and torch.equal(copy, odd)
    f32 = torch.zeros((2, 8, 5, 68))[..., :64]
    assert tattn._operand(f32, "f32") is f32  # any unit last stride


# -- TimeDistributedCriterion -------------------------------------------------

def _log_probs(B, T, C, seed):
    x = _arrays([(B, T, C)], seed)[0]
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("padded", [False, True])
def test_time_distributed_matches_reference(size_average, padded):
    """Loss and gradient within 1e-6; with padding labels (-1) whose count
    varies per step, so per-step means differ from one flattened mean."""
    B, T, C = 6, 9, 11
    out = _log_probs(B, T, C, seed=3)
    tgt = np.random.RandomState(4).randint(0, C, (B, T)).astype(np.int32)
    if padded:
        for t in range(T):
            tgt[: t % B, t] = -1  # step t has t % B padded rows
    jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                         size_average=size_average)
    tcrit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=size_average)
    jloss, jgrad = jax.value_and_grad(jcrit.loss)(jnp.asarray(out),
                                                 jnp.asarray(tgt))
    o = torch.from_numpy(out).requires_grad_()
    tloss = tcrit(o, torch.from_numpy(tgt))
    (tgrad,) = torch.autograd.grad(tloss, o)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=CRIT_TOL,
                               rtol=CRIT_TOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                               atol=CRIT_TOL, rtol=CRIT_TOL)
    if padded and size_average:
        flat = tnn.ClassNLLCriterion()(o.reshape(B * T, C),
                                       torch.from_numpy(tgt).reshape(-1))
        assert abs(float(flat.detach()) - float(tloss.detach())) > 1e-3


@pytest.mark.parametrize("inner", ["nll", "cross_entropy"])
def test_time_distributed_sums_per_step_losses(inner):
    """The batched pass equals the inner criterion applied step by step
    (padding labels included), summed and divided by T."""
    make = {"nll": tnn.ClassNLLCriterion,
            "cross_entropy": tnn.CrossEntropyCriterion}[inner]
    out = torch.from_numpy(_log_probs(4, 5, 7, seed=8))
    tgt = torch.from_numpy(np.random.RandomState(9).randint(-1, 7, (4, 5)))
    got = tnn.TimeDistributedCriterion(make(), size_average=True)(out, tgt)
    want = sum(make()(out[:, t], tgt[:, t]) for t in range(5)) / 5
    np.testing.assert_allclose(float(got), float(want), rtol=CRIT_TOL)


def test_time_distributed_needs_step_losses():
    """An inner criterion without per-step losses is refused up front."""

    class Plain(tnn.Criterion):
        def loss(self, output, target):
            return tnn.ClassNLLCriterion().loss(output, target)

    with pytest.raises(TypeError, match="step_losses"):
        tnn.TimeDistributedCriterion(Plain())


# -- Dropout ------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_dropout_identity_at_p0_and_in_eval():
    x = torch.from_numpy(_arrays([(4, 50)], 0)[0])
    d = tnn.Dropout(0.0)
    with tnn.dropout_rng(_gen(0)):
        assert torch.equal(d(x), x)
    d = tnn.Dropout(0.5)
    d.eval()
    assert torch.equal(d(x), x)  # no generator needed in eval mode
    d.train()
    with pytest.raises(ValueError, match="generator"):
        d(x)


@pytest.mark.parametrize("scale", [True, False])
def test_dropout_mask_rate_scale_and_gradient(scale):
    p = 0.3
    x = (torch.from_numpy(_arrays([(200, 500)], 1)[0]) + 5.0)
    x.requires_grad_()
    d = tnn.Dropout(p, scale=scale)
    with tnn.dropout_rng(_gen(11)):
        y = d(x)
    kept = y != 0
    assert abs(1 - float(kept.float().mean()) - p) < 0.01
    want = x.detach() / (1 - p) if scale else x.detach()
    assert torch.equal(y[kept], want[kept])
    (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    factor = 1 / (1 - p) if scale else 1.0
    assert torch.equal(gx, kept.float() * factor)


def test_dropout_same_seed_same_mask():
    x = torch.ones((64, 64))
    d = tnn.Dropout(0.5).set_p(0.4)
    assert d.p == 0.4
    with tnn.dropout_rng(_gen(5)):
        a = d(x)
    with tnn.dropout_rng(_gen(5)):
        b = d(x)
    with tnn.dropout_rng(_gen(6)):
        c = d(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


# a rank's worker: one Optimizer step of Dropout -> Linear on rows of ones
# under a gloo group; saves the mask the step drew (the Linear's input)
_DROPOUT_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    from bigdl_torch import Engine
    import bigdl_torch.nn as nn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.optim import SGD, Optimizer, Trigger

    out = sys.argv[1]
    Engine.init(device="cpu")
    model = nn.Sequential().add(nn.Dropout(0.5)).add(nn.Linear(64, 3))
    seen = []
    model.layers[1].register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].detach().numpy().copy()))
    x = np.ones((16, 64), np.float32)
    y = np.arange(16, dtype=np.int32) % 3
    opt = Optimizer(model, DataSet.array(
        [Sample.from_ndarray(x[i], y[i]) for i in range(16)],
        distributed=True), nn.CrossEntropyCriterion(), batch_size=4)
    opt.set_optim_method(SGD(0.1))
    opt.set_end_when(Trigger.max_iteration(1)).optimize()
    pickle.dump(seen, open(out + "." + str(Engine.rank()), "wb"))
    Engine.reset()
''')


def test_dropout_masks_differ_across_ranks(tmp_path):
    """Two gloo ranks draw different Dropout masks: each rank's generator
    is seeded from BIGDL_TORCH_SEED with its rank folded in, as the
    reference draws one mask over the global batch.  Rank 0's seed is the
    single-process one."""
    from bigdl_torch.optim.optimizer import dropout_seed

    assert dropout_seed(0) == config.seed()
    assert len({dropout_seed(r) for r in range(8)}) == 8
    (tmp_path / "worker.py").write_text(_DROPOUT_WORKER)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp_path / 'store'}",
           "BIGDL_TORCH_NUM_PROCESSES": "2"}
    out = str(tmp_path / "masks")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), out],
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    masks = [pickle.load(open(f"{out}.{r}", "rb")) for r in range(2)]
    assert all(len(m) == 1 and m[0].shape == (4, 64) for m in masks)
    for m in masks:
        assert set(np.unique(m[0])) <= {0.0, 2.0}  # ones, kept or dropped
    assert not np.array_equal(masks[0][0], masks[1][0])


LM_CFG = dict(vocab_size=97, max_len=16, d_model=32, num_heads=4,
              num_layers=2)


def test_dropout_lm_reference_tree_round_trips():
    """Dropout adds no leaves: a TransformerLM(dropout=0.1) reference tree
    loads leaf for leaf and comes back bit for bit; the blocks carry their
    two Dropouts where the reference puts them."""
    jm = jlm.TransformerLM(**LM_CFG, dropout=0.1).build(jax.random.key(2))
    tm = tlm.TransformerLM(**LM_CFG, dropout=0.1).build("cpu")
    params = jax.tree.map(np.asarray, jm.params)
    load_reference_tree(tm, params, jax.tree.map(np.asarray, jm.state))
    back, state = to_reference_tree(tm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jax.tree.structure(state) == jax.tree.structure(jm.state)
    drops = [m for m in tm.modules() if isinstance(m, tnn.Dropout)]
    assert len(drops) == 2 * LM_CFG["num_layers"]
    assert all(d.p == 0.1 for d in drops)


# -- the slice: 5 steps against the JAX Optimizer ----------------------------

STEPS = 5
BATCH = 8


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


def test_small_lm_trains_like_reference():
    """TransformerLM(vocab 97, 2 layers), float32, dropout 0, trained 5
    steps with TimeDistributedCriterion(ClassNLLCriterion()) and SGD with
    momentum by both packages from the same weights and batches."""
    jm = jlm.TransformerLM(**LM_CFG).build(jax.random.key(0))
    tm = tlm.TransformerLM(**LM_CFG).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    toks = np.random.RandomState(0).randint(
        0, LM_CFG["vocab_size"], (BATCH * STEPS, LM_CFG["max_len"] + 1))
    toks = toks.astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]

    Engine.init()
    jlosses, tlosses = {}, {}
    jopt = JOptimizer(jm, JDataSet.array(
        [JSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                     size_average=True), batch_size=BATCH)
    jopt.set_optim_method(JSGD(0.1, momentum=0.9))
    jopt.set_end_when(_recorder(JTrigger, jlosses)).optimize()
    topt = TOptimizer(tm, TDataSet.array(
        [TSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                     size_average=True),
        batch_size=BATCH, device="cpu")
    topt.set_optim_method(TSGD(0.1, momentum=0.9))
    topt.set_end_when(_recorder(TTrigger, tlosses)).optimize()

    assert sorted(tlosses) == sorted(jlosses) == list(range(1, STEPS + 1))
    for k in jlosses:
        assert np.isfinite(tlosses[k])
        assert abs(tlosses[k] - jlosses[k]) <= TRAIN_TOL, (k, tlosses,
                                                           jlosses)
    assert tlosses[STEPS] != tlosses[1]
    tp, _ = to_reference_tree(tm)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TRAIN_TOL,
                                   rtol=TRAIN_TOL)
