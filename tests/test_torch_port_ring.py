"""Sequence parallelism (``parallel/ring_attention.py``) against the JAX
package.

- ``ring_attention`` (causal and not) and ``ulysses_attention`` (causal
  and not) on 2 and 4 gloo CPU ranks (subprocesses, ``Engine.init(
  mesh_shape={"seq": n})``), each rank holding its [B, H, T/n, D] shard:
  the ranks' output shards and the gradients of q, k and v (of
  sum(o · g)) against the reference's on a ``seq`` mesh of n of the
  suite's virtual CPU devices, within 2e-5 (output) and 2e-4 (gradients),
  the reference tests' tolerances (float32, blockwise softmax merges in
  another order).
- ``block_bwd_reference`` (the ring's plain block backward from the final
  log-sum-exp) summed over the blocks equals the whole tensor's backward.
- ``TransformerLM(seq_parallel=True)`` on 2 gloo ranks: its forward on
  fixed tokens against the reference's seq-parallel forward (rtol 2e-4,
  atol 2e-5, the reference test's), every rank the same global output;
  5 training steps with the reference's weights and batches within 2e-3
  (the roadmap's training-parity bound) of the reference's dense LM (the
  ring computes the dense math), equal on both ranks.
- Without a ``seq`` axis the module raises at forward, as the
  reference's ``shard_map`` does; a rank count that does not divide the
  heads raises in Ulysses.
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
from jax.sharding import Mesh

import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import ring_attention as jring_attention
from bigdl_tpu.parallel import ulysses_attention as julysses_attention

from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.ops.attention import flash_bwd_reference, mha_reference
from bigdl_torch.parallel.ring_attention import (block_bwd_reference,
                                                 ring_attention)

OUT_TOL = 2e-5
GRAD_TOL = 2e-4
LOSS_TOL = 2e-3
STEPS = 5
BATCH = 8
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=30, max_len=16, d_model=32, num_heads=4, num_layers=2,
          causal=True)
#: (function, causal) of the attention cases
CASES = [("ring", False), ("ring", True), ("ulysses", False),
         ("ulysses", True)]


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    """The JAX Optimizer draws a key a step from the JAX package's default
    stream; put it back for the later tests of this process."""
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _qkvg(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((2, 4, 4 * n, 8)).astype(np.float32)
            for _ in range(4)]


def _lm_data():
    rs = np.random.RandomState(5)
    toks = rs.randint(0, LM["vocab_size"], (BATCH * STEPS, LM["max_len"] + 1))
    return toks.astype(np.int32)


_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    import bigdl_torch.nn as tnn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models import transformer_lm as tlm
    from bigdl_torch.optim import SGD, Optimizer, Trigger
    from bigdl_torch.parallel import ring_attention, ulysses_attention
    from bigdl_torch.utils.convert import load_reference_tree
    from bigdl_torch.utils.engine import Engine

    spec, out = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
    torch.set_num_threads(1)   # the ranks share the host's cores
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    n = int(os.environ["BIGDL_TORCH_NUM_PROCESSES"])
    Engine.init(device="cpu", mesh_shape={"seq": n})
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    res = {}
    q, k, v, g = (torch.from_numpy(a) for a in spec["qkvg"])
    t = q.shape[2] // n
    rows = slice(rank * t, (rank + 1) * t)
    for name, causal in spec["cases"]:
        shards = [a[:, :, rows].clone().requires_grad_() for a in (q, k, v)]
        o = fns[name](*shards, causal=causal)
        (o * g[:, :, rows]).sum().backward()
        res[f"{name}-{causal}"] = [o.detach().numpy()] + [
            a.grad.numpy() for a in shards]
    if "lm" in spec:
        model = tlm.TransformerLM(**spec["lm"], seq_parallel=True)
        model.build("cpu")
        load_reference_tree(model, *spec["lm_params"])
        model.eval()
        with torch.no_grad():
            res["lm_forward"] = model(torch.from_numpy(
                spec["lm_tokens"]).long()).numpy()
        model.train()
        toks = spec["lm_data"]
        losses = {}

        def rec(state):
            if state["neval"] > 1:
                losses[state["neval"] - 1] = state["loss"]
            return state["neval"] > spec["steps"]
        Optimizer(model, DataSet.array(
            [Sample.from_ndarray(toks[i, :-1], toks[i, 1:])
             for i in range(len(toks))]),
            tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=True),
            batch_size=spec["batch"]).set_optim_method(
                SGD(0.1, momentum=0.9)).set_end_when(
                    Trigger(rec, "record")).optimize()
        res["lm_losses"] = [losses[i] for i in sorted(losses)]
    pickle.dump(res, open(os.path.join(out, f"rank{rank}.pkl"), "wb"))
    # every rank done before any closes its connections
    torch.distributed.barrier()
    Engine.reset()
''')


def _reference_attention(n):
    """The reference's outputs and q, k, v gradients on an n-device seq
    mesh, by case."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    q, k, v, g = map(jnp.asarray, _qkvg(n, seed=n))
    fns = {"ring": jring_attention, "ulysses": julysses_attention}
    out = {}
    for name, causal in CASES:
        def both(q, k, v, g, name=name, causal=causal):
            o, pull = jax.vjp(lambda *a: fns[name](
                *a, mesh=mesh, causal=causal, batch_axis=None), q, k, v)
            return (o,) + pull(g)
        out[f"{name}-{causal}"] = [np.asarray(a)
                                   for a in jax.jit(both)(q, k, v, g)]
    return out


def _reference_lm():
    """The reference LM's weights, fixed tokens and its seq-parallel
    forward on them over a 2-device seq mesh."""
    dense = jlm.TransformerLM(**LM).build(jax.random.key(1))
    sp = jlm.TransformerLM(**LM, seq_parallel=True).build(jax.random.key(1))
    sp.params = dense.params
    tokens = np.random.RandomState(6).randint(
        0, LM["vocab_size"], (2, LM["max_len"])).astype(np.int32)
    with Mesh(np.array(jax.devices()[:2]), ("seq",)):
        fwd, _ = jax.jit(lambda p, st, x: sp.apply(
            p, st, x, training=False, rng=None))(
                sp.params, sp.state, jnp.asarray(tokens))
    return (dense, jax.tree.map(np.asarray, (dense.params, dense.state)),
            tokens, np.asarray(fwd))


def _reference_losses(dense):
    """The reference's dense LM trained 5 steps."""
    toks = _lm_data()
    losses = {}

    def rec(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    JEngine.reset()
    JEngine.init()
    try:
        JOptimizer(dense, JDataSet.array(
            [JSample.from_ndarray(toks[i, :-1], toks[i, 1:])
             for i in range(len(toks))]),
            jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                         size_average=True),
            batch_size=BATCH).set_optim_method(
                JSGD(0.1, momentum=0.9)).set_end_when(
                    JTrigger(rec, "record")).optimize()
    finally:
        JEngine.reset()
    return [losses[i] for i in range(1, STEPS + 1)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both groups' ranks started first (2 ranks with the LM, 4 without),
    the reference computed while they run."""
    tmp = tmp_path_factory.mktemp("ring")
    dense, lm_params, lm_tokens, lm_forward = _reference_lm()
    procs, dirs = [], {}
    for n in (2, 4):
        d = tmp / f"n{n}"
        d.mkdir()
        dirs[n] = d
        spec = {"qkvg": _qkvg(n, seed=n), "cases": CASES}
        if n == 2:
            spec.update(lm=LM, lm_params=lm_params, lm_tokens=lm_tokens,
                        lm_data=_lm_data(), steps=STEPS, batch=BATCH)
        pickle.dump(spec, open(d / "spec.pkl", "wb"))
        (d / "worker.py").write_text(_WORKER)
        env = {**os.environ, "PYTHONPATH": _REPO,
               "BIGDL_TORCH_COORDINATOR": f"file://{d}/store",
               "BIGDL_TORCH_NUM_PROCESSES": str(n)}
        procs += [subprocess.Popen(
            [sys.executable, str(d / "worker.py"), str(d / "spec.pkl"),
             str(d)], env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
    try:
        ref = {n: _reference_attention(n) for n in (2, 4)}
        ref_lm = (lm_forward, _reference_losses(dense))
        errs = [p.communicate(timeout=180)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    got = {n: [pickle.load(open(dirs[n] / f"rank{r}.pkl", "rb"))
               for r in range(n)] for n in (2, 4)}
    return ref, ref_lm, got


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name,causal", CASES)
def test_attention_shards_match_reference(ranks, n, name, causal):
    ref, _, got = ranks
    key = f"{name}-{causal}"
    for i, what in enumerate(("o", "dq", "dk", "dv")):
        whole = np.concatenate([r[key][i] for r in got[n]], axis=2)
        tol = OUT_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(whole, ref[n][key][i], atol=tol,
                                   rtol=tol, err_msg=what)


def test_seq_parallel_lm_forward_matches_reference(ranks):
    _, ref_lm, got = ranks
    for r in got[2]:
        np.testing.assert_allclose(r["lm_forward"], ref_lm[0], rtol=2e-4,
                                   atol=2e-5)
    assert np.array_equal(got[2][0]["lm_forward"], got[2][1]["lm_forward"])


def test_seq_parallel_lm_trains_like_reference(ranks):
    _, ref_lm, got = ranks
    losses = [r["lm_losses"] for r in got[2]]
    assert losses[0] == losses[1]
    assert len(losses[0]) == STEPS and losses[0][-1] != losses[0][0]
    np.testing.assert_allclose(losses[0], ref_lm[1], atol=LOSS_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_block_backward_sums_to_whole(causal):
    """Two key blocks of one query shard: B7's plain version from the
    final log-sum-exp, summed over the blocks, is the whole backward (the
    diagonal block causal, the block below it not)."""
    rs = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rs.standard_normal((1, 2, 8, 8)).astype(
        np.float32)) for _ in range(4))
    scale = 8 ** -0.5
    # q holds rows 8..15, the keys rows 0..15 (block 0 below the diagonal)
    k2, v2 = (torch.from_numpy(rs.standard_normal((1, 2, 8, 8)).astype(
        np.float32)) for _ in range(2))
    kk, vv = torch.cat([k2, k], 2), torch.cat([v2, v], 2)
    o = mha_reference(q, kk, vv, causal=causal, sm_scale=scale, q_offset=8)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    if causal:
        qi = 8 + torch.arange(8)[:, None]
        s = s.masked_fill(torch.arange(16)[None, :] > qi, float("-inf"))
    lse = torch.logsumexp(s, -1)
    parts = [block_bwd_reference(q, kb, vb, o, g, lse, causal=c,
                                 sm_scale=scale)
             for kb, vb, c in ((k2, v2, False), (k, v, causal))]
    want = flash_bwd_reference(q, kk, vv, g, causal=causal, sm_scale=scale,
                               q_offset=8)
    dq = parts[0][0] + parts[1][0]
    dk = torch.cat([parts[0][1], parts[1][1]], 2)
    dv = torch.cat([parts[0][2], parts[1][2]], 2)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_seq_parallel_builds_and_raises_without_axis():
    model = tlm.TransformerLM(97, seq_parallel=True, num_layers=1,
                              d_model=16, num_heads=2, max_len=8)
    attn = [m for m in model.modules()
            if type(m).__name__ == "MultiHeadAttention"]
    assert attn and all(m.seq_parallel and m.seq_axis == "seq"
                        for m in attn)
    model.build("cpu")
    with pytest.raises(ValueError, match="'seq' axis"):
        model(torch.zeros((1, 8), dtype=torch.long))
    with pytest.raises(ValueError, match="'seq' axis"):
        ring_attention(*(torch.zeros(1, 2, 4, 8) for _ in range(3)))
