"""Mixture-of-experts (``parallel/expert.py``) against the JAX package.

- ``top_k_routing`` at k = 1 and 2, with and without overflow: dispatch
  and assign bit-equal to the reference's (the routing is piecewise
  constant), combine and probs within 1e-6 (float32 softmax, one ulp
  apart at most).
- ``load_balancing_loss`` within 1e-6.
- ``MoEFFN`` (float32, eval and training with ``router_jitter = 0``):
  output, input gradient and parameter gradients within 1e-5 of the
  compared tensor's largest magnitude, the ``aux_loss`` state within 1e-6;
  its reference tree round trip; the jitter draws from the ``dropout_rng``
  generator.
- ``TransformerLM(num_experts=4)``, 2 layers, trained 5 steps by both
  packages' ``Optimizer`` (SGD with momentum, jitter 0): each loss within
  2e-3 (the roadmap's training-parity bound), the auxiliary loss added to
  the criterion's as the reference adds it.
- ``expert_parallel_ffn`` over 2 gloo ranks (a ``DeviceMesh`` axis
  ``"expert"``, started with ``subprocess``): each rank's global [T, D]
  within 1e-5 of the reference's ``shard_map`` program on a 2-device
  ``"expert"`` mesh, with and without dropped tokens, and of the dense
  ``MoEFFN`` math where no token overflows; the dense math on a mesh
  without the axis, equal to the reference's.
- The CLI, ``ViT`` and ``tools/perf.py`` build the MoE variants.
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
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import run as jrun
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import expert as jexp

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import run as trun
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.models import vit as tvit
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.parallel import expert as texp
from bigdl_torch.tools import perf as tperf
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

F32 = 1e-5
AUX_TOL = 1e-6
TRAIN_TOL = 2e-3
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _logits(T, E, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal((T, E))
            .astype(np.float32) * scale)


@pytest.mark.parametrize("T,E,cap,k", [(64, 4, 20, 1), (64, 4, 8, 1),
                                       (64, 8, 12, 2), (37, 8, 3, 2),
                                       (128, 8, 20, 1)])
def test_top_k_routing_bit_equal(T, E, cap, k):
    lg = _logits(T, E, seed=T + E + cap + k, scale=3.0)
    want = jexp.top_k_routing(jnp.asarray(lg), cap, k)
    got = texp.top_k_routing(torch.from_numpy(lg), cap, k)
    (jc, jd, jp, ja), (tc, td, tp, ta) = want, got
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=AUX_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=AUX_TOL)
    # capacity binds where it is small: some token is dropped
    if cap * E < k * T:
        assert td.numpy().sum() < k * T


def test_top_k_routing_refuses_k_above_experts():
    with pytest.raises(ValueError, match="num_experts"):
        texp.top_k_routing(torch.zeros((4, 2)), 4, k=3)


def test_load_balancing_loss():
    lg = _logits(96, 8, seed=3, scale=2.0)
    _, _, jp, ja = jexp.top_k_routing(jnp.asarray(lg), 16, 2)
    _, _, tp, ta = texp.top_k_routing(torch.from_numpy(lg), 16, 2)
    want = float(jexp.load_balancing_loss(jp, ja))
    got = float(texp.load_balancing_loss(tp, ta))
    assert abs(got - want) <= AUX_TOL


D, H, E = 16, 32, 4


def _moe_pair(seed=0, **kw):
    jm = jexp.MoEFFN(D, H, E, **kw).build(jax.random.key(seed))
    tm = texp.MoEFFN(D, H, E, **kw).build("cpu")
    tm.router_jitter = jm.router_jitter = 0.0
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


def _close(got, want, tol=F32, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("training", [False, True])
def test_moe_ffn_forward_backward(k, training):
    jm, tm = _moe_pair(seed=k, k=k)
    x = np.random.RandomState(k).standard_normal((2, 12, D)).astype(
        np.float32)
    ct = np.random.RandomState(9).standard_normal(x.shape).astype(np.float32)

    def f(p, x_):
        y, st = jm.apply(p, jm.state, x_, training=training)
        return jnp.sum(y * ct) + st["aux_loss"], (y, st)
    (jl, (jy, jst)), (jgp, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jm.params, jnp.asarray(x))

    tm.train(training)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tm(tx)
    aux = texp.collect_aux_losses(tm)
    assert (aux is not None) == training
    loss = (ty * torch.from_numpy(ct)).sum() + (
        aux if training else tm.aux_loss)
    loss.backward()
    _close(ty.detach(), jy, what="output")
    assert abs(float(tm.aux_loss) - float(jst["aux_loss"])) <= AUX_TOL
    _close(tx.grad, jgx, what="input gradient")
    for name in ("gate", "w1", "b1", "w2", "b2"):
        _close(getattr(tm, name).grad, jgp[name], what=name)
    assert texp.collect_aux_losses(tm) is None     # taken once


def test_moe_tree_round_trip_and_roles():
    jm, tm = _moe_pair()
    params, state = to_reference_tree(tm)
    assert jax.tree.structure(params) == jax.tree.structure(jm.params)
    assert jax.tree.structure(state) == jax.tree.structure(jm.state)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jm.params)):
        assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b))
    assert texp.MoEFFN.PARAM_ROLES == jexp.MoEFFN.PARAM_ROLES
    assert tm._capacity(24) == jm._capacity(24) == 8


def test_router_jitter_draws_from_the_dropout_generator():
    _, tm = _moe_pair()
    tm.router_jitter = 0.5
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (64, D)).astype(np.float32))
    plain = tm(x)
    outs = []
    for seed in (5, 5, 6):
        with tnn.dropout_rng(torch.Generator().manual_seed(seed)):
            outs.append(tm(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2]) or not torch.equal(
        outs[0], plain)
    tm.eval()
    assert torch.equal(tm(x), tm(x))


LM = dict(vocab_size=97, max_len=16, d_model=32, num_heads=4, num_layers=2,
          num_experts=4)
STEPS, BATCH = 5, 8


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


def _jax_moes(m):
    out = [m] if isinstance(m, jexp.MoEFFN) else []
    for c in getattr(m, "modules", None) or []:
        out += _jax_moes(c)
    return out


def test_moe_lm_trains_like_reference():
    jm = jlm.TransformerLM(**LM)
    for m in _jax_moes(jm):
        m.router_jitter = 0.0
    jm.build(jax.random.key(0))
    tm = tlm.TransformerLM(**LM).build("cpu")
    moes = [m for m in tm.modules() if isinstance(m, texp.MoEFFN)]
    assert len(moes) == LM["num_layers"]
    for m in moes:
        m.router_jitter = 0.0
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    toks = np.random.RandomState(0).randint(
        0, LM["vocab_size"], (BATCH * STEPS, LM["max_len"] + 1))
    toks = toks.astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]

    JEngine.init()
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
    for n in jlosses:
        assert np.isfinite(tlosses[n])
        assert abs(tlosses[n] - jlosses[n]) <= TRAIN_TOL, (n, tlosses,
                                                           jlosses)
    # the auxiliary losses are in the loss: the state holds them
    assert all(float(m.aux_loss) > 0 for m in moes)
    assert tlosses[STEPS] != tlosses[1]


def test_optimizer_loss_adds_the_aux_loss():
    """The Optimizer's training loss is the criterion's plus each
    MoEFFN's Switch loss of the same forward (the reference's
    ``collect_aux_losses``)."""
    tm = tlm.TransformerLM(**LM).build("cpu", torch.Generator()
                                       .manual_seed(0))
    toks = np.random.RandomState(1).randint(0, 97, (8, 17)).astype(np.int32)
    opt = TOptimizer(tm, TDataSet.array(
        [TSample.from_ndarray(toks[i, :-1], toks[i, 1:]) for i in range(8)]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                     size_average=True),
        batch_size=8, device="cpu")
    tm.train()
    x, y = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])
    loss = opt._loss(x, y, None).detach()
    assert texp.collect_aux_losses(tm) is None      # taken by the loss
    base = opt.criterion(tm(x), y).detach()
    aux = texp.collect_aux_losses(tm).detach()
    assert float(aux) > 0
    assert loss.item() == pytest.approx((base + aux).item(), abs=1e-6)


def test_remat_recompute_leaves_no_aux_loss():
    """Under ``set_remat("full")`` the loss carries the forward's Switch
    losses, equal to the unremat loss, and the backward's recompute leaves
    none behind; a model without MoE layers has none to collect."""
    toks = np.random.RandomState(3).randint(0, 97, (8, 17)).astype(np.int32)
    x, y = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])
    losses = []
    for policy in (None, "full"):
        tm = tlm.TransformerLM(**LM).build("cpu", torch.Generator()
                                           .manual_seed(0))
        opt = TOptimizer(tm, TDataSet.array(
            [TSample.from_ndarray(toks[i, :-1], toks[i, 1:])
             for i in range(8)]),
            tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=True),
            batch_size=8, device="cpu").set_remat(policy)
        tm.train()
        loss = opt._loss(x, y, None)
        loss.backward()
        assert len(opt._aux_layers) == LM["num_layers"]
        assert all("_aux_live" not in m.__dict__ for m in tm.modules())
        losses.append(loss.item())
    assert losses[1] == pytest.approx(losses[0], abs=1e-6)
    dense = {**LM, "num_experts": 0}
    tm = tlm.TransformerLM(**dense).build("cpu")
    opt = TOptimizer(tm, TDataSet.array(
        [TSample.from_ndarray(toks[i, :-1], toks[i, 1:]) for i in range(8)]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                     size_average=True),
        batch_size=8, device="cpu")
    opt._loss(x, y, None)
    assert opt._aux_layers == []


# -- expert parallelism over 2 gloo ranks -------------------------------------

_EP_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from bigdl_torch.parallel.expert import expert_parallel_ffn

    rank, out, store = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("expert",))
    params, x = pickle.load(open(out + ".in", "rb"))
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    ys = [expert_parallel_ffn(mesh, params, torch.from_numpy(x), k=1,
                              capacity_factor=cf).numpy()
          for cf in (4.0, 1.0)]
    pickle.dump(ys, open(out + "." + str(rank), "wb"))
    dist.destroy_process_group()
''')


def test_expert_parallel_ffn_two_gloo_ranks(tmp_path):
    _, tm = _moe_pair(seed=7)
    params = {n: getattr(tm, n).detach().numpy() for n in tm.param_names}
    T = 32
    x = np.random.RandomState(7).standard_normal((T, D)).astype(np.float32)
    out = str(tmp_path / "ep")
    pickle.dump((params, x), open(out + ".in", "wb"))
    (tmp_path / "worker.py").write_text(_EP_WORKER)
    store = str(tmp_path / "store")
    env = {**os.environ, "PYTHONPATH": _REPO}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r), out, store],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    outs = [pickle.load(open(f"{out}.{r}", "rb")) for r in range(2)]
    # the reference's shard_map program over a 2-device "expert" axis, at
    # the same local capacities: capacity_factor 4 routes every token,
    # 1.0 drops some in each shard
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("expert",))
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    half = torch.from_numpy(x).view(2, T // 2, D)
    kept = [texp.top_k_routing(h @ torch.from_numpy(params["gate"]),
                               texp._capacity(1, T // 2, E, 1.0), 1)[1].sum()
            for h in half]
    assert sum(kept) < T        # capacity 1.0 drops tokens
    for i, cf in enumerate((4.0, 1.0)):
        want = np.asarray(jexp.expert_parallel_ffn(
            jmesh, jparams, jnp.asarray(x), k=1, capacity_factor=cf))
        for r in range(2):      # every rank holds the global [T, D]
            assert outs[r][i].shape == (T, D)
            _close(outs[r][i], want, what=f"rank {r} at capacity {cf}")
    got = outs[0][0]
    # the dense math at a capacity where no token overflows
    tparams = {n: torch.from_numpy(v) for n, v in params.items()}
    dense = texp.expert_parallel_ffn(None, tparams, torch.from_numpy(x),
                                     capacity_factor=float(E))
    _, dispatch, _, _ = texp.top_k_routing(
        torch.from_numpy(x) @ tparams["gate"], T, 1)
    assert dispatch.sum() == T      # every token routed
    _close(got, dense.numpy())
    # and the MoEFFN module at that capacity
    tm.capacity_factor = float(E)
    with torch.no_grad():
        _close(got, tm.eval()(torch.from_numpy(x)).numpy())


def test_expert_parallel_ffn_dense_without_the_axis():
    _, tm = _moe_pair(seed=2)
    params = {n: getattr(tm, n).detach() for n in tm.param_names}
    x = np.random.RandomState(2).standard_normal((24, D)).astype(np.float32)

    class NoAxis:
        mesh_dim_names = ("data",)

        def size(self, dim=None):
            return 2
    for mesh in (None, NoAxis()):
        got = texp.expert_parallel_ffn(mesh, params, torch.from_numpy(x))
        jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
        want = jexp.expert_parallel_ffn(
            jmesh, {n: jnp.asarray(v.numpy()) for n, v in params.items()},
            jnp.asarray(x))
        _close(got.numpy(), want)


# -- the entry points -----------------------------------------------------------

def _leaves(model):
    kids = list(getattr(model, "layers", None) or getattr(model, "modules",
                                                          None) or [])
    if not kids or not isinstance(kids, list):
        return [(type(model).__name__,)]
    return [(type(model).__name__,)] + [s for c in kids for s in _leaves(c)]


@pytest.mark.parametrize("name", ["transformer", "vit"])
def test_cli_builds_the_moe_variants(name):
    tmodel, tspec, tcrit = trun._build_model(name, 10, num_experts=4)
    jmodel, jspec, jcrit = jrun._build_model(name, 10, num_experts=4)
    assert (tspec, tcrit) == (jspec, jcrit)
    moes = [m for m in tmodel.modules() if isinstance(m, texp.MoEFFN)]
    assert len(moes) == 4 and {m.num_experts for m in moes} == {4}
    tmodel.build("cpu")
    jmodel.build(jax.random.key(0))
    load_reference_tree(tmodel, jax.tree.map(np.asarray, jmodel.params),
                        jax.tree.map(np.asarray, jmodel.state))


def test_vit_moe_forward_matches_reference():
    kw = dict(image_size=16, patch_size=4, class_num=5, d_model=16,
              num_heads=2, num_layers=2, num_experts=2)
    jm = __import__("bigdl_tpu.models.vit", fromlist=["ViT"]).ViT(**kw)
    jm.build(jax.random.key(3))
    tm = tvit.ViT(**kw).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    x = np.random.RandomState(3).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    jy, _ = jm.apply(jm.params, jm.state, jnp.asarray(x), training=False)
    with torch.no_grad():
        ty = tm.eval()(torch.from_numpy(x))
    _close(ty.numpy(), jy)


def test_perf_cli_runs_the_moe_lm():
    out = tperf.run("transformer", 2, iters=1, warmup=1, num_experts=2,
                    device="cpu")
    assert out["num_experts"] == 2
    assert np.isfinite(out["timing"]["first_loss"])


def test_seq_parallel_still_raises():
    """Ported since: the seq-parallel LM builds (with experts too) and
    raises at its forward without a ``seq`` axis."""
    m = tlm.TransformerLM(97, seq_parallel=True, num_experts=2,
                          num_layers=1, d_model=16, num_heads=2,
                          max_len=8).build("cpu")
    with pytest.raises(ValueError, match="'seq' axis"):
        m(torch.zeros((1, 8), dtype=torch.long))
