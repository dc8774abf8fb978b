"""The topology router on four gloo CPU ranks, against the JAX package's
``TopologyRouter`` on four of the suite's virtual devices.

Four rank processes (one intra-op thread each, a barrier before every
``Engine.reset()``) run the scenarios below in turn while this process
runs the reference's on the same weights (a small LM: 2 layers, 4 heads,
width 64; requests of 5 to 16 tokens over the sequence buckets (8, 16)).
A row's float32 sums on the CPU depend on the rows beside it (the
product's blocking), so the routers serve batches of one wherever answers
are compared bit for bit, as ``tests/test_torch_port_serve_control.py``
does:

- the dispatch order of ``_pick`` on an unstarted pool of two (1,1,1)
  members at ``max_batch=4`` (the reference's
  ``tests/test_serve_scale.py:333-355``);
- two (1,1,1) members (ranks {0}, {1}) and two (1,1,2) members (ranks
  {0,1}, {2,3}, the parameters tp-sharded): every answer bit-equal to
  ``Predictor`` on the member's layout (pinned to the member's mesh,
  batch 1), on both members, and within :data:`TOL` of the reference's
  router; both members routed to;
- a member lost: member 0 of the (1,1,2) pool marked unhealthy takes no
  more traffic, member 1 answers everything, the pool stays healthy;
- ``scale_to`` and the ``AutoScaler`` (the router as its target) up and
  down on a (1,1,1) pool planned for two members: the answers before,
  after growing and after shrinking bit-equal, the queued requests
  answered through the shrink; the offered-traffic trace, replayed
  through the router;
- ``parallel/dryrun_extras.run`` on the four ranks.

``plan_subsets`` and the typed ``PlacementError`` are checked against the
reference in this process.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from bigdl_tpu import Engine as JEngine
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.parallel import MeshLayout as JMeshLayout
from bigdl_tpu.serve import PlacementError as JPlacementError
from bigdl_tpu.serve import TopologyRouter as JTopologyRouter
from bigdl_tpu.serve import plan_subsets as jplan_subsets

from bigdl_torch.serve import PlacementError, TopologyRouter, plan_subsets

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LM = dict(vocab_size=64, max_len=16, d_model=64, num_heads=4, num_layers=2)
SEQ_BUCKETS = (8, 16)
MAX_BATCH = 1
PROBE_BATCH = 4
N_REQ = 12
LAYOUTS = {"111": (1, 1, 1), "112": (1, 1, 2)}


def _requests(n=N_REQ, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, LM["vocab_size"], rs.integers(5, 17)).astype(
        np.int32) for _ in range(n)]


_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigdl_torch.models.transformer_lm import TransformerLM
    from bigdl_torch.optim import Predictor
    from bigdl_torch.parallel import LayoutSharding, MeshLayout
    from bigdl_torch.parallel import dryrun_extras
    from bigdl_torch.serve import (AutoScaler, ReplicaLostError,
                                   TopologyRouter, replay)
    from bigdl_torch.serve.batcher import fit_bucket, pad_tail
    from bigdl_torch.utils.convert import load_reference_tree
    from bigdl_torch.utils.engine import Engine

    job, tmp = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
    torch.set_num_threads(1)   # the ranks share the host's cores
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{tmp}/store"
    Engine.init(device="cpu")
    res = {}
    xs = job["xs"]
    N = len(xs)
    kw = dict(seq_buckets=job["seq_buckets"], max_batch=job["max_batch"],
              max_wait_ms=5, example=np.zeros(8, np.int32), device="cpu")

    def lm():
        m = TransformerLM(**job["lm"]).build("cpu")
        return load_reference_tree(m, *job["params"])

    def padded(x):
        return pad_tail(x, fit_bucket(len(x), job["seq_buckets"]))

    def answers(router, rows):
        return [h.result(60) for h in [router.submit(x) for x in rows]]

    # the dispatch order on an unstarted pool (members built by hand)
    probe = TopologyRouter(lm(), replicas=2,
                           **dict(kw, max_batch=job["probe_batch"]))
    if rank == 0:
        for i in range(2):
            probe._members[i] = probe._build_member(i)
        m0, m1 = probe._members
        picks = [probe._pick()]
        m0.batcher._q.extend([object()] * 4)
        picks.append(probe._pick())
        m1.batcher._q.extend([object()] * 5)
        picks.append(probe._pick())
        m0.batcher._q.clear()
        m1.batcher._q.clear()
        m1.batcher._q.append(object())
        picks.append(probe._pick())
        m1.batcher._q.clear()
        m0._unhealthy = ReplicaLostError("drill")
        picks.append(probe._pick())
        res["picks"] = picks

    for key, sizes in job["layouts"].items():
        model = lm()
        router = TopologyRouter(model, layout=MeshLayout(*sizes), replicas=2,
                                **kw).start()
        if rank == 0:
            out = answers(router, xs)
            st = router.stats()
            res[key] = {"answers": out, "routed": st["router"]["routed"],
                        "router_keys": sorted(st["router"]),
                        "members": st["router"]["members"]}
            if key == "112":
                router._members[0]._mark_unhealthy(
                    ReplicaLostError("drill: member 0 lost"))
                before = list(router._routed)
                lost = answers(router, xs[:8])
                res["lost"] = {"answers": lost, "routed_after": [
                    a - b for a, b in zip(router._routed, before)],
                    "healthy": router.healthy(),
                    "member_health": [router.stats()["router"]["members"][i]
                                      ["healthy"] for i in ("0", "1")]}
        router.stop()
        # Predictor on the member's layout, on the member's ranks
        mine = next(i for i, s in enumerate(router._subsets) if rank in s) \\
            if any(rank in s for s in router._subsets) else None
        if mine is not None:
            with Engine.pinned(router._meshes[mine]):
                strat = LayoutSharding(model) if sizes != (1, 1, 1) else None
                pred = Predictor(model, batch_size=1, strategy=strat,
                                 device="cpu")
                res[f"{key}_predictor"] = [pred.predict(padded(x)[None])[0]
                                           for x in xs]
        res[f"{key}_member"] = mine

    # scale up and down on a (1,1,1) pool planned for two members: the
    # autoscaler's decisions on the router, and scale_to
    router = TopologyRouter(lm(), replicas=1, max_replicas=2, **kw).start()
    if rank == 0:
        router.record_trace()
        one = answers(router, xs)
        scaler = AutoScaler(router, min_replicas=1, max_replicas=2,
                            target_wait_ms=0.001, up_polls=1, idle_s=1.0,
                            cooldown_s=0.0)
        burst = [router.submit(x) for x in xs]
        decisions = [scaler.check()]      # the burst is still queued
        burst = [h.result(60) for h in burst]
        two = answers(router, xs)
        st2 = router.stats()
        pending = [router.submit(x) for x in xs]
        router.scale_to(1)
        shrunk = [h.result(60) for h in pending]
        after = answers(router, xs)
        live_after = router.stats()["replicas_live"]
        router.scale_to(2)
        t = scaler.clock()
        decisions += [scaler.check(now=t), scaler.check(now=t + 5.0)]
        events = router.stop_trace()
        # the recorded traffic replayed through the router
        outcomes = replay(events[:N], lambda e: router.submit(e.payload),
                          speed=1000.0)
        res["replay"] = [o.handle.result(60) for o in outcomes]
        res["scale"] = {"one": one, "burst": burst, "two": two,
                        "shrunk": shrunk, "after": after,
                        "decisions": decisions,
                        "replicas_end": router.replicas,
                        "live_two": st2["replicas_live"],
                        "routed_two": st2["router"]["routed"],
                        "live_after": live_after,
                        "trace_events": len(events)}
    router.stop()

    res["dryrun"] = dryrun_extras.run(
        MeshLayout(1, 2, 2).build_mesh(range(4)))
    pickle.dump(res, open(os.path.join(tmp, f"rank{rank}.pkl"), "wb"))
    dist.barrier()
    Engine.reset()
''')


def _reference(params, xs):
    """The reference's router answers on each layout, and its ``_pick``
    order on an unstarted pool."""
    jm = jlm.TransformerLM(**LM)
    jm.build(jax.random.key(0))
    jm.params = jax.tree.map(np.asarray, params[0])
    kw = dict(seq_buckets=SEQ_BUCKETS, max_batch=MAX_BATCH, max_wait_ms=5,
              example=np.zeros(8, np.int32))
    out = {}
    JEngine.reset()
    JEngine.init()
    try:
        for key, sizes in LAYOUTS.items():
            with JTopologyRouter(jm, layout=JMeshLayout(*sizes), replicas=2,
                                 **kw) as router:
                out[key] = [h.result(60) for h in
                            [router.submit(x) for x in xs]]
                out[key + "_keys"] = sorted(router.stats()["router"])
        from bigdl_tpu.serve import ReplicaLostError
        probe = JTopologyRouter(jm, replicas=2,
                                **dict(kw, max_batch=PROBE_BATCH))
        for i in range(2):
            probe._members[i] = probe._build_member(i)
        m0, m1 = probe._members
        picks = [probe._pick()]
        m0.batcher._q.extend([object()] * 4)
        picks.append(probe._pick())
        m1.batcher._q.extend([object()] * 5)
        picks.append(probe._pick())
        m0.batcher._q.clear()
        m1.batcher._q.clear()
        m1.batcher._q.append(object())
        picks.append(probe._pick())
        m1.batcher._q.clear()
        m0._unhealthy = ReplicaLostError("drill")
        picks.append(probe._pick())
        out["picks"] = picks
    finally:
        JEngine.reset()
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's scenarios on four gloo ranks, started first, and the
    reference's computed while they run."""
    tmp = tmp_path_factory.mktemp("router")
    jm = jlm.TransformerLM(**LM).build(jax.random.key(5))
    params = jax.tree.map(np.asarray, (jm.params, jm.state))
    xs = _requests()
    job = {"lm": LM, "params": params, "xs": xs, "seq_buckets": SEQ_BUCKETS,
           "max_batch": MAX_BATCH, "probe_batch": PROBE_BATCH,
           "layouts": LAYOUTS}
    (tmp / "job.pkl").write_bytes(pickle.dumps(job))
    (tmp / "worker.py").write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_NUM_PROCESSES": "4"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "job.pkl"),
         str(tmp)], env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        ref = _reference(params, xs)
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    ranks = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    return job, ref, ranks


def test_plan_subsets_disjoint_and_typed_placement_error():
    ranks = list(range(8))
    subsets = plan_subsets(ranks, 2, 4)
    assert subsets == jplan_subsets(ranks, 2, 4)
    seen = [r for s in subsets for r in s]
    assert len(set(seen)) == len(seen) == 8
    for per, n in ((3, 3), (0, 1), (1, 0)):
        with pytest.raises(PlacementError):
            plan_subsets(ranks, per, n)
        with pytest.raises(JPlacementError):
            jplan_subsets(ranks, per, n)
    assert issubclass(PlacementError, __import__(
        "bigdl_torch.serve", fromlist=["ServeError"]).ServeError)


def test_placement_error_at_construction():
    """A world of one process holds no two members: typed, before any
    group is formed."""
    from bigdl_torch.nn import Linear
    with pytest.raises(PlacementError, match="cannot place 2"):
        TopologyRouter(Linear(4, 3), replicas=2, device="cpu")


def test_pick_order_on_an_unstarted_pool(run):
    _, ref, ranks = run
    assert ranks[0]["picks"] == ref["picks"] == [0, 1, 1, 1, 1]


@pytest.mark.parametrize("key", sorted(LAYOUTS))
def test_answers_bit_equal_to_predictor_on_the_member_layout(run, key):
    job, _, ranks = run
    got = ranks[0][key]["answers"]
    owners = {r[f"{key}_member"]: r[f"{key}_predictor"] for r in ranks
              if r[f"{key}_member"] is not None}
    assert sorted(owners) == [0, 1]
    for want in owners.values():
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert all(n > 0 for n in ranks[0][key]["routed"])
    assert sum(ranks[0][key]["routed"]) == N_REQ


@pytest.mark.parametrize("key", sorted(LAYOUTS))
def test_answers_match_reference_router(run, key):
    _, ref, ranks = run
    for a, b in zip(ranks[0][key]["answers"], ref[key]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_stats_router_keys_match_reference(run):
    _, ref, ranks = run
    for key in LAYOUTS:
        assert ranks[0][key]["router_keys"] == ref[key + "_keys"]
        members = ranks[0][key]["members"]
        ranks_of = [members[i]["devices"] for i in ("0", "1")]
        want = [[0], [1]] if key == "111" else [[0, 1], [2, 3]]
        assert ranks_of == want
        assert all(m["messages"]["activate"] == 1 for m in members.values())


def test_member_lost_routes_around(run):
    _, _, ranks = run
    lost = ranks[0]["lost"]
    assert lost["routed_after"] == [0, 8]
    assert lost["healthy"] is True
    assert lost["member_health"] == [False, True]
    for a, b in zip(lost["answers"], ranks[0]["112"]["answers"][:8]):
        np.testing.assert_array_equal(a, b)


def test_scale_to_up_and_down(run):
    """``scale_to`` and the ``AutoScaler`` with the router as its target:
    a queued burst grows the pool, an idle window shrinks it; every answer
    bit-equal across the resizes."""
    _, _, ranks = run
    sc = ranks[0]["scale"]
    for name in ("burst", "two", "shrunk", "after"):
        for a, b in zip(sc[name], sc["one"]):
            np.testing.assert_array_equal(a, b)
    assert sc["decisions"] == ["up", None, "down"]
    assert sc["replicas_end"] == 1
    assert sc["live_two"] == 2 and sc["live_after"] == 1
    assert sum(sc["routed_two"]) == 3 * N_REQ
    assert sc["trace_events"] == 5 * N_REQ
    # the replay target: the first recorded requests through the router
    for a, b in zip(ranks[0]["replay"], sc["one"]):
        np.testing.assert_array_equal(a, b)


def test_dryrun_extras_on_four_ranks(run):
    _, _, ranks = run
    for r in ranks:
        d = r["dryrun"]
        assert set(d) == {"ring_max_abs_err", "ulysses_max_abs_err",
                          "pipeline_max_abs_err", "pipeline_loss_err"}
        assert max(d.values()) <= 2e-5
