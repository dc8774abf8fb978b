"""Serving on a mesh layout on four gloo CPU ranks, against the JAX
package's ``InferenceServer(mesh=)`` and ``DecodeEngine(mesh=)`` on the
suite's virtual devices; and the scaling tool's collectives by route.

Four rank processes (one intra-op thread each, a barrier before every
``Engine.reset()``) run on the Engine's ``(1,2,2)`` mesh while this
process runs the reference's on the same weights (a small LM: 2 layers, 4
heads, width 64; requests of 5 to 16 tokens over the sequence buckets (8,
16); batches of one, since a row's float32 sums on the CPU depend on the
rows beside it):

- ``InferenceServer(mesh=, strategy=LayoutSharding, replicas=2)`` led by
  rank 0: requests from two client threads, each answer bit-equal to
  ``Predictor`` under the same layout on its own request (no answer
  crosses to another request) and within :data:`TOL` of the reference's
  server on the same layout;
- three swaps while a client thread keeps submitting (a reference tree, a
  snapshot file the reference wrote, a Module): no request lost, every
  answer bit-equal to ``Predictor`` under the layout on the weights of
  the version that answered it; the followers hold only the versions the
  leader still serves; then a canary promoted, the pool resized and a
  replica restarted on the mesh, the answers likewise;
- ``DecodeEngine(mesh=)`` on the ``(1,2,2)`` mesh and, at once, on two
  ``(1,1,2)`` meshes (ranks {0,1} led by rank 0, {2,3} by rank 2):
  continuous admission with a cache page grown mid-flight; greedy tokens
  equal to the reference's ``DecodeEngine(mesh=(1,1,2))`` and to its
  engine on one device (its ``(1,2,2)`` engine fails its own prefill: the
  executable's cache sharding differs from the cache's), no CUDA graph,
  and a sampled run that completes on every rank.
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
from bigdl_tpu.parallel import LayoutSharding as JLayoutSharding
from bigdl_tpu.parallel import MeshLayout as JMeshLayout
from bigdl_tpu.serve import DecodeEngine as JDecodeEngine
from bigdl_tpu.serve import InferenceServer as JServer
from bigdl_tpu.utils import file_io as jio

from bigdl_torch.tools import scaling

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LM = dict(vocab_size=64, max_len=16, d_model=64, num_heads=4, num_layers=2)
SEQ_BUCKETS = (8, 16)
N_REQ = 12
#: (prompt length, new tokens): four fit the 8-token page, the last two
#: arrive while two of those still decode and grow it to 16
DECODE = ((3, 5), (3, 2), (3, 2), (4, 4), (5, 6), (5, 6))


def _requests(n=N_REQ, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, LM["vocab_size"], rs.integers(5, 17)).astype(
        np.int32) for _ in range(n)]


def _prompts(seed=3):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, LM["vocab_size"], n).astype(np.int32)
            for n, _ in DECODE]


_WORKER = textwrap.dedent('''
    import os, pickle, sys, threading, time
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigdl_torch.models.transformer_lm import TransformerLM
    from bigdl_torch.optim import Predictor
    from bigdl_torch.parallel import LayoutSharding, MeshLayout
    from bigdl_torch.serve import DecodeEngine, InferenceServer
    from bigdl_torch.serve import lead as lead_mod
    from bigdl_torch.serve.batcher import fit_bucket, pad_tail
    from bigdl_torch.utils.convert import load_reference_tree
    from bigdl_torch.utils.engine import Engine

    job, tmp = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
    torch.set_num_threads(1)   # the ranks share the host's cores
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{tmp}/store"
    Engine.init(device="cpu", mesh_shape=MeshLayout(1, 2, 2).shape())
    lead_mod.KEEPALIVE_S = 0.1   # an idle leader's no-ops, within a test
    res = {}
    xs = job["xs"]

    def lm(params):
        m = TransformerLM(**job["lm"]).build("cpu")
        return load_reference_tree(m, *params)

    def padded(x):
        return pad_tail(x, fit_bucket(len(x), job["seq_buckets"]))

    model = lm(job["params"][0])
    # a clock that stands still: every batch lasts 0 s, so the canary is
    # judged on errors alone
    server = InferenceServer(
        model, mesh=Engine.mesh(), strategy=LayoutSharding(model),
        replicas=2, max_batch=1, max_wait_ms=2, canary_min_batches=2,
        seq_buckets=job["seq_buckets"], example=np.zeros(8, np.int32),
        clock=lambda: 0.0, device="cpu").start()
    if rank == 0:
        got = {}

        def client(rows, tag):
            hs = [(i, server.submit(x)) for i, x in rows]
            got[tag] = [(i, h.result(60), h.version) for i, h in hs]
        ts = [threading.Thread(target=client, args=(
            [(i, x) for i, x in enumerate(xs) if i % 2 == k], k))
            for k in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        res["initial"] = sorted(got[0] + got[1], key=lambda r: r[0])
        res["initial_stats"] = server.stats()

        # three swaps while a client keeps submitting
        done = threading.Event()
        flow = []

        def traffic():
            # closed loop: one request in flight, answered before the next
            while not done.is_set():
                for i, x in enumerate(xs):
                    h = server.submit(x)
                    h.result(60)
                    flow.append((i, h))
        t = threading.Thread(target=traffic)
        t.start()
        vids = [server.swap(job["params"][1][0], state=job["params"][1][1]),
                server.swap(job["snapshot"]),
                server.swap(lm(job["params"][3]))]
        done.set()
        t.join()
        after = [(i, server.submit(x)) for i, x in enumerate(xs)]
        res["swap"] = {"vids": vids, "labels": server.stats()[
            "version_label"], "answers": [
                (i, h.result(60), h.version) for i, h in flow + after]}
        # a canary of the first weights, promoted after two clean batches;
        # then the pool resized and replica 0 restarted, all on the mesh
        canary = server.swap(job["params"][0][0], state=job["params"][0][1],
                             canary_fraction=0.5)
        more = [(i, server.submit(x)) for i, x in enumerate(xs)]
        more = [(i, h.result(60), h.version) for i, h in more]
        promoted = server.version.id
        server.scale_to(3)
        more += [(i, server.predict(x, timeout=60), server.version.id)
                 for i, x in enumerate(xs[:4])]
        live = server.stats()["replicas_live"]
        server.scale_to(1)
        server._restart_replica(0)
        more += [(i, server.predict(x, timeout=60), server.version.id)
                 for i, x in enumerate(xs[:4])]
        time.sleep(1.0)   # idle: no-ops, which the followers skip
        more += [(i, server.predict(x, timeout=60), server.version.id)
                 for i, x in enumerate(xs[:2])]
        st = server.stats()
        res["control"] = {"canary": canary, "promoted": promoted,
                          "canary_state": st["canary"]["state"],
                          "live_three": live, "restarts": st["restarts"],
                          "replicas": st["replicas"], "answers": more}
        res["stats"] = st
    server.stop()
    # final once the leader sent stop (no no-op after it)
    res["noops"] = server._lead.noops
    if rank != 0:
        res["follower_stats"] = server.stats()
    # Predictor under the layout on every version's weights
    for v, params in enumerate(job["params"], 1):
        m = model if v == 1 else lm(params)
        pred = Predictor(m, batch_size=1, strategy=LayoutSharding(m),
                         device="cpu")
        res[f"predict_v{v}"] = [pred.predict(padded(x)[None])[0]
                                for x in xs]
    dist.barrier()

    def decode(mesh, lead):
        eng = DecodeEngine(lm(job["params"][0]), mesh=mesh, slots=4, page=8,
                           max_len=16, device="cpu").start()
        out = None
        if rank == lead:
            hs = [eng.submit(p, n) for p, (_, n) in
                  zip(job["prompts"], job["decode"])]
            toks = [h.result(60) for h in hs]
            out = {"tokens": toks, "stats": eng.stats()}
            out["sampled"] = [eng.submit(p, 4, temperature=0.8, top_k=8,
                                         seed=i).result(60)
                              for i, p in enumerate(job["prompts"][:2])]
        eng.stop()
        return out, eng.stats()
    res["decode_122"], res["decode_122_rank"] = decode(Engine.mesh(), 0)
    pair = [MeshLayout(1, 1, 2).build_mesh(r) for r in ([0, 1], [2, 3])]
    mine = pair[rank // 2]
    res["decode_112"], res["decode_112_rank"] = decode(mine, 2 * (rank // 2))
    pickle.dump(res, open(os.path.join(tmp, f"rank{rank}.pkl"), "wb"))
    dist.barrier()
    Engine.reset()
''')


def _reference(params, xs, prompts):
    """The reference's server answers under (1,2,2), and its decode tokens
    under (1,1,2) and on one device."""
    jm = jlm.TransformerLM(**LM)
    jm.build(jax.random.key(0))
    jm.params = jax.tree.map(np.asarray, params[0][0])
    out = {}
    JEngine.reset()
    JEngine.init()
    try:
        mesh = JMeshLayout(1, 2, 2).build_mesh(jax.devices()[:4])
        with JServer(jm, mesh=mesh, strategy=JLayoutSharding(jm),
                     max_batch=1, seq_buckets=SEQ_BUCKETS, replicas=2,
                     example=np.zeros(8, np.int32)) as server:
            out["initial"] = [h.result(60) for h in
                              [server.submit(x) for x in xs]]
        for name, mesh in (("112", JMeshLayout(1, 1, 2).build_mesh(
                jax.devices()[:2])), ("one", None)):
            with JDecodeEngine(jm, mesh=mesh, slots=4, page=8,
                               max_len=16) as eng:
                hs = [eng.submit(p, n) for p, (_, n) in zip(prompts,
                                                             DECODE)]
                out["decode_" + name] = [h.result(60) for h in hs]
    finally:
        JEngine.reset()
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's scenarios on four gloo ranks, started first, and the
    reference's computed while they run."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    params = []
    for seed in range(4):
        jm = jlm.TransformerLM(**LM).build(jax.random.key(seed + 5))
        params.append(jax.tree.map(np.asarray, (jm.params, jm.state)))
    snapshot = str(tmp / "model.7")
    jio.save({"params": params[2][0], "state": params[2][1]}, snapshot)
    xs, prompts = _requests(), _prompts()
    job = {"lm": LM, "params": params, "xs": xs, "prompts": prompts,
           "decode": DECODE, "seq_buckets": SEQ_BUCKETS,
           "snapshot": snapshot}
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
        ref = _reference(params, xs, prompts)
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    ranks = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    return job, ref, ranks


def test_replicas_two_answer_each_request_bit_equal(run):
    _, _, ranks = run
    r0 = ranks[0]
    assert [i for i, _, _ in r0["initial"]] == list(range(N_REQ))
    for i, out, version in r0["initial"]:
        assert version == 1
        np.testing.assert_array_equal(out, r0["predict_v1"][i])
    st = r0["initial_stats"]
    assert st["replicas"] == st["replicas_live"] == 2
    assert st["mesh"]["role"] == "leader" and st["mesh"]["ranks"] == \
        [0, 1, 2, 3]
    assert st["mesh"]["messages"]["batch"] == \
        st["warmup_batches"] + N_REQ


def test_answers_match_reference_server(run):
    _, ref, ranks = run
    for (_, out, _), want in zip(ranks[0]["initial"], ref["initial"]):
        assert out.shape == want.shape
        np.testing.assert_allclose(out, want, atol=TOL, rtol=TOL)


def test_predictor_agrees_on_every_rank(run):
    _, _, ranks = run
    for v in range(1, 5):
        for r in ranks[1:]:
            for a, b in zip(r[f"predict_v{v}"], ranks[0][f"predict_v{v}"]):
                np.testing.assert_array_equal(a, b)


def test_swap_on_a_mesh_loses_nothing(run):
    _, _, ranks = run
    sw = ranks[0]["swap"]
    assert sw["vids"] == [2, 3, 4]
    assert sw["labels"] == "module:Sequential"
    seen = set()
    for i, out, version in sw["answers"]:
        seen.add(version)
        np.testing.assert_array_equal(out,
                                      ranks[0][f"predict_v{version}"][i])
    assert 4 in seen
    st = ranks[0]["stats"]
    assert st["swaps"] == 4 and st["batch_errors"] == 0
    assert st["mesh"]["messages"]["swap"] == 4


def test_canary_resize_and_restart_on_a_mesh(run):
    """A canary swap promoted, ``scale_to`` up and down and a replica
    restart, all on the mesh: every answer bit-equal to ``Predictor``
    under the layout on its version's weights (the canary, version 5,
    serves the first weights)."""
    _, _, ranks = run
    ctl = ranks[0]["control"]
    assert ctl["canary"] == ctl["promoted"] == 5
    assert ctl["canary_state"] == "promoted"
    assert ctl["live_three"] == 3 and ctl["replicas"] == 1
    assert ctl["restarts"] == 1
    for i, out, version in ctl["answers"]:
        want = 1 if version == 5 else version
        np.testing.assert_array_equal(out, ranks[0][f"predict_v{want}"][i])


def test_followers_follow_and_stop(run):
    """Every follower took the leader's messages, the idle leader's
    no-ops skipped but counted alike, and stopped with it."""
    _, _, ranks = run
    assert ranks[0]["noops"] >= 2
    assert all(r["noops"] == ranks[0]["noops"] for r in ranks[1:])
    for r in ranks[1:]:
        st = r["follower_stats"]
        assert st["mesh"]["role"] == "follower"
        assert st["mesh"]["messages"] == \
            {k: v for k, v in ranks[0]["stats"]["mesh"]["messages"].items()
             if v} | {"stop": 1}


@pytest.mark.parametrize("key", ["122", "112"])
def test_decode_on_a_mesh_greedy_tokens_equal_reference(run, key):
    job, ref, ranks = run
    leaders = [0] if key == "122" else [0, 2]
    for lead in leaders:
        got = ranks[lead]["decode_" + key]
        for a, b, c in zip(got["tokens"], ref["decode_112"],
                           ref["decode_one"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert [len(t) for t in got["tokens"]] == [p + n for p, n in DECODE]


@pytest.mark.parametrize("key", ["122", "112"])
def test_decode_on_a_mesh_grows_its_page_eagerly(run, key):
    job, _, ranks = run

    def job_prompts():
        return job["prompts"][:2]
    for r, rr in enumerate(ranks):
        st = rr[f"decode_{key}_rank"]
        assert st["graphs"]["captures"] == 0
        lead = 0 if key == "122" else 2 * (r // 2)
        assert st["mesh"]["leader"] == lead
        assert st["mesh"]["role"] == ("leader" if r == lead else "follower")
        if r == lead:
            got = rr["decode_" + key]
            assert got["stats"]["cache_grows"] >= 1
            assert got["stats"]["cache_len"] == 16
            for p, row in zip(job_prompts(), got["sampled"]):
                assert len(row) == len(p) + 4
                np.testing.assert_array_equal(row[:len(p)], p)
                assert row.max() < LM["vocab_size"]
    # the (1,2,2) engine splits its four slots over fsdp: two a rank
    assert [rr["decode_122_rank"]["mesh"]["slots_here"] for rr in ranks] \
        == [[0, 2], [0, 2], [2, 2], [2, 2]]


def test_scaling_collectives_by_route():
    """The reference's kinds (``tests/test_scaling.py:46-63``), from the
    Engine's counts after one step of each route on four ranks."""
    sig = scaling.strategy_signatures(4, device="cpu")
    assert sig["dp4"].get("all-reduce", 0) >= 1, sig["dp4"]
    assert sig["zero4"].get("all-gather", 0) >= 1, sig["zero4"]
    assert sig["zero4"].get("reduce-scatter", 0) >= 1, sig["zero4"]
    tp = sig["dp2xtp2"]
    assert sum(tp.values()) > 1 and tp.get("all-reduce", 0) >= 1, tp
    assert sig["ring_sp4"].get("collective-permute", 0) >= 1, sig["ring_sp4"]
    assert sig["ulysses_sp4"].get("all-to-all", 0) >= 1, sig["ulysses_sp4"]
    assert sig["detail"]["ring_sp4"]["permute"] == {"ring": 3}
    assert sig["detail"]["ulysses_sp4"]["all_to_all"] == {"ulysses": 4}


def test_scaling_records_per_rank():
    out = scaling.measure(2, batch_per_device=8, device="cpu", steps=2)
    assert out["n_devices"] == 2 and out["device"] == "cpu"
    assert out["throughput_1dev_records_s"] > 0
    assert out["throughput_ndev_records_s"] > 0
    assert out["collectives_ndev_step"] == {"all-reduce": 1}
