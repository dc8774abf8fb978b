"""The port's serving control plane against the JAX package's.

- ``CanaryController``: one scripted sequence of batch latencies and
  errors gives the same routing, the same verdicts and the same summaries
  (reason strings included) in both packages.
- ``ReplicaMonitor``: one scripted sequence of replica deaths, silences
  and clock ticks over a stub pool gives the same condemnations, restarts,
  unhealthy verdict and ``stats()``.
- LeNet-5 with the reference's weights, served on the CPU: a swap to a
  checkpoint directory the reference wrote, a canary of a snapshot file
  the reference wrote that is promoted, and one that ``serve.canary``
  faults and that is rolled back.  Every answer is bit-equal to the
  port's ``Predictor`` on the weights of the version that answered it
  (``handle.version``; ``max_batch=1``, so server and Predictor run the
  same [1, 28, 28, 1] forward) and within 1e-5 of the reference's server
  on the same weights (float32 convolution and matmul in another
  library's summation order).
- A replica killed by ``serve.replica@0`` is restarted and every admitted
  request is answered; a spent restart budget turns ``healthy()`` False.
- Tenant quotas refuse with ``QuotaExceeded`` (the HTTP front's 429).
"""

import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from bigdl_tpu import Engine
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.serve import InferenceServer as JServer
from bigdl_tpu.serve import control as jcontrol
from bigdl_tpu.utils import file_io as jio

from bigdl_torch.models import LeNet5
from bigdl_torch.optim import Predictor
from bigdl_torch.serve import (CanaryRejected, InferenceServer,
                               QuotaExceeded, ReplicaLostError)
from bigdl_torch.serve import control as tcontrol
from bigdl_torch.utils import chaos, metrics_export
from bigdl_torch.utils.convert import load_reference_tree

REF_ATOL = 1e-5
EXAMPLE = np.zeros((28, 28, 1), np.float32)


# -- the canary comparator ------------------------------------------------

#: per batch: (incumbent seconds, canary seconds, canary errors?)
CANARY_SCRIPTS = {
    "promote": [(0.010, 0.011, False)] * 12,
    "latency": [(0.010, 0.010, False)] * 3 + [(0.010, 0.050, False)] * 9,
    "errors": [(0.010, 0.010, False)] * 2 + [(0.010, 0.010, True)] * 10,
    "noisy": [(0.010 + 0.001 * (i % 3), 0.012 + 0.002 * (i % 2), i == 7)
              for i in range(24)],
}


def _run_canary(mod, script, fraction):
    ctl = mod.CanaryController(SimpleNamespace(id=7), fraction,
                               min_batches=4, window=8, latency_ratio=2.0,
                               error_margin=0.05)
    trail = []
    for base, cand, err in script:
        is_canary = ctl.route()
        decision = ctl.observe(is_canary, cand if is_canary else base,
                               err and is_canary)
        trail.append((is_canary, decision))
        if decision is not None:
            ctl.state = {"promote": "promoted",
                         "rollback": "rolled_back"}[decision]
            break
    return trail, ctl.summary(), (None if ctl.reason is None
                                  else (type(ctl.reason).__name__,
                                        str(ctl.reason)))


@pytest.mark.parametrize("fraction", [0.25, 0.5])
@pytest.mark.parametrize("name", sorted(CANARY_SCRIPTS))
def test_canary_verdicts_equal(name, fraction):
    a = _run_canary(jcontrol, CANARY_SCRIPTS[name], fraction)
    b = _run_canary(tcontrol, CANARY_SCRIPTS[name], fraction)
    assert a == b
    assert a[1]["routed"] <= fraction * a[1]["total"]


def test_canary_fraction_validated_alike():
    for mod in (jcontrol, tcontrol):
        with pytest.raises(ValueError, match="canary_fraction"):
            mod.CanaryController(SimpleNamespace(id=1), 1.0)


# -- the replica monitor --------------------------------------------------

class _Thread:
    def __init__(self):
        self.alive = True

    def is_alive(self):
        return self.alive


class _StubPool:
    """The server surface the monitor drives, recording its calls."""

    def __init__(self, clock):
        self.batcher = SimpleNamespace(clock=clock, closed=False)
        self.replicas = 2
        self._replica = {i: [_Thread(), 1, clock()] for i in range(2)}
        self.calls = []

    def _condemn_replica(self, idx):
        self.calls.append(("condemn", idx))
        self._replica[idx][1] += 1

    def _restart_replica(self, idx):
        self.calls.append(("restart", idx))
        st = self._replica[idx]
        st[0], st[2] = _Thread(), self.batcher.clock()

    def _mark_unhealthy(self, err):
        self.calls.append(("unhealthy", type(err).__name__, str(err)))


def _run_monitor(mod):
    t = [0.0]
    pool = _StubPool(lambda: t[0])
    mon = mod.ReplicaMonitor(pool, 0.5, budget=2, backoff=0.1, poll=0.01)
    # (advance, replica 0 beats?, replica 1 dies?)
    script = [(0.1, True, False), (0.1, True, True), (0.05, True, False),
              (0.1, True, False), (0.3, True, False), (0.2, False, False),
              (0.4, False, False), (0.2, True, False), (0.2, True, True),
              (0.3, True, False), (0.1, True, True), (0.5, True, False)]
    for advance, beat0, die1 in script:
        t[0] += advance
        if beat0:
            pool._replica[0][2] = t[0]
        if die1:
            pool._replica[1][0].alive = False
        pool._replica[1][2] = t[0] if pool._replica[1][0].alive else \
            pool._replica[1][2]
        mon._check()
    st = mon.stats()
    return pool.calls, st


def test_replica_monitor_decisions_equal():
    a, b = _run_monitor(jcontrol), _run_monitor(tcontrol)
    assert a == b
    calls, st = b
    assert ("restart", 1) in calls and ("restart", 0) in calls
    assert calls[-1][0] == "unhealthy"
    # past the budget the dead thread stays dead and is counted again
    assert st["restarts"] == {0: 1, 1: 4} and st["lost"] == 5


def test_monitor_skips_slots_a_shrink_retired():
    t = [0.0]
    pool = _StubPool(lambda: t[0])
    pool.replicas = 1
    pool._replica[1][0].alive = False
    mon = tcontrol.ReplicaMonitor(pool, 0.5)
    mon._check()
    assert pool.calls == [] and mon.lost == 0


# -- LeNet-5 served, swapped, canaried --------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lenets():
    """Three reference LeNet-5s and their port twins (reference weights
    copied in)."""
    out = []
    for seed in range(3):
        jm = JLeNet5(10).build(jax.random.key(seed))
        tm = load_reference_tree(LeNet5(10).build("cpu"), _np(jm.params),
                                 _np(jm.state))
        out.append((jm, tm))
    return out


def _rows(n, seed):
    return np.random.default_rng(seed).random((n, 28, 28, 1)) \
        .astype(np.float32)


def _port_server(model, **kw):
    return InferenceServer(model, device="cpu", example=EXAMPLE,
                           max_batch=1, max_wait_ms=1, **kw)


def _check_answers(handles, rows, predictors):
    for h, x in zip(handles, rows):
        out = h.result(30)
        ref = predictors[h.version].predict(x[None])[0]
        np.testing.assert_array_equal(out, ref)


def test_swap_canary_promote_and_rollback(tmp_path, lenets):
    (j1, t1), (j2, t2), (j3, t3) = lenets
    # the reference writes a checkpoint pair and a snapshot file
    ckpt = tmp_path / "ckpt"
    jio.save_checkpoint(str(ckpt), 5, {"params": _np(j2.params),
                                       "state": _np(j2.state)},
                        {"method": {}, "opt_state": {}})
    snap = tmp_path / "model.7"
    jio.save({"params": _np(j3.params), "state": _np(j3.state)},
             str(snap))
    preds = {1: Predictor(t1, device="cpu"), 2: Predictor(t2, device="cpu"),
             3: Predictor(t3, device="cpu"), 4: Predictor(t1, device="cpu")}
    xs = _rows(8, 0)
    # a clock that stands still: every batch lasts 0 s, so the canary is
    # judged on its errors alone, never on host timing noise
    server = _port_server(t1, canary_min_batches=3, clock=lambda: 0.0)
    with server:
        h1 = [server.submit(x) for x in xs]
        _check_answers(h1, xs, preds)
        assert {h.version for h in h1} == {1}
        assert server.swap(str(ckpt)) == 2
        assert server.version.label == f"ckpt:{ckpt}@5"
        h2 = [server.submit(x) for x in xs]
        _check_answers(h2, xs, preds)
        assert {h.version for h in h2} == {2}
        # version 2 is a clone with tensors of its own: version 1's live
        # weights were never touched by the swap
        v2 = server.version.module
        assert v2 is not t1
        np.testing.assert_array_equal(v2.layers[1].weight.detach().numpy(),
                                      t2.layers[1].weight.detach().numpy())
        np.testing.assert_array_equal(t1.layers[1].weight.detach().numpy(),
                                      np.asarray(j1.params[1]["weight"]))
        # canary of the reference's snapshot file: promoted
        assert server.swap(str(snap), canary_fraction=0.5) == 3
        h3 = [server.submit(x) for x in np.concatenate([xs, xs])]
        _check_answers(h3, np.concatenate([xs, xs]), preds)
        st = server.stats()
        assert st["canary"]["state"] == "promoted"
        assert server.version.id == 3
        assert {h.version for h in h3} == {2, 3}
        # a canary that serve.canary faults: rolled back, typed
        with chaos.scoped("serve.canary=fail@1,2,3"):
            assert server.swap(t1, canary_fraction=0.5) == 4
            h4 = [server.submit(x) for x in xs]
            outcomes = []
            for h in h4:
                try:
                    h.result(30)
                    outcomes.append(h.version)
                except chaos.ChaosFault:
                    outcomes.append("fault")
        st = server.stats()
        assert st["canary"]["state"] == "rolled_back"
        assert st["canary"]["reason_type"] == CanaryRejected.__name__
        assert server.version.id == 3 and st["canary_rollbacks"] == 1
        assert "fault" in outcomes and all(h.done() for h in h4)
        _check_answers([h for h, o in zip(h4, outcomes) if o != "fault"],
                       [x for x, o in zip(xs, outcomes) if o != "fault"],
                       preds)
        assert st["swaps"] == 2   # the plain swap and the promotion
    # the reference's server on the same weights and sources
    Engine.init()
    jserver = JServer(j1, example=EXAMPLE, max_batch=1, max_wait_ms=1)
    with jserver:
        r1 = [jserver.predict(x, timeout=60) for x in xs]
        jserver.swap(str(ckpt))
        r2 = [jserver.predict(x, timeout=60) for x in xs]
    for h, r in zip(h1 + h2, r1 + r2):
        np.testing.assert_allclose(h.result(1), r, atol=REF_ATOL, rtol=0)


def test_swap_module_file_and_tree(tmp_path, lenets):
    (j1, t1), (j2, t2), _ = lenets
    path = str(tmp_path / "lenet.module")
    t2.save(path)
    xs = _rows(3, 1)
    with _port_server(t1) as server:
        assert server.swap(path) == 2
        assert server.version.label == f"file:{path}"
        _check_answers([server.submit(x) for x in xs], xs,
                       {2: Predictor(t2, device="cpu")})
        assert server.swap(_np(j1.params), state=_np(j1.state)) == 3
        assert server.version.label == "params"
        _check_answers([server.submit(x) for x in xs], xs,
                       {3: Predictor(t1, device="cpu")})
        with pytest.raises(ValueError, match="neither"):
            jio.save([1, 2], str(tmp_path / "junk"))
            server.swap(str(tmp_path / "junk"))


def test_mesh_raises_naming_item_8(lenets):
    with pytest.raises(NotImplementedError, match="item 8"):
        InferenceServer(lenets[0][1], device="cpu", mesh=object())


def test_chaos_killed_replica_restarted_none_lost(lenets):
    _, t1 = lenets[0]
    pred = {1: Predictor(t1, device="cpu")}
    xs = _rows(12, 2)
    server = _port_server(t1, replica_lost=0.3, restart_backoff=0.01)
    with server:
        with chaos.scoped("serve.replica@0=exit@2"):
            handles = [server.submit(x) for x in xs]
            _check_answers(handles, xs, pred)
        deadline = time.monotonic() + 5
        while server.stats()["restarts"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        st = server.stats()
        assert st["restarts"] == 1 and st["replicas_live"] == 1
        assert st["replica_monitor"]["lost"] == 1 and server.healthy()
        more = [server.submit(x) for x in xs[:3]]
        _check_answers(more, xs[:3], pred)


def test_restart_budget_spent_turns_unhealthy(lenets):
    _, t1 = lenets[0]
    server = _port_server(t1, replica_lost=0.2, restart_budget=1,
                          restart_backoff=0.01)
    with server:
        with chaos.scoped("serve.replica@0=exit@1,2"):
            h = server.submit(_rows(1, 3)[0])
            deadline = time.monotonic() + 5
            while server.healthy() and time.monotonic() < deadline:
                time.sleep(0.02)
        assert not server.healthy()
        with pytest.raises(ReplicaLostError):
            h.result(5)
        with pytest.raises(ReplicaLostError, match="unhealthy"):
            server.submit(_rows(1, 3)[0])
        assert server.stats()["unhealthy_type"] == "ReplicaLostError"


def test_quota_refuses_typed_and_counts(lenets):
    _, t1 = lenets[0]
    reg = metrics_export.arm()
    try:
        with _port_server(t1, tenant_qps=0.001, tenant_burst=1) as server:
            server.predict(_rows(1, 4)[0], timeout=30)
            server.submit(_rows(1, 4)[0], tenant="a").result(30)
            with pytest.raises(QuotaExceeded) as e:
                server.submit(_rows(1, 4)[0], tenant="a")
            assert e.value.retry_after_s > 0
            server.submit(_rows(1, 4)[0], tenant="b").result(30)
            assert server.stats()["quota"]["denied_by_tenant"] == {"a": 1}
        assert 'bigdl_serve_shed_total{cause="quota"} 1' in reg.render()
    finally:
        metrics_export.disarm()
