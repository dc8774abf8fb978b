"""The port's autoscaler, pool resizing and traffic traces against the JAX
package's.

- ``AutoScaler``: one scripted sequence of queue signals under a fake
  clock gives the same decisions (grow, shrink, hold) and ``stats()`` in
  both packages, the bounds checks included.
- ``serve/tracefile.py``: a trace the port writes is byte-identical to
  the reference's for the same events, and each package reads the
  other's; ``replay`` paces the same under one fake clock, and
  ``slo_report`` reduces the same outcomes to the same report.
- The CPU server: ``scale_to`` grows and shrinks the worker pool with no
  request lost, the armed autoscaler grows under a stalled backlog and
  shrinks when idle, and ``record_trace`` on the server and on the decode
  engine writes traces the reference reads back.

Exact comparisons throughout (fake clocks, the same bytes).
"""

import time

import jax
import numpy as np
import pytest

from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.serve import autoscale as jauto
from bigdl_tpu.serve import batcher as jbatcher
from bigdl_tpu.serve import tracefile as jtf

from bigdl_torch.models import LeNet5, TransformerLM
from bigdl_torch.serve import (DecodeEngine, InferenceServer,
                               TraceFormatError)
from bigdl_torch.serve import autoscale as tauto
from bigdl_torch.serve import batcher as tbatcher
from bigdl_torch.serve import tracefile as ttf
from bigdl_torch.utils import chaos
from bigdl_torch.utils.convert import load_reference_tree
from bigdl_torch.utils.recordio import CorruptRecord

EXAMPLE = np.zeros((28, 28, 1), np.float32)


# -- the autoscaler's decisions ---------------------------------------------

class _StubPool:
    def __init__(self, replicas=1):
        self.replicas = replicas
        self.sig = {"depth": 0, "row_s_ema": None, "batches": 0}
        self._healthy = True
        self.calls = []

    def healthy(self):
        return self._healthy

    def autoscale_signals(self):
        return dict(self.sig, live=self.replicas)

    def scale_to(self, n):
        self.calls.append(n)
        self.replicas = n


#: per poll: (seconds later, depth, row seconds, batches so far, healthy)
SIGNALS = [(0.05, 0, None, 0, True), (0.05, 40, 0.01, 1, True),
           (0.05, 40, 0.01, 2, True), (0.05, 60, 0.01, 3, True),
           (0.05, 60, 0.01, 4, True), (0.6, 80, 0.01, 5, True),
           (0.05, 80, 0.01, 6, True), (0.05, 2, 0.01, 7, True),
           (0.05, 0, 0.01, 8, True), (0.05, 0, 0.01, 8, True),
           (1.0, 0, 0.01, 8, True), (0.6, 0, 0.01, 8, True),
           (1.1, 0, 0.01, 8, True), (0.2, 90, 0.01, 9, False),
           (0.2, 90, 0.01, 9, False), (1.5, 0, 0.01, 9, True),
           (1.5, 0, 0.01, 9, True), (1.5, 0, 0.01, 9, True)]


def _run_scaler(mod, up_polls, step):
    pool = _StubPool(1)
    t = [0.0]
    sc = mod.AutoScaler(pool, min_replicas=1, max_replicas=3,
                        target_wait_ms=100.0, up_polls=up_polls,
                        idle_s=1.0, cooldown_s=0.5, step=step,
                        clock=lambda: t[0])
    trail = []
    for dt, depth, row_s, batches, healthy in SIGNALS:
        t[0] += dt
        pool.sig = {"depth": depth, "row_s_ema": row_s, "batches": batches}
        pool._healthy = healthy
        trail.append((sc.check(), pool.replicas))
    return trail, pool.calls, sc.stats()


@pytest.mark.parametrize("up_polls,step", [(1, 1), (2, 1), (2, 2)])
def test_autoscaler_decisions_equal(up_polls, step):
    a = _run_scaler(jauto, up_polls, step)
    b = _run_scaler(tauto, up_polls, step)
    assert a == b
    trail, calls, st = b
    assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1
    assert max(calls) <= 3 and min(calls) >= 1


def test_autoscaler_bounds_and_knobs_alike(monkeypatch):
    for mod in (jauto, tauto):
        with pytest.raises(ValueError, match="max"):
            mod.AutoScaler(_StubPool(), min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="min"):
            mod.AutoScaler(_StubPool(), min_replicas=0, max_replicas=2)
    monkeypatch.setenv("BIGDL_TPU_SERVE_AUTOSCALE_MAX", "4")
    monkeypatch.setenv("BIGDL_TORCH_SERVE_AUTOSCALE_MAX", "4")
    over = {"idle_s": 0.25, "step": None}
    assert jauto.autoscale_knobs(2, over) == tauto.autoscale_knobs(2, over)
    assert tauto.autoscale_knobs(2, over)["max_replicas"] == 4


# -- traces -----------------------------------------------------------------

def _events(mod):
    rng = np.random.default_rng(0)
    out = [mod.TraceEvent(0.0, rng.random((4,)).astype(np.float32),
                          tenant="a", priority=1, deadline_ms=50.0),
           mod.TraceEvent(0.013, rng.random((4,)).astype(np.float32)),
           mod.TraceEvent(0.2, rng.integers(0, 9, (5,)).astype(np.int32),
                          tenant="b", priority=2,
                          gen={"max_tokens": 4, "temperature": 0.0,
                               "top_k": 0, "seed": 0, "eos_token": 2})]
    return out


def test_trace_bytes_identical_and_cross_read(tmp_path):
    jp, tp = str(tmp_path / "ref.trace"), str(tmp_path / "port.trace")
    jtf.write_trace(jp, _events(jtf), meta={"source": "x"})
    ttf.write_trace(tp, _events(ttf), meta={"source": "x"})
    assert open(jp, "rb").read() == open(tp, "rb").read()
    for reader, path in ((ttf.read_trace, jp), (jtf.read_trace, tp)):
        header, events = reader(path)
        assert header["count"] == 3 and header["meta"] == {"source": "x"}
        assert [repr(e) for e in events] == [repr(e) for e in
                                            _events(jtf)]
        for a, b in zip(events, _events(ttf)):
            np.testing.assert_array_equal(a.payload, b.payload)


def test_trace_damage_typed(tmp_path):
    path = str(tmp_path / "t")
    ttf.write_trace(path, _events(ttf))
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CorruptRecord):
        ttf.read_trace(path)
    from bigdl_torch.utils import recordio
    recordio.write_records(path, [{"not": "a trace"}])
    with pytest.raises(TraceFormatError):
        ttf.read_trace(path)


def _replay(mod, speed):
    t = [0.0]

    def clock():
        return t[0]

    def sleep(s):
        t[0] += s

    seen = []

    def submit(e):
        seen.append(round(t[0], 6))
        if e.priority == 2:
            raise getattr(mod, "ServerOverloaded")("full")
        if e.tenant == "a":
            t[0] += 0.05         # a slow admission: later events lag
        return None

    out = mod.replay(_events(mod), submit, speed=speed, clock=clock,
                     sleep=sleep)
    return seen, [round(o.lag_s, 6) for o in out], \
        [type(o.error).__name__ for o in out]


@pytest.mark.parametrize("speed", [1.0, 10.0])
def test_replay_paces_alike(speed):
    class J:
        replay = staticmethod(jtf.replay)
        TraceEvent = jtf.TraceEvent
        ServerOverloaded = jbatcher.ServerOverloaded

    class T:
        replay = staticmethod(ttf.replay)
        TraceEvent = ttf.TraceEvent
        ServerOverloaded = tbatcher.ServerOverloaded

    assert _replay(J, speed) == _replay(T, speed)
    with pytest.raises(ValueError):
        ttf.replay([], lambda e: None, speed=0)


class _Handle:
    def __init__(self, latency_s, error=None):
        self.latency_s = latency_s
        self._error = error

    def result(self, timeout=None):
        if self._error is not None:
            raise self._error
        return 0


def _report(tf, batcher):
    def ev(tenant, priority, deadline_ms):
        return tf.TraceEvent(0.0, 0, tenant=tenant, priority=priority,
                             deadline_ms=deadline_ms)
    outs = [tf.ReplayOutcome(ev("a", 2, 100.0), handle=_Handle(0.05)),
            tf.ReplayOutcome(ev("a", 2, 100.0), handle=_Handle(0.25)),
            tf.ReplayOutcome(ev(None, 0, None), handle=_Handle(1.0)),
            tf.ReplayOutcome(ev("b", 1, 100.0),
                             error=batcher.ServerOverloaded("full")),
            tf.ReplayOutcome(ev("b", 1, 100.0), handle=_Handle(
                0.3, batcher.RequestTimeout("late"))),
            tf.ReplayOutcome(ev("b", 0, 100.0),
                             error=RuntimeError("backend died"))]
    tf.resolve_outcomes(outs, timeout=1)
    return tf.slo_report(outs), tf.slo_report(outs, default_deadline_ms=10)


def test_slo_report_equal():
    a, b = _report(jtf, jbatcher), _report(ttf, tbatcher)
    assert a == b
    rep = b[0]
    assert rep["offered"] == 6 and rep["served"] == 3
    assert rep["shed"] == {"overload": 1, "timeout": 1, "errors": 1}


# -- the CPU server: pool size and recording --------------------------------

def _lenet():
    import torch
    return LeNet5(10).build("cpu", torch.Generator().manual_seed(0))


def _rows(n, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28, 1)) \
        .astype(np.float32)


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_scale_to_grows_and_shrinks_none_lost():
    xs = _rows(24)
    with InferenceServer(_lenet(), device="cpu", example=EXAMPLE,
                         max_batch=2, max_wait_ms=1) as server:
        assert server.scale_to(3) == 3
        assert _wait(lambda: server.stats()["replicas_live"] == 3)
        handles = [server.submit(x) for x in xs]
        assert server.scale_to(1) == 1
        outs = [h.result(30) for h in handles]
        assert _wait(lambda: server.stats()["replicas_live"] == 1)
        sig = server.autoscale_signals()
        assert sig["live"] == 1 and sig["depth"] == 0
        assert sig["row_s_ema"] is not None and sig["batches"] > 0
    assert len(outs) == 24 and all(o.shape == (10,) for o in outs)


def test_autoscaler_grows_under_backlog_then_shrinks():
    xs = _rows(40, 1)
    spec = "serve.batch=stall*0.05@" + ",".join(str(i)
                                                for i in range(1, 60))
    with chaos.scoped(spec):
        with InferenceServer(_lenet(), device="cpu", example=EXAMPLE,
                             max_batch=4, max_wait_ms=1, queue_limit=128,
                             autoscale_min=1, autoscale_max=2,
                             autoscale_target_wait_ms=20.0,
                             autoscale_up_polls=1,
                             autoscale_cooldown_s=0.05,
                             autoscale_idle_s=0.3,
                             autoscale_poll_s=0.01) as server:
            handles = [server.submit(x) for x in xs]
            for h in handles:
                h.result(30)
            assert _wait(lambda: server.stats()["replicas"] == 1)
            st = server.stats()["autoscale"]
    assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1
    assert {"direction", "from", "to", "est_wait_ms",
            "queue_depth"} <= set(st["events"][0])


def test_server_records_offered_traffic(tmp_path):
    path = str(tmp_path / "offered.trace")
    xs = _rows(5, 2)
    with InferenceServer(_lenet(), device="cpu", example=EXAMPLE,
                         max_batch=2, max_wait_ms=1) as server:
        rec = server.record_trace(path)
        assert server.record_trace(path) is rec
        for i, x in enumerate(xs):
            server.submit(x, tenant=f"t{i % 2}", priority=i,
                          deadline_ms=500).result(30)
        assert server.stats()["trace_recording"]["events"] == 5
        events = server.stop_trace()
    assert len(events) == 5
    header, jevents = jtf.read_trace(path)
    assert header["count"] == 5 and header["sample_shape"] == [28, 28, 1]
    assert [e.tenant for e in jevents] == ["t0", "t1"] * 2 + ["t0"]
    assert [e.priority for e in jevents] == list(range(5))
    assert all(e.deadline_ms == 500 for e in jevents)
    for e, x in zip(jevents, xs):
        np.testing.assert_array_equal(e.payload, x)


def test_decode_engine_records_sequences(tmp_path):
    cfg = dict(vocab_size=31, max_len=32, d_model=32, num_heads=2,
               num_layers=1)
    jm = jlm.TransformerLM(**cfg).build(jax.random.key(0))
    tm = load_reference_tree(TransformerLM(**cfg).build("cpu"),
                             jax.tree.map(np.asarray, jm.params),
                             jax.tree.map(np.asarray, jm.state))
    path = str(tmp_path / "gen.trace")
    eng = DecodeEngine(tm, slots=2, page=16, device="cpu")
    eng.record_trace(path)
    with eng:
        rows = [eng.generate(np.array([1, 2, 3], np.int32), 4,
                             eos_token=None),
                eng.generate(np.array([5], np.int32), 3, tenant="z",
                             eos_token=7)]
    eng.stop_trace()
    assert [len(r) for r in rows[:1]] == [7]
    header, events = jtf.read_trace(path)
    assert header["count"] == 2
    assert events[0].gen == {"max_tokens": 4, "temperature": 0.0,
                             "top_k": 0, "seed": 0}
    assert events[1].gen["eos_token"] == 7 and events[1].tenant == "z"
    np.testing.assert_array_equal(events[0].payload, [1, 2, 3])
