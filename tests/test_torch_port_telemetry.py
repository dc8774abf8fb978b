"""The port's telemetry and metrics against the JAX package's.

- ``utils/telemetry.py``: the same scripted spans, instants, counters,
  flows and thread names under one injected clock pair give the same
  events (name, cat, ph, ts, dur, id, args) from both tracers; the
  reference's ``merge_traces``, ``phase_breakdown``, ``request_breakdown``,
  ``diff_breakdowns`` and ``format_*`` give the same results on the
  port's trace files as the port's own; the module helpers are inert
  with no tracer; a chaos hit lands on the active tracer.
- ``utils/metrics_export.py``: the same observations give the identical
  exposition text; ``parse_exposition`` and ``render_rollup`` agree.

No tolerance: every comparison is exact (the clocks are fakes).
"""

import json
import os

import pytest

from bigdl_tpu.utils import metrics_export as jmet
from bigdl_tpu.utils import telemetry as jtel

from bigdl_torch.utils import chaos
from bigdl_torch.utils import metrics_export as tmet
from bigdl_torch.utils import telemetry as ttel


class _Clock:
    """A perf clock advanced by hand (seconds) and a fixed wall clock."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _inert():
    for mod in (jtel, ttel):
        mod.set_active(None)
    jmet.disarm()
    tmet.disarm()
    yield
    for mod in (jtel, ttel):
        mod.set_active(None)
    jmet.disarm()
    tmet.disarm()


def _script(mod, tracer, clock):
    """One scripted run against ``mod``'s module helpers."""
    mod.set_active(tracer)
    mod.thread_name("scripted main")
    with mod.span("outer", cat="serve", size=4):
        clock.t += 0.010
        with mod.span("inner"):
            clock.t += 0.002
        mod.instant("serve.swap", cat="serve", version=2)
        mod.counter("serve", queue_depth=3, batch_fill=0.75)
    clock.t += 0.001
    mod.complete("data", 0.004, cat="phase")
    rid = mod.mint_request_id()
    mod.flow_start(rid, hop="queue.enqueue", depth=1)
    clock.t += 0.003
    mod.flow_step(rid, hop="batch.assemble", size=1, bucket=1)
    clock.t += 0.005
    mod.flow_finish(rid, hop="resolve", status="ok")
    mod.counter("serve.autoscale", replicas=2, est_wait_ms=1.5,
                queue_depth=0)
    mod.instant("serve.autoscale", cat="serve", direction="up")
    mod.counter("deploy", deployed=1, promoted=1)
    mod.instant("deploy.promoted", cat="deploy", release=1)
    mod.counter("serve.decode", tokens_per_s=123.0, fill=0.5)
    mod.set_active(None)
    return rid


def _events(tracer):
    with tracer._lock:
        return [dict(e) for e in tracer._meta + tracer._events]


def _pair(tmp_path, ring=None):
    out = []
    for name, mod in (("ref", jtel), ("port", ttel)):
        clock = _Clock()
        tr = mod.Tracer(str(tmp_path / name), rank=0, ring=ring,
                        flush_every=0, clock=clock, wall_clock=lambda: 1e9)
        rid = _script(mod, tr, clock)
        out.append((tr, rid))
    return out


def test_scripted_events_equal(tmp_path):
    (jtr, jrid), (ttr, trid) = _pair(tmp_path)
    assert jrid == trid
    assert _events(jtr) == _events(ttr)
    names = [e["name"] for e in _events(ttr)]
    assert {"outer", "inner", "serve.swap", "serve", "data",
            "request"} <= set(names)


def test_ring_drops_oldest_alike(tmp_path):
    (jtr, _), (ttr, _) = _pair(tmp_path, ring=5)
    assert jtr.dropped == ttr.dropped > 0
    assert _events(jtr) == _events(ttr)


@pytest.mark.parametrize("kind", ["phase", "request", "diff"])
def test_analysis_of_the_port_files_equal(tmp_path, kind):
    (jtr, _), (ttr, _) = _pair(tmp_path)
    jtr.flush()
    ttr.flush()
    tdir = str(tmp_path / "port")
    merged_j = jtel.merge_traces(tdir)
    merged_t = ttel.merge_traces(tdir)
    assert merged_j == merged_t
    if kind == "phase":
        a, b = jtel.phase_breakdown(merged_j), ttel.phase_breakdown(merged_t)
        assert a == b
        assert a["autoscale"]["decisions"] == 1 and a["deploy"]["events"]
        assert jtel.format_report(a, merged_j) == \
            ttel.format_report(b, merged_t)
    elif kind == "request":
        a = jtel.request_breakdown(merged_j)
        b = ttel.request_breakdown(merged_t)
        assert a == b and a["count"] == 1
        assert a["segments"]["queue"]["total_ms"] == pytest.approx(3.0)
        assert jtel.format_requests(a) == ttel.format_requests(b)
    else:
        ref_file = jtel.merge_traces(str(tmp_path / "ref"))
        a = jtel.diff_breakdowns(jtel.phase_breakdown(ref_file),
                                 jtel.phase_breakdown(merged_j))
        b = ttel.diff_breakdowns(ttel.phase_breakdown(ref_file),
                                 ttel.phase_breakdown(merged_t))
        assert a == b
        assert jtel.format_diff(a) == ttel.format_diff(b)


def test_trace_file_is_chrome_json(tmp_path):
    (_, _), (ttr, _) = _pair(tmp_path)
    path = ttr.flush()
    blob = json.load(open(path))
    assert os.path.basename(path) == "trace.0.json"
    assert blob["displayTimeUnit"] == "ms"
    assert blob["otherData"]["dropped_events"] == 0
    phases = {e["ph"] for e in blob["traceEvents"]}
    assert phases == {"M", "X", "i", "C", "s", "t", "f"}


def test_merge_empty_dir_raises_alike(tmp_path):
    for mod in (jtel, ttel):
        with pytest.raises(FileNotFoundError, match="no trace"):
            mod.merge_traces(str(tmp_path))


def test_helpers_inert_without_tracer():
    assert ttel.get_active() is None
    assert ttel.span("x") is ttel._NULL_SPAN
    assert ttel.mint_request_id() is None
    ttel.instant("x")
    ttel.counter("x", a=1)
    ttel.flow_start(None, hop="x")
    assert ttel.maybe_start() is None      # BIGDL_TORCH_TRACE unset


def test_maybe_start_reads_the_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE", str(tmp_path / "tr"))
    tr = ttel.maybe_start(rank=3)
    try:
        assert tr is not None and ttel.get_active() is tr
        assert ttel.maybe_start() is None  # the slot is taken
        ttel.instant("hello")
    finally:
        tr.close()
    assert ttel.get_active() is None
    assert os.path.exists(tmp_path / "tr" / "trace.3.json")


def test_chaos_hit_is_an_instant(tmp_path):
    clock = _Clock()
    tr = ttel.Tracer(str(tmp_path), flush_every=0, clock=clock,
                     wall_clock=lambda: 1e9)
    ttel.set_active(tr)
    with chaos.scoped("serve.batch=fail@2"):
        chaos.fire("serve.batch")
        with pytest.raises(chaos.ChaosFault):
            chaos.fire("serve.batch")
    ttel.set_active(None)
    hits = [e for e in _events(tr) if e["name"] == "chaos:serve.batch"]
    assert len(hits) == 1 and hits[0]["args"]["count"] == 2


def _observe(mod):
    reg = mod.MetricsRegistry(slo_ms=50, window=8)
    for lat, status in ((0.001, "ok"), (0.02, "ok"), (0.3, "ok"),
                        (0.004, "RequestTimeout"), (7.0, "ok")):
        reg.observe_request(lat, status)
    reg.shed("overloaded")
    reg.shed("quota")
    reg.shed("quota")
    reg.counter_inc("bigdl_serve_restarts_total", 1.0,
                    help="replica respawns by the monitor")
    reg.feed_counter("serve", {"queue_depth": 3, "batch_fill": 0.5,
                               "bad": "x"})
    reg.observe("bigdl_decode_ttlt_seconds", 0.75, help="ttlt")
    reg.gauge_set("g", 2.5, replica="1")
    return reg


def test_exposition_identical():
    a, b = _observe(jmet).render(), _observe(tmet).render()
    assert a == b
    assert "bigdl_serve_slo_attainment 0.4" in b   # 2 of 5 within 50 ms
    assert 'bigdl_serve_shed_total{cause="quota"} 2' in b


def test_parse_and_rollup_agree():
    text = _observe(tmet).render()
    assert jmet.parse_exposition(text) == tmet.parse_exposition(text)
    parsed = tmet.parse_exposition(text)
    assert parsed["bigdl_serve_request_latency_seconds"]["type"] == \
        "histogram"
    members = {"0": text, "1": _observe(jmet).render()}
    assert jmet.render_rollup(text, members) == \
        tmet.render_rollup(text, members)


def test_registry_slot_and_counter_feed():
    assert not tmet.armed() and tmet.registry() is None
    reg = tmet.arm()
    assert tmet.arm() is reg and tmet.armed()
    ttel.counter("serve", queue_depth=4)   # no tracer: the gauge all same
    assert "bigdl_serve_queue_depth 4" in reg.render()
    tmet.disarm()
    assert tmet.registry() is None


def test_enabled_knob(monkeypatch):
    assert tmet.enabled()
    monkeypatch.setenv("BIGDL_TORCH_METRICS", "0")
    assert not tmet.enabled()
