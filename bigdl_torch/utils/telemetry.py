"""Run telemetry: a span tracer writing Chrome-trace JSON, and its analysis.

Counterpart of ``bigdl_tpu/utils/telemetry.py``, all of it:

- :class:`Tracer`: nested spans ("X" complete events), instants ("i"),
  counter tracks ("C") and request flows ("s"/"t"/"f", one id per request,
  :data:`REQUEST_ID_HEADER` carries it between processes) in Chrome
  trace-event JSON, loadable in Perfetto.  Events live in a bounded ring
  (the oldest dropped and counted) and flush inline, every
  ``flush_every`` events and on ``flush()`` / ``close()``, through
  ``file_io`` to ``trace.<rank>.json``.  There is no thread.
- The module-level ``span()``, ``complete()``, ``instant()``,
  ``counter()``, ``flow_*()`` and ``mint_request_id()`` act on the active
  tracer (:func:`set_active`, :func:`maybe_start`); with none active each
  costs one ``is None`` check and allocates nothing.  ``counter()`` also
  feeds the armed ``metrics_export`` registry, so every counter track is a
  gauge on ``GET /metrics``.
- Timestamps are epoch microseconds advanced by a monotonic clock, so
  traces of several processes line up after :func:`merge_traces`; both
  clocks are injectable.
- The analysis half: :func:`merge_traces`, :func:`phase_breakdown`,
  :func:`request_breakdown` (per-request critical paths from the flows),
  :func:`diff_breakdowns` and the ``format_*`` renderings.  A trace the
  port writes and one the JAX package writes are read alike.

Who emits here: the serving stack (``serve.batch`` spans, the ``serve``,
``serve.canary``, ``serve.autoscale`` and ``serve.decode`` counter tracks,
request flows, ``serve.*`` and ``deploy.*`` instants) and the chaos points
(one ``chaos:<point>`` instant per schedule hit).  The training loop's
spans and the prefetch worker's ``prefetch.item`` spans are not emitted
yet (ROADMAP queue A item 6).

Knobs (``utils/config``):

| env var | meaning | default |
|---|---|---|
| ``BIGDL_TORCH_TRACE`` | trace output dir (any file_io scheme); empty = tracing off | off |
| ``BIGDL_TORCH_TRACE_RING`` | max buffered events (ring; oldest dropped) | 65536 |
| ``BIGDL_TORCH_TRACE_FLUSH_EVERY`` | events between automatic flushes | 4096 |
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional

from . import config
from . import metrics_export

logger = logging.getLogger("bigdl_torch")

__all__ = ["Tracer", "enabled", "trace_dir", "maybe_start", "set_active",
           "get_active", "span", "complete", "instant", "counter",
           "thread_name", "merge_traces", "phase_breakdown",
           "format_report", "diff_breakdowns", "format_diff",
           "flow_start", "flow_step", "flow_finish", "mint_request_id",
           "request_breakdown", "format_requests",
           "REQUEST_ID_HEADER", "TRACE_FILE_RE"]

#: the train loop's phase spans — the names phase_breakdown() ranks first
PHASE_NAMES = ("data", "step", "checkpoint", "validation")

TRACE_FILE_RE = r"trace\.(\d+)\.json"

#: every flow event of one request shares this name+cat — Chrome links
#: s/t/f phases into one arrow chain only when (name, cat, id) all match
FLOW_NAME = "request"
FLOW_CAT = "req"

#: the HTTP header the fleet front uses to propagate a request id to the
#: member that serves it (and that members echo back in every response)
REQUEST_ID_HEADER = "X-BigDL-Request-Id"


class _NullSpan:
    """Shared no-op context manager: what ``span()`` hands out when no
    tracer is active — one singleton, zero allocation per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = self._tr._now_us()
        return self

    def __exit__(self, *exc):
        self._tr._emit_complete(self.name, self.cat, self._t0,
                                self._tr._now_us() - self._t0, self.args)
        return False


class Tracer:
    """Chrome-trace-event tracer with a bounded ring and file_io flush.

    ``out_dir`` accepts any file_io scheme (local path, ``memory://``,
    ``gs://``); each flush rewrites ``trace.<rank>.json`` with the current
    ring contents, so the newest events are always on storage — a crashed
    or stalled run's trace survives up to its last flush (the supervisor
    forces one before writing a crash report).  No background thread:
    flushing happens inline every ``flush_every`` appended events and on
    ``flush()``/``close()``."""

    def __init__(self, out_dir: str, rank: int = 0, *,
                 ring: Optional[int] = None,
                 flush_every: Optional[int] = None,
                 clock=None, wall_clock=None):
        self.out_dir = str(out_dir)
        self.rank = int(rank)
        self.ring = (config.get_int("TRACE_RING", 65536)
                     if ring is None else int(ring))
        self.flush_every = (config.get_int("TRACE_FLUSH_EVERY", 4096)
                            if flush_every is None else int(flush_every))
        self._clock = clock or time.perf_counter
        wall = wall_clock or time.time
        # wall-anchored monotonic micros: cross-host merge needs a shared
        # timebase (epoch), in-process ordering needs monotonicity
        self._base_us = wall() * 1e6
        self._base_perf = self._clock()
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._meta: List[dict] = []   # process/thread names: never evicted
        self._tids: Dict[int, int] = {}
        self.dropped = 0
        self._since_flush = 0
        self._rid_seq = 0
        self._closed = False
        import socket
        self._host = socket.gethostname()
        self._meta.append({"ph": "M", "name": "process_name",
                           "pid": self.rank, "tid": 0,
                           "args": {"name": f"rank {self.rank} "
                                            f"({self._host})"}})

    # -- clocks / ids ---------------------------------------------------

    def _now_us(self) -> float:
        return self._base_us + (self._clock() - self._base_perf) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
            self._emit_meta("thread_name", tid,
                            threading.current_thread().name)
        return tid

    def _emit_meta(self, kind: str, tid: int, name: str) -> None:
        with self._lock:
            self._meta.append({"ph": "M", "name": kind, "pid": self.rank,
                               "tid": tid, "args": {"name": name}})

    def thread_name(self, name: str) -> None:
        """(Re)label the calling thread's track (the prefetch worker names
        itself at startup)."""
        self._emit_meta("thread_name", self._tid(), name)

    # -- event emission -------------------------------------------------

    def _append(self, ev: dict) -> None:
        flush_now = False
        with self._lock:
            if self._closed:
                return
            self._events.append(ev)
            if len(self._events) > self.ring:
                del self._events[0]
                self.dropped += 1
            self._since_flush += 1
            if self.flush_every > 0 and \
                    self._since_flush >= self.flush_every:
                self._since_flush = 0
                flush_now = True
        if flush_now:
            self.flush()

    def span(self, name: str, cat: str = "phase", **args) -> _Span:
        """Context manager emitting one "X" complete event on exit; nested
        ``with`` blocks nest in Perfetto by time containment."""
        return _Span(self, name, cat, args or None)

    def _emit_complete(self, name, cat, ts_us, dur_us, args) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "ts": round(ts_us, 1),
              "dur": round(max(dur_us, 0.0), 1), "pid": self.rank,
              "tid": self._tid()}
        if args:
            ev["args"] = args
        self._append(ev)

    def complete(self, name: str, dur_s: float, cat: str = "phase",
                 **args) -> None:
        """Record a span that just ENDED and lasted ``dur_s`` seconds —
        for code that already measured a duration (the train loop's
        data_wait) without restructuring it into a ``with`` block."""
        now = self._now_us()
        self._emit_complete(name, cat, now - dur_s * 1e6, dur_s * 1e6, args)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "ts":
              round(self._now_us(), 1), "s": "t", "pid": self.rank,
              "tid": self._tid()}
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, track: str, **values) -> None:
        """One sample on counter track ``track`` (Perfetto renders each
        arg key as a series)."""
        self._append({"name": track, "ph": "C",
                      "ts": round(self._now_us(), 1), "pid": self.rank,
                      "tid": 0, "args": {k: round(float(v), 6)
                                         for k, v in values.items()}})

    # -- request flows ("s"/"t"/"f" — the cross-process arrow chain) -----

    def mint_request_id(self) -> str:
        """A process-unique request id (pid-rank-seq hex).  Minted at
        admission (FleetFront.submit / InferenceServer.submit /
        DecodeEngine.submit) and carried on the PendingRequest + the
        ``X-BigDL-Request-Id`` header so every process's flow events for
        one request share one Chrome flow ``id``."""
        import os
        with self._lock:
            self._rid_seq += 1
            n = self._rid_seq
        return f"{os.getpid():x}-{self.rank:x}-{n:x}"

    def _emit_flow(self, ph: str, flow_id: str, args) -> None:
        ev = {"name": FLOW_NAME, "cat": FLOW_CAT, "ph": ph,
              "id": str(flow_id), "ts": round(self._now_us(), 1),
              "pid": self.rank, "tid": self._tid()}
        if ph == "f":
            # bind the arrow head to the ENCLOSING slice, not the next one
            ev["bp"] = "e"
        if args:
            ev["args"] = args
        self._append(ev)

    def flow_start(self, flow_id: str, **args) -> None:
        """Open a request flow ("s"): the admission point of the process
        that MINTED the id.  ``args`` should carry ``hop`` — the
        request_breakdown() segment attribution is keyed on hop names."""
        self._emit_flow("s", flow_id, args or None)

    def flow_step(self, flow_id: str, **args) -> None:
        """A "t" flow phase: every later hop the request passes through
        (front send, member enqueue, batch assembly, decode ticks,
        retries, failovers) on whichever process observes it."""
        self._emit_flow("t", flow_id, args or None)

    def flow_finish(self, flow_id: str, **args) -> None:
        """Close the flow ("f", bp="e"): emitted by the id's minter when
        the request resolves (the front's dispatch return, or the
        server's _resolve for locally-minted ids)."""
        self._emit_flow("f", flow_id, args or None)

    # -- inspection / persistence --------------------------------------

    def events_tail(self, n: int = 64) -> List[dict]:
        """The newest n events (the supervisor embeds this in stall crash
        reports so the timeline leading into a hang is preserved even if
        the trace file itself is lost)."""
        with self._lock:
            return [dict(e) for e in self._events[-n:]]

    @property
    def path(self) -> str:
        from . import file_io
        base = file_io._strip_file_scheme(self.out_dir)
        return file_io._join(base, f"trace.{self.rank}.json")

    def flush(self) -> str:
        """Rewrite ``trace.<rank>.json`` with the current ring contents.
        Returns the path; a broken trace store must never take down the
        traced run (logged, not raised)."""
        from . import file_io
        with self._lock:
            payload = {"traceEvents": self._meta + self._events,
                       "displayTimeUnit": "ms",
                       "otherData": {"rank": self.rank, "host": self._host,
                                     "dropped_events": self.dropped}}
            self._since_flush = 0
        path = self.path
        try:
            base = file_io._strip_file_scheme(self.out_dir)
            fs = file_io.get_filesystem(base)
            fs.makedirs(base)
            fs.write_bytes(path, json.dumps(payload).encode())
        except Exception as e:  # noqa: BLE001 — telemetry is best-effort
            logger.warning("telemetry: trace flush to %s failed: %s",
                           path, e)
        return path

    def close(self) -> None:
        """Final flush + detach (idempotent); clears the active slot if
        this tracer holds it."""
        if not self._closed:
            self.flush()
            self._closed = True
        if get_active() is self:
            set_active(None)


# ---------------------------------------------------------------------------
# process-wide active tracer + zero-overhead module helpers
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None


def set_active(tr: Optional[Tracer]) -> None:
    global _ACTIVE
    _ACTIVE = tr


def get_active() -> Optional[Tracer]:
    return _ACTIVE


def trace_dir() -> str:
    """The ``BIGDL_TORCH_TRACE`` knob: the trace output dir ('' = off)."""
    return config.get_str("TRACE", "").strip()


def enabled() -> bool:
    return bool(trace_dir())


def maybe_start(rank: int = 0) -> Optional[Tracer]:
    """Start (and make active) a Tracer per the env knobs.  Returns the
    NEW tracer only when this call created one — None when tracing is off
    or another tracer already owns the process slot — so the caller that
    gets a handle back is the one that must ``close()`` it."""
    if _ACTIVE is not None or not enabled():
        return None
    tr = Tracer(trace_dir(), rank=rank)
    set_active(tr)
    return tr


def span(name: str, cat: str = "phase", **args):
    """Module-level span against the active tracer; the shared no-op
    singleton when tracing is off (no allocation, no event)."""
    tr = _ACTIVE
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, cat, **args)


def complete(name: str, dur_s: float, cat: str = "phase", **args) -> None:
    tr = _ACTIVE
    if tr is not None:
        tr.complete(name, dur_s, cat, **args)


def instant(name: str, cat: str = "event", **args) -> None:
    tr = _ACTIVE
    if tr is not None:
        tr.instant(name, cat, **args)


def counter(track: str, **values) -> None:
    tr = _ACTIVE
    if tr is not None:
        tr.counter(track, **values)
    # the live-metrics plane rides the same call sites: every counter
    # track doubles as a Prometheus gauge when a registry is armed (and
    # costs one module-attribute load + None check when it is not)
    reg = metrics_export._REGISTRY
    if reg is not None:
        reg.feed_counter(track, values)


def thread_name(name: str) -> None:
    tr = _ACTIVE
    if tr is not None:
        tr.thread_name(name)


def mint_request_id() -> Optional[str]:
    """Mint a request id against the active tracer — None when tracing is
    off, so untraced admission paths carry (and allocate) nothing."""
    tr = _ACTIVE
    if tr is None:
        return None
    return tr.mint_request_id()


def flow_start(flow_id: Optional[str], **args) -> None:
    tr = _ACTIVE
    if tr is not None and flow_id:
        tr.flow_start(flow_id, **args)


def flow_step(flow_id: Optional[str], **args) -> None:
    tr = _ACTIVE
    if tr is not None and flow_id:
        tr.flow_step(flow_id, **args)


def flow_finish(flow_id: Optional[str], **args) -> None:
    tr = _ACTIVE
    if tr is not None and flow_id:
        tr.flow_finish(flow_id, **args)


# ---------------------------------------------------------------------------
# cross-host merge + phase breakdown (the trace_report core)
# ---------------------------------------------------------------------------

def merge_traces(trace_dir_: str) -> dict:
    """Merge every ``trace.<rank>.json`` under ``trace_dir_`` (any file_io
    scheme) into one Chrome-trace object on a shared timeline: events are
    already wall-clock-anchored and pid-tagged by rank, so the merge is a
    concatenation + time sort.  Raises FileNotFoundError when no trace
    files exist."""
    import re
    from . import file_io
    base = file_io._strip_file_scheme(str(trace_dir_))
    fs = file_io.get_filesystem(base)
    try:
        names = fs.listdir(base)
    except Exception as e:  # noqa: BLE001 — uniform error for a bad dir
        raise FileNotFoundError(f"{trace_dir_}: cannot list trace dir "
                                f"({type(e).__name__}: {e})") from e
    ranks, events, other = [], [], {}
    for name in sorted(names):
        m = re.fullmatch(TRACE_FILE_RE, name)
        if not m:
            continue
        blob = json.loads(fs.read_bytes(file_io._join(base, name)))
        ranks.append(int(m.group(1)))
        events.extend(blob.get("traceEvents", []))
        other[m.group(1)] = blob.get("otherData", {})
    if not ranks:
        raise FileNotFoundError(
            f"{trace_dir_}: no trace.<rank>.json files found")
    # metadata events (ph=M) first, then time order — Perfetto wants names
    # declared before use and meta events carry no ts
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"ranks": sorted(ranks), "per_rank": other}}


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(int(q * (len(sorted_vals) - 1) + 0.5),
                           len(sorted_vals) - 1)]


def phase_breakdown(merged: dict) -> dict:
    """Per-phase stats + the input-bound-vs-compute-bound diagnosis from a
    merged trace.

    - ``phases``: per span name — count, total seconds, p50/p95/max ms
      (the optimizer's ``data``/``step``/``checkpoint``/``validation``
      first, then every other span name seen);
    - ``ranks``: per rank — wall seconds (first span start to last span
      end), ``data_wait_fraction`` (sum of ``data`` span time / wall: the
      share of the wall time the step waited for input), mean step
      seconds;
    - ``data_wait_fraction`` overall + ``diagnosis``;
    - ``straggler_ranks``: ranks whose mean ``step`` span runs > 1.5x the
      median rank's (the one-slow-host signal);
    - ``instants``: count per instant-event name (chaos injections show up
      here);
    - ``elastic``: the ``elastic.*`` instants keyed by suffix
      (join/agree/reform/resume/…) plus ``joined`` — the last value of
      the ``peers`` counter track, i.e. the world size after the most
      recent shrink/grow (parallel/elastic.py)."""
    spans = [e for e in merged.get("traceEvents", [])
             if e.get("ph") == "X" and "dur" in e]
    by_name: Dict[str, List[float]] = {}
    per_rank: Dict[int, dict] = {}
    for e in spans:
        dur_s = e["dur"] / 1e6
        by_name.setdefault(e["name"], []).append(dur_s)
        r = per_rank.setdefault(int(e.get("pid", 0)),
                                {"start": e["ts"], "end": e["ts"] + e["dur"],
                                 "data": 0.0, "step": [], "spans": 0})
        r["start"] = min(r["start"], e["ts"])
        r["end"] = max(r["end"], e["ts"] + e["dur"])
        r["spans"] += 1
        if e["name"] == "data":
            r["data"] += dur_s
        elif e["name"] == "step":
            r["step"].append(dur_s)
    phases = {}
    order = [n for n in PHASE_NAMES if n in by_name] + \
        sorted(n for n in by_name if n not in PHASE_NAMES)
    for name in order:
        vals = sorted(by_name[name])
        phases[name] = {"count": len(vals),
                        "total_s": round(sum(vals), 6),
                        "p50_ms": round(_pct(vals, 0.50) * 1e3, 3),
                        "p95_ms": round(_pct(vals, 0.95) * 1e3, 3),
                        "max_ms": round(vals[-1] * 1e3, 3)}
    ranks = {}
    total_data = total_wall = 0.0
    step_means = {}
    for rank, r in sorted(per_rank.items()):
        wall = max((r["end"] - r["start"]) / 1e6, 1e-9)
        frac = min(r["data"] / wall, 1.0)
        total_data += r["data"]
        total_wall += wall
        mean_step = (sum(r["step"]) / len(r["step"])) if r["step"] else None
        if mean_step is not None:
            step_means[rank] = mean_step
        ranks[str(rank)] = {"wall_s": round(wall, 6),
                            "spans": r["spans"],
                            "data_wait_fraction": round(frac, 4),
                            "step_mean_s": (round(mean_step, 6)
                                            if mean_step is not None
                                            else None)}
    stragglers = []
    if len(step_means) > 1:
        means = sorted(step_means.values())
        # lower median: with an even rank count the SLOWER of the middle
        # pair must not become the yardstick (2 ranks would never flag)
        median = means[(len(means) - 1) // 2]
        stragglers = [{"rank": rk, "step_mean_s": round(v, 6),
                       "x_median": round(v / max(median, 1e-12), 2)}
                      for rk, v in sorted(step_means.items())
                      if v > 1.5 * median]
    frac = min(total_data / total_wall, 1.0) if total_wall > 0 else 0.0
    instants: Dict[str, int] = {}
    for e in merged.get("traceEvents", []):
        if e.get("ph") == "i":
            instants[e["name"]] = instants.get(e["name"], 0) + 1
    # counter tracks ("C" events): per track.series — count/mean/max/last.
    # Counter tracks become part of the printed report, not only of
    # Perfetto's view.
    counter_vals: Dict[str, List[float]] = {}
    for e in merged.get("traceEvents", []):
        if e.get("ph") == "C":
            for k, v in (e.get("args") or {}).items():
                counter_vals.setdefault(f"{e['name']}.{k}", []).append(
                    float(v))
    counters = {}
    for name in sorted(counter_vals):
        vals = counter_vals[name]
        counters[name] = {"count": len(vals),
                          "mean": round(sum(vals) / len(vals), 6),
                          "max": round(max(vals), 6),
                          "last": round(vals[-1], 6)}
    # the reference's compile-cache track, promoted the same way as the
    # sections below (its last samples are cumulative totals); the port
    # emits none, but reads the reference's traces alike
    aot = {series[len("aot."):]: int(st["last"])
           for series, st in counters.items() if series.startswith("aot.")}
    # the serving autoscaler's track, promoted the same way: its LAST
    # replicas sample is the pool's final size and the serve.autoscale
    # instant count is how many scale decisions fired — "did the pool
    # actually track the load?" becomes a report line, not a Perfetto
    # hunt (serve/autoscale.py)
    autoscale = {series[len("serve.autoscale."):]: st["last"]
                 for series, st in counters.items()
                 if series.startswith("serve.autoscale.")}
    if autoscale:
        autoscale["decisions"] = instants.get("serve.autoscale", 0)
    # the continuous-deployment track, promoted the same way: the
    # trainer's publishes and the controller's deploy/promote/rollback
    # counts share the one `deploy` track, so a merged trainer+server
    # trace answers "did every good release reach traffic?" as a report
    # line (serve/continuous.py) — last values are cumulative totals
    deploy = {series[len("deploy."):]: st["last"]
              for series, st in counters.items()
              if series.startswith("deploy.")}
    if deploy:
        deploy["events"] = sum(v for k, v in instants.items()
                               if k.startswith("deploy."))
    # the elastic re-form track, promoted the same way: the `peers`
    # counter's `joined` series carries the joined-rank count after every
    # re-form (its LAST sample is the final world size) and the
    # elastic.* instants are the protocol milestones — "did the run
    # shrink and grow back?" becomes a report line (parallel/elastic)
    elastic = {k[len("elastic."):]: v for k, v in instants.items()
               if k.startswith("elastic.")}
    joined = counters.get("peers.joined")
    if joined is not None:
        elastic["joined"] = int(joined["last"])
    # the cross-process fleet track, promoted the same way: the
    # supervisor's `fleet` counter (live/restarts/degraded, last values
    # are the final state) plus the fleet.* instants (spawn/lost/
    # condemn/respawn/deploy milestones across supervisor, front tier,
    # and every worker process) — "did the fleet lose, replace, and
    # re-deploy members?" becomes a report line spanning every member's
    # trace (serve/fleet.py, serve/fleetfront.py)
    fleet = {series[len("fleet."):]: st["last"]
             for series, st in counters.items()
             if series.startswith("fleet.")}
    fleet_events = sum(v for k, v in instants.items()
                       if k.startswith("fleet."))
    if fleet or fleet_events:
        fleet["events"] = fleet_events
    # the continuous-batching decode engine's track, promoted the same
    # way: tokens/s, active-slot fill, prefill-vs-decode step fractions
    # and cache bytes/slot (serve/decode.py emits cumulative/derived
    # values per tick, so LAST is the steady-state answer) — "did the
    # decode loop stay full and cheap?" becomes a report line
    decode = {series[len("serve.decode."):]: st["last"]
              for series, st in counters.items()
              if series.startswith("serve.decode.")}
    return {"phases": phases, "ranks": ranks, "counters": counters,
            "aot": aot, "autoscale": autoscale, "deploy": deploy,
            "elastic": elastic, "fleet": fleet, "decode": decode,
            "data_wait_fraction": round(frac, 4),
            "diagnosis": ("input-bound (data_wait_fraction "
                          f"{frac:.2f} > 0.5: the host pipeline gates the "
                          "chip)" if frac > 0.5 else
                          f"compute-bound (data_wait_fraction {frac:.2f} "
                          "<= 0.5: the device step sets the pace)"),
            "straggler_ranks": stragglers,
            "instants": instants}


def format_report(breakdown: dict, merged: Optional[dict] = None) -> str:
    """Human-readable phase breakdown (the trace_report CLI's output)."""
    lines = []
    if merged is not None:
        meta = merged.get("otherData", {})
        lines.append(f"ranks: {meta.get('ranks', '?')}  events: "
                     f"{len(merged.get('traceEvents', []))}")
    lines.append(f"{'phase':<16}{'count':>8}{'total_s':>12}{'p50_ms':>10}"
                 f"{'p95_ms':>10}{'max_ms':>10}")
    for name, st in breakdown["phases"].items():
        lines.append(f"{name:<16}{st['count']:>8}{st['total_s']:>12.3f}"
                     f"{st['p50_ms']:>10.2f}{st['p95_ms']:>10.2f}"
                     f"{st['max_ms']:>10.2f}")
    lines.append(f"data_wait_fraction: {breakdown['data_wait_fraction']} "
                 f"— {breakdown['diagnosis']}")
    for rank, st in breakdown["ranks"].items():
        lines.append(f"  rank {rank}: wall {st['wall_s']:.3f}s, "
                     f"data_wait_fraction {st['data_wait_fraction']}, "
                     f"step mean "
                     f"{st['step_mean_s'] if st['step_mean_s'] is not None else '-'}")
    if breakdown["straggler_ranks"]:
        for s in breakdown["straggler_ranks"]:
            lines.append(f"STRAGGLER rank {s['rank']}: step mean "
                         f"{s['step_mean_s']}s = {s['x_median']}x the "
                         "median rank")
    else:
        lines.append("stragglers: none")
    if breakdown.get("counters"):
        lines.append(f"{'counter':<28}{'count':>8}{'mean':>14}{'max':>14}"
                     f"{'last':>14}")
        # sorted here too (not just at breakdown build): a breakdown that
        # round-tripped through JSON (trace_report --json | --diff) must
        # render the same row order
        for name in sorted(breakdown["counters"]):
            st = breakdown["counters"][name]
            lines.append(f"{name:<28}{st['count']:>8}{st['mean']:>14.6g}"
                         f"{st['max']:>14.6g}{st['last']:>14.6g}")
    if breakdown.get("aot"):
        lines.append("aot ledger: " + "  ".join(
            f"{k}={v}" for k, v in sorted(breakdown["aot"].items())))
    if breakdown.get("autoscale"):
        lines.append("autoscale: " + "  ".join(
            f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(breakdown["autoscale"].items())))
    if breakdown.get("deploy"):
        lines.append("deploy: " + "  ".join(
            f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(breakdown["deploy"].items())))
    if breakdown.get("elastic"):
        lines.append("elastic: " + "  ".join(
            f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(breakdown["elastic"].items())))
    if breakdown.get("fleet"):
        lines.append("fleet: " + "  ".join(
            f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(breakdown["fleet"].items())))
    if breakdown.get("decode"):
        lines.append("decode: " + "  ".join(
            f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(breakdown["decode"].items())))
    if breakdown["instants"]:
        lines.append("instant events: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(breakdown["instants"].items())))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# per-request critical paths (trace_report --requests)
# ---------------------------------------------------------------------------

#: hop name -> which latency segment the time ENTERING that hop belongs
#: to.  A segment is the gap between consecutive flow events of one
#: request; it is attributed by where the request ARRIVED (e.g. the gap
#: ending at ``queue.enqueue`` was spent in transport getting there).
_SEG_BY_DST = {
    "front.send": "dispatch",       # front admit -> picked a member
    "queue.enqueue": "transport",   # front send -> member admission
    "batch.assemble": "queue",      # enqueue -> pulled into a batch
    "decode.admit": "queue",        # enqueue -> admitted to a KV slot
    "decode.tick": "device",        # admit/tick -> next decode step
    "resolve": "device",            # batch assembly -> result resolved
    "front.done": "transport",      # member resolve -> front response
    "fleet.retry": "failover",      # send -> the attempt was abandoned
    "replica.lost": "failover",     # a replica died holding the request
    "decode.fault": "failover",     # a KV slot faulted mid-sequence
}
_SEGMENTS = ("dispatch", "queue", "device", "transport", "failover")


def request_breakdown(merged: dict, slowest: int = 5) -> dict:
    """Reconstruct per-request critical paths from a merged multi-process
    trace's flow events.

    Every flow phase ("s"/"t"/"f" with name=:data:`FLOW_NAME`) carries the
    request id in ``id`` and a ``hop`` arg naming the pipeline station it
    marks; consecutive hops of one id — across front, worker, and
    controller pids — partition the request's latency into segments
    (:data:`_SEGMENTS`).  Returns per-segment p50/p95/p99 over all
    requests, per-request totals, and the slowest-N hop timelines —
    "where did the p99 go" as data."""
    flows: Dict[str, List[dict]] = {}
    for e in merged.get("traceEvents", []):
        if e.get("ph") in ("s", "t", "f") and e.get("name") == FLOW_NAME:
            a = e.get("args") or {}
            flows.setdefault(str(e.get("id")), []).append(
                {"ts": float(e.get("ts", 0.0)), "rank": int(e.get("pid", 0)),
                 "hop": a.get("hop", "?"), "args": a})
    requests = {}
    seg_samples: Dict[str, List[float]] = {s: [] for s in _SEGMENTS}
    for rid, evs in flows.items():
        evs.sort(key=lambda e: e["ts"])
        segments = {s: 0.0 for s in _SEGMENTS}
        for prev, cur in zip(evs, evs[1:]):
            seg = _SEG_BY_DST.get(cur["hop"], "dispatch")
            segments[seg] += max(cur["ts"] - prev["ts"], 0.0)
        total_us = max(evs[-1]["ts"] - evs[0]["ts"], 0.0)
        members = sorted({e["args"]["member"] for e in evs
                          if "member" in e["args"]})
        status = next((e["args"]["status"] for e in reversed(evs)
                       if "status" in e["args"]), None)
        requests[rid] = {
            "total_ms": round(total_us / 1e3, 3),
            "hops": len(evs),
            "ranks": sorted({e["rank"] for e in evs}),
            "members": members,
            "status": status,
            "segments": {s: round(v / 1e3, 3)
                         for s, v in segments.items() if v > 0.0}}
        for s, v in segments.items():
            seg_samples[s].append(v / 1e3)
    seg_stats = {}
    for s in _SEGMENTS:
        vals = sorted(v for v in seg_samples[s] if v > 0.0)
        if not vals:
            continue
        seg_stats[s] = {"count": len(vals),
                        "total_ms": round(sum(vals), 3),
                        "p50_ms": round(_pct(vals, 0.50), 3),
                        "p95_ms": round(_pct(vals, 0.95), 3),
                        "p99_ms": round(_pct(vals, 0.99), 3)}
    slow = sorted(requests.items(), key=lambda kv: -kv[1]["total_ms"])
    slowest_list = []
    for rid, st in slow[:max(int(slowest), 0)]:
        evs = flows[rid]
        t0 = evs[0]["ts"]
        slowest_list.append({
            "id": rid, "total_ms": st["total_ms"], "status": st["status"],
            "timeline": [{"t_ms": round((e["ts"] - t0) / 1e3, 3),
                          "rank": e["rank"], "hop": e["hop"],
                          **({"member": e["args"]["member"]}
                             if "member" in e["args"] else {})}
                         for e in evs]})
    totals = sorted(st["total_ms"] for st in requests.values())
    return {"count": len(requests),
            "total_p50_ms": round(_pct(totals, 0.50), 3),
            "total_p95_ms": round(_pct(totals, 0.95), 3),
            "total_p99_ms": round(_pct(totals, 0.99), 3),
            "segments": seg_stats, "requests": requests,
            "slowest": slowest_list}


def format_requests(rb: dict) -> str:
    """Human-readable rendering of :func:`request_breakdown`."""
    if not rb.get("count"):
        return "requests: none (no flow events in this trace)"
    lines = [f"requests: {rb['count']}  total p50/p95/p99 ms: "
             f"{rb['total_p50_ms']}/{rb['total_p95_ms']}/"
             f"{rb['total_p99_ms']}",
             f"{'segment':<12}{'count':>8}{'total_ms':>12}{'p50_ms':>10}"
             f"{'p95_ms':>10}{'p99_ms':>10}"]
    for seg in _SEGMENTS:
        st = rb["segments"].get(seg)
        if st is None:
            continue
        lines.append(f"{seg:<12}{st['count']:>8}{st['total_ms']:>12.3f}"
                     f"{st['p50_ms']:>10.3f}{st['p95_ms']:>10.3f}"
                     f"{st['p99_ms']:>10.3f}")
    for s in rb["slowest"]:
        lines.append(f"slowest {s['id']}: {s['total_ms']}ms"
                     + (f" status={s['status']}" if s["status"] else ""))
        for h in s["timeline"]:
            member = f" member={h['member']}" if "member" in h else ""
            lines.append(f"  +{h['t_ms']:>10.3f}ms  rank {h['rank']:<3}"
                         f" {h['hop']}{member}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# run-to-run diff (trace_report --diff A B)
# ---------------------------------------------------------------------------

def diff_breakdowns(a: dict, b: dict) -> dict:
    """Structured diff of two phase breakdowns (A = baseline, B = new run).

    Per phase: count/total_s/p50 in both runs + the B/A total-time ratio;
    per counter series: last values in both runs + delta; the promoted
    ``fleet`` and ``decode`` sections diff key-by-key the
    same way, so A/B runs compare tokens/s, fill, live members and
    restarts directly.  Phases or series present in only one run are
    flagged (``only``)."""
    phases = {}
    for name in sorted(set(a.get("phases", {})) | set(b.get("phases", {}))):
        pa, pb = a.get("phases", {}).get(name), \
            b.get("phases", {}).get(name)
        if pa is None or pb is None:
            phases[name] = {"only": "B" if pa is None else "A"}
            continue
        phases[name] = {
            "count": [pa["count"], pb["count"]],
            "total_s": [pa["total_s"], pb["total_s"]],
            "p50_ms": [pa["p50_ms"], pb["p50_ms"]],
            "total_ratio": round(pb["total_s"] / max(pa["total_s"], 1e-12),
                                 4)}
    counters = {}
    for name in sorted(set(a.get("counters", {})) |
                       set(b.get("counters", {}))):
        ca, cb = a.get("counters", {}).get(name), \
            b.get("counters", {}).get(name)
        if ca is None or cb is None:
            counters[name] = {"only": "B" if ca is None else "A"}
            continue
        counters[name] = {"last": [ca["last"], cb["last"]],
                          "delta": round(cb["last"] - ca["last"], 6)}
    sections = {}
    for sec in ("fleet", "decode"):
        sa, sb = a.get(sec) or {}, b.get(sec) or {}
        rows = {}
        for name in sorted(set(sa) | set(sb)):
            va, vb = sa.get(name), sb.get(name)
            if va is None or vb is None:
                rows[name] = {"only": "B" if va is None else "A"}
                continue
            rows[name] = {"last": [va, vb],
                          "delta": round(float(vb) - float(va), 6)}
        sections[sec] = rows
    return {"phases": phases, "counters": counters,
            "fleet": sections["fleet"], "decode": sections["decode"],
            "data_wait_fraction": [a.get("data_wait_fraction"),
                                   b.get("data_wait_fraction")]}


def format_diff(diff: dict) -> str:
    """Human-readable rendering of :func:`diff_breakdowns`."""
    lines = [f"{'phase':<16}{'count A/B':>14}{'total_s A':>12}"
             f"{'total_s B':>12}{'B/A':>8}"]
    for name, d in diff["phases"].items():
        if "only" in d:
            lines.append(f"{name:<16}  only in run {d['only']}")
            continue
        lines.append(f"{name:<16}{'%d/%d' % tuple(d['count']):>14}"
                     f"{d['total_s'][0]:>12.3f}{d['total_s'][1]:>12.3f}"
                     f"{d['total_ratio']:>8.2f}")
    if diff["counters"]:
        lines.append(f"{'counter':<28}{'last A':>14}{'last B':>14}"
                     f"{'delta':>12}")
        for name, d in diff["counters"].items():
            if "only" in d:
                lines.append(f"{name:<28}  only in run {d['only']}")
                continue
            lines.append(f"{name:<28}{d['last'][0]:>14.6g}"
                         f"{d['last'][1]:>14.6g}{d['delta']:>12.6g}")
    for sec in ("fleet", "decode"):
        rows = diff.get(sec) or {}
        if not rows:
            continue
        lines.append(f"{sec + ':':<28}{'A':>14}{'B':>14}{'delta':>12}")
        for name, d in rows.items():
            if "only" in d:
                lines.append(f"  {name:<26}  only in run {d['only']}")
                continue
            lines.append(f"  {name:<26}{d['last'][0]:>14.6g}"
                         f"{d['last'][1]:>14.6g}{d['delta']:>12.6g}")
    dw = diff["data_wait_fraction"]
    lines.append(f"data_wait_fraction: {dw[0]} -> {dw[1]}")
    return "\n".join(lines)
