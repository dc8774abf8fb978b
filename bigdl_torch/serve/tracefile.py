"""Serving traffic traces: record a request stream, replay it faster.

Counterpart of ``bigdl_tpu/serve/tracefile.py``, all of it:

- record: a :class:`TraceRecorder` on the server's admission path
  (``InferenceServer.record_trace``, ``TopologyRouter.record_trace``,
  ``DecodeEngine.record_trace``, or the HTTP front's
  ``X-BigDL-Record-Trace`` header) captures every offered
  request, shed ones included, as (arrival delta, payload, tenant,
  priority, deadline, and for a generated sequence its generation
  settings);
- persist: :func:`write_trace` / :func:`read_trace` keep one header record
  and one record per event in ``utils/recordio``'s framing (length and
  masked CRC32C per record), byte for byte the reference's file, so each
  package reads the other's traces; a damaged byte is a typed
  ``CorruptRecord``, a file of other records a :class:`TraceFormatError`;
- replay: :func:`replay` offers the stream open loop at ``speed`` times
  the recorded rate (arrivals at ``t0 + cumulative_dt / speed`` whatever
  the server does; ``lag_s`` records where the replayer fell behind);
- judge: :func:`resolve_outcomes` waits out the handles and
  :func:`slo_report` reduces the outcomes to SLO attainment (answered ok
  within the request's own deadline, over offered) overall, per tenant
  and per priority, beside served-latency percentiles and sheds by cause.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..utils import recordio
from .batcher import RequestTimeout, ServeError, ServerOverloaded

__all__ = ["TRACE_FORMAT", "TraceEvent", "TraceFormatError",
           "TraceRecorder", "write_trace", "read_trace", "replay",
           "slo_report"]

#: the header's format tag, the reference's: both packages write and read it
TRACE_FORMAT = "bigdl_tpu-serve-trace-v1"

#: recorder safety valve: default cap on in-memory events
#: (BIGDL_TORCH_SERVE_TRACE_LIMIT overrides) — recording must never OOM a
#: live server; past the cap events are counted as dropped, not kept
_DEFAULT_LIMIT = 100_000


class TraceFormatError(ServeError):
    """The file is framed recordio but not a serve trace (wrong/missing
    header) — typed so a mis-pointed path fails loudly, not as a weird
    replay."""


class TraceEvent:
    """One offered request: ``dt`` seconds after the PREVIOUS event (0
    for the first), the payload row, and its admission metadata.

    ``gen``: optional generation metadata for decode traces (serve/
    decode.py) — a small dict (max_tokens, eos, temperature, ...) the
    replayer hands to ``DecodeEngine.submit``.  For a generative
    sequence the payload is the prompt token row and ``deadline_ms`` is
    the time-to-LAST-token budget (the engine resolves the request at
    its final token, so recorded latency and SLO attainment are
    per-sequence by construction).  Absent on classic one-shot traces
    (``from_record`` defaults it to None — old trace files replay
    unchanged)."""

    __slots__ = ("dt", "payload", "tenant", "priority", "deadline_ms",
                 "gen")

    def __init__(self, dt: float, payload, tenant: Optional[str] = None,
                 priority: int = 0, deadline_ms: Optional[float] = None,
                 gen: Optional[dict] = None):
        self.dt = max(float(dt), 0.0)
        self.payload = payload
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline_ms = (float(deadline_ms)
                            if deadline_ms is not None else None)
        self.gen = dict(gen) if gen else None

    def to_record(self) -> dict:
        rec = {"dt": self.dt, "x": np.asarray(self.payload),
               "tenant": self.tenant, "priority": self.priority,
               "deadline_ms": self.deadline_ms}
        if self.gen is not None:
            rec["gen"] = dict(self.gen)
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "TraceEvent":
        return cls(rec["dt"], rec["x"], tenant=rec.get("tenant"),
                   priority=rec.get("priority", 0),
                   deadline_ms=rec.get("deadline_ms"),
                   gen=rec.get("gen"))

    def __repr__(self):
        return (f"TraceEvent(dt={self.dt:.4f}, shape="
                f"{tuple(np.asarray(self.payload).shape)}, "
                f"tenant={self.tenant!r}, priority={self.priority}, "
                f"deadline_ms={self.deadline_ms}"
                + (f", gen={self.gen}" if self.gen else "") + ")")


class TraceRecorder:
    """Thread-safe offered-request capture (clock-injectable).

    ``note()`` is called from the server's admission path under no lock
    of its own beyond this recorder's — it must stay cheap (one stamp,
    one append) because it sits in front of every request."""

    def __init__(self, clock=None, limit: Optional[int] = None,
                 path: Optional[str] = None):
        from ..utils import config
        self.clock = clock or time.monotonic
        self.limit = int(limit) if limit is not None else \
            config.get_int("SERVE_TRACE_LIMIT", _DEFAULT_LIMIT)
        self.path = path
        self.dropped = 0
        self._lock = threading.Lock()
        self._stamps: List[float] = []
        self._events: List[TraceEvent] = []

    def note(self, payload, tenant: Optional[str] = None,
             priority: int = 0,
             deadline_ms: Optional[float] = None,
             gen: Optional[dict] = None) -> None:
        now = self.clock()
        with self._lock:
            if len(self._events) >= self.limit:
                self.dropped += 1
                return
            prev = self._stamps[-1] if self._stamps else now
            self._stamps.append(now)
            self._events.append(TraceEvent(
                now - prev, np.asarray(payload), tenant=tenant,
                priority=priority, deadline_ms=deadline_ms, gen=gen))

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._events)

    def save(self, path: Optional[str] = None,
             meta: Optional[dict] = None) -> int:
        """Write the captured stream (``path`` overrides the armed one);
        returns the event count."""
        path = path or self.path
        if not path:
            raise ValueError("serve: trace recorder has no path — pass "
                             "one to save() or record_trace()")
        events = self.events()
        write_trace(path, events, meta=meta)
        return len(events)

    def stats(self) -> dict:
        with self._lock:
            return {"events": len(self._events), "dropped": self.dropped,
                    "limit": self.limit, "path": self.path}


def write_trace(path: str, events: Sequence[TraceEvent],
                meta: Optional[dict] = None) -> None:
    """Persist a trace: one header record (format, sample shape/dtype,
    count, caller meta) then one record per event, all CRC-framed
    (utils/recordio)."""
    events = list(events)
    sample = np.asarray(events[0].payload) if events else np.zeros((0,))
    header = {"format": TRACE_FORMAT,
              "sample_shape": list(sample.shape),
              "sample_dtype": str(sample.dtype),
              "count": len(events),
              "duration_s": round(sum(e.dt for e in events), 6),
              "meta": dict(meta or {})}
    recordio.write_records(path, [header] + [e.to_record()
                                             for e in events])


def read_trace(path: str) -> tuple:
    """Load ``(header, events)``; typed :class:`TraceFormatError` when
    the file is not a serve trace, :class:`CorruptRecord` (from the
    recordio layer) on CRC/framing damage."""
    records = iter(recordio.read_records(path))
    try:
        header = next(records)
    except StopIteration:
        raise TraceFormatError(f"serve: {path!r} is empty — not a "
                               "recorded trace") from None
    if not (isinstance(header, dict)
            and header.get("format") == TRACE_FORMAT):
        raise TraceFormatError(
            f"serve: {path!r} is not a {TRACE_FORMAT} trace (header "
            f"{type(header).__name__})")
    events = [TraceEvent.from_record(r) for r in records]
    if header.get("count") is not None and header["count"] != len(events):
        raise TraceFormatError(
            f"serve: {path!r} header claims {header['count']} events, "
            f"file holds {len(events)}")
    return header, events


# ---------------------------------------------------------------------------
# replay + SLO attainment
# ---------------------------------------------------------------------------


class ReplayOutcome:
    """One replayed request's fate, filled in two phases: submit (shed at
    admission?) then resolve (served / shed / errored + latency)."""

    __slots__ = ("event", "handle", "error", "lag_s", "latency_s")

    def __init__(self, event, handle=None, error=None, lag_s=0.0):
        self.event = event
        self.handle = handle
        self.error = error        # admission or resolution error
        self.lag_s = lag_s        # replayer behind schedule at submit
        self.latency_s = None


def replay(events: Sequence[TraceEvent], submit: Callable, *,
           speed: float = 10.0, clock=None, sleep=None,
           progress: Optional[Callable] = None) -> List[ReplayOutcome]:
    """Open-loop replay: offer every event at ``recorded_time / speed``
    regardless of how the pool is coping.

    ``submit(event)`` returns a
    :class:`~bigdl_torch.serve.batcher.PendingRequest` (or raises a typed
    admission rejection, which becomes the outcome's error).  Pacing
    never waits on results — an overloaded pool faces the backlog, like
    production.  ``lag_s`` per outcome records when the replayer itself
    fell behind schedule (a loaded host, not the server's fault: big
    sustained lag means the measurement under-offers and the record
    should say so)."""
    if speed <= 0:
        raise ValueError(f"serve: replay speed must be > 0, got {speed}")
    clock = clock or time.monotonic
    sleep = sleep or time.sleep
    outcomes: List[ReplayOutcome] = []
    t0 = clock()
    due = 0.0
    for e in events:
        due += e.dt / speed
        delay = (t0 + due) - clock()
        if delay > 0:
            sleep(delay)
        lag = max(-delay, 0.0)
        try:
            h = submit(e)
            outcomes.append(ReplayOutcome(e, handle=h, lag_s=lag))
        except Exception as exc:  # noqa: BLE001 — typed shed at
            # admission (overload/quota) or a real failure; classified
            # by slo_report
            outcomes.append(ReplayOutcome(e, error=exc, lag_s=lag))
        if progress is not None:
            progress()
    return outcomes


def resolve_outcomes(outcomes: Sequence[ReplayOutcome],
                     timeout: float = 120.0) -> None:
    """Wait for every submitted handle and record latency or the typed
    error.  Latency is the SERVER-side enqueue->resolve time
    (``PendingRequest.latency_s`` — the same clock the deadline logic
    uses), not the caller's result() wait."""
    for o in outcomes:
        if o.handle is None:
            continue
        try:
            o.handle.result(timeout)
            o.latency_s = o.handle.latency_s
        except Exception as exc:  # noqa: BLE001 — typed per-request
            o.error = exc
            o.latency_s = o.handle.latency_s


def _percentiles_ms(latencies: List[float]) -> dict:
    if not latencies:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    xs = sorted(latencies)

    def pick(q):
        return xs[min(int(q * (len(xs) - 1) + 0.5), len(xs) - 1)]

    return {"p50_ms": round(pick(0.50) * 1e3, 2),
            "p95_ms": round(pick(0.95) * 1e3, 2),
            "p99_ms": round(pick(0.99) * 1e3, 2)}


def _classify(error) -> str:
    """Shed-by-cause bucket: intentional load shedding (overload
    eviction/refusal, deadline timeout) vs real failures — the split the
    bench's open loop historically lumped together."""
    if isinstance(error, ServerOverloaded):
        return "overload"          # includes QuotaExceeded (subclass)
    if isinstance(error, RequestTimeout):
        return "timeout"
    return "errors"


def slo_report(outcomes: Sequence[ReplayOutcome],
               default_deadline_ms: Optional[float] = None) -> dict:
    """Reduce replay outcomes to SLO attainment.

    **Attainment** = answered successfully AND within the request's own
    deadline (its recorded ``deadline_ms``, else ``default_deadline_ms``;
    a request with neither attains by being answered at all), divided by
    OFFERED — sheds and errors count against the tenant they belonged
    to.  Reported overall, by tenant, and by priority class, beside
    served-latency percentiles and shed-by-cause counts."""

    def bucket():
        return {"offered": 0, "served": 0, "attained": 0,
                "shed_overload": 0, "shed_timeout": 0, "errors": 0}

    overall = bucket()
    by_tenant: dict = {}
    by_priority: dict = {}
    latencies: List[float] = []
    max_lag = 0.0
    for o in outcomes:
        e = o.event
        tb = by_tenant.setdefault(e.tenant or "default", bucket())
        pb = by_priority.setdefault(str(e.priority), bucket())
        rows = (overall, tb, pb)
        for r in rows:
            r["offered"] += 1
        max_lag = max(max_lag, o.lag_s)
        if o.error is not None:
            key = {"overload": "shed_overload", "timeout": "shed_timeout",
                   "errors": "errors"}[_classify(o.error)]
            for r in rows:
                r[key] += 1
            continue
        lat = o.latency_s
        if lat is not None:
            latencies.append(lat)
        for r in rows:
            r["served"] += 1
        deadline = e.deadline_ms if e.deadline_ms is not None \
            else default_deadline_ms
        if deadline is None or (lat is not None
                                and lat * 1e3 <= deadline):
            for r in rows:
                r["attained"] += 1

    def finish(b):
        b["attainment"] = round(b["attained"] / b["offered"], 4) \
            if b["offered"] else None
        return b

    return {"offered": overall["offered"],
            "served": overall["served"],
            "attainment": finish(overall)["attainment"],
            "shed": {"overload": overall["shed_overload"],
                     "timeout": overall["shed_timeout"],
                     "errors": overall["errors"]},
            "per_tenant": {t: finish(b)
                           for t, b in sorted(by_tenant.items())},
            "per_priority": {p: finish(b)
                             for p, b in sorted(by_priority.items())},
            "max_replay_lag_ms": round(max_lag * 1e3, 2),
            **_percentiles_ms(latencies)}
