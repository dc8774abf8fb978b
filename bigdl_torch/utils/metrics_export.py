"""Live metrics: a process-wide registry and its Prometheus text exposition.

Counterpart of ``bigdl_tpu/utils/metrics_export.py``, all of it.  One
:class:`MetricsRegistry` collects

- counters (requests by status, sheds by cause, replica restarts),
- gauges (queue depth, batch fill, tokens/s: every ``telemetry.counter``
  track arrives through :meth:`MetricsRegistry.feed_counter`, so
  instrumented code needs no second call),
- histograms (request latency, the decode engine's time to last token),
- a rolling SLO-attainment gauge (the share of the last
  ``BIGDL_TORCH_METRICS_WINDOW`` requests answered ok within
  ``BIGDL_TORCH_METRICS_SLO_MS``),

and renders them as Prometheus text (version 0.0.4) for ``GET /metrics``
of ``bigdl_torch.tools.serve_http``.  :func:`parse_exposition` reads that
text back and :func:`render_rollup` re-labels members' expositions under
one front.  The same observations give the same text as the reference.

Until :func:`arm` is called (the HTTP front does at start unless
``BIGDL_TORCH_METRICS=0``) there is no registry: instrumented code pays
one module attribute load and an ``is None`` check.  The registry has no
thread; it renders when scraped.

Knobs (``utils/config``):

| env var | meaning | default |
|---|---|---|
| ``BIGDL_TORCH_METRICS`` | ``0`` keeps the HTTP front from arming the registry | ``1`` |
| ``BIGDL_TORCH_METRICS_SLO_MS`` | request-latency SLO of the rolling attainment gauge | ``100`` |
| ``BIGDL_TORCH_METRICS_WINDOW`` | rolling window (requests) of SLO attainment | ``512`` |
"""

from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import config

__all__ = ["MetricsRegistry", "arm", "disarm", "registry", "armed",
           "enabled", "render_rollup", "parse_exposition",
           "CONTENT_TYPE", "DEFAULT_BUCKETS"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: request-latency histogram bucket upper bounds, seconds (Prometheus
#: convention: cumulative, +Inf added by the renderer)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(raw: str) -> str:
    """Sanitize a track/series name into a Prometheus metric name."""
    name = _NAME_OK.sub("_", raw.strip())
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{str(v)}"' for k, v in labels)
    return "{" + body + "}"


class MetricsRegistry:
    """Thread-safe counter/gauge/histogram store with text exposition.

    All mutators take ``**labels``; each distinct label set is one
    series.  There is deliberately no unregister and no background
    thread — the registry is a dict behind one lock, rendered on pull."""

    def __init__(self, *, slo_ms: Optional[float] = None,
                 window: Optional[int] = None):
        self._lock = threading.Lock()
        # name -> {labels_tuple: value}
        self._counters: Dict[str, Dict[tuple, float]] = {}
        self._gauges: Dict[str, Dict[tuple, float]] = {}
        # name -> {labels_tuple: [bucket_counts..., sum, count]}
        self._hists: Dict[str, Dict[tuple, list]] = {}
        self._hist_bounds: Dict[str, tuple] = {}
        self._help: Dict[str, str] = {}
        self.slo_s = (config.get_float("METRICS_SLO_MS", 100.0)
                      if slo_ms is None else float(slo_ms)) / 1e3
        n = (config.get_int("METRICS_WINDOW", 512)
             if window is None else int(window))
        self._slo_window: deque = deque(maxlen=max(n, 1))

    # -- mutators --------------------------------------------------------

    def counter_inc(self, name: str, value: float = 1.0,
                    help: Optional[str] = None, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + float(value)

    def gauge_set(self, name: str, value: float,
                  help: Optional[str] = None, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, value: float,
                buckets: tuple = DEFAULT_BUCKETS,
                help: Optional[str] = None, **labels) -> None:
        key = tuple(sorted(labels.items()))
        v = float(value)
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            bounds = self._hist_bounds.setdefault(name, tuple(buckets))
            series = self._hists.setdefault(name, {})
            cell = series.get(key)
            if cell is None:
                cell = series[key] = [0] * len(bounds) + [0.0, 0]
            for i, b in enumerate(bounds):
                if v <= b:
                    cell[i] += 1
            cell[-2] += v
            cell[-1] += 1

    def observe_request(self, latency_s: float, status: str = "ok",
                        **labels) -> None:
        """The one call the serving resolve path makes: requests-total
        counter by status, latency histogram, and the rolling SLO window
        (a request attains the SLO when it resolved ok within
        ``slo_s``)."""
        self.counter_inc("bigdl_serve_requests_total", 1.0,
                         help="requests resolved, by final status",
                         status=status, **labels)
        self.observe("bigdl_serve_request_latency_seconds",
                     latency_s,
                     help="request latency (submit to resolve), seconds",
                     **labels)
        with self._lock:
            self._slo_window.append(
                1.0 if (status == "ok" and latency_s <= self.slo_s)
                else 0.0)

    def shed(self, cause: str, **labels) -> None:
        self.counter_inc("bigdl_serve_shed_total", 1.0,
                         help="requests shed at admission, by cause",
                         cause=cause, **labels)

    def feed_counter(self, track: str, values: Dict[str, float]) -> None:
        """telemetry.counter() mirror: every track.series sample becomes
        gauge ``bigdl_<track>_<series>`` — queue depth, batch fill,
        decode tokens/s, fleet live/restarts all arrive through here."""
        for k, v in values.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            self.gauge_set(f"bigdl_{_metric_name(track)}_{_metric_name(k)}",
                           f)

    # -- exposition ------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition of every series (plus the SLO
        gauge), sorted by metric name for a stable scrape diff."""
        with self._lock:
            counters = {n: dict(s) for n, s in self._counters.items()}
            gauges = {n: dict(s) for n, s in self._gauges.items()}
            hists = {n: {k: list(c) for k, c in s.items()}
                     for n, s in self._hists.items()}
            bounds = dict(self._hist_bounds)
            helps = dict(self._help)
            window = list(self._slo_window)
        if window:
            gauges["bigdl_serve_slo_attainment"] = {(): (
                sum(window) / len(window))}
            helps.setdefault(
                "bigdl_serve_slo_attainment",
                f"fraction of the last {len(window)} requests resolved ok "
                f"within {self.slo_s * 1e3:g}ms")
        lines: List[str] = []
        for name in sorted(set(counters) | set(gauges) | set(hists)):
            help_ = helps.get(name)
            if help_:
                lines.append(f"# HELP {name} {help_}")
            if name in counters:
                lines.append(f"# TYPE {name} counter")
                for key in sorted(counters[name]):
                    lines.append(f"{name}{_label_str(key)} "
                                 f"{_fmt(counters[name][key])}")
            elif name in gauges:
                lines.append(f"# TYPE {name} gauge")
                for key in sorted(gauges[name]):
                    lines.append(f"{name}{_label_str(key)} "
                                 f"{_fmt(gauges[name][key])}")
            else:
                lines.append(f"# TYPE {name} histogram")
                bnds = bounds[name]
                for key in sorted(hists[name]):
                    # observe() increments every bucket the value fits
                    # under, so cells are already cumulative (le= form)
                    cell = hists[name][key]
                    for i, b in enumerate(bnds):
                        lines.append(
                            f"{name}_bucket"
                            f"{_label_str(key + (('le', _fmt(b)),))} "
                            f"{cell[i]}")
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(key + (('le', '+Inf'),))} "
                        f"{cell[-1]}")
                    lines.append(f"{name}_sum{_label_str(key)} "
                                 f"{_fmt(cell[-2])}")
                    lines.append(f"{name}_count{_label_str(key)} "
                                 f"{cell[-1]}")
        return "\n".join(lines) + "\n" if lines else ""


# ---------------------------------------------------------------------------
# process-wide slot (mirrors telemetry's _ACTIVE contract)
# ---------------------------------------------------------------------------

_REGISTRY: Optional[MetricsRegistry] = None


def enabled() -> bool:
    """The ``BIGDL_TORCH_METRICS`` knob: may the HTTP servers arm the
    plane at startup?  (Library use never arms implicitly.)"""
    return config.get_str("METRICS", "1").strip() not in ("0", "false", "")


def armed() -> bool:
    return _REGISTRY is not None


def registry() -> Optional[MetricsRegistry]:
    """The armed registry or None — instrumented code's fast path."""
    return _REGISTRY


def arm() -> MetricsRegistry:
    """Create (idempotently) and return the process-wide registry."""
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = MetricsRegistry()
    return _REGISTRY


def disarm() -> None:
    """Drop the registry (tests; restores the zero-overhead mode)."""
    global _REGISTRY
    _REGISTRY = None


# ---------------------------------------------------------------------------
# fleet rollup: parse member expositions, re-export with member labels
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse Prometheus text exposition into
    ``{metric: {"type": str, "samples": [(sample_name, labels, value)]}}``
    — ``sample_name`` keeps the ``_bucket``/``_sum``/``_count`` suffix so
    a rollup can re-emit histograms faithfully."""
    metrics: Dict[str, dict] = {}
    current_type: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                current_type[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        sample_name, label_blob, raw = m.groups()
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix) and \
                    sample_name[:-len(suffix)] in current_type:
                base = sample_name[:-len(suffix)]
                break
        labels = tuple(_LABEL_RE.findall(label_blob or ""))
        try:
            value = float(raw.replace("+Inf", "inf"))
        except ValueError:
            continue
        entry = metrics.setdefault(
            base, {"type": current_type.get(base, "untyped"),
                   "samples": []})
        entry["samples"].append((sample_name, labels, value))
    return metrics


def render_rollup(own_text: str,
                  member_texts: Dict[str, str]) -> str:
    """The fleet front's ``/metrics`` body: its own exposition followed by
    every member's samples re-labelled ``member="<idx>"`` under a
    ``fleet_`` prefix, plus a fleet-wide sum per counter/histogram
    series (gauges get per-member samples only — summing queue depths is
    meaningful, summing fill fractions is not, so the aggregate is left
    to the scraper)."""
    lines = [own_text.rstrip("\n")] if own_text.strip() else []
    merged: Dict[str, dict] = {}
    for idx in sorted(member_texts):
        for base, entry in parse_exposition(member_texts[idx]).items():
            slot = merged.setdefault(
                base, {"type": entry["type"], "per_member": [],
                       "sums": {}})
            for sample_name, labels, value in entry["samples"]:
                slot["per_member"].append(
                    (sample_name, labels + (("member", str(idx)),), value))
                if entry["type"] in ("counter", "histogram"):
                    key = (sample_name, labels)
                    slot["sums"][key] = slot["sums"].get(key, 0.0) + value
    for base in sorted(merged):
        slot = merged[base]
        lines.append(f"# TYPE fleet_{base} {slot['type']}")
        for key in sorted(slot["sums"]):
            sample_name, labels = key
            lines.append(f"fleet_{sample_name}{_label_str(labels)} "
                         f"{_fmt(slot['sums'][key])}")
        for sample_name, labels, value in slot["per_member"]:
            lines.append(f"fleet_{sample_name}{_label_str(labels)} "
                         f"{_fmt(value)}")
    return "\n".join(lines) + "\n" if lines else ""
