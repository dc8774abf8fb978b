"""The fleet's front: HTTP routing over supervised worker processes.

Counterpart of ``bigdl_tpu/serve/fleetfront.py``, all of it.  The members
are the processes of ``serve/fleet.py``, found through its registry and
reached over their HTTP endpoints (``tools/serve_http.py``'s wire format):

- **liveness**: the member set is the registry filtered by heartbeat
  publication freshness (``fleet.member_alive``), so a stale entry (a
  record without a live heartbeat, or a condemned generation) never
  attracts traffic; the set is cached for ``refresh_s``.
- **routing**: the reference's dispatch key over the front's own
  in-flight counts per member (the exact queue depth lives in another
  process): fewest pending full buckets (``inflight // max_batch``), then
  a partial batch already filling, then in-flight, then index; members in
  a rolling swap last.
- **failure**: a per-member HTTP timeout; a transport failure or a 5xx
  from one member retries on the next one, bounded (a predict is
  idempotent: a retried row costs compute, never a second effect).  Typed
  member answers map back to the typed serve errors (429
  ``ServerOverloaded``, 504 ``RequestTimeout``, 400 ``ServeError``); with
  no live member the front raises :class:`MemberLostError`, a
  ``ReplicaLostError``, which the HTTP front end answers with 503 and
  Retry-After.
- **capture and replay**: ``record_trace`` / ``stop_trace`` note offered
  traffic as the server does, so ``serve/tracefile.py`` replays through
  the front unchanged.
- **rolling deploy**: :meth:`FleetFront.swap` is the fleet mode the
  ``DeployController`` drives: a canary on the lowest live member, judged
  by that member's own comparator over its ``/v1/stats``, then the
  release rolled over the rest with at most ``max_unavailable`` members
  swapping at a time.  The verdict is mirrored into ``stats()["canary"]``.
- **metrics**: :meth:`FleetFront.metrics_text` is the front's own
  registry followed by every live member's ``/metrics`` under a
  ``fleet_`` prefix (``utils/metrics_export.render_rollup``).

| env var | meaning | default |
|---|---|---|
| ``BIGDL_TORCH_FLEET_TIMEOUT_S`` | per-member HTTP request timeout, seconds | 60 |
| ``BIGDL_TORCH_FLEET_RETRIES`` | retries on the next member after the first attempt | 2 |
| ``BIGDL_TORCH_FLEET_REFRESH_S`` | registry cache refresh interval, seconds | 0.25 |
| ``BIGDL_TORCH_FLEET_MAX_UNAVAILABLE`` | members swapping at once during a rolling deploy | 1 |
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from ..utils import config, metrics_export, telemetry
from . import fleet
from .batcher import (RequestTimeout, ServeError, ServerClosed,
                      ServerOverloaded)
from .fleet import MemberLostError

logger = logging.getLogger("bigdl_torch")

__all__ = ["FleetFront"]


class _FleetHandle:
    """PendingRequest-shaped future over one dispatched request —
    ``result(timeout)`` / ``latency_s`` / ``version`` are what replay
    resolution (serve/tracefile.resolve_outcomes) consumes."""

    __slots__ = ("_future", "latency_s", "version")

    def __init__(self, future):
        self._future = future
        self.latency_s = None
        self.version = None

    def result(self, timeout: Optional[float] = None):
        out, version, latency_s = self._future.result(timeout)
        self.version = version
        self.latency_s = latency_s
        return out


class FleetFront:
    """Route requests over the fleet registry (see module docstring).

    Duck-type compatible with :class:`InferenceServer` where the deploy
    controller and the replay tooling need it: ``submit`` / ``predict``
    / ``swap`` / ``stats`` / ``healthy`` / ``record_trace`` /
    ``stop_trace``."""

    #: continuous.DeployController switches to rolling fleet fan-out
    #: when the serving target declares itself a fleet
    fleet = True

    def __init__(self, fleet_dir: str, *, timeout_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 refresh_s: Optional[float] = None,
                 lost_after_s: Optional[float] = None,
                 max_unavailable: Optional[int] = None,
                 decision_timeout: float = 60.0,
                 max_workers: int = 32, clock=None):
        self.fleet_dir = str(fleet_dir)
        self.timeout_s = (config.get_float("FLEET_TIMEOUT_S", 60.0)
                          if timeout_s is None else float(timeout_s))
        self.retries = (config.get_int("FLEET_RETRIES", 2)
                        if retries is None else int(retries))
        self.refresh_s = (config.get_float("FLEET_REFRESH_S", 0.25)
                          if refresh_s is None else float(refresh_s))
        self.lost_after_s = (fleet.lost_after_seconds()
                             if lost_after_s is None else float(lost_after_s))
        self.max_unavailable = max(
            1, config.get_int("FLEET_MAX_UNAVAILABLE", 1)
            if max_unavailable is None else int(max_unavailable))
        self.decision_timeout = float(decision_timeout)
        self.clock = clock or time.monotonic
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="bigdl-fleet")
        self._lock = threading.Lock()
        self._inflight: Dict[int, int] = {}
        self._routed: Dict[int, int] = {}
        self._retried = 0
        self._deploying: set = set()
        self._deploy_stats = {"rolled": 0, "max_concurrent": 0}
        self._registry: Dict[int, dict] = {}
        self._registry_at = float("-inf")
        self._last_canary: Optional[dict] = None
        self._recorder = None
        self._closed = False

    # -- registry / liveness --------------------------------------------

    def _refresh(self, force: bool = False) -> Dict[int, dict]:
        now = self.clock()
        with self._lock:
            if not force and now - self._registry_at < self.refresh_s:
                return self._registry
        registry = fleet.read_registry(self.fleet_dir)
        live = {}
        for idx, record in registry.items():
            if fleet.member_alive(self.fleet_dir, idx,
                                  generation=record.get("generation"),
                                  lost_after=self.lost_after_s):
                live[idx] = record
        with self._lock:
            self._registry = live
            self._registry_at = now
        return live

    def members(self) -> Dict[int, dict]:
        """Current LIVE member records (index -> record)."""
        return dict(self._refresh())

    def healthy(self) -> bool:
        return bool(self._refresh(force=True))

    # -- routing --------------------------------------------------------

    def _pick(self, exclude=()) -> Optional[int]:
        """The reference's dispatch key over local in-flight counts:
        (pending full buckets, no-partial-coalescing, in-flight, index).
        Members currently in a rolling swap are deprioritized (not
        excluded — with one survivor, a deploying member still beats a
        503)."""
        live = self._refresh()
        best = best_key = None
        with self._lock:
            for i, record in live.items():
                if i in exclude:
                    continue
                d = self._inflight.get(i, 0)
                mb = int(record.get("max_batch") or 8)
                key = (1 if i in self._deploying else 0,
                       d // mb, 0 if d % mb else 1, d, i)
                if best_key is None or key < best_key:
                    best, best_key = i, key
        return best

    def _url(self, record: dict, route: str) -> str:
        return (f"http://{record.get('host', '127.0.0.1')}:"
                f"{record['port']}{route}")

    def _post(self, record: dict, route: str, body: dict,
              timeout: Optional[float] = None,
              request_id: Optional[str] = None):
        """POST JSON to one member; returns (status, parsed body).
        Raises URLError/OSError on transport failure (the caller's
        retry-on-next-member signal).  ``request_id`` rides the
        ``X-BigDL-Request-Id`` header so the member joins the request's
        flow (and echoes the id back)."""
        headers = {"Content-Type": "application/json"}
        if request_id is not None:
            headers[telemetry.REQUEST_ID_HEADER] = request_id
        req = urllib.request.Request(
            self._url(record, route), data=json.dumps(body).encode(),
            headers=headers, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout_s) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            # a TYPED member answer (429/504/...) — not a transport
            # failure; surface the body for the error mapping
            try:
                return e.code, json.loads(e.read().decode())
            except Exception:  # noqa: BLE001 — unparseable error body
                return e.code, {"error": str(e)}

    def _get(self, record: dict, route: str,
             timeout: Optional[float] = None) -> dict:
        with urllib.request.urlopen(self._url(record, route),
                                    timeout=timeout or self.timeout_s) as r:
            return json.loads(r.read().decode())

    def _get_text(self, record: dict, route: str,
                  timeout: Optional[float] = None) -> str:
        with urllib.request.urlopen(self._url(record, route),
                                    timeout=timeout or self.timeout_s) as r:
            return r.read().decode()

    # -- live metrics (GET /metrics on the front) ------------------------

    def metrics_text(self) -> str:
        """The front's Prometheus exposition: its own registry (request
        latency/SLO as routed callers saw them, failovers included)
        followed by the fleet-wide rollup — every live member's
        ``/metrics`` scraped and re-exported under a ``fleet_`` prefix
        with ``member`` labels plus per-series fleet sums.  One scrape of
        the front sees the whole fleet; a member whose scrape fails is
        skipped (its supervisor owns it), not fatal."""
        reg = metrics_export.registry()
        own = reg.render() if reg is not None else ""
        member_texts: Dict[str, str] = {}
        for i, record in self._refresh().items():
            try:
                member_texts[str(i)] = self._get_text(record, "/metrics")
            except Exception:  # noqa: BLE001 — scrape best-effort
                continue
        return metrics_export.render_rollup(own, member_texts)

    @staticmethod
    def _typed(status: int, body: dict):
        """One member's typed HTTP rejection -> the typed serve
        exception the caller (and the replay SLO classifier) expects."""
        msg = body.get("error") or f"member answered {status}"
        if status == 429:
            err = ServerOverloaded(msg)
            err.retry_after_s = body.get("retry_after_s")
            return err
        if status == 504:
            return RequestTimeout(msg)
        if status == 400:
            return ServeError(msg)
        return None  # 5xx/503: the caller retries on the next member

    def _no_member(self) -> MemberLostError:
        return MemberLostError(
            "fleet: no live member in the registry — every worker is "
            "lost, condemned, or degraded", retry_after_s=1.0)

    def _finish_flow(self, rid, t0, status: str) -> None:
        """Close the request's flow and feed the front's metrics (the
        front MINTED the id, so it owns the "f" phase)."""
        if rid is not None:
            telemetry.flow_finish(rid, hop="front.done", status=status)
        dt = self.clock() - t0
        if rid is not None:
            telemetry.complete("fleet.request", dt, cat="fleet",
                               status=status, req=rid)
        reg = metrics_export._REGISTRY
        if reg is not None:
            reg.observe_request(dt, status)

    def _dispatch(self, x: np.ndarray, deadline_ms, tenant, priority,
                  rid=None):
        """Runs in the pool: route, POST, retry-on-next-member (bounded,
        idempotent predicts only).  Returns (outputs, version,
        latency_s)."""
        t0 = self.clock()
        body = {"inputs": x.tolist(), "timeout_s": self.timeout_s}
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        if tenant is not None:
            body["tenant"] = tenant
        if priority:
            body["priority"] = int(priority)
        tried: set = set()
        last_exc = None
        for _attempt in range(self.retries + 1):
            i = self._pick(exclude=tried)
            if i is None:
                break
            record = self._refresh().get(i)
            if record is None:
                tried.add(i)
                continue
            with self._lock:
                self._inflight[i] = self._inflight.get(i, 0) + 1
                self._routed[i] = self._routed.get(i, 0) + 1
            if rid is not None:
                telemetry.flow_step(rid, hop="front.send", member=i)
            try:
                status, resp = self._post(record, "/v1/predict", body,
                                          request_id=rid)
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                # transport failure: the member died under us (kill -9
                # drill) or never bound — try the next one
                last_exc = e
                tried.add(i)
                with self._lock:
                    self._retried += 1
                telemetry.instant("fleet.retry", cat="fleet", member=i,
                                  error=type(e).__name__)
                if rid is not None:
                    # the failover lands on this request's flow: the
                    # arrow chain shows WHICH member the request lost
                    telemetry.flow_step(rid, hop="fleet.retry", member=i,
                                        error=type(e).__name__)
                continue
            finally:
                with self._lock:
                    self._inflight[i] = max(self._inflight.get(i, 1) - 1, 0)
            if status == 200:
                out = np.asarray(resp["outputs"], np.float32)
                self._finish_flow(rid, t0, "ok")
                return (out, resp.get("version"),
                        float(resp.get("latency_ms", 0.0)) / 1e3)
            err = self._typed(status, resp)
            if err is not None:
                self._finish_flow(rid, t0, type(err).__name__)
                raise err
            # 503 / 5xx: that member is unhealthy or mid-replacement —
            # its supervisor owns it; route around
            last_exc = ServerClosed(resp.get("error") or
                                    f"member {i} answered {status}")
            tried.add(i)
            with self._lock:
                self._retried += 1
            telemetry.instant("fleet.retry", cat="fleet", member=i,
                              status=status)
            if rid is not None:
                telemetry.flow_step(rid, hop="fleet.retry", member=i,
                                    status=status)
        self._finish_flow(rid, t0, "MemberLostError")
        if last_exc is not None and not self._refresh(force=True):
            raise self._no_member()
        if last_exc is not None:
            raise MemberLostError(
                f"fleet: request failed on {len(tried)} member(s) "
                f"({type(last_exc).__name__}: {last_exc}) with retries "
                "exhausted", retry_after_s=1.0)
        raise self._no_member()

    def submit(self, x, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None, priority: int = 0,
               request_id: Optional[str] = None):
        """Admit one sample: returns a handle whose ``result()`` blocks
        on the HTTP round trip (+ bounded failover).  Raises
        :class:`MemberLostError` at ADMISSION when no member is live —
        the typed 503 the replay accounting records as a shed, never a
        silently lost accepted request.  When tracing is on, the front
        mints the request's flow id here (``request_id`` overrides — a
        caller propagating an upstream id) and every hop downstream
        links to it."""
        if self._closed:
            raise ServerClosed("fleet: front tier is closed")
        x = np.asarray(x, np.float32)
        if self._recorder is not None:
            self._recorder.note(x, tenant=tenant, priority=priority,
                                deadline_ms=deadline_ms)
        rid = request_id
        if rid is None:
            rid = telemetry.mint_request_id()  # None when tracing is off
        if rid is not None:
            telemetry.flow_start(rid, hop="front.admit")
        if self._pick() is None:
            if rid is not None:
                telemetry.flow_finish(rid, hop="front.done",
                                      status="MemberLostError")
            raise self._no_member()
        return _FleetHandle(self._pool.submit(
            self._dispatch, x, deadline_ms, tenant, priority, rid))

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    # -- rolling deploy (the DeployController's fleet mode) -------------

    def member_stats(self, index: int) -> Optional[dict]:
        record = self._refresh(force=True).get(index)
        if record is None:
            return None
        try:
            return self._get(record, "/v1/stats")
        except Exception:  # noqa: BLE001 — a stats hiccup is not a
            # verdict; the caller polls
            return None

    def _await_member_canary(self, index: int, vid: int) -> dict:
        """Poll the canary MEMBER's own comparator verdict for version
        `vid` (promoted/rolled_back), bounded by ``decision_timeout``."""
        t0 = self.clock()
        while True:
            st = self.member_stats(index) or {}
            summary = st.get("canary") or {}
            if summary.get("version") == vid and \
                    summary.get("state") in ("promoted", "rolled_back"):
                return dict(summary)
            if 0 < self.decision_timeout < self.clock() - t0:
                return {"state": "timeout", "version": vid}
            time.sleep(0.1)

    def swap(self, source, *, quantized: bool = False,
             canary_fraction: Optional[float] = None,
             max_unavailable: Optional[int] = None) -> int:
        """Fan a release over the fleet: canary on the lowest-index live
        member first (its own comparator decides under real routed
        traffic), then — only on promotion — roll the remaining members
        with at most `max_unavailable` concurrently in-swap.  Members
        keep serving THROUGH their own zero-drop swap; the bound is the
        blast-radius cap, enforced by deprioritizing in-swap members in
        ``_pick`` and by the fan-out batching here.  The verdict lands
        in ``stats()["canary"]`` for the DeployController."""
        live = self._refresh(force=True)
        if not live:
            raise self._no_member()
        order = sorted(live)
        canary_idx = order[0]
        bound = max(1, int(max_unavailable if max_unavailable is not None
                           else self.max_unavailable))
        body = {"source": source if isinstance(source, str) else None,
                "quantized": bool(quantized)}
        if body["source"] is None:
            raise ServeError("fleet: swap source must be a path (the "
                             "members load it in their own processes)")
        telemetry.instant("fleet.deploy", cat="fleet", member=canary_idx,
                          canary=canary_fraction is not None)
        with self._lock:
            self._deploying.add(canary_idx)
        try:
            status, resp = self._post(live[canary_idx], "/v1/swap",
                                      dict(body,
                                           canary_fraction=canary_fraction))
        finally:
            with self._lock:
                self._deploying.discard(canary_idx)
        if status != 200:
            raise ServeError(f"fleet: canary swap on member {canary_idx} "
                             f"failed: {resp.get('error')}")
        vid = int(resp["version"])
        if canary_fraction is not None:
            verdict = self._await_member_canary(canary_idx, vid)
            verdict["member"] = canary_idx
            with self._lock:
                self._last_canary = verdict
            if verdict.get("state") != "promoted":
                # the canary member already rolled itself back; the rest
                # of the fleet never saw the release
                telemetry.instant("fleet.deploy_rollback", cat="fleet",
                                  member=canary_idx, version=vid)
                return vid
        self._roll(source, order[1:], bound, quantized=quantized)
        with self._lock:
            if canary_fraction is None:
                self._last_canary = {"state": "promoted", "version": vid,
                                     "member": canary_idx,
                                     "reason": "full_swap"}
            else:
                self._last_canary = dict(self._last_canary or {},
                                         rolled=len(order))
        return vid

    def _roll(self, source, indices, bound: int, *,
              quantized: bool = False) -> None:
        """Plain rolling swaps over `indices`, at most `bound`
        concurrently in-swap (each member's own swap is zero-drop; the
        bound caps how much of the fleet is warming at once)."""
        body = {"source": source, "quantized": bool(quantized)}
        for start in range(0, len(indices), bound):
            group = list(indices[start:start + bound])
            with self._lock:
                self._deploying.update(group)
                self._deploy_stats["max_concurrent"] = max(
                    self._deploy_stats["max_concurrent"], len(group))
            try:
                live = self._refresh(force=True)
                futures = {i: self._pool.submit(
                    self._post, live[i], "/v1/swap", body)
                    for i in group if i in live}
                for i, f in futures.items():
                    try:
                        status, resp = f.result(timeout=self.timeout_s * 2)
                        ok = status == 200
                    except Exception as e:  # noqa: BLE001 — a member
                        # that died mid-roll is the supervisor's problem;
                        # its replacement swaps on the next release
                        ok, resp = False, {"error": str(e)}
                    telemetry.instant("fleet.deploy_member", cat="fleet",
                                      member=i, ok=ok,
                                      version=resp.get("version"))
                    with self._lock:
                        self._deploy_stats["rolled"] += 1
                    if not ok:
                        logger.warning("fleet: rolling swap on member %d "
                                       "failed: %s", i, resp.get("error"))
            finally:
                with self._lock:
                    self._deploying.difference_update(group)

    # -- traffic trace capture ------------------------------------------

    def record_trace(self, path: Optional[str] = None, *,
                     limit: Optional[int] = None):
        from .tracefile import TraceRecorder
        if self._recorder is not None and (path is None or
                                           self._recorder.path == path):
            return self._recorder
        self._recorder = TraceRecorder(clock=self.clock, limit=limit,
                                       path=path)
        return self._recorder

    def stop_trace(self, path: Optional[str] = None):
        rec, self._recorder = self._recorder, None
        if rec is None:
            return []
        if path or rec.path:
            rec.save(path)
        return rec.events()

    # -- lifecycle / introspection --------------------------------------

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=False)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """InferenceServer-shaped alias (the HTTP front end calls
        ``server.stop()`` at shutdown)."""
        del drain, timeout
        self.close()

    def stats(self) -> dict:
        live = self._refresh()
        with self._lock:
            out = {
                "fleet": {
                    "dir": self.fleet_dir,
                    "live": sorted(live),
                    "members": {str(i): {
                        "generation": r.get("generation"),
                        "pid": r.get("pid"),
                        "port": r.get("port"),
                        "inflight": self._inflight.get(i, 0),
                        "routed": self._routed.get(i, 0),
                    } for i, r in live.items()},
                    "retried": self._retried,
                    "deploy": dict(self._deploy_stats),
                },
                "replicas_live": len(live),
                "healthy": bool(live),
            }
            if self._last_canary is not None:
                out["canary"] = dict(self._last_canary)
        if self._recorder is not None:
            out["trace_recording"] = self._recorder.stats()
        return out

