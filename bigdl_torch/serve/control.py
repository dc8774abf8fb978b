"""Serving control plane: replica lifecycle, canary, tenant quotas.

Counterpart of ``bigdl_tpu/serve/control.py``, all of it:

- :class:`ReplicaMonitor`: every replica worker stamps a local heartbeat;
  the monitor turns a replica whose beats go silent past ``deadline``
  (``BIGDL_TORCH_SERVE_REPLICA_LOST``), or whose thread died, into a
  typed :class:`ReplicaLostError`, condemns the old thread (a zombie that
  wakes later hands its held batch back to the queue and exits) and, after
  an exponential backoff, has the server respawn it on a fresh forward of
  the current version with its bucket ladder warmed again.  Restarts per
  replica are bounded (``SERVE_RESTART_BUDGET``); past the budget the
  server turns unhealthy (``/healthz`` answers 503).  A restarted replica
  runs the same kernels: nothing here moves it to another route.
- :class:`CanaryController`: ``swap(source, canary_fraction=f)`` sends a
  deterministic share ``f`` of device batches to the new version while a
  rolling window compares p99 latency and error rate with the incumbent's:
  a regression past ``SERVE_CANARY_LATENCY_RATIO`` or
  ``SERVE_CANARY_ERROR_MARGIN`` rolls it back with a typed
  :class:`CanaryRejected` in ``stats()``, ``SERVE_CANARY_MIN_BATCHES``
  clean batches promote it.  A batch's time runs to its answer on the
  host, so on an asynchronous device it is the device's time too.
- :class:`TenantQuotas`: per-tenant token buckets
  (``SERVE_TENANT_QPS`` / ``_BURST``) refuse an over-quota tenant with a
  typed :class:`QuotaExceeded` carrying ``retry_after_s`` (HTTP 429 and
  Retry-After); the batcher sheds the lowest priority first under queue
  pressure.

Fault points (``utils/chaos.py``): ``serve.replica@<idx>`` fires once per
non-empty batch replica ``idx`` collects (``exit@c`` ends just that
worker thread, which requeues its batch first; ``wedge*N@c`` blocks it);
``serve.canary`` once per canary batch (``stall*S@c`` inflates its
latency, ``fail@c`` its error rate).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional

from ..utils import telemetry
from .batcher import ServeError, ServerOverloaded

logger = logging.getLogger("bigdl_torch")

__all__ = ["ReplicaLostError", "CanaryRejected", "QuotaExceeded",
           "ReplicaExit", "TenantQuotas", "CanaryController",
           "ReplicaMonitor"]


class ReplicaLostError(ServeError):
    """A replica worker died or went heartbeat-silent past
    ``SERVE_REPLICA_LOST``.  The monitor restarts it (bounded budget);
    the error surfaces in ``stats()`` / queued requests only when the
    pool is beyond recovery (restart budget exhausted)."""


class CanaryRejected(ServeError):
    """The canary comparator rolled a candidate version back: its rolling
    p99 latency or error rate regressed past the configured thresholds.
    Recorded (typed) in ``stats()["canary"]`` — the canary never served
    more than its configured fraction and never became the incumbent."""


class QuotaExceeded(ServerOverloaded):
    """A tenant exceeded its token-bucket admission quota.  A kind of
    :class:`ServerOverloaded`; ``retry_after_s`` says when the bucket next
    has a token."""


class ReplicaExit(BaseException):
    """Internal chaos-drill signal: the ``serve.replica@<idx>`` point's
    ``exit`` action kills exactly one worker THREAD (unlike the
    process-level ``host.lost`` drill).  BaseException so the replica
    loop's broad ``except Exception`` backstop cannot swallow it; the
    worker requeues any held batch, then lets the thread die — the
    monitor detects the dead thread and respawns."""


# ---------------------------------------------------------------------------
# per-tenant token buckets
# ---------------------------------------------------------------------------


class TenantQuotas:
    """Per-tenant token-bucket admission quotas.

    Each tenant owns a bucket refilled at ``qps`` tokens a second up to
    ``burst`` (default ``max(2 * qps, 1)``); one admission takes one token.
    An empty bucket raises :class:`QuotaExceeded` with ``retry_after_s`` =
    seconds until the next token, so one chatty tenant exhausts its own
    quota instead of the shared queue.  ``qps <= 0`` admits everything.
    Clock-injectable."""

    def __init__(self, qps: float, burst: Optional[float] = None,
                 clock=None):
        self.qps = float(qps)
        self.burst = float(burst) if burst and float(burst) > 0 \
            else max(2.0 * self.qps, 1.0)
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._buckets: Dict[str, tuple] = {}  # tenant -> (tokens, stamp)
        self.denied = 0
        self.denied_by_tenant: Dict[str, int] = {}

    def admit(self, tenant: Optional[str]) -> None:
        """Take one token from ``tenant``'s bucket (created full on first
        sight); raise :class:`QuotaExceeded` when it is empty."""
        if self.qps <= 0:
            return
        key = tenant or "default"
        now = self.clock()
        with self._lock:
            tokens, stamp = self._buckets.get(key, (self.burst, now))
            tokens = min(self.burst, tokens + (now - stamp) * self.qps)
            if tokens >= 1.0:
                self._buckets[key] = (tokens - 1.0, now)
                return
            self._buckets[key] = (tokens, now)
            self.denied += 1
            self.denied_by_tenant[key] = \
                self.denied_by_tenant.get(key, 0) + 1
            retry = (1.0 - tokens) / self.qps
        raise QuotaExceeded(
            f"serve: tenant {key!r} over quota ({self.qps:g} req/s, "
            f"burst {self.burst:g}); retry in {retry:.3f}s",
            retry_after_s=retry)

    def stats(self) -> dict:
        with self._lock:
            return {"qps": self.qps, "burst": self.burst,
                    "denied": self.denied,
                    "denied_by_tenant": dict(self.denied_by_tenant)}


# ---------------------------------------------------------------------------
# canary comparator
# ---------------------------------------------------------------------------


def _p99(values) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    return vs[min(int(0.99 * len(vs)), len(vs) - 1)]


class CanaryController:
    """Weighted routing + rolling p99/error comparator for one candidate
    :class:`~bigdl_torch.serve.server.ModelVersion`.

    All methods are called under the server's data-path lock (brief):
    routing and observation are deterministic, no RNG, no internal lock.

    Routing: :meth:`route` admits the canary for batch ``k`` only while
    ``routed/total <= fraction`` stays true AFTER the admission — the
    canary can never serve more than its fraction.

    Decision: from the canary's 2nd batch every observation runs the
    ROLLBACK comparators (error rate beyond the incumbent's +
    ``error_margin``; rolling-window p99 beyond ``latency_ratio`` x the
    incumbent's).  PROMOTION needs ``min_batches`` clean canary batches
    AND an equal incumbent observation window — fast-fail, slow-promote.
    """

    def __init__(self, version, fraction: float, *, min_batches: int = 8,
                 window: int = 64, latency_ratio: float = 2.0,
                 error_margin: float = 0.05):
        if not 0.0 < float(fraction) < 1.0:
            raise ValueError(
                f"serve: canary_fraction must be in (0, 1), got {fraction} "
                "(use a plain swap() for a full cutover)")
        self.version = version
        self.fraction = float(fraction)
        self.min_batches = max(int(min_batches), 2)
        self.latency_ratio = float(latency_ratio)
        self.error_margin = float(error_margin)
        self.state = "running"        # running | promoted | rolled_back
        self.reason: Optional[CanaryRejected] = None
        self.routed = 0               # batches sent to the canary
        self.total = 0                # batches routed while running
        self._lat = {False: collections.deque(maxlen=int(window)),
                     True: collections.deque(maxlen=int(window))}
        self._batches = {False: 0, True: 0}
        self._errors = {False: 0, True: 0}

    # -- routing --------------------------------------------------------

    def route(self) -> bool:
        """True when the NEXT batch goes to the canary (deterministic
        counter-based weighting, admissible only while the realized
        fraction stays <= the configured one)."""
        self.total += 1
        if self.routed + 1 <= self.fraction * self.total:
            self.routed += 1
            return True
        return False

    # -- comparator -----------------------------------------------------

    def observe(self, is_canary: bool, dur_s: float,
                errored: bool) -> Optional[str]:
        """Record one finished batch; return ``"promote"``,
        ``"rollback"`` (with :attr:`reason` set), or None (keep
        running)."""
        self._batches[is_canary] += 1
        if errored:
            self._errors[is_canary] += 1
        else:
            self._lat[is_canary].append(float(dur_s))
        nc, nb = self._batches[True], self._batches[False]
        if nc < 2 or nb < 1:
            return None
        err_c = self._errors[True] / nc
        err_b = self._errors[False] / nb
        p99_c, p99_b = _p99(self._lat[True]), _p99(self._lat[False])
        telemetry.counter(
            "serve.canary", err_rate_canary=round(err_c, 4),
            err_rate_base=round(err_b, 4),
            p99_canary_ms=round(p99_c * 1e3, 3) if p99_c else 0.0,
            p99_base_ms=round(p99_b * 1e3, 3) if p99_b else 0.0)
        if err_c > err_b + self.error_margin:
            self.reason = CanaryRejected(
                f"canary v{self.version.id} error rate {err_c:.3f} vs "
                f"incumbent {err_b:.3f} (margin {self.error_margin}) "
                f"after {nc} canary batches")
            return "rollback"
        if (p99_c is not None and p99_b is not None and
                len(self._lat[True]) >= 2 and len(self._lat[False]) >= 2
                and p99_c > p99_b * self.latency_ratio):
            self.reason = CanaryRejected(
                f"canary v{self.version.id} p99 {p99_c * 1e3:.1f}ms vs "
                f"incumbent {p99_b * 1e3:.1f}ms (ratio bound "
                f"{self.latency_ratio}) after {nc} canary batches")
            return "rollback"
        if nc >= self.min_batches and nb >= self.min_batches:
            return "promote"
        return None

    def summary(self) -> dict:
        """The ``stats()["canary"]`` blob (also the terminal record kept
        after promotion/rollback)."""
        out = {"state": self.state, "version": self.version.id,
               "fraction": self.fraction, "routed": self.routed,
               "total": self.total,
               "batches": {"canary": self._batches[True],
                           "incumbent": self._batches[False]},
               "errors": {"canary": self._errors[True],
                          "incumbent": self._errors[False]}}
        if self.reason is not None:
            out["reason"] = str(self.reason)
            out["reason_type"] = type(self.reason).__name__
        return out


# ---------------------------------------------------------------------------
# replica lifecycle monitor
# ---------------------------------------------------------------------------


class ReplicaMonitor:
    """Background watchdog over the server's replica pool (one daemon
    thread, started by ``InferenceServer.start()`` when
    ``SERVE_REPLICA_LOST`` > 0).

    Detection: a replica whose local heartbeat stamp is silent past
    ``deadline`` seconds (a wedged device call, an uninterruptible chaos
    wedge), or whose thread is no longer alive (crashed, chaos exit
    drill).  Reaction: condemn the old generation (the server bumps the
    replica's generation so a zombie that wakes later requeues its held
    batch and exits), then — after an exponential per-replica backoff —
    respawn via ``server._restart_replica`` (fresh engine, bucket ladder
    warmed again).  Budget: more than ``budget``
    restarts of one replica marks the server unhealthy instead of
    looping forever.

    Uses the server's (injectable) batcher clock for silence/backoff
    arithmetic; the poll cadence itself is wall-clock (daemon wait)."""

    def __init__(self, server, deadline: float, *, budget: int = 3,
                 backoff: float = 0.1, poll: Optional[float] = None):
        self._server = server
        self.deadline = float(deadline)
        self.budget = int(budget)
        self.backoff = float(backoff)
        self.clock = server.batcher.clock
        self.poll = poll if poll is not None else \
            min(max(self.deadline / 4.0, 0.02), 1.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pending: Dict[int, float] = {}   # idx -> earliest respawn
        self._counts: Dict[int, int] = {}      # idx -> restarts so far
        self.lost = 0
        self.events: List[dict] = []

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ReplicaMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="bigdl-serve-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None

    # -- the monitor loop -----------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll):
            try:
                self._check()
            except Exception:  # noqa: BLE001 — the watchdog must outlive
                # any single broken respawn/warmup
                logger.exception("serve monitor error (non-fatal)")

    def _check(self) -> None:
        srv = self._server
        if srv.batcher.closed:
            return
        now = self.clock()
        for idx, st in list(srv._replica.items()):
            if idx >= srv.replicas:
                # retired by a pool shrink (serve/autoscale.py): a slot
                # the autoscaler deliberately emptied is not a lost
                # replica — healing it back would fight the controller
                # and burn restart budget
                self._pending.pop(idx, None)
                continue
            due = self._pending.get(idx)
            if due is not None:
                # condemned and waiting out its backoff: respawn when due
                if now >= due:
                    self._pending.pop(idx, None)
                    srv._restart_replica(idx)
                continue
            thread, last = st[0], st[2]
            if thread is None:
                continue
            dead = not thread.is_alive()
            silent = self.deadline > 0 and (now - last) > self.deadline
            if not dead and not silent:
                continue
            age = now - last
            err = ReplicaLostError(
                f"serve: replica {idx} "
                + ("thread died"
                   if dead else f"heartbeat silent {age:.2f}s "
                                f"(deadline {self.deadline:g}s)"))
            self.lost += 1
            self._counts[idx] = self._counts.get(idx, 0) + 1
            n = self._counts[idx]
            self.events.append(
                {"replica": idx, "dead": dead,
                 "age_seconds": round(age, 3), "restart": n,
                 "error_type": type(err).__name__, "error": str(err)})
            telemetry.instant("serve.replica_lost", cat="serve",
                              replica=idx, dead=dead,
                              age_s=round(age, 3), restart=n)
            logger.error("%s — %s", err,
                         "restart budget exhausted; flipping unhealthy"
                         if n > self.budget else
                         f"restart {n}/{self.budget} scheduled")
            srv._condemn_replica(idx)
            if n > self.budget:
                srv._mark_unhealthy(err)
                continue
            # exponential backoff: a replica that keeps dying backs off
            # 1x, 2x, 4x... the base before each respawn attempt
            self._pending[idx] = now + self.backoff * (2 ** (n - 1))

    def stats(self) -> dict:
        return {"lost": self.lost,
                "restarts": dict(self._counts),
                "budget": self.budget,
                "deadline_seconds": self.deadline,
                "events": list(self.events[-8:])}
