"""Queue-driven replica autoscaling: the serving pool follows offered load.

Counterpart of ``bigdl_tpu/serve/autoscale.py``, all of it.  An
:class:`AutoScaler` grows an ``InferenceServer``'s pool when the estimated
queue wait passes a target and shrinks it after a sustained idle window.
Its signals are ones the server keeps anyway:

- queue depth, ``DynamicBatcher.depth()``;
- the EMA service seconds a row, ``DynamicBatcher.service_row_seconds()``
  (the estimate behind ``retry_after_s``);
- the server's served-batch count (idle = nothing queued and no batch
  finished over the whole idle window).

The rule, with hysteresis on both edges and a cooldown between actions::

    est_wait = depth * row_seconds_ema / live_replicas
    est_wait > target for UP_POLLS consecutive polls  -> scale UP by STEP
    idle (depth == 0, no batches) for IDLE_S seconds  -> scale DOWN by 1

The pool stays in [min, max]; a shrink retires the highest slots (the
``ReplicaMonitor`` skips retired slots, so a scale-down is never healed
back); an unhealthy server (restart budget spent) freezes the controller.
Scale-up adds worker threads over the current version's forward, whose
bucket ladder was warmed at start or swap: no new shape reaches the card.

Each decision is a ``serve.autoscale`` instant, each poll a sample of the
``serve.autoscale`` counter track, and ``stats()["autoscale"]`` keeps the
last events.

Knobs (``BIGDL_TORCH_SERVE_AUTOSCALE_*``; constructor arguments override):

| env var | meaning | default |
|---|---|---|
| ``..._MAX`` | pool size ceiling; > 0 arms the controller | 0 (off) |
| ``..._MIN`` | pool size floor | initial replicas |
| ``..._TARGET_WAIT_MS`` | est. queue wait that triggers growth | 50 |
| ``..._UP_POLLS`` | consecutive over-target polls before growing | 2 |
| ``..._IDLE_S`` | sustained-idle seconds before one shrink step | 2.0 |
| ``..._COOLDOWN_S`` | minimum seconds between scale actions | 0.5 |
| ``..._STEP`` | replicas added per scale-up (shrink is always 1) | 1 |
| ``..._POLL_S`` | controller poll cadence seconds | 0.05 |

The decisions run on the target's injectable clock (tests drive
:meth:`AutoScaler.check` with a fake one); only the poll cadence is wall
clock, a daemon thread, as for the ``ReplicaMonitor``.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from ..utils import config, telemetry

logger = logging.getLogger("bigdl_torch")

__all__ = ["AutoScaler", "autoscale_knobs"]


def autoscale_knobs(initial_replicas: int, overrides: Optional[dict] = None
                    ) -> dict:
    """Resolve the ``BIGDL_TORCH_SERVE_AUTOSCALE_*`` env tier into the
    AutoScaler constructor kwargs; ``overrides`` (constructor args, None
    = unset) win per key.  ``max_replicas <= 0`` means "controller off"
    — the server checks that before arming."""
    ov = {k: v for k, v in (overrides or {}).items() if v is not None}
    return {
        "min_replicas": int(ov.get(
            "min_replicas",
            config.get_int("SERVE_AUTOSCALE_MIN", initial_replicas))),
        "max_replicas": int(ov.get(
            "max_replicas", config.get_int("SERVE_AUTOSCALE_MAX", 0))),
        "target_wait_ms": float(ov.get(
            "target_wait_ms",
            config.get_float("SERVE_AUTOSCALE_TARGET_WAIT_MS", 50.0))),
        "up_polls": int(ov.get(
            "up_polls", config.get_int("SERVE_AUTOSCALE_UP_POLLS", 2))),
        "idle_s": float(ov.get(
            "idle_s", config.get_float("SERVE_AUTOSCALE_IDLE_S", 2.0))),
        "cooldown_s": float(ov.get(
            "cooldown_s",
            config.get_float("SERVE_AUTOSCALE_COOLDOWN_S", 0.5))),
        "step": int(ov.get(
            "step", config.get_int("SERVE_AUTOSCALE_STEP", 1))),
        "poll_s": float(ov.get(
            "poll_s", config.get_float("SERVE_AUTOSCALE_POLL_S", 0.05))),
    }


class AutoScaler:
    """Queue-wait-driven pool-size controller (see module docstring).

    ``target`` is anything with the scale protocol:

    - ``autoscale_signals() -> {"depth", "row_s_ema", "batches", "live"}``
      (queued rows, EMA seconds/row or None, cumulative served batches,
      live replica count),
    - ``scale_to(n)`` — grow/shrink the pool to ``n`` replicas,
    - ``replicas`` — the current pool target size,
    - ``healthy()`` — False freezes the controller,

    implemented by :class:`~bigdl_torch.serve.server.InferenceServer`
    (worker threads over one shared queue)."""

    def __init__(self, target, *, min_replicas: int, max_replicas: int,
                 target_wait_ms: float = 50.0, up_polls: int = 2,
                 idle_s: float = 2.0, cooldown_s: float = 0.5,
                 step: int = 1, poll_s: float = 0.05, clock=None):
        if max_replicas < min_replicas:
            raise ValueError(
                f"serve: autoscale max ({max_replicas}) < min "
                f"({min_replicas})")
        if min_replicas < 1:
            raise ValueError(f"serve: autoscale min must be >= 1, got "
                             f"{min_replicas}")
        self.target = target
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.target_wait_s = float(target_wait_ms) / 1000.0
        self.up_polls = max(int(up_polls), 1)
        self.idle_s = float(idle_s)
        self.cooldown_s = float(cooldown_s)
        self.step = max(int(step), 1)
        self.poll_s = float(poll_s)
        self.clock = clock or getattr(
            getattr(target, "batcher", None), "clock", None)
        if self.clock is None:
            import time
            self.clock = time.monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # decision state (single controller thread; check() under test)
        self._over_target = 0          # consecutive over-target polls
        self._last_action: Optional[float] = None
        self._last_busy: Optional[float] = None
        self._last_batches: Optional[int] = None
        self._last_wait_s = 0.0
        self.scale_ups = 0
        self.scale_downs = 0
        self.events: List[dict] = []

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "AutoScaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="bigdl-serve-autoscaler")
        self._thread.start()
        logger.info("serve: autoscaler armed — replicas in [%d, %d], "
                    "target wait %.0fms, idle window %.1fs",
                    self.min_replicas, self.max_replicas,
                    self.target_wait_s * 1e3, self.idle_s)
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the controller must
                # outlive any single broken poll (a member mid-teardown,
                # a telemetry sink error)
                logger.exception("serve autoscaler error (non-fatal)")

    # -- the decision step ----------------------------------------------

    def check(self, now: Optional[float] = None) -> Optional[str]:
        """One controller poll: read signals, maybe act.  Returns
        ``"up"`` / ``"down"`` when a scale action fired, else None.
        Tests drive this directly with a fake clock."""
        now = self.clock() if now is None else now
        if not self.target.healthy():
            # restart budget spent: the control plane already decided
            # this host needs replacing — resizing a broken pool would
            # only mask the signal (and burn more restart budget)
            return None
        sig = self.target.autoscale_signals()
        depth = int(sig.get("depth", 0))
        row_s = sig.get("row_s_ema") or 0.0
        live = max(int(sig.get("live", 0)), 1)
        batches = int(sig.get("batches", 0))
        cur = int(self.target.replicas)
        est_wait = depth * row_s / live
        self._last_wait_s = est_wait
        # busy = anything queued, or a batch completed since last poll
        busy = depth > 0 or (self._last_batches is not None
                             and batches != self._last_batches)
        self._last_batches = batches
        if busy or self._last_busy is None:
            self._last_busy = now
        telemetry.counter("serve.autoscale", replicas=cur,
                          est_wait_ms=round(est_wait * 1e3, 3),
                          queue_depth=depth)
        in_cooldown = (self._last_action is not None and
                       now - self._last_action < self.cooldown_s)
        # -- grow: sustained over-target queue wait ---------------------
        if est_wait > self.target_wait_s and depth > 0:
            self._over_target += 1
            if (self._over_target >= self.up_polls and cur <
                    self.max_replicas and not in_cooldown):
                n = min(cur + self.step, self.max_replicas)
                self._act(now, "up", n, est_wait, depth)
                return "up"
            return None
        self._over_target = 0
        # -- shrink: a full idle window with nothing queued or served ---
        if (not busy and cur > self.min_replicas and not in_cooldown and
                now - self._last_busy >= self.idle_s):
            n = cur - 1
            self._act(now, "down", n, est_wait, depth)
            # restart the idle window: gradual decay, one step per
            # idle_s, instead of collapsing straight to min
            self._last_busy = now
            return "down"
        return None

    def _act(self, now: float, direction: str, n: int, est_wait: float,
             depth: int) -> None:
        prev = int(self.target.replicas)
        self.target.scale_to(n)
        self._last_action = now
        self._over_target = 0
        if direction == "up":
            self.scale_ups += 1
        else:
            self.scale_downs += 1
        event = {"direction": direction, "from": prev, "to": n,
                 "est_wait_ms": round(est_wait * 1e3, 3),
                 "queue_depth": depth}
        self.events.append(event)
        del self.events[:-16]
        telemetry.instant("serve.autoscale", cat="serve", **event)
        telemetry.counter("serve.autoscale", replicas=n,
                          est_wait_ms=round(est_wait * 1e3, 3),
                          queue_depth=depth)
        logger.info("serve: autoscale %s %d -> %d (est wait %.1fms vs "
                    "target %.1fms, depth %d)", direction.upper(), prev,
                    n, est_wait * 1e3, self.target_wait_s * 1e3, depth)

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        return {"replicas": int(self.target.replicas),
                "min": self.min_replicas, "max": self.max_replicas,
                "target_wait_ms": round(self.target_wait_s * 1e3, 3),
                "est_wait_ms": round(self._last_wait_s * 1e3, 3),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "events": list(self.events[-8:])}
