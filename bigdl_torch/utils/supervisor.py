"""Training-run supervision: the stall watchdog and peer liveness.

Counterpart of ``bigdl_tpu/utils/supervisor.py``.  A run that hangs (a data source that never returns, a
step that never finishes) raises nothing, so the checkpoint lineage never
gets to recover it; the :class:`Supervisor` turns such a hang into a typed
:class:`StallError`.

- The supervised loop beats phase-tagged heartbeats
  (``beat("data" | "step" | "compile" | "checkpoint" | "validation")``); a
  monitor thread holds each phase to its deadline (the constructor, else
  the ``BIGDL_TORCH_SUPERVISE_<PHASE>`` / ``_SUPERVISE_DEADLINE`` knobs).
  The clock is injectable, so tests run without waiting.
- On a missed deadline it writes a JSON crash report (every thread's
  stack, the beat timeline, ``chaos.counts()``, platform info with the
  CUDA device's name, index and driver) through ``file_io`` into
  ``report_dir``, then acts: ``raise`` (default) async-raises a
  :class:`StallError` into the thread that beat last, which the
  Optimizer's retry loop recovers from the lineage; ``exit`` hard-exits
  (``os._exit(86)``); an ``on_stall`` callback takes over instead.
- Channels (:meth:`Supervisor.channel`): a background worker of the loop
  (the prefetch worker, ``dataset/prefetch.py``) beats its own slot under
  the same deadlines; a stall there is raised into the worker, which
  forwards it to the consumer's ``next()``.

An async raise lands at the thread's next Python bytecode.  A thread
blocked inside one C call (``torch.cuda.synchronize()``, or ``.item()``
behind a kernel that never ends) never reaches one, so ``raise`` cannot
free it; that is what the ``exit`` policy is for.

Peer liveness (the reference's ``:643-929``), for ranks that share a
store: each process's monitor thread publishes ``<peer_dir>/heartbeat.
<rank>`` (JSON: the supervised thread's last beat wall time ``time``, the
monitor's own publication time ``published``, the heartbeat
``generation``) through ``file_io``, retried on the next poll when a write
fails (``heartbeat_errors``).  A peer whose BEAT is older than
``peer_stale`` is stale (logged, ``on_peer_stale`` once per episode, its
age on the ``peers`` counter track, named in crash reports).  With
``peer_lost`` > 0 (``BIGDL_TORCH_ELASTIC_PEER_LOST``) a peer whose
PUBLICATION is silent that long is a lost host: a rank that is stuck in a
step still publishes, only a dead one goes silent.  The monitor publishes
the ``elastic/recover.<rank>`` intent (``parallel/elastic.py``) and
async-raises :class:`~bigdl_torch.parallel.elastic.PeerLostError` into
the supervised thread, as it does a StallError; another survivor's intent
promotes the same loss at the next poll.  :meth:`Supervisor.reform`
installs the topology after the recovery, keeps watching the lost peers'
frozen files for a RETURN (a higher generation, :meth:`returned_peers`,
``on_peer_returned`` once per episode), and holds promotion for
``BIGDL_TORCH_ELASTIC_REFORM_GRACE`` seconds while every member rebuilds.

Knobs (``utils/config.py``): ``BIGDL_TORCH_SUPERVISE_DATA`` / ``_STEP`` /
``_COMPILE`` / ``_CHECKPOINT`` / ``_VALIDATION`` / ``_SERVE`` (seconds, 0 =
unwatched), ``_SUPERVISE_DEADLINE`` (the default), ``_SUPERVISE_POLICY``
(``raise`` or ``exit``), ``_SUPERVISE_PEER_STALE`` (60),
``_ELASTIC_PEER_LOST`` (0, off), ``_ELASTIC_REFORM_GRACE`` (2).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from . import chaos, config

logger = logging.getLogger("bigdl_torch")

__all__ = ["StallError", "Supervisor", "PHASES", "notify", "set_active",
           "get_active", "env_deadlines"]

#: the optimizer loop's heartbeat phases.  "compile" tags the first step
#: of each attempt (the reference's XLA compile; here the first launches
#: build the CUDA kernels) and is unwatched unless given its own deadline.
#: "serve" is the serving replicas' phase.
PHASES = ("data", "step", "compile", "checkpoint", "validation", "serve")

# PyThreadState_SetAsyncExc raises the exception CLASS with no args in the
# target thread; the class pulls its message from here so the StallError
# the optimizer catches still names the phase/deadline/stale peers.
_LAST_STALL = {"message": None}


class StallError(RuntimeError):
    """A supervision deadline was missed: the run is hung, not crashed.

    Raised (asynchronously) into the supervised thread so the optimizer's
    retry loop treats the hang like any transient failure — recover from
    the checkpoint lineage and continue."""

    def __init__(self, *args):
        if not args and _LAST_STALL["message"]:
            args = (_LAST_STALL["message"],)
        super().__init__(*args or
                         ("training run stalled (supervision deadline "
                          "missed)",))


def _async_raise(thread_id: int, exc_class) -> bool:
    """Schedule `exc_class` to be raised in `thread_id` at its next
    bytecode boundary (CPython PyThreadState_SetAsyncExc)."""
    import ctypes
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(exc_class))
    if res > 1:  # delivered to >1 thread state: undo, report failure
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_id), None)
        return False
    return res == 1


def env_deadlines():
    """(per-phase deadlines dict, default deadline or None) from the
    ``BIGDL_TORCH_SUPERVISE_*`` knobs."""
    deadlines = {}
    for phase in PHASES:
        v = config.get_float("SUPERVISE_" + phase.upper(), 0.0)
        if v > 0:
            deadlines[phase] = v
    default = config.get_float("SUPERVISE_DEADLINE", 0.0)
    return deadlines, (default if default > 0 else None)


# the process-default supervisor: helpers deep in a call chain refresh it
# through notify() without a handle passed down to them
_ACTIVE: Optional["Supervisor"] = None


def set_active(sup: Optional["Supervisor"]) -> None:
    global _ACTIVE
    _ACTIVE = sup


def get_active() -> Optional["Supervisor"]:
    return _ACTIVE


def notify(phase: Optional[str] = None) -> None:
    """Heartbeat the process-default supervisor (no-op when none is
    active).  phase=None refreshes the current phase's timer without
    changing it — the generic progress-callback semantic."""
    sup = _ACTIVE
    if sup is not None:
        sup.beat(phase)


class _Channel:
    """Heartbeat handle for one auxiliary supervised thread (see
    Supervisor.channel).  beat(None) refreshes the timer without changing
    the phase; close() retires the slot (idempotent)."""

    __slots__ = ("_sup", "name")

    def __init__(self, sup: "Supervisor", name: str):
        self._sup = sup
        self.name = name

    def beat(self, phase: Optional[str] = None) -> None:
        self._sup._beat_channel(self.name, phase)

    def close(self) -> None:
        self._sup._close_channel(self.name)


def _platform_info() -> dict:
    """The environment for the crash report, taken when the Supervisor is
    made: the monitor thread never touches the device (a hung card may be
    why it reports).  The CUDA device's name, index and driver where the
    process has initialised CUDA."""
    import platform as _platform
    info = {"python": sys.version.split()[0],
            "platform": _platform.platform(),
            "pid": os.getpid()}
    torch = sys.modules.get("torch")
    if torch is None:
        return info
    info["torch"] = torch.__version__
    info["cuda_runtime"] = torch.version.cuda
    try:
        if torch.cuda.is_initialized():
            i = torch.cuda.current_device()
            info["cuda_device"] = {"index": i,
                                   "name": torch.cuda.get_device_name(i)}
            drv = getattr(torch._C, "_cuda_getDriverVersion", None)
            if drv is not None:
                info["cuda_device"]["driver"] = drv()
    except Exception as e:  # noqa: BLE001 - the report must still be made
        info["cuda_device"] = f"unavailable ({type(e).__name__}: {e})"
    return info




class Supervisor:
    """Phase-tagged heartbeat watchdog with per-phase deadlines::

        sup = Supervisor({"step": 120, "data": 60}, report_dir=ckpt_dir)
        sup.start()
        sup.beat("data"); batch = next(it)
        sup.beat("step"); loss = step(batch)
        sup.stop()

    Deadline lookup: the phase's own, else that of the part before ``:``
    (``compile:resnet50``), else ``default_deadline``; None or 0 leaves the
    phase unwatched.  ``peer_dir``, ``rank`` and ``world`` arm the peer
    liveness of the module docstring, ``lineage_dir`` (the checkpoint
    path) with ``peer_lost`` the elastic promotion.  ``sleep`` is the
    reference's injectable sleep, which no path here calls."""

    def __init__(self, deadlines: Optional[Dict[str, float]] = None,
                 default_deadline: Optional[float] = None, *,
                 report_dir: Optional[str] = None,
                 policy: Optional[str] = None,
                 on_stall: Optional[Callable[[dict], bool]] = None,
                 poll_interval: Optional[float] = None,
                 clock=None, sleep=None, wall_clock=None,
                 peer_dir: Optional[str] = None,
                 rank: int = 0, world: int = 1,
                 peer_stale: Optional[float] = None,
                 publish_interval: Optional[float] = None,
                 peer_lost: Optional[float] = None,
                 lineage_dir: Optional[str] = None,
                 on_peer_stale: Optional[Callable[[int, float],
                                                  None]] = None,
                 on_peer_returned: Optional[Callable[[int, int],
                                                     None]] = None,
                 generation: int = 0,
                 name: str = "bigdl-supervisor",
                 timeline_len: int = 64):
        del sleep
        self.deadlines = dict(deadlines or {})
        self.default_deadline = default_deadline
        self.report_dir = report_dir
        self.policy = policy or config.get_str("SUPERVISE_POLICY", "raise")
        if self.policy not in ("raise", "exit"):
            # a typo would otherwise leave a wedged run hanging
            raise ValueError(f"supervisor: unknown policy {self.policy!r} "
                             "(expected 'raise' or 'exit')")
        self.on_stall = on_stall
        self.clock = clock or time.monotonic
        self.wall_clock = wall_clock or time.time
        self.poll_interval = poll_interval
        self.peer_dir = peer_dir
        self.rank, self.world = int(rank), int(world)
        self.peer_stale = (peer_stale if peer_stale is not None
                           else config.get_float("SUPERVISE_PEER_STALE",
                                                 60.0))
        self.publish_interval = publish_interval
        # publication silence that promotes a peer to lost (0 = off)
        self.peer_lost = (peer_lost if peer_lost is not None
                          else config.get_float("ELASTIC_PEER_LOST", 0.0))
        # after a re-form every member rebuilds its step; silence inside
        # this window is that, not a death
        self.reform_grace = config.get_float("ELASTIC_REFORM_GRACE", 2.0)
        self._promotion_grace_until = 0.0
        #: the checkpoint path whose ``elastic/`` holds the protocol files
        self.lineage_dir = lineage_dir
        self.on_peer_stale = on_peer_stale
        self.on_peer_returned = on_peer_returned
        #: stamped into this rank's heartbeat; a joiner bumps it past its
        #: previous life's
        self.generation = int(generation)
        self.elastic_epoch = 0      # completed elastic recovery rounds
        self.heartbeat_errors = 0   # failed (retried) heartbeat publishes
        self._publish_suspended = False
        # ranks recovered away from -> the generation their return must
        # exceed
        self._lost_peers: Dict[int, int] = {}
        self._returned_peers: Dict[int, int] = {}
        self._peer_gens: Dict[int, int] = {}
        self._peer_lost_pending = False
        self._lost_candidates: Dict[int, float] = {}
        self._last_publish = None
        self._stale_peers: Dict[int, float] = {}
        self.name = name
        self._platform = _platform_info()
        self._lock = threading.Lock()
        self._timeline = collections.deque(maxlen=timeline_len)
        self._count = 0
        self._last = ("init", self.clock())
        self._thread_id = threading.get_ident()
        # auxiliary supervised threads: key -> [phase, last beat,
        # thread id, beats], each held to the deadlines on its own, apart
        # from the main slot, so neither can mask the other's stall
        self._channels: Dict[str, list] = {}
        self._chan_seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reports = []   # crash-report paths written
        self.stalls = 0     # deadlines missed

    # -- heartbeats -----------------------------------------------------

    def beat(self, phase: Optional[str] = None) -> None:
        """Record liveness.  ``phase`` tags what the supervised thread is
        about to do; None keeps the current phase.  The thread that beat
        last is the one a ``raise`` stall targets."""
        now = self.clock()
        with self._lock:
            if phase is None:
                phase = self._last[0]
            self._last = (phase, now)
            self._count += 1
            self._timeline.append((phase, self._count, now,
                                   self.wall_clock()))
            self._thread_id = threading.get_ident()

    def channel(self, name: str, phase: str = "data") -> "_Channel":
        """A heartbeat slot of its own for a background worker of the
        loop, held to the same per-phase deadlines; a missed deadline
        raises the StallError into the worker's thread.  ``close()`` the
        handle when the worker retires, or its silence reads as a
        stall."""
        with self._lock:
            self._chan_seq += 1
            key = f"{name}#{self._chan_seq}"
            self._channels[key] = [phase, self.clock(), None, 0]
        return _Channel(self, key)

    def _beat_channel(self, key: str, phase: Optional[str]) -> None:
        now = self.clock()
        with self._lock:
            st = self._channels.get(key)
            if st is None:
                return
            st[0] = phase if phase is not None else st[0]
            st[1] = now
            st[2] = threading.get_ident()
            st[3] += 1

    def _close_channel(self, key: str) -> None:
        with self._lock:
            self._channels.pop(key, None)

    def deadline_for(self, phase: str) -> Optional[float]:
        if phase in self.deadlines:
            return self.deadlines[phase]
        root = phase.split(":", 1)[0]
        if root in self.deadlines:
            return self.deadlines[root]
        return self.default_deadline

    def set_deadlines(self, default: Optional[float] = None,
                      phases: Optional[Dict[str, float]] = None) -> None:
        if default is not None:
            self.default_deadline = default
        if phases:
            self.deadlines.update(phases)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Supervisor":
        if self._thread is not None:
            return self
        self._stop.clear()
        with self._lock:  # a stale beat from before start must not fire
            self._last = (self._last[0], self.clock())
        if self.poll_interval is None:
            cands = [d for d in (*self.deadlines.values(),
                                 self.default_deadline) if d]
            if self.peer_lost > 0 and self.peer_dir and self.world > 1:
                # detection polls well inside the loss threshold
                cands.append(self.peer_lost)
            self.poll_interval = (min(max(min(cands) / 4.0, 0.05), 10.0)
                                  if cands else 1.0)
        try:
            # visible to the peers from the start: a rank that dies before
            # the monitor's first poll must still leave a heartbeat whose
            # silence the others can see
            self._publish_heartbeat()
        except Exception:  # noqa: BLE001 - the monitor retries it
            self.heartbeat_errors += 1
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name=self.name)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None
        if get_active() is self:
            set_active(None)

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- the monitor ----------------------------------------------------

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval):
            # each duty guarded on its own: a broken peer listing must not
            # skip the deadline checks, nor the reverse
            try:
                self._publish_heartbeat()
            except Exception:  # noqa: BLE001
                self.heartbeat_errors += 1
                logger.warning("supervisor: heartbeat publish errored "
                               "(non-fatal, will retry)", exc_info=True)
            stale: Dict[int, float] = {}
            try:
                stale = self._check_peers(log=True)
            except Exception:  # noqa: BLE001
                logger.exception("supervisor peer check error (non-fatal)")
            try:
                self._check_elastic(stale)
            except Exception:  # noqa: BLE001
                logger.exception("supervisor elastic check error "
                                 "(non-fatal)")
            try:
                if self.poll():
                    return
            except Exception:  # noqa: BLE001 - the watchdog outlives a
                # broken report write
                logger.exception("supervisor monitor error (non-fatal)")

    def poll(self) -> bool:
        """One check of every slot against its deadline (the monitor
        thread's turn; tests call it with an injected clock).  Returns
        True when monitoring should stop."""
        now = self.clock()
        # channels first: a stalled input worker is the cause of the main
        # thread's stale data wait, so its raise owns the recovery
        chan_fired_phase = None
        with self._lock:
            chans = [(k, st[0], st[1], st[2])
                     for k, st in self._channels.items()]
        for key, phase, t, tid in chans:
            deadline = self.deadline_for(phase)
            if not deadline or now - t <= deadline:
                continue
            if self._handle_stall(phase, now - t, deadline, channel=key,
                                  channel_tid=tid):
                return True
            chan_fired_phase = phase
        with self._lock:
            phase, t = self._last
            if chan_fired_phase is not None and \
                    phase.split(":", 1)[0] == chan_fired_phase:
                # the main slot's wait follows from the channel's stall:
                # a full deadline of grace instead of a second raise
                self._last = (phase, self.clock())
                return False
        deadline = self.deadline_for(phase)
        if not deadline:
            return False
        idle = self.clock() - t
        if idle <= deadline:
            return False
        return self._handle_stall(phase, idle, deadline)

    def _handle_stall(self, phase: str, idle: float, deadline: float,
                      channel: Optional[str] = None,
                      channel_tid: Optional[int] = None) -> bool:
        """A missed deadline: report, then act per callback or policy.
        Returns True when monitoring should stop."""
        self.stalls += 1
        stale = self._check_peers(log=False)
        where = f"phase {phase!r}" if channel is None else \
            f"phase {phase!r} (worker channel {channel!r})"
        msg = (f"supervisor[{self.name}]: {where} made no progress "
               f"for {idle:.1f}s (deadline {deadline:.1f}s)")
        if stale:
            msg += "; stale peers: " + ", ".join(
                f"host {r} last seen {age:.0f}s ago"
                for r, age in sorted(stale.items()))
        report_path = self._write_report(phase, idle, deadline, stale, msg)
        logger.error("%s%s", msg,
                     f" (crash report: {report_path})" if report_path
                     else "")
        if self.on_stall is not None:
            stall = {"phase": phase, "idle_seconds": round(idle, 1),
                     "deadline_seconds": deadline, "report": report_path,
                     "stale_peers": stale, "message": msg}
            if channel is not None:
                stall["channel"] = channel
            self._reset_timer(phase, channel)
            return bool(self.on_stall(stall))
        if self.policy == "exit":
            # the supervised thread is presumed stuck in one C call, which
            # no async raise reaches: leave, and let the next incarnation
            # resume from the lineage
            logger.error("supervisor: policy=exit, hard-exiting the "
                         "wedged process (crash report: %s)", report_path)
            try:
                for h in logger.handlers:
                    h.flush()
                sys.stderr.flush()
            except Exception:  # noqa: BLE001
                pass
            os._exit(86)
        # recovery beats no phase until it re-enters the loop: give it a
        # full deadline before a second stall can be declared
        self._reset_timer(phase, channel)
        with self._lock:
            tid = (channel_tid if channel_tid is not None
                   else self._thread_id)
        _LAST_STALL["message"] = msg
        if not _async_raise(tid, StallError):
            logger.error("supervisor: could not deliver StallError to "
                         "thread %s (already exited?)", tid)
        return False

    def _reset_timer(self, phase: str, channel: Optional[str]) -> None:
        with self._lock:
            if channel is None:
                self._last = (phase, self.clock())
            elif channel in self._channels:
                self._channels[channel][1] = self.clock()

    # -- crash report ---------------------------------------------------

    def crash_report(self, phase: str, idle: float, deadline: float,
                     stale: Optional[Dict[int, float]] = None,
                     reason: Optional[str] = None) -> dict:
        """Every thread's stack, the heartbeat timeline, the channels,
        the chaos counters, the stale peers and the platform."""
        now = self.clock()
        names = {t.ident: t.name for t in threading.enumerate()}
        threads = {}
        for tid, frame in sys._current_frames().items():
            label = f"{names.get(tid, '?')} (tid {tid})"
            threads[label] = [line.rstrip("\n")
                              for line in traceback.format_stack(frame)]
        with self._lock:
            timeline = [{"phase": p, "count": c,
                         "age_seconds": round(now - t, 3), "time": w}
                        for p, c, t, w in self._timeline]
            channels = {k: {"phase": st[0],
                            "age_seconds": round(now - st[1], 3),
                            "beats": st[3]}
                        for k, st in self._channels.items()}
        return {"reason": reason or f"phase {phase!r} stalled",
                "phase": phase,
                "idle_seconds": round(idle, 3),
                "deadline_seconds": deadline,
                "time": self.wall_clock(),
                "rank": self.rank, "world": self.world,
                "timeline": timeline,
                "channels": channels,
                "threads": threads,
                "chaos_counts": chaos.counts(),
                "stale_peers": {str(r): round(a, 1)
                                for r, a in (stale or {}).items()},
                "platform": self._platform}

    def _write_report(self, phase, idle, deadline, stale, msg):
        data = json.dumps(self.crash_report(phase, idle, deadline, stale,
                                            msg),
                          indent=2, default=str).encode()
        if not self.report_dir:
            logger.error("supervisor crash report (no report dir "
                         "configured):\n%s", data.decode(errors="replace"))
            return None
        from . import file_io
        base = file_io._strip_file_scheme(str(self.report_dir))
        path = file_io._join(
            base, f"crash_report-r{self.rank}-{self.stalls}.json")
        try:
            fs = file_io.get_filesystem(base)
            fs.makedirs(base)
            fs.write_bytes(path, data)
        except Exception as e:  # noqa: BLE001 - a broken store must not
            # hide the stall itself
            logger.error("supervisor: crash report write to %s failed "
                         "(%s); dumping inline:\n%s", path, e,
                         data.decode(errors="replace"))
            return None
        # a native dump beside it (local dirs: faulthandler needs an fd)
        try:
            import faulthandler
            if os.path.isdir(base):
                with open(path + ".stacks.txt", "w") as f:
                    faulthandler.dump_traceback(file=f, all_threads=True)
        except Exception:  # noqa: BLE001
            pass
        self.reports.append(path)
        return path

    # -- peer liveness ---------------------------------------------------

    def _heartbeat_path(self, rank: int) -> str:
        from . import file_io
        return file_io._join(file_io._strip_file_scheme(str(self.peer_dir)),
                             f"heartbeat.{rank}")

    def suspend_heartbeat(self) -> None:
        """Stop publishing liveness (the ``host.lost`` chaos drill: the
        peers must see this rank go publication-silent)."""
        self._publish_suspended = True

    def resume_heartbeat(self) -> None:
        """Publish again, on the next poll (a joiner, once its
        announcement has cleaned its previous life's files and bumped the
        generation)."""
        self._publish_suspended = False
        self._last_publish = None

    def hold_elastic(self) -> None:
        """No host-loss promotion until the next :meth:`reform`: a joiner
        that is not a member yet, or a grow in progress, must not start a
        shrink."""
        self._peer_lost_pending = True

    def _publish_heartbeat(self) -> None:
        """Publish this process's heartbeat: the supervised thread's last
        beat (``time``, which a stalled rank stops advancing) and the
        monitor's publication time (``published``, which only a dead rank
        stops).  A failed write is counted and tried again at the next
        poll (``_last_publish`` advances only on success)."""
        if not self.peer_dir or self.world <= 1 or self._publish_suspended:
            return
        now = self.clock()
        interval = self.publish_interval
        if interval is None:
            interval = max(self.peer_stale / 4.0, 0.5)
            if self.peer_lost > 0:
                # publication age is the loss signal: publish well inside
                # its threshold
                interval = min(interval, self.peer_lost / 4.0)
        if self._last_publish is not None and \
                now - self._last_publish < interval:
            return
        with self._lock:
            phase, _ = self._last
            count = self._count
            last_wall = (self._timeline[-1][3] if self._timeline
                         else self.wall_clock())
        blob = json.dumps({"rank": self.rank, "phase": phase,
                           "count": count, "time": last_wall,
                           "published": self.wall_clock(),
                           "generation": self.generation}).encode()
        path = self._heartbeat_path(self.rank)
        try:
            from . import file_io
            fs = file_io.get_filesystem(path)
            fs.makedirs(file_io._strip_file_scheme(str(self.peer_dir)))
            fs.write_bytes(path, blob)
        except Exception as e:  # noqa: BLE001 - liveness is best effort;
            # a broken store must not stop training
            self.heartbeat_errors += 1
            logger.warning("supervisor: heartbeat publish to %s failed "
                           "(%d so far; retrying next poll): %s",
                           path, self.heartbeat_errors, e)
            return
        self._last_publish = now

    def check_peers(self) -> Dict[int, float]:
        """rank -> seconds since the last beat of every stale peer."""
        return dict(self._check_peers(log=False))

    def stale_peers(self) -> Dict[int, float]:
        """The last poll's stale peers (rank -> beat age, seconds), without
        listing the store again."""
        with self._lock:
            return dict(self._stale_peers)

    def lost_peers(self) -> Dict[int, float]:
        """The last poll's peers whose publication is silent past
        ``peer_lost`` (rank -> publication age, seconds)."""
        with self._lock:
            return dict(self._lost_candidates)

    def _check_peers(self, log: bool) -> Dict[int, float]:
        # a world shrunk to 1 has no live peer, but the lost peers' frozen
        # heartbeats stay watched: a returning rank announces there
        if not self.peer_dir or (self.world <= 1 and not self._lost_peers):
            return {}
        from . import file_io
        base = file_io._strip_file_scheme(str(self.peer_dir))
        try:
            fs = file_io.get_filesystem(base)
            names = fs.listdir(base)
        except Exception:  # noqa: BLE001 - the dir may not exist yet
            return {}
        now = self.wall_clock()
        stale, lost = {}, {}
        for name in names:
            head, _, tail = name.rpartition(".")
            if head != "heartbeat" or not tail.isdigit():
                continue
            rank = int(tail)
            if rank == self.rank:
                continue
            if rank in self._lost_peers:
                # a lost peer's file is not news unless a higher
                # generation shows up: its next life
                if log:
                    self._check_returned(rank, fs)
                continue
            try:
                hb = json.loads(fs.read_bytes(self._heartbeat_path(rank)))
                age = now - float(hb["time"])
                pub_age = now - float(hb.get("published", hb["time"]))
            except Exception:  # noqa: BLE001 - a torn write; the next
                # publish replaces it
                continue
            with self._lock:
                # on a loss, the generation a return must exceed
                self._peer_gens[rank] = int(hb.get("generation", 0))
            if self.peer_lost > 0 and pub_age > self.peer_lost:
                lost[rank] = pub_age
            if age > self.peer_stale:
                stale[rank] = age
                if log and rank not in self._stale_peers:
                    logger.warning(
                        "supervisor: peer host %d heartbeat is stale: last "
                        "seen %.0fs ago (phase %r)", rank, age,
                        hb.get("phase"))
                    if self.on_peer_stale is not None:
                        try:
                            self.on_peer_stale(rank, age)
                        except Exception:  # noqa: BLE001 - observer only
                            logger.exception("on_peer_stale callback "
                                             "failed (non-fatal)")
        if log and stale:
            from . import telemetry
            telemetry.counter("peers", **{f"stale_age_r{r}": round(a, 3)
                                          for r, a in stale.items()})
        with self._lock:
            self._stale_peers = stale
            self._lost_candidates = lost
        return stale

    def _check_returned(self, rank: int, fs) -> None:
        """A lost peer's return: its heartbeat generation exceeds the one
        its previous life left.  Observed once per episode; admission
        happens at the optimizer's next checkpoint boundary."""
        try:
            hb = json.loads(fs.read_bytes(self._heartbeat_path(rank)))
            gen = int(hb.get("generation", 0))
        except Exception:  # noqa: BLE001 - a torn write; next poll
            return
        with self._lock:
            if gen <= self._lost_peers.get(rank, 0) or \
                    rank in self._returned_peers:
                return
            self._returned_peers[rank] = gen
        logger.warning("supervisor: peer host %d returned: heartbeat "
                       "generation %d supersedes its lost life", rank, gen)
        from . import telemetry
        telemetry.instant("elastic.peer_returned", cat="elastic",
                          rank=rank, generation=gen)
        if self.on_peer_returned is not None:
            try:
                self.on_peer_returned(rank, gen)
            except Exception:  # noqa: BLE001 - observer only
                logger.exception("on_peer_returned callback failed "
                                 "(non-fatal)")

    def returned_peers(self) -> Dict[int, int]:
        """Lost peers that published a newer generation (rank ->
        generation), waiting for admission; cleared by :meth:`reform`."""
        with self._lock:
            return dict(self._returned_peers)

    def peer_lost_pending(self) -> bool:
        """True between a host-loss promotion and the :meth:`reform` that
        completes it: a join then waits, so re-forms never interleave."""
        return self._peer_lost_pending

    # -- elastic host-loss promotion (parallel/elastic.py) ---------------

    def _check_elastic(self, stale: Dict[int, float]) -> None:
        """Promote publication-silent peers (or another survivor's
        intent) into a PeerLostError: publish this rank's
        ``elastic/recover.<rank>`` intent and async-raise into the
        supervised thread; the retry loop negotiates and re-forms."""
        del stale
        if self.peer_lost <= 0 or self.world <= 1 or not self.peer_dir \
                or self._peer_lost_pending or not self.lineage_dir:
            return
        if self.clock() < self._promotion_grace_until:
            return  # the rebuild after a re-form: observe, do not promote
        with self._lock:
            lost = {r: a for r, a in self._lost_candidates.items()
                    if r not in self._lost_peers}
        from ..parallel import elastic
        # another survivor may have called this round already
        intents = elastic.read_intents(
            self.lineage_dir, min_epoch=self.elastic_epoch + 1,
            exclude_rank=self.rank)
        for doc in intents.values():
            for r in doc.get("lost", []):
                if int(r) != self.rank and int(r) not in self._lost_peers:
                    lost.setdefault(int(r), 0.0)
        if not lost:
            return
        propose = max([self.elastic_epoch + 1] +
                      [int(d.get("epoch", 0)) for d in intents.values()])
        ages = ", ".join(f"{a:.0f}s (host {r})"
                         for r, a in sorted(lost.items()))
        msg = (f"supervisor[{self.name}]: peer host(s) {sorted(lost)} lost "
               f"— heartbeat publication silent {ages}; starting elastic "
               f"recovery round {propose}")
        try:
            elastic.publish_intent(self.lineage_dir, self.rank, propose,
                                   sorted(lost), self.wall_clock())
        except Exception:  # noqa: BLE001 - this rank still recovers; the
            # others fall back to their own thresholds
            logger.exception("supervisor: could not publish elastic "
                             "recovery intent (non-fatal)")
        from . import telemetry
        telemetry.instant("elastic.detect", cat="elastic",
                          lost=sorted(lost), epoch=propose)
        logger.error(msg)
        elastic.set_last_peer_lost(msg, sorted(lost), propose)
        self._peer_lost_pending = True
        with self._lock:
            tid = self._thread_id
        if not _async_raise(tid, elastic.PeerLostError):
            logger.error("supervisor: could not deliver PeerLostError to "
                         "thread %s (already exited?)", tid)

    def reform(self, rank: int, world: int, epoch: int,
               lost=(), returned=()) -> None:
        """Install the topology after a recovery: the ``lost`` peers'
        frozen files stop counting (each with the generation its return
        must exceed), ``returned`` ranks are watched again, the round is
        recorded, and promotion re-arms after the reform grace."""
        with self._lock:
            self.rank, self.world = int(rank), int(world)
            for r in lost:
                self._lost_peers[int(r)] = self._peer_gens.get(int(r), 0)
            for r in returned:
                self._lost_peers.pop(int(r), None)
                self._returned_peers.pop(int(r), None)
            self._stale_peers = {r: a for r, a in self._stale_peers.items()
                                 if r not in self._lost_peers}
            self._lost_candidates = {
                r: a for r, a in self._lost_candidates.items()
                if r not in self._lost_peers}
        self.elastic_epoch = int(epoch)
        self._peer_lost_pending = False
        self._promotion_grace_until = self.clock() + self.reform_grace
