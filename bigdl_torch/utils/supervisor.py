"""Training-run supervision: the stall watchdog (single process).

Counterpart of ``bigdl_tpu/utils/supervisor.py``, its single-process half
(``:116-640``).  A run that hangs (a data source that never returns, a
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

The multi-host half (peer heartbeat files, stale and lost peers, elastic
promotion, ``:643-929``) goes with ``parallel/elastic.py`` (ROADMAP queue
A item 6): its methods raise ``NotImplementedError`` naming that item.

Knobs (``utils/config.py``): ``BIGDL_TORCH_SUPERVISE_DATA`` / ``_STEP`` /
``_COMPILE`` / ``_CHECKPOINT`` / ``_VALIDATION`` / ``_SERVE`` (seconds, 0 =
unwatched), ``_SUPERVISE_DEADLINE`` (the default), ``_SUPERVISE_POLICY``
(``raise`` or ``exit``).
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

_PEER_HALF = ("the supervisor's multi-host half (peer heartbeats, stale "
              "and lost peers, elastic promotion) is not ported yet "
              "(ROADMAP queue A item 6)")

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
    phase unwatched.  ``peer_dir`` and the other multi-host arguments
    raise (ROADMAP queue A item 6)."""

    def __init__(self, deadlines: Optional[Dict[str, float]] = None,
                 default_deadline: Optional[float] = None, *,
                 report_dir: Optional[str] = None,
                 policy: Optional[str] = None,
                 on_stall: Optional[Callable[[dict], bool]] = None,
                 poll_interval: Optional[float] = None,
                 clock=None, wall_clock=None,
                 peer_dir: Optional[str] = None,
                 rank: int = 0, world: int = 1,
                 peer_lost: Optional[float] = None,
                 lineage_dir: Optional[str] = None,
                 name: str = "bigdl-supervisor",
                 timeline_len: int = 64):
        if peer_dir is not None or peer_lost or lineage_dir is not None:
            raise NotImplementedError(_PEER_HALF)
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
        self.rank, self.world = int(rank), int(world)
        self.name = name
        self._platform = _platform_info()
        self._publish_suspended = False
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
            self.poll_interval = (min(max(min(cands) / 4.0, 0.05), 10.0)
                                  if cands else 1.0)
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
        where = f"phase {phase!r}" if channel is None else \
            f"phase {phase!r} (worker channel {channel!r})"
        msg = (f"supervisor[{self.name}]: {where} made no progress "
               f"for {idle:.1f}s (deadline {deadline:.1f}s)")
        report_path = self._write_report(phase, idle, deadline, msg)
        logger.error("%s%s", msg,
                     f" (crash report: {report_path})" if report_path
                     else "")
        if self.on_stall is not None:
            stall = {"phase": phase, "idle_seconds": round(idle, 1),
                     "deadline_seconds": deadline, "report": report_path,
                     "message": msg}
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
                     reason: Optional[str] = None) -> dict:
        """Every thread's stack, the heartbeat timeline, the channels,
        the chaos counters and the platform."""
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
                "platform": self._platform}

    def _write_report(self, phase, idle, deadline, msg):
        data = json.dumps(self.crash_report(phase, idle, deadline, msg),
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

    # -- the multi-host half (ROADMAP queue A item 6) -------------------

    def suspend_heartbeat(self) -> None:
        """Stop publishing liveness (the ``host.lost`` chaos drill).  A
        single process publishes nothing, so this only records it."""
        self._publish_suspended = True

    def _peer_half(self, *_a, **_k):
        raise NotImplementedError(_PEER_HALF)

    resume_heartbeat = hold_elastic = check_peers = stale_peers = \
        lost_peers = returned_peers = peer_lost_pending = reform = \
        _peer_half
