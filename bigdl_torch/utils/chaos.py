"""Fault injection: named fault points with deterministic schedules.

Counterpart of ``bigdl_tpu/utils/chaos.py``, all of it (the reference's
``ExceptionTest`` layer, ``test/.../utils/TestUtils.scala:103``, made a
layer the whole runtime shares).  Production code declares fault points
(one :func:`fire` or :func:`transform` call per operation); tests attach
schedules to them.  Everything is counter-driven, with no clock and no
RNG, so a chaos run repeats exactly.

Fault points fired by the port:

| point            | where it fires                                   | kind         |
|------------------|--------------------------------------------------|--------------|
| ``ckpt.write``   | once per checkpoint blob written (file_io)       | fail/corrupt |
| ``ckpt.read``    | once per checkpoint blob read (file_io)          | fail/corrupt |
| ``fs.remote``    | once per remote filesystem op attempt (file_io)  | fail         |
| ``data.batch``   | once per training minibatch (driver loop or the prefetch worker) | fail/corrupt |
| ``data.stall``   | once per minibatch fetch (likewise)              | stall        |
| ``step.stall``   | once per training step (driver loop)             | stall        |
| ``step.loss_nan``| once per host loss observation (driver loop)     | nan          |
| ``serve.request``| once per request admission (serve/batcher)       | fail         |
| ``serve.batch``  | once per device batch (serve/server)             | fail/stall   |
| ``serve.replica@<idx>`` | once per non-empty batch replica idx collects (serve/server) | exit/wedge |
| ``serve.canary`` | once per canary batch (serve/server)             | fail/stall   |
| ``serve.decode@<slot>`` | once per admission into and per tick of a decode slot (serve/decode) | fail |
| ``deploy.publish`` | once per release entry written (serve/continuous) | corrupt    |
| ``host.lost@<rank>`` | once per training iteration of that rank (driver loop) | exit/wedge |
| ``host.return@<rank>`` | the elastic joiner's announcement gate (optim/optimizer ``_elastic_join``) | gate |
| ``fleet.member@<idx>`` | once per beat-loop turn of fleet worker idx (tools/serve_worker) | exit/wedge |
| ``data.record``  | once per record payload read (utils/recordio)     | fail/corrupt |

Each hit is a ``chaos:<point>`` instant on the
active tracer (``utils/telemetry``).

Schedules (1-based counts): ``FailAt(3, 5)``, ``FailN(2, start=4)``,
``CorruptAt(2)`` / ``CorruptAt(2, mode="truncate")`` (bytes flipped or
cut, floats and float arrays and MiniBatch features made NaN),
``StallAt(2, seconds=30)`` (a sleep in 50 ms slices, so a supervisor's
async ``StallError`` lands), ``ExitAt(2)`` and ``WedgeAt(2, seconds=30)``
(the host-loss drill: ``os._exit(117)``, or an uninterruptible block),
``ReturnAt(2)`` (an observation gate read by :func:`gate`).

Spec (``BIGDL_TORCH_CHAOS``, or :func:`install`, or :class:`scoped`),
``;``-separated points::

    ckpt.write=corrupt@3;fs.remote=fail*2@1;data.batch=fail@6;step.stall=stall*30@5

``fail`` raises :class:`ChaosFault` (a RuntimeError); ``stall`` blocks
3600 s, ``stall*N`` N seconds; ``exit``, ``wedge*N`` / ``lost``,
``corrupt`` / ``flip``, ``truncate``, ``nan``, ``join`` / ``return`` /
the bare ``@e:i`` gate.  A count may be an ``epoch:iteration`` pair
(``stall*30@2:5``), matched against the position the driver publishes
once per iteration (:func:`at_position`); a gate fires at or after its
position.  A fire site may pass ``thread_exc`` to scope exit and wedge
schedules to the calling thread.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Iterable, List, Optional

logger = logging.getLogger("bigdl_torch")

__all__ = ["ChaosFault", "FailAt", "FailN", "CorruptAt", "StallAt",
           "ExitAt", "WedgeAt", "ReturnAt", "register", "install", "clear",
           "reset", "armed", "fire", "gate", "transform", "scoped",
           "counts", "at_position", "FAULT_POINTS"]

FAULT_POINTS = ("ckpt.write", "ckpt.read", "fs.remote", "data.batch",
                "step.loss_nan", "data.record", "data.stall", "step.stall",
                "serve.request", "serve.batch", "serve.replica",
                "serve.canary", "host.lost", "host.return",
                "fleet.member")

#: the driver loop's current (epoch, neval), published once per iteration
#: via at_position() — the coordinate ``@epoch:iteration`` addresses match
_POSITION = {"at": None}


def at_position(epoch: int, neval: int) -> None:
    """Publish the driver's position for ``@epoch:iteration``-addressed
    schedules (one dict store; free when no such schedule exists)."""
    _POSITION["at"] = (int(epoch), int(neval))


class ChaosFault(RuntimeError):
    """An injected failure (point + invocation count in the message)."""


class FailAt:
    """Raise on exactly the given 1-based invocation counts."""

    def __init__(self, *counts: int):
        self.counts = frozenset(int(c) for c in counts)

    def fires(self, count: int) -> bool:
        return count in self.counts

    def mutate(self, value):  # fail schedules never mutate
        raise AssertionError("FailAt has no payload mutation")

    is_fail = True

    def __repr__(self):
        return f"FailAt({sorted(self.counts)})"


class FailN:
    """Raise on `n` consecutive counts starting at `start` (fail-n-times:
    the reference's transient-fault shape — down, then back up)."""

    def __init__(self, n: int, start: int = 1):
        self.n, self.start = int(n), int(start)

    def fires(self, count: int) -> bool:
        return self.start <= count < self.start + self.n

    def mutate(self, value):
        raise AssertionError("FailN has no payload mutation")

    is_fail = True

    def __repr__(self):
        return f"FailN({self.n}, start={self.start})"


class CorruptAt:
    """Mutate the payload at the given counts instead of raising.

    bytes payloads: ``mode="flip"`` XORs a span in the middle (same length
    — a bit-rot tear the CRC frame must catch), ``mode="truncate"`` drops
    the tail (a torn write).  float payloads become NaN regardless of mode
    (the ``step.loss_nan`` sentinel).  Float ndarrays and MiniBatch-like
    objects (``get_input``/``get_target``) get their float features
    NaN-poisoned — the ``data.batch`` corruption the non-finite-loss
    sentinel must catch."""

    def __init__(self, *counts: int, mode: str = "flip"):
        if mode not in ("flip", "truncate"):
            raise ValueError(f"CorruptAt: unknown mode {mode!r}")
        self.counts = frozenset(int(c) for c in counts)
        self.mode = mode

    def fires(self, count: int) -> bool:
        return count in self.counts

    @staticmethod
    def _poison_floats(x):
        """NaN-fill every float array in a (possibly nested) structure;
        integer arrays pass through (labels stay valid indices)."""
        import numpy as np
        if isinstance(x, (list, tuple)):
            return [CorruptAt._poison_floats(e) for e in x]
        arr = np.asarray(x)
        if arr.dtype.kind == "f":
            return np.full_like(arr, np.nan)
        return x

    def mutate(self, value):
        if isinstance(value, (bytes, bytearray)):
            data = bytes(value)
            if self.mode == "truncate":
                return data[:max(len(data) // 2, 0)]
            if not data:
                return data
            mid = len(data) // 2
            span = min(8, len(data) - mid) or 1
            return (data[:mid] +
                    bytes(b ^ 0xFF for b in data[mid:mid + span]) +
                    data[mid + span:])
        if isinstance(value, (int, float)):
            return float("nan")
        if hasattr(value, "get_input") and hasattr(value, "get_target"):
            # MiniBatch-like: poison the float features, keep targets —
            # the loss goes NaN and the host sentinel must catch it
            return type(value)(self._poison_floats(value.get_input()),
                               value.get_target())
        if hasattr(value, "dtype") or hasattr(value, "__array__"):
            return self._poison_floats(value)
        raise TypeError(
            f"CorruptAt cannot mutate {type(value).__name__} payloads")

    is_fail = False

    def __repr__(self):
        return f"CorruptAt({sorted(self.counts)}, mode={self.mode!r})"


class StallAt:
    """BLOCK at the given counts — the silent-hang failure mode (a lost
    backend RPC, a wedged collective) the supervision subsystem exists to
    catch.  The sleep runs in 50ms slices so Python bytecode executes
    between them and the supervisor's async-raised ``StallError`` can
    land; a genuinely wedged C call (no bytecode) is exactly the
    supervisor's hard-exit policy case."""

    def __init__(self, *counts: int, seconds: float = 3600.0):
        self.counts = frozenset(int(c) for c in counts)
        self.seconds = float(seconds)

    def fires(self, count: int) -> bool:
        return count in self.counts

    def mutate(self, value):  # stall schedules never mutate
        raise AssertionError("StallAt has no payload mutation")

    def block(self) -> None:
        end = time.monotonic() + self.seconds
        while time.monotonic() < end:
            time.sleep(min(0.05, max(end - time.monotonic(), 0.001)))

    is_fail = False
    is_stall = True

    def __repr__(self):
        return f"StallAt({sorted(self.counts)}, seconds={self.seconds})"


def _suspend_liveness():
    """Host-loss drill: this rank must go publication-silent on its peers
    (the signal parallel/elastic promotes to PeerLostError).  Lazy import:
    supervisor imports chaos at module level."""
    from . import supervisor as supervision
    sup = supervision.get_active()
    if sup is not None:
        sup.suspend_heartbeat()


class ExitAt:
    """Host-loss drill, hard mode: at the given counts the process stops
    publishing heartbeats and dies instantly (``os._exit(117)``) — the
    deterministic stand-in for a host falling out of the pod.  The
    SURVIVORS' behavior is what the drill measures."""

    EXIT_CODE = 117

    def __init__(self, *counts: int):
        self.counts = frozenset(int(c) for c in counts)

    def fires(self, count: int) -> bool:
        return count in self.counts

    def mutate(self, value):  # exit schedules never mutate
        raise AssertionError("ExitAt has no payload mutation")

    def engage(self) -> None:
        import os as _os
        _suspend_liveness()
        logger.error("chaos[host.lost]: exiting this rank (drill)")
        _os._exit(self.EXIT_CODE)

    is_fail = False
    is_exit = True

    def __repr__(self):
        return f"ExitAt({sorted(self.counts)})"


class WedgeAt:
    """Host-loss drill, zombie mode: stop publishing heartbeats and block
    UNINTERRUPTIBLY (async-raised exceptions are swallowed — a lost host
    cannot be rescued by a StallError, which is exactly what makes it a
    host loss rather than a stall)."""

    def __init__(self, *counts: int, seconds: float = 3600.0):
        self.counts = frozenset(int(c) for c in counts)
        self.seconds = float(seconds)

    def fires(self, count: int) -> bool:
        return count in self.counts

    def mutate(self, value):  # wedge schedules never mutate
        raise AssertionError("WedgeAt has no payload mutation")

    def engage(self) -> None:
        _suspend_liveness()
        self.block_uninterruptible()

    def block_uninterruptible(self) -> None:
        """The wedge itself, without the liveness side effect — the
        thread-scoped variant (``serve.replica`` drills) reuses it."""
        end = time.monotonic() + self.seconds
        while time.monotonic() < end:
            try:
                time.sleep(min(0.05, max(end - time.monotonic(), 0.001)))
            except BaseException:  # noqa: BLE001 — swallow async raises:
                # the wedged host must stay wedged
                pass

    is_fail = False
    is_exit = True  # engage() like ExitAt; never returns control normally

    def __repr__(self):
        return f"WedgeAt({sorted(self.counts)}, seconds={self.seconds})"


class ReturnAt:
    """Host-return drill (the grow half of parallel/elastic): an
    observation GATE with fault-schedule addressing but NO fault
    semantics — :func:`fire`/:func:`transform` ignore it entirely; only
    :func:`gate` reports it.  The elastic joiner polls its
    ``host.return@<rank>`` point once per announce loop and announces
    itself when the gate is reached (by invocation count, or at-or-after
    an ``@epoch:iteration`` position — see the module docstring)."""

    def __init__(self, *counts: int):
        self.counts = frozenset(int(c) for c in counts)

    def fires(self, count: int) -> bool:
        return count in self.counts

    def mutate(self, value):  # gate schedules never mutate
        raise AssertionError("ReturnAt has no payload mutation")

    is_fail = False
    is_gate = True

    def __repr__(self):
        return f"ReturnAt({sorted(self.counts)})"


class _Point:
    __slots__ = ("schedules", "count")

    def __init__(self):
        self.schedules: List = []
        self.count = 0


_LOCK = threading.Lock()
_POINTS: Dict[str, _Point] = {}
_ENV_LOADED = False


def register(point: str, schedule) -> None:
    """Attach a schedule to a fault point (additive)."""
    with _LOCK:
        _POINTS.setdefault(point, _Point()).schedules.append(schedule)


def clear(point: Optional[str] = None) -> None:
    """Remove schedules (and counters) for one point, or everything."""
    global _ENV_LOADED
    with _LOCK:
        if point is None:
            _POINTS.clear()
            _ENV_LOADED = False
            _POSITION["at"] = None
        else:
            _POINTS.pop(point, None)


def reset(point: Optional[str] = None) -> None:
    """Zero invocation counters, keeping schedules (re-run a scenario)."""
    with _LOCK:
        for name, p in _POINTS.items():
            if point is None or name == point:
                p.count = 0


def counts() -> Dict[str, int]:
    """Current invocation counters (diagnostics / test assertions)."""
    with _LOCK:
        return {name: p.count for name, p in _POINTS.items()}


def armed(point: str) -> bool:
    """True when any schedule is attached to `point` — production code may
    branch to a chaos-compatible (e.g. non-streaming) path only then."""
    _load_env()
    with _LOCK:
        return point in _POINTS and bool(_POINTS[point].schedules)


def _matches(s, count: int) -> bool:
    """Plain invocation-count match OR ``@epoch:iteration`` position match
    (positions attached by the spec parser; see at_position)."""
    if s.fires(count):
        return True
    at = _POSITION["at"]
    return at is not None and at in getattr(s, "positions", ())


def _bump(point: str):
    """count++ and return (count, matching schedules) — one counted
    invocation per fire()/transform() call."""
    _load_env()
    with _LOCK:
        p = _POINTS.get(point)
        if p is None or not p.schedules:
            return 0, []
        p.count += 1
        return p.count, [s for s in p.schedules if _matches(s, p.count)]


def _trace_hits(point: str, count: int, hits) -> None:
    """Mark each schedule hit as a ``chaos:<point>`` instant on the run's
    timeline (``utils/telemetry``), next to the retries, stalls and
    failures it causes, and log it.  Only runs when a schedule fired, so
    unarmed points stay free."""
    from . import telemetry
    telemetry.instant(f"chaos:{point}", cat="chaos", count=count,
                      schedules=[repr(s) for s in hits])
    logger.warning("chaos[%s]: invocation %d hits %s", point, count,
                   [repr(s) for s in hits])


def fire(point: str, thread_exc=None) -> None:
    """Count one invocation; raise ChaosFault if a fail schedule matches,
    block if a stall schedule matches.  Corrupt schedules are ignored here
    (no payload to mutate).

    ``thread_exc`` (an exception class) scopes exit/wedge schedules to
    the CALLING THREAD: ``exit`` raises ``thread_exc`` instead of
    ``os._exit`` and ``wedge`` blocks uninterruptibly without suspending
    process liveness — the serve replica-loss drill
    (``serve.replica@<idx>``, serve/control.py)."""
    count, hits = _bump(point)
    if hits:
        _trace_hits(point, count, hits)
    for s in hits:
        if getattr(s, "is_exit", False):
            if thread_exc is not None:
                if isinstance(s, WedgeAt):
                    s.block_uninterruptible()
                else:
                    raise thread_exc(
                        f"chaos[{point}] thread exit "
                        f"(invocation {count}, {s!r})")
            else:
                s.engage()
        elif getattr(s, "is_stall", False):
            s.block()
        elif s.is_fail:
            raise ChaosFault(f"chaos[{point}] injected failure "
                             f"(invocation {count}, {s!r})")


def gate(point: str) -> bool:
    """Count one invocation and report whether an OBSERVATION GATE at
    `point` is reached — nothing raises, blocks, or exits (the
    difference from :func:`fire`).  The elastic joiner's announce loop
    polls its ``host.return@<rank>`` point with this.

    Matching: plain invocation counts are exact (like every schedule);
    ``@epoch:iteration`` positions fire AT-OR-AFTER the addressed
    coordinate (tuple order on ``(epoch, neval)``) — the gate's caller
    POLLS positions sampled from the checkpoint stream and may never
    observe the exact coordinate, so exact-match would be a silent
    never-fire."""
    _load_env()
    with _LOCK:
        p = _POINTS.get(point)
        if p is None or not p.schedules:
            return False
        p.count += 1
        count = p.count
        at = _POSITION["at"]
        hits = [s for s in p.schedules
                if s.fires(count) or
                (at is not None and
                 any(at >= pos for pos in getattr(s, "positions", ())))]
    if hits:
        _trace_hits(point, count, hits)
    return bool(hits)


def transform(point: str, value):
    """Count one invocation; raise on fail schedules, block on stall
    schedules, else pipe the payload through every matching corrupt
    schedule."""
    count, hits = _bump(point)
    if hits:
        _trace_hits(point, count, hits)
    for s in hits:
        if getattr(s, "is_exit", False):
            s.engage()
        elif getattr(s, "is_stall", False):
            s.block()
        elif s.is_fail:
            raise ChaosFault(f"chaos[{point}] injected failure "
                             f"(invocation {count}, {s!r})")
        elif not getattr(s, "is_gate", False):
            value = s.mutate(value)
    return value


# ---------------------------------------------------------------------------
# spec parsing (env var / --chaos CLI)
# ---------------------------------------------------------------------------

def _parse_counts(at: str, action: str):
    """``@`` operand -> (plain counts, (epoch, neval) positions).  Each
    comma-separated entry is a 1-based invocation count or an
    ``epoch:iteration`` pair (the net-new position addressing)."""
    counts_, positions = [], []
    for c in at.split(","):
        if not c:
            continue
        if ":" in c:
            e, _, s = c.partition(":")
            positions.append((int(e), int(s)))
        else:
            counts_.append(int(c))
    if not counts_ and not positions:
        raise ValueError(f"chaos spec: empty counts in {action!r}")
    return counts_, frozenset(positions)


def _parse_action(action: str):
    """One schedule from ``fail@3,5`` / ``fail*2@4`` / ``corrupt@2`` /
    ``truncate@2`` / ``nan@7`` / ``stall@5`` / ``stall*30@5`` (for stall,
    ``*N`` is the block duration in SECONDS, not a repeat count) /
    ``exit@4`` / ``wedge*30@4`` / ``lost@4`` (= wedge; the host-loss
    drill actions) / ``join@2:2`` / ``return@2:2`` or the bare ``@2:2``
    shorthand (= ReturnAt, the host-return gate).  Counts may be
    ``epoch:iteration`` pairs (``stall*30@2:5``)."""
    if "@" not in action:
        raise ValueError(f"chaos spec: missing '@counts' in {action!r}")
    kind, _, at = action.partition("@")
    counts_, positions = _parse_counts(at, action)

    def place(sched):
        if positions:
            sched.positions = positions
        return sched

    if kind.startswith("stall"):
        seconds = 3600.0
        if "*" in kind:  # stall*SECONDS@counts
            seconds = float(kind.split("*", 1)[1])
        return place(StallAt(*counts_, seconds=seconds))
    if kind == "exit":
        return place(ExitAt(*counts_))
    if kind.startswith(("wedge", "lost")):
        seconds = 3600.0
        if "*" in kind:  # wedge*SECONDS@counts
            seconds = float(kind.split("*", 1)[1])
        return place(WedgeAt(*counts_, seconds=seconds))
    if kind.startswith("fail"):
        if "*" in kind:  # fail*N@start
            n = int(kind.split("*", 1)[1])
            if len(counts_) != 1 or positions:
                raise ValueError(
                    f"chaos spec: fail*N takes one start count: {action!r}")
            return FailN(n, start=counts_[0])
        return place(FailAt(*counts_))
    if kind in ("corrupt", "flip"):
        return place(CorruptAt(*counts_, mode="flip"))
    if kind == "truncate":
        return place(CorruptAt(*counts_, mode="truncate"))
    if kind == "nan":
        return place(CorruptAt(*counts_))  # float payloads NaN any mode
    if kind in ("join", "return", ""):
        # host-return gate: ``host.return@1=join@2:2`` — or the bare
        # ``host.return@1=@2:2`` the drill specs read most naturally
        return place(ReturnAt(*counts_))
    raise ValueError(f"chaos spec: unknown action {kind!r} in {action!r}")


def install(spec: str) -> None:
    """Install schedules from a spec string:
    ``point=action@counts[;point=action@counts...]``."""
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"chaos spec: expected point=action, got "
                             f"{part!r}")
        point, _, action = part.partition("=")
        register(point.strip(), _parse_action(action.strip()))


def _load_env() -> None:
    """One-shot pickup of BIGDL_TORCH_CHAOS (``utils/config.py``).
    Loaded lazily on the first armed()/fire()/transform() so importing this
    module never reads the environment."""
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    with _LOCK:
        if _ENV_LOADED:
            return
        _ENV_LOADED = True
    from . import config
    spec = config.get_str("CHAOS", "")
    if spec:
        install(spec)


class scoped:
    """Context manager for tests: install a spec (or programmatic
    (point, schedule) pairs), clear everything on exit."""

    def __init__(self, spec: str = "", schedules:
                 Optional[Iterable] = None):
        self.spec = spec
        self.schedules = list(schedules or [])

    def __enter__(self):
        clear()
        global _ENV_LOADED
        _ENV_LOADED = True  # scoped runs ignore the ambient env spec
        if self.spec:
            install(self.spec)
        for point, schedule in self.schedules:
            register(point, schedule)
        import sys
        return sys.modules[__name__]

    def __exit__(self, *exc):
        clear()
        return False
