"""The serving fleet: worker processes, their registry and supervisor.

Counterpart of ``bigdl_tpu/serve/fleet.py``, all of it.  Each member of the
fleet is an OS process (``python -m bigdl_torch.tools.serve_worker``: an
:class:`~bigdl_torch.serve.InferenceServer` behind the HTTP front end of
``tools/serve_http.py``) that registers itself, is supervised and dies on
its own.  The processes coordinate through one shared fleet dir only, with
the heartbeat rule of elastic training (``parallel/elastic.py``): a member
is lost when its heartbeat's publication goes silent.  The files are the
reference's, so each package reads the other's:

- ``member.<idx>.<generation>``: the member record, a CRC-framed pickle
  (``file_io.frame_bytes``) of format, index, pid, generation, devices,
  buckets, max_batch, host, port and wall_time.  A torn or bit-rotted
  record reads as absent.  The writer sweeps the records of dead
  generations (``BIGDL_TORCH_FLEET_KEEP_GENERATIONS`` kept,
  ``file_io.sweep_numbered``).
- ``heartbeats/heartbeat.<idx>``: elastic-schema liveness JSON (``rank``,
  ``phase``, ``count``, ``time``, ``published``, ``generation``),
  restamped at every worker beat; a ``published`` stamp older than
  ``BIGDL_TORCH_FLEET_MEMBER_LOST`` is the loss.
- ``condemn.<idx>``: the supervisor's verdict ``{"index", "generation",
  "time"}``: every life of member ``idx`` at or below that generation is
  dead to the fleet.  A zombie that wakes from a wedge reads it in its
  beat loop and exits; its replacement spawns one generation higher.

:class:`FleetSupervisor` runs in the front's process: it promotes a silent
member (or one whose process exited) into a typed :class:`MemberLostError`,
condemns the lost generation, kills the pid, respawns at the next
generation under exponential backoff, and past the restart budget
degrades the slot: the fleet serves from the survivors.  A respawned
worker builds and warms its model itself (the reference's shared AOT
cache is not ported).  The routing half is ``serve/fleetfront.py``.

Knobs (``utils/config.py``; constructor arguments override):

| env var | meaning | default |
|---|---|---|
| ``BIGDL_TORCH_FLEET_MEMBER_LOST`` | heartbeat publication silence that is a loss, seconds | 5.0 |
| ``BIGDL_TORCH_FLEET_RESTART_BUDGET`` | respawns per member before the slot degrades | 3 |
| ``BIGDL_TORCH_FLEET_RESTART_BACKOFF`` | first respawn delay, seconds (doubling per consecutive restart) | 0.5 |
| ``BIGDL_TORCH_FLEET_POLL`` | supervisor poll, seconds | 0.5 |
| ``BIGDL_TORCH_FLEET_SPAWN_GRACE`` | seconds a fresh spawn may take to publish its first heartbeat | 30.0 |
| ``BIGDL_TORCH_FLEET_HEARTBEAT`` | worker beat interval, seconds | 0.5 |
| ``BIGDL_TORCH_FLEET_KEEP_GENERATIONS`` | member-record generations kept per index | 4 |

Chaos (``utils/chaos.py``): the worker's beat loop fires
``fleet.member@<idx>`` once per turn: ``=exit@N`` ends the process
(``os._exit(117)``), ``=wedge@N`` blocks the beat loop so the member goes
publication-silent while its HTTP threads still answer (the zombie the
condemnation exists for).
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ..parallel.elastic import _read_json, _write_json
from ..utils import config, file_io, telemetry
from .control import ReplicaLostError

logger = logging.getLogger("bigdl_torch")

__all__ = ["MemberLostError", "FleetSupervisor", "MEMBER_FORMAT",
           "HEARTBEAT_DIRNAME", "publish_member", "read_member",
           "read_registry", "beat", "read_heartbeat", "member_alive",
           "condemn", "condemned_generation", "default_spawner",
           "lost_after_seconds"]

#: the member record's format tag, the reference's: both packages write
#: and read each other's records
MEMBER_FORMAT = "bigdl_tpu-fleet-member-v1"

#: liveness subdir — same name and schema as parallel/elastic, so the
#: trace/debug tooling that reads elastic heartbeats reads fleet ones too
HEARTBEAT_DIRNAME = "heartbeats"

_MEMBER_RE = re.compile(r"member\.(\d+)\.(\d+)")


class MemberLostError(ReplicaLostError):
    """A fleet member went publication-silent (or no member is live to
    take a request).  Subclasses :class:`ReplicaLostError` so the HTTP
    front end's typed 503 + Retry-After mapping applies unchanged — the
    caller backs off while the supervisor replaces the process."""

    def __init__(self, message: str, *, index: Optional[int] = None,
                 generation: Optional[int] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.index = index
        self.generation = generation
        self.retry_after_s = retry_after_s


def lost_after_seconds() -> float:
    return config.get_float("FLEET_MEMBER_LOST", 5.0)


def keep_generations() -> int:
    return config.get_int("FLEET_KEEP_GENERATIONS", 4)


# ---------------------------------------------------------------------------
# registry files
# ---------------------------------------------------------------------------

def _heartbeat_dir(fleet_dir: str) -> str:
    return file_io._join(file_io._strip_file_scheme(str(fleet_dir)),
                         HEARTBEAT_DIRNAME)


def publish_member(fleet_dir: str, *, index: int, generation: int,
                   pid: int, port: int, host: str = "127.0.0.1",
                   devices: Optional[List[str]] = None,
                   buckets: Optional[List[int]] = None,
                   max_batch: Optional[int] = None,
                   wall_time: Optional[float] = None) -> str:
    """WORKER side: publish this life's CRC-framed member record and
    sweep records from dead generations (writer-side retention — the
    shared :func:`file_io.sweep_numbered` bound)."""
    base = file_io._strip_file_scheme(str(fleet_dir))
    record = {"format": MEMBER_FORMAT, "index": int(index),
              "generation": int(generation), "pid": int(pid),
              "host": str(host), "port": int(port),
              "devices": [str(d) for d in (devices or [])],
              "buckets": [int(b) for b in (buckets or [])],
              "max_batch": int(max_batch) if max_batch else None,
              "wall_time": float(wall_time if wall_time is not None
                                 else time.time())}
    fs = file_io.get_filesystem(base)
    fs.makedirs(base)
    path = file_io._join(base, f"member.{int(index)}.{int(generation)}")
    fs.write_bytes(path, file_io.frame_bytes(pickle.dumps(record)))
    file_io.sweep_numbered(base, rf"member\.{int(index)}\.(\d+)",
                           keep=keep_generations())
    return path


def read_member(path: str) -> Optional[dict]:
    """One member record, CRC-verified; None for torn/corrupt/absent
    bytes (the consumer polls — same contract as elastic's
    ``_read_json``)."""
    try:
        fs = file_io.get_filesystem(path)
        if not fs.exists(path):
            return None
        record = pickle.loads(file_io.unframe_bytes(fs.read_bytes(path)))
    except Exception:  # noqa: BLE001 — a half-written or bit-rotted
        # record reads as absent; the next publish replaces it
        return None
    if not isinstance(record, dict) or record.get("format") != MEMBER_FORMAT:
        return None
    return record


def read_registry(fleet_dir: str) -> Dict[int, dict]:
    """index -> newest VERIFIED member record whose generation survives
    condemnation.  Records from condemned generations — and records that
    fail the CRC frame — are invisible, so a stale or torn registry
    entry can never attract traffic."""
    base = file_io._strip_file_scheme(str(fleet_dir))
    fs = file_io.get_filesystem(base)
    try:
        names = fs.listdir(base) if fs.isdir(base) else []
    except Exception:  # noqa: BLE001 — dir may not exist yet
        return {}
    by_index: Dict[int, List[int]] = {}
    for name in names:
        m = _MEMBER_RE.fullmatch(name)
        if m:
            by_index.setdefault(int(m.group(1)), []).append(int(m.group(2)))
    registry = {}
    for idx, gens in by_index.items():
        floor = condemned_generation(base, idx)
        for gen in sorted(gens, reverse=True):
            if gen <= floor:
                break  # everything older is condemned too
            record = read_member(file_io._join(base, f"member.{idx}.{gen}"))
            if record is not None:
                registry[idx] = record
                break
    return registry


def beat(fleet_dir: str, index: int, generation: int, count: int, *,
         phase: str = "serve", wall_time: Optional[float] = None) -> str:
    """WORKER side: restamp this member's liveness heartbeat (elastic
    schema — ``published`` is the stamp whose age IS the loss signal)."""
    now = float(wall_time if wall_time is not None else time.time())
    return _write_json(_heartbeat_dir(fleet_dir), f"heartbeat.{int(index)}",
                       {"rank": int(index), "phase": str(phase),
                        "count": int(count), "time": now,
                        "published": now, "generation": int(generation)})


def read_heartbeat(fleet_dir: str, index: int) -> Optional[dict]:
    return _read_json(file_io._join(_heartbeat_dir(fleet_dir),
                                    f"heartbeat.{int(index)}"))


def member_alive(fleet_dir: str, index: int, *,
                 generation: Optional[int] = None,
                 lost_after: Optional[float] = None,
                 now: Optional[float] = None) -> bool:
    """Publication-freshness liveness: True when member `index` has a
    heartbeat of (at least) `generation` whose ``published`` stamp is
    younger than the silence threshold.  A registry record WITHOUT a
    fresh heartbeat is a stale entry, not a member."""
    hb = read_heartbeat(fleet_dir, index)
    if hb is None:
        return False
    if generation is not None and int(hb.get("generation", 0)) < generation:
        return False
    lost_after = lost_after_seconds() if lost_after is None else lost_after
    now = time.time() if now is None else now
    return (now - float(hb.get("published", 0.0))) <= lost_after


def condemn(fleet_dir: str, index: int, generation: int) -> str:
    """SUPERVISOR side: declare every life of member `index` up to and
    including `generation` dead.  Monotonic (never lowered): a late
    verdict for an old generation cannot un-condemn a newer one."""
    base = file_io._strip_file_scheme(str(fleet_dir))
    floor = condemned_generation(base, index)
    generation = max(int(generation), floor)
    path = _write_json(base, f"condemn.{int(index)}",
                       {"index": int(index), "generation": generation,
                        "time": time.time()})
    telemetry.instant("fleet.condemn", cat="fleet", index=int(index),
                      generation=generation)
    return path


def condemned_generation(fleet_dir: str, index: int) -> int:
    """Newest condemned generation for member `index` (0 when none)."""
    doc = _read_json(file_io._join(
        file_io._strip_file_scheme(str(fleet_dir)), f"condemn.{int(index)}"))
    return int(doc.get("generation", 0)) if doc else 0


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def default_spawner(fleet_dir: str, *, model: str = "linear",
                    extra_args: tuple = (), env: Optional[dict] = None,
                    python: Optional[str] = None) -> Callable:
    """A ``spawn(index, generation) -> Popen`` running ``python -m
    bigdl_torch.tools.serve_worker`` with the stock arguments and
    ``extra_args`` (``--device cpu``, say) in the inherited environment,
    the package's parent directory on ``PYTHONPATH``.  Drills and tests
    inject their own spawner (a chaos spec per member)."""
    package_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def spawn(index: int, generation: int):
        cmd = [python or sys.executable, "-m",
               "bigdl_torch.tools.serve_worker",
               "--fleet-dir", str(fleet_dir),
               "--index", str(int(index)),
               "--generation", str(int(generation)),
               "--model", model] + list(extra_args)
        child_env = dict(env if env is not None else os.environ)
        child_env.setdefault("PYTHONPATH", package_parent)
        return subprocess.Popen(cmd, env=child_env)

    return spawn


# ---------------------------------------------------------------------------
# supervision
# ---------------------------------------------------------------------------

class _Slot:
    """One supervised member index: its process handle and restart
    bookkeeping (a server replica's restart state, lifted to a
    process)."""

    __slots__ = ("proc", "generation", "restarts", "degraded",
                 "spawned_at", "respawn_at", "last_error")

    def __init__(self):
        self.proc = None
        self.generation = 0
        self.restarts = 0
        self.degraded = False
        self.spawned_at = 0.0
        self.respawn_at = None   # pending-backoff deadline, monotonic
        self.last_error = None


class FleetSupervisor:
    """Supervise N worker processes through the shared fleet dir.

    The monitor thread polls liveness (heartbeat publication silence OR
    process exit), and on loss: records a typed
    :class:`MemberLostError`, CONDEMNS the lost generation (the bump a
    waking zombie exits on), best-effort kills the pid, and schedules a
    respawn at generation+1 under exponential backoff.  Past
    ``restart_budget`` respawns the slot DEGRADES — the fleet serves
    from the survivors instead of flapping a poisoned member forever
    (the server replicas' restart budget, one level up)."""

    def __init__(self, fleet_dir: str, spawn: Optional[Callable] = None, *,
                 members: int = 3, lost_after_s: Optional[float] = None,
                 restart_budget: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 clock=None, wall=None):
        self.fleet_dir = file_io._strip_file_scheme(str(fleet_dir))
        self.spawn = spawn or default_spawner(self.fleet_dir)
        self.members = int(members)
        self.lost_after_s = (lost_after_seconds() if lost_after_s is None
                             else float(lost_after_s))
        self.restart_budget = (config.get_int("FLEET_RESTART_BUDGET", 3)
                               if restart_budget is None
                               else int(restart_budget))
        self.backoff_s = (config.get_float("FLEET_RESTART_BACKOFF", 0.5)
                          if backoff_s is None else float(backoff_s))
        self.grace_s = (config.get_float("FLEET_SPAWN_GRACE", 30.0)
                        if grace_s is None else float(grace_s))
        self.poll_s = (config.get_float("FLEET_POLL", 0.5)
                       if poll_s is None else float(poll_s))
        self.clock = clock or time.monotonic
        self.wall = wall or time.time
        self._slots = [_Slot() for _ in range(self.members)]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.last_error: Optional[MemberLostError] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            return self
        for i in range(self.members):
            self._spawn(i)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="bigdl-fleet-supervisor")
        self._thread.start()
        logger.info("fleet: supervising %d member(s) in %s (silence "
                    "threshold %.1fs, restart budget %d)", self.members,
                    self.fleet_dir, self.lost_after_s, self.restart_budget)
        return self

    def stop(self, terminate: bool = True, timeout: float = 15.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self.poll_s * 4, 2.0))
        if not terminate:
            return
        procs = []
        with self._lock:
            for i, slot in enumerate(self._slots):
                if slot.proc is not None and slot.proc.poll() is None:
                    # condemn so a worker that misses the signal still
                    # exits on its next beat
                    condemn(self.fleet_dir, i, slot.generation)
                    try:
                        slot.proc.terminate()
                    except Exception:  # noqa: BLE001 — already gone
                        pass
                    procs.append(slot.proc)
        deadline = self.clock() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - self.clock(), 0.1))
            except Exception:  # noqa: BLE001 — a straggler gets the axe
                try:
                    p.kill()
                except Exception:  # noqa: BLE001
                    pass

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- spawning -------------------------------------------------------

    def _next_generation(self, index: int) -> int:
        """Past every condemned life AND past any frozen heartbeat a
        previous run left behind (the elastic announce_join rule: a
        returning life must outrank its ghost)."""
        floor = condemned_generation(self.fleet_dir, index)
        hb = read_heartbeat(self.fleet_dir, index)
        if hb:
            floor = max(floor, int(hb.get("generation", 0)))
        return floor + 1

    def _spawn(self, index: int) -> None:
        generation = self._next_generation(index)
        proc = self.spawn(index, generation)
        with self._lock:
            slot = self._slots[index]
            slot.proc = proc
            slot.generation = generation
            slot.spawned_at = self.clock()
            slot.respawn_at = None
        telemetry.instant("fleet.spawn", cat="fleet", index=index,
                          generation=generation,
                          pid=getattr(proc, "pid", None))
        logger.info("fleet: spawned member %d generation %d (pid %s)",
                    index, generation, getattr(proc, "pid", None))

    # -- monitoring -----------------------------------------------------

    def _slot_alive(self, index: int, slot: _Slot) -> bool:
        if slot.proc is not None and slot.proc.poll() is not None:
            return False  # the process itself is gone: no grace needed
        if member_alive(self.fleet_dir, index, generation=slot.generation,
                        lost_after=self.lost_after_s, now=self.wall()):
            return True
        # a fresh spawn gets a grace window to import/compile/bind
        # before silence counts — but only until its FIRST heartbeat
        hb = read_heartbeat(self.fleet_dir, index)
        in_grace = self.clock() - slot.spawned_at < self.grace_s
        not_yet_beating = (hb is None or
                           int(hb.get("generation", 0)) < slot.generation)
        return in_grace and not_yet_beating

    def _handle_loss(self, index: int) -> None:
        with self._lock:
            slot = self._slots[index]
            slot.restarts += 1
            restarts = slot.restarts
            generation = slot.generation
            proc = slot.proc
            err = MemberLostError(
                f"fleet: member {index} (generation {generation}) went "
                f"publication-silent past {self.lost_after_s:.1f}s",
                index=index, generation=generation,
                retry_after_s=self.backoff_s * (2 ** max(restarts - 1, 0)))
            slot.last_error = err
            self.last_error = err
        telemetry.instant("fleet.lost", cat="fleet", index=index,
                          generation=generation, restarts=restarts)
        logger.warning("%s (restart %d/%d)", err, restarts,
                       self.restart_budget)
        # condemn FIRST: a zombie that wakes after the kill misses must
        # still see the bump and exit before the replacement registers
        condemn(self.fleet_dir, index, generation)
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except Exception:  # noqa: BLE001 — already reaped
                pass
        with self._lock:
            if restarts > self.restart_budget:
                slot.degraded = True
                slot.respawn_at = None
            else:
                backoff = self.backoff_s * (2 ** max(restarts - 1, 0))
                slot.respawn_at = self.clock() + backoff
        if restarts > self.restart_budget:
            telemetry.instant("fleet.degraded", cat="fleet", index=index,
                              restarts=restarts)
            logger.error("fleet: member %d past restart budget %d — "
                         "slot DEGRADED, serving from survivors", index,
                         self.restart_budget)

    def _loop(self) -> None:
        telemetry.thread_name("fleet supervisor")
        while not self._stop.is_set():
            now = self.clock()
            for i in range(self.members):
                with self._lock:
                    slot = self._slots[i]
                    degraded = slot.degraded
                    respawn_at = slot.respawn_at
                if degraded:
                    continue
                if respawn_at is not None:
                    if now >= respawn_at:
                        self._spawn(i)
                        telemetry.instant("fleet.respawn", cat="fleet",
                                          index=i)
                    continue
                if not self._slot_alive(i, slot):
                    self._handle_loss(i)
            st = self.stats()
            telemetry.counter("fleet", live=st["live"],
                              restarts=st["restarts"],
                              degraded=st["degraded"])
            self._stop.wait(self.poll_s)

    # -- introspection --------------------------------------------------

    def live_count(self) -> int:
        return sum(1 for i in range(self.members)
                   if not self._slots[i].degraded
                   and member_alive(self.fleet_dir, i,
                                    generation=self._slots[i].generation,
                                    lost_after=self.lost_after_s,
                                    now=self.wall()))

    def healthy(self) -> bool:
        """True while ANY supervised member is live — degradation to
        survivors, not death with one."""
        return self.live_count() > 0

    def stats(self) -> dict:
        with self._lock:
            slots = {str(i): {
                "generation": s.generation,
                "pid": getattr(s.proc, "pid", None),
                "restarts": s.restarts,
                "degraded": s.degraded,
                "respawn_pending": s.respawn_at is not None,
                "last_error": str(s.last_error) if s.last_error else None,
            } for i, s in enumerate(self._slots)}
            restarts = sum(s.restarts for s in self._slots)
            degraded = sum(1 for s in self._slots if s.degraded)
        return {"members": self.members, "live": self.live_count(),
                "restarts": restarts, "degraded": degraded,
                "slots": slots,
                "last_error": (str(self.last_error)
                               if self.last_error else None)}
