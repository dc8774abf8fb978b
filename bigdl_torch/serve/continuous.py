"""Continuous train-to-serve deployment: release lineage and controller.

Counterpart of ``bigdl_tpu/serve/continuous.py``, all of it:

- :class:`ReleasePublisher`, the training side: the Optimizer's checkpoint
  path (``set_checkpoint(..., publish=True)``) writes one release entry a
  published snapshot, ``release.<id>`` (a monotonic id), a framed pickle
  (``file_io.frame_bytes``) of epoch, iteration, the training metrics,
  the snapshot's path and its frame fingerprint
  (``file_io.frame_fingerprint``).  The entry is the reference's format,
  so each package reads the other's releases.
- :class:`DeployController`, the serving side: it watches the lineage
  (``file_io.watch_lineage``), verifies every new entry and the snapshot
  it names before anything is served (a corrupt entry, a missing or
  damaged snapshot, or one rewritten after publication, whose fingerprint
  no longer matches, is renamed ``.corrupt`` and recorded as a typed
  :class:`ReleaseRejected`), and canaries a verified release into the
  live server (``swap(snapshot, canary_fraction=f)``); the server's canary
  comparator promotes or rolls it back, and the controller waits for the
  verdict before it takes the next release.  Past ``rollback_budget``
  consecutive rollbacks it freezes (unhealthy in ``stats()["deploy"]``).
  The version timeline (deployed, promoted, rolled_back, rejected,
  frozen) is kept for ``versions()`` (``/v1/versions``) and emitted on
  the ``deploy`` telemetry track.

A target that declares ``fleet = True`` (``serve/fleetfront.FleetFront``,
worker processes behind one front) gets each release fanned out: the
front's ``swap`` canaries it on its lowest live member, then rolls it over
the others with at most ``max_unavailable`` members swapping at a time;
the verdict comes back through the front's ``stats()["canary"]`` as from
one server.

Fault point (``utils/chaos.py``): ``deploy.publish`` fires once per entry
write and a ``corrupt@N`` schedule mutates the framed bytes.

Knobs (``utils/config``; constructor arguments override):

| env var | meaning | default |
|---|---|---|
| ``BIGDL_TORCH_DEPLOY_CANARY_FRACTION`` | canary batch fraction per release; 0 = plain full swaps | 0.25 |
| ``BIGDL_TORCH_DEPLOY_ROLLBACK_BUDGET`` | consecutive canary rollbacks before the controller freezes | 2 |
| ``BIGDL_TORCH_DEPLOY_POLL_S`` | lineage poll cadence, seconds | 0.25 |
| ``BIGDL_TORCH_DEPLOY_DECISION_TIMEOUT`` | seconds to wait for a canary verdict; past it the controller freezes (0 = forever) | 0 |
| ``BIGDL_TORCH_DEPLOY_MAX_UNAVAILABLE`` | fleet mode: members swapping at once during the rolling fan-out | 1 |
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import threading
import time
from typing import Dict, List, Optional

from ..utils import chaos, config, file_io, telemetry
from .batcher import ServeError

logger = logging.getLogger("bigdl_torch")

__all__ = ["ReleaseRejected", "ReleasePublisher", "DeployController",
           "RELEASE_PATTERN", "RELEASE_FORMAT", "read_release"]

#: release entry file names: ``release.<monotonic id>``
RELEASE_PATTERN = r"release\.(\d+)"
#: the entry's format tag, the reference's: both packages write and read it
RELEASE_FORMAT = "bigdl_tpu-release-v1"


class ReleaseRejected(ServeError):
    """A lineage release entry failed verification before deployment —
    corrupt/truncated entry bytes, a missing or CRC-failing snapshot, or
    a snapshot whose frame fingerprint no longer matches the one recorded
    at publication (rewritten after publish).  The controller quarantines
    the entry, records the typed rejection in the timeline, and moves on
    to the next release — a bad publish never reaches traffic and never
    stops the feed."""

    def __init__(self, message: str, release_id: Optional[int] = None):
        super().__init__(message)
        self.release_id = release_id


# ---------------------------------------------------------------------------
# the training side: release publication
# ---------------------------------------------------------------------------


class ReleasePublisher:
    """Emit release entries into a lineage directory (any file_io scheme).

    One entry per :meth:`publish`: ``release.<id>`` with a monotonic id
    resumed from the directory contents (quarantined ids are never
    reused), CRC-framed exactly like checkpoints so the consumer's
    ``file_io.load`` verifies it for free.  The write goes through the
    scheme's own atomicity (local tmp+rename, retried remote ops) — a
    watcher can never list a half-written entry under its final name."""

    def __init__(self, lineage_dir: str, clock=None):
        self.dir = file_io._strip_file_scheme(str(lineage_dir))
        self.clock = clock or time.time
        self._lock = threading.Lock()
        self._next = self._scan_next()
        self.published = 0

    def _scan_next(self) -> int:
        fs = file_io.get_filesystem(self.dir)
        try:
            names = fs.listdir(self.dir) if fs.isdir(self.dir) else []
        except Exception:  # noqa: BLE001 — an empty/unreachable dir just
            # starts the id sequence; the first write surfaces real errors
            names = []
        newest = 0
        for n in names:
            m = re.fullmatch(RELEASE_PATTERN + r"(?:\.corrupt)?", n)
            if m:
                newest = max(newest, int(m.group(1)))
        return newest + 1

    def publish(self, model_path: str, *, neval: int,
                epoch: Optional[int] = None,
                iteration: Optional[int] = None,
                metrics: Optional[dict] = None) -> int:
        """Write one release entry for the snapshot at `model_path`;
        returns the release id.  The snapshot must already be on storage
        — its frame fingerprint is read here and pinned into the entry so
        the consumer can prove it serves the bytes that were published."""
        model_path = file_io._strip_file_scheme(str(model_path))
        try:
            fingerprint = file_io.frame_fingerprint(model_path)
        except Exception as e:  # noqa: BLE001 — refuse to publish a
            # snapshot we cannot even read: the entry would be dead on
            # arrival at the controller
            raise ReleaseRejected(
                f"publish: cannot fingerprint snapshot {model_path} "
                f"({type(e).__name__}: {e})") from e
        with self._lock:
            rid = self._next
            self._next += 1
        entry = {"format": RELEASE_FORMAT, "release_id": rid,
                 "neval": int(neval),
                 "epoch": None if epoch is None else int(epoch),
                 "iteration": int(neval if iteration is None else iteration),
                 "metrics": dict(metrics or {}),
                 "model_path": model_path,
                 "model_name": os.path.basename(model_path),
                 "fingerprint": fingerprint,
                 "wall_time": self.clock()}
        payload = pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL)
        # the chaos point mutates the FRAMED bytes: a corrupt@N schedule
        # lands an entry whose CRC verification must fail at the consumer
        data = chaos.transform("deploy.publish",
                               file_io.frame_bytes(payload))
        fs = file_io.get_filesystem(self.dir)
        fs.makedirs(self.dir)
        fs.write_bytes(file_io._join(self.dir, f"release.{rid}"), data)
        with self._lock:
            self.published += 1
            published = self.published
        telemetry.instant("deploy.publish", cat="deploy", release=rid,
                          neval=int(neval))
        telemetry.counter("deploy", published=published)
        logger.info("release %d published -> %s (snapshot %s, neval %d)",
                    rid, self.dir, entry["model_name"], int(neval))
        return rid


def read_release(path: str) -> dict:
    """Load + verify one release entry; raises
    :class:`~bigdl_torch.utils.file_io.CorruptCheckpoint` on frame/payload
    corruption and :class:`ReleaseRejected` on a well-formed blob that is
    not a release entry."""
    blob = file_io.load(path)
    if not isinstance(blob, dict) or blob.get("format") != RELEASE_FORMAT:
        got = (blob.get("format") if isinstance(blob, dict)
               else type(blob).__name__)
        raise ReleaseRejected(f"{path}: not a release entry "
                              f"(format {got!r})")
    return blob


# ---------------------------------------------------------------------------
# the serving side: the deployment controller
# ---------------------------------------------------------------------------


class DeployController:
    """Watch a release lineage and drive a live server's swap/canary path
    (see module docstring).

    ``server`` needs ``swap(source, canary_fraction=)`` + ``stats()``
    (InferenceServer; a stub suffices in tests).  All public state
    (counters, timeline, frozen flag) is lock-guarded; the watch loop
    runs on one daemon thread started by :meth:`start`."""

    def __init__(self, server, lineage_dir: str, *,
                 canary_fraction: Optional[float] = None,
                 rollback_budget: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 decision_timeout: Optional[float] = None,
                 max_unavailable: Optional[int] = None,
                 since: int = 0, clock=None,
                 timeline_limit: int = 256):
        self.server = server
        #: fleet mode: a target declaring ``fleet = True`` gets releases
        #: fanned out, a canary member then rolling swaps of at most
        #: ``max_unavailable`` members at a time
        self.fleet_mode = bool(getattr(server, "fleet", False))
        self.max_unavailable = max(1, int(
            max_unavailable if max_unavailable is not None
            else config.get_int("DEPLOY_MAX_UNAVAILABLE", 1)))
        self.dir = file_io._strip_file_scheme(str(lineage_dir))
        f = (canary_fraction if canary_fraction is not None
             else config.get_float("DEPLOY_CANARY_FRACTION", 0.25))
        # outside (0, 1) means plain full swaps — no canary phase
        self.canary_fraction = float(f) if 0.0 < float(f) < 1.0 else None
        self.rollback_budget = int(
            rollback_budget if rollback_budget is not None
            else config.get_int("DEPLOY_ROLLBACK_BUDGET", 2))
        self.poll_s = float(poll_s if poll_s is not None
                            else config.get_float("DEPLOY_POLL_S", 0.25))
        self.decision_timeout = float(
            decision_timeout if decision_timeout is not None
            else config.get_float("DEPLOY_DECISION_TIMEOUT", 0.0))
        self.clock = clock or time.monotonic
        self.since = int(since)
        self.timeline_limit = int(timeline_limit)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.counts: Dict[str, int] = {
            "seen": 0, "deployed": 0, "promoted": 0, "rolled_back": 0,
            "rejected": 0}
        self.consecutive_rollbacks = 0
        self.frozen: Optional[str] = None   # freeze reason, None = healthy
        self.last_release: Optional[int] = None
        self.timeline: List[dict] = []

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "DeployController":
        if self._thread is not None:
            return self
        attach = getattr(self.server, "attach_deploy", None)
        if attach is not None:
            attach(self)   # stats()["deploy"] / /v1/stats integration
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="bigdl-deploy-controller")
        self._thread.start()
        logger.info("deploy: controller watching %s (canary_fraction=%s, "
                    "rollback_budget=%d)", self.dir,
                    self.canary_fraction, self.rollback_budget)
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
        self._thread = None

    def healthy(self) -> bool:
        """False once frozen (rollback budget spent, decision timeout, or
        a controller crash) — the outer orchestrator's replace-me signal,
        surfaced in ``/v1/stats`` and ``/v1/versions``."""
        return self.frozen is None

    # -- the watch loop -------------------------------------------------

    def _loop(self) -> None:
        telemetry.thread_name("deploy controller")
        stop = lambda: self._stop.is_set() or self.frozen is not None  # noqa: E731
        try:
            for rid, path in file_io.watch_lineage(
                    self.dir, since=self.since, pattern=RELEASE_PATTERN,
                    poll=self.poll_s, clock=self.clock,
                    sleep=lambda s: self._stop.wait(s), stop=stop):
                self._handle(rid, path)
        except Exception as e:  # noqa: BLE001 — a crashed controller must
            # flag itself unhealthy, not die silently while the operator
            # believes deployments still flow
            logger.exception("deploy: controller loop crashed")
            self._freeze(self.last_release,
                         f"controller error: {type(e).__name__}: {e}")

    def _handle(self, rid: int, path: str) -> None:
        with self._lock:
            self.counts["seen"] += 1
            self.last_release = rid
        try:
            entry = self._verify(rid, path)
        except ReleaseRejected as e:
            self._quarantine(path)
            self._record("rejected", rid, reason=e)
            return
        try:
            self._deploy(rid, entry)
        except Exception as e:  # noqa: BLE001 — a release whose swap
            # fails (unbuildable module, engine error) is rejected typed;
            # the feed keeps flowing
            self._record("rejected", rid, reason=e)

    def _verify(self, rid: int, path: str) -> dict:
        """CRC-verify the entry AND the snapshot it points at before any
        of it goes near traffic; raises :class:`ReleaseRejected`."""
        try:
            entry = read_release(path)
        except (file_io.CorruptCheckpoint, OSError) as e:
            raise ReleaseRejected(
                f"release {rid}: unreadable entry "
                f"({type(e).__name__}: {e})", rid) from e
        model_path = entry.get("model_path") or ""
        fs = file_io.get_filesystem(model_path or self.dir)
        if not model_path or not fs.exists(model_path):
            # trainer and server may mount the lineage at different
            # paths: fall back to the snapshot's basename beside the dir
            alt = file_io._join(self.dir, entry.get("model_name") or "")
            if entry.get("model_name") and \
                    file_io.get_filesystem(alt).exists(alt):
                model_path = alt
            else:
                raise ReleaseRejected(
                    f"release {rid}: snapshot {model_path or '<none>'} "
                    "does not exist (pruned or quarantined after "
                    "publication)", rid)
        try:
            file_io.verify(model_path)
        except (file_io.CorruptCheckpoint, OSError) as e:
            raise ReleaseRejected(
                f"release {rid}: snapshot {model_path} failed "
                f"verification ({type(e).__name__}: {e})", rid) from e
        want = entry.get("fingerprint")
        if want is not None:
            got = file_io.frame_fingerprint(model_path)
            if got is None or tuple(got) != tuple(want):
                raise ReleaseRejected(
                    f"release {rid}: snapshot {model_path} fingerprint "
                    f"{got} != published {tuple(want)} (rewritten after "
                    "publication)", rid)
        entry["_model_path"] = model_path
        return entry

    def _quarantine(self, path: str) -> None:
        """Rename a rejected entry aside (``.corrupt``): it drops out of
        every future lineage walk but stays on storage for forensics —
        same contract as checkpoint quarantine."""
        fs = file_io.get_filesystem(path)
        try:
            if fs.exists(path):
                fs.rename(path, path + ".corrupt")
                logger.warning("deploy: quarantined release entry %s -> "
                               "%s.corrupt", path, path)
        except Exception as e:  # noqa: BLE001 — best-effort: the feed
            # must keep moving even when the store refuses the rename
            logger.warning("deploy: could not quarantine %s: %s", path, e)

    def _deploy(self, rid: int, entry: dict) -> None:
        fraction = self.canary_fraction
        kwargs = {"canary_fraction": fraction}
        if self.fleet_mode:
            kwargs["max_unavailable"] = self.max_unavailable
        vid = self.server.swap(entry["_model_path"], **kwargs)
        self._record("deployed", rid, version=vid,
                     neval=entry.get("neval"),
                     **({"fleet": True} if self.fleet_mode else {}))
        if fraction is None:
            # plain full swap: live immediately, nothing to observe
            with self._lock:
                self.consecutive_rollbacks = 0
            self._record("promoted", rid, version=vid,
                         neval=entry.get("neval"), verdict="full_swap")
            return
        verdict = self._await_decision(vid)
        if verdict is None:
            return  # stopping — leave the in-flight canary to the server
        state = verdict.get("state")
        if state == "promoted":
            with self._lock:
                self.consecutive_rollbacks = 0
            self._record("promoted", rid, version=vid,
                         neval=entry.get("neval"), verdict=verdict)
        elif state == "rolled_back":
            with self._lock:
                self.consecutive_rollbacks += 1
                over = self.consecutive_rollbacks > self.rollback_budget
            self._record("rolled_back", rid, version=vid,
                         neval=entry.get("neval"), verdict=verdict)
            if over:
                self._freeze(rid, f"{self.consecutive_rollbacks} "
                             "consecutive canary rollbacks (budget "
                             f"{self.rollback_budget}) — the release "
                             "feed looks systematically bad")
        else:
            # an undecided canary past the deadline: proceeding would
            # stack canaries; freeze and flag instead of guessing
            self._freeze(rid, f"canary v{vid} (release {rid}) undecided "
                         f"after {self.decision_timeout:g}s")

    def _await_decision(self, vid: int) -> Optional[dict]:
        """Poll the server's canary summary until version `vid` resolves
        (promoted/rolled_back), the decision deadline passes, or stop()
        is requested (returns None)."""
        t0 = self.clock()
        while not self._stop.is_set():
            try:
                summary = (self.server.stats() or {}).get("canary") or {}
            except Exception:  # noqa: BLE001 — a stats hiccup is not a
                # verdict; keep waiting
                summary = {}
            if summary.get("version") == vid and \
                    summary.get("state") in ("promoted", "rolled_back"):
                return dict(summary)
            if 0 < self.decision_timeout < self.clock() - t0:
                return {"state": "timeout"}
            self._stop.wait(0.02)
        return None

    # -- timeline / stats -----------------------------------------------

    def _record(self, action: str, rid: int, *, version=None, neval=None,
                reason=None, verdict=None, fleet=None) -> None:
        ev = {"release": int(rid), "action": action,
              "time": round(time.time(), 3)}
        if version is not None:
            ev["version"] = int(version)
        if neval is not None:
            ev["neval"] = int(neval)
        if reason is not None:
            ev["reason"] = str(reason)
            ev["reason_type"] = type(reason).__name__
        if isinstance(verdict, dict):
            ev["verdict"] = {k: verdict[k] for k in
                             ("state", "reason", "reason_type", "routed",
                              "total") if k in verdict}
        elif verdict is not None:
            ev["verdict"] = str(verdict)
        if fleet:
            ev["fleet"] = True
        with self._lock:
            if action in self.counts:
                self.counts[action] += 1
            self.timeline.append(ev)
            del self.timeline[:-self.timeline_limit]
            snap = dict(self.counts)
            consecutive = self.consecutive_rollbacks
            frozen = self.frozen is not None
        telemetry.instant(f"deploy.{action}", cat="deploy", release=rid,
                          **({"reason": str(reason)} if reason else {}))
        telemetry.counter("deploy", deployed=snap["deployed"],
                          promoted=snap["promoted"],
                          rolled_back=snap["rolled_back"],
                          rejected=snap["rejected"],
                          consecutive_rollbacks=consecutive,
                          frozen=int(frozen))
        log = logger.error if action in ("rejected", "rolled_back",
                                         "frozen") else logger.info
        log("deploy: release %d %s%s", rid, action,
            f" — {reason}" if reason else
            (f" (version {version})" if version is not None else ""))

    def _freeze(self, rid, reason: str) -> None:
        with self._lock:
            if self.frozen is not None:
                return
            self.frozen = reason
        telemetry.instant("deploy.frozen", cat="deploy", reason=reason)
        self._record("frozen", rid if rid is not None else -1,
                     reason=ReleaseRejected(reason))
        logger.error("deploy: controller FROZEN — %s; no further "
                     "releases will deploy until it is restarted", reason)

    def stats(self) -> dict:
        """The ``stats()["deploy"]`` blob (bounded timeline tail)."""
        with self._lock:
            out = {"watching": self.dir,
                   "healthy": self.frozen is None,
                   "frozen": self.frozen is not None,
                   "frozen_reason": self.frozen,
                   "canary_fraction": self.canary_fraction,
                   "rollback_budget": self.rollback_budget,
                   "consecutive_rollbacks": self.consecutive_rollbacks,
                   "last_release": self.last_release}
            out.update(self.counts)
            out["timeline"] = [dict(e) for e in self.timeline[-16:]]
        return out

    def versions(self) -> dict:
        """The FULL model-version timeline (``/v1/versions``)."""
        with self._lock:
            return {"healthy": self.frozen is None,
                    "frozen": self.frozen is not None,
                    "frozen_reason": self.frozen,
                    "last_release": self.last_release,
                    "timeline": [dict(e) for e in self.timeline]}
