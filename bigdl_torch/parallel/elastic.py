"""Elastic training: coordinated host-loss recovery and re-admission.

Counterpart of ``bigdl_tpu/parallel/elastic.py``, all of it, pure Python
over ``utils/file_io.py``; its files are the reference's (the same names,
JSON fields and CRC-verified lineage entries), so each package reads the
other's.  A synchronous data-parallel job whose peer process dies hangs in
its next collective; the reference's driver re-formed the job from
checkpoints (DistriOptimizer.scala:750-816).  Without a driver the ranks do
it among themselves, through files only:

1. **detect**: every rank's supervisor (``utils/supervisor.py``) promotes a
   peer whose heartbeat PUBLICATION has been silent for
   ``BIGDL_TORCH_ELASTIC_PEER_LOST`` seconds into a
   :class:`PeerLostError`, async-raised into the train loop, and publishes
   an epoch-stamped ``elastic/recover.<rank>`` intent that the other
   survivors converge on at their next poll.  A rank stuck in a step still
   publishes from its monitor thread; only a dead one goes silent.
2. **negotiate** (:func:`negotiate`): each survivor publishes its verified
   lineage view (``elastic/lineage.<rank>``), reads the others', and all
   take the newest entry valid for every responder; the leader (the lowest
   responding rank) quarantines the entries newer than that.
3. **re-form**: the Optimizer loads the agreed snapshot, re-forms the
   logical topology (``Engine.reform``), rescales each batcher to keep the
   global batch (``ceil(B * W / W')``) and resumes.
4. **grow**: a returning rank waits for its :func:`death_certificate`,
   then :func:`announce_join` restamps its heartbeat at a higher
   generation, deletes its previous life's protocol files and publishes
   ``elastic/join.<rank>``; the survivors see it at their next checkpoint
   boundary, the writer publishes ``elastic/grow.<epoch>`` naming the wider
   survivor set, and every party, the joiner too, negotiates the same
   round and adopts the snapshot just written.  A join seen while a shrink
   is pending waits for the next boundary.
5. **drill**: chaos ``host.lost@<rank>`` (exit or wedge) and
   ``host.return@<rank>`` (the joiner's announcement gate);
   ``bigdl_torch/tools/elastic_smoke.py`` runs both drills with processes.

The ranks are separate processes that share the checkpoint store, with the
logical topology declared by ``BIGDL_TORCH_ELASTIC_WORLD`` / ``_RANK``
(``utils/engine.py``).  A live ``torch.distributed`` group does not shrink
in place: its survivors restart into the smaller world.

Knobs (``utils/config.py``):

| env var | meaning | default |
|---|---|---|
| ``BIGDL_TORCH_ELASTIC_PEER_LOST`` | publication-silence seconds that promote a peer to LOST (0 = elasticity off) | 0 |
| ``BIGDL_TORCH_ELASTIC_WORLD`` / ``_ELASTIC_RANK`` | the logical topology of separate processes | off |
| ``BIGDL_TORCH_ELASTIC_NEGOTIATE_TIMEOUT`` | seconds to wait for every survivor's lineage view | 60 |
| ``BIGDL_TORCH_ELASTIC_NEGOTIATE_POLL`` | seconds between view polls | 0.25 |
| ``BIGDL_TORCH_ELASTIC_JOIN`` | 1 = this process is a joiner: it announces itself and adopts the agreed snapshot before training | 0 |
| ``BIGDL_TORCH_ELASTIC_JOIN_TIMEOUT`` | seconds the joiner waits for an admission offer (and the survivors for the joiner's view) | 120 |
| ``BIGDL_TORCH_ELASTIC_JOIN_POLL`` | seconds between the joiner's gate and admission polls | 0.25 |
| ``BIGDL_TORCH_ELASTIC_REFORM_GRACE`` | seconds after a re-form during which silence is not promoted (every member rebuilds its step) | 2 |
| ``BIGDL_TORCH_PROTOCOL_KEEP`` | grow offers the writer keeps | 8 |
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..utils import config, file_io, telemetry

logger = logging.getLogger("bigdl_torch")

__all__ = ["PeerLostError", "ElasticNegotiationError", "ElasticJoinError",
           "ElasticPlan", "armed", "peer_lost_seconds", "join_armed",
           "join_timeout_seconds", "join_poll_seconds", "elastic_dir",
           "survey", "publish_intent", "read_intents",
           "publish_lineage_view", "read_lineage_view", "negotiate",
           "quarantine_tail", "set_last_peer_lost", "publish_join_intent",
           "read_join_intents", "clear_join_intent", "publish_grow_offer",
           "latest_grow_epoch", "read_grow_offer", "wait_for_admission",
           "previous_generation", "death_certificate", "announce_join",
           "cluster_position"]

#: subdirectory of the checkpoint dir holding the recovery protocol files
ELASTIC_DIRNAME = "elastic"

# PyThreadState_SetAsyncExc raises the exception CLASS with no args in the
# target thread (the StallError pattern, utils/supervisor): the class pulls
# its payload from here so the error the retry loop catches still names the
# lost ranks and the proposed recovery epoch.
_LAST_PEER_LOST = {"message": None, "lost": (), "epoch": 0}


def set_last_peer_lost(message: str, lost: Sequence[int],
                       epoch: int) -> None:
    """Stage the payload the next async-raised PeerLostError picks up."""
    _LAST_PEER_LOST["message"] = message
    _LAST_PEER_LOST["lost"] = tuple(int(r) for r in lost)
    _LAST_PEER_LOST["epoch"] = int(epoch)


class PeerLostError(RuntimeError):
    """A peer host stopped publishing heartbeats: its collectives would
    hang every rank forever.  Async-raised into the train loop (the
    StallError mechanism); the retry loop runs the elastic
    detect->negotiate->re-form->resume sequence as one typed attempt."""

    def __init__(self, *args):
        if not args and _LAST_PEER_LOST["message"]:
            args = (_LAST_PEER_LOST["message"],)
        super().__init__(*args or ("peer host lost (heartbeat publication "
                                   "silent past the elastic threshold)",))
        self.lost_ranks = tuple(_LAST_PEER_LOST["lost"])
        self.epoch = int(_LAST_PEER_LOST["epoch"])


class ElasticNegotiationError(RuntimeError):
    """Negotiation could not produce a restore point (empty lineage, or
    no entry valid for every survivor): typed failure, never a hang —
    the run is unrecoverable in place and the retry loop re-raises."""


class ElasticJoinError(RuntimeError):
    """A joiner could not get admitted: no survivor published an
    admission offer naming this rank within the join timeout.  Typed so
    the operator can tell "cluster never answered" from a negotiation
    failure after admission."""


@dataclass
class ElasticPlan:
    """The negotiated recovery: resume `neval` on `survivors`."""

    neval: int
    model_path: str
    optim_path: str
    survivors: tuple
    epoch: int


def peer_lost_seconds() -> float:
    return config.get_float("ELASTIC_PEER_LOST", 0.0)


def armed() -> bool:
    """True when host-loss promotion is configured (the elasticity master
    switch; 0/unset keeps every path in this module inert)."""
    return peer_lost_seconds() > 0


def join_armed() -> bool:
    """True when THIS process is a joiner: it must announce itself and
    adopt the cluster's agreed snapshot before training a single step."""
    return config.get_bool("ELASTIC_JOIN", False)


def join_timeout_seconds() -> float:
    return config.get_float("ELASTIC_JOIN_TIMEOUT", 120.0)


def join_poll_seconds() -> float:
    return config.get_float("ELASTIC_JOIN_POLL", 0.25)


def elastic_dir(ckpt_path: str) -> str:
    return file_io._join(file_io._strip_file_scheme(str(ckpt_path)),
                         ELASTIC_DIRNAME)


# ---------------------------------------------------------------------------
# protocol files (intents + lineage views) — best-effort, retried by the
# caller's poll loop; a torn write is replaced by the next one
# ---------------------------------------------------------------------------

def _write_json(base_dir: str, name: str, doc: dict) -> str:
    path = file_io._join(base_dir, name)
    fs = file_io.get_filesystem(path)
    fs.makedirs(base_dir)
    fs.write_bytes(path, json.dumps(doc).encode())
    return path


def _read_json(path: str) -> Optional[dict]:
    try:
        fs = file_io.get_filesystem(path)
        if not fs.exists(path):
            return None
        return json.loads(fs.read_bytes(path))
    except Exception:  # noqa: BLE001 — a torn/in-flight write is transient;
        # the caller's poll loop retries
        return None


def publish_intent(ckpt_path: str, rank: int, epoch: int,
                   lost: Sequence[int], wall_time: float) -> str:
    """Announce 'I observed host loss; recovery round `epoch` begins' so
    ranks that have not noticed the silence yet converge on their next
    monitor poll instead of waiting out their own threshold."""
    return _write_json(elastic_dir(ckpt_path), f"recover.{int(rank)}",
                       {"rank": int(rank), "epoch": int(epoch),
                        "lost": sorted(int(r) for r in lost),
                        "time": float(wall_time)})


def read_intents(ckpt_path: str, min_epoch: int,
                 exclude_rank: Optional[int] = None) -> Dict[int, dict]:
    """rank -> intent doc, for every ``recover.<rank>`` proposing a
    recovery round >= `min_epoch` (stale rounds are ignored)."""
    base = elastic_dir(ckpt_path)
    fs = file_io.get_filesystem(base)
    try:
        names = fs.listdir(base)
    except Exception:  # noqa: BLE001 — dir may not exist yet
        return {}
    intents = {}
    for name in names:
        head, _, tail = name.rpartition(".")
        if head != "recover" or not tail.isdigit():
            continue
        rank = int(tail)
        if exclude_rank is not None and rank == exclude_rank:
            continue
        doc = _read_json(file_io._join(base, name))
        if doc and int(doc.get("epoch", 0)) >= min_epoch:
            intents[rank] = doc
    return intents


def publish_lineage_view(ckpt_path: str, rank: int, epoch: int,
                         valid: Sequence[int]) -> str:
    return _write_json(elastic_dir(ckpt_path), f"lineage.{int(rank)}",
                       {"rank": int(rank), "epoch": int(epoch),
                        "valid": sorted((int(n) for n in valid),
                                        reverse=True)})


def read_lineage_view(ckpt_path: str, rank: int,
                      min_epoch: int) -> Optional[dict]:
    doc = _read_json(file_io._join(elastic_dir(ckpt_path),
                                   f"lineage.{int(rank)}"))
    if doc is None or int(doc.get("epoch", -1)) < min_epoch:
        return None
    return doc


# ---------------------------------------------------------------------------
# lineage survey + negotiation
# ---------------------------------------------------------------------------

def survey(ckpt_path: str) -> List[int]:
    """This rank's verified lineage view: nevals (newest first) whose
    model+optimMethod pair both exist AND pass CRC verification from
    here.  Entries that fail stay in place — whether they are corrupt
    for everyone is the CLUSTER's call (negotiate/quarantine_tail), not
    one rank's."""
    valid = []
    for mp, op, n in file_io.checkpoint_lineage(ckpt_path):
        try:
            file_io.verify(mp)
            file_io.verify(op)
        except Exception as e:  # noqa: BLE001 — unreadable == not usable
            logger.warning("elastic: lineage entry %d fails verification "
                           "here (%s: %s); excluded from this rank's view",
                           n, type(e).__name__, e)
            continue
        valid.append(n)
    return valid


def quarantine_tail(ckpt_path: str, above_neval: int) -> List[int]:
    """Quarantine every lineage entry NEWER than the negotiated one (the
    per-rank divergent tail: entries some survivor cannot see or cannot
    verify).  Renamed ``.corrupt`` — out of every future resume's sight,
    kept for forensics — so a straggler negotiating late, or the plain
    retry loop's newest-first recovery, lands on the same entry."""
    pruned = []
    for mp, op, n in file_io.checkpoint_lineage(ckpt_path):
        if n <= above_neval:
            continue
        file_io.quarantine_checkpoint(mp, op)
        pruned.append(n)
    if pruned:
        logger.warning("elastic: quarantined divergent lineage tail %s "
                       "(newer than the negotiated entry %d)",
                       sorted(pruned), above_neval)
    return pruned


def negotiate(ckpt_path: str, rank: int, survivors: Sequence[int],
              epoch: int, *, my_valid: Optional[Sequence[int]] = None,
              timeout: Optional[float] = None,
              poll: Optional[float] = None,
              clock=None, sleep=None) -> ElasticPlan:
    """Agree on the newest lineage entry valid for every survivor.

    Pure file_io, no collectives: publish my verified view, poll for the
    other survivors' views (stamped with this recovery round or newer),
    intersect, take the max.  A survivor that never publishes within
    `timeout` is dropped from the agreement (it is effectively lost too;
    when it comes back it finds the divergent tail quarantined and
    converges on the same entry).  Raises the typed
    :class:`ElasticNegotiationError` — never hangs — when the lineage is
    empty or no common entry exists."""
    timeout = (config.get_float("ELASTIC_NEGOTIATE_TIMEOUT", 60.0)
               if timeout is None else timeout)
    poll = (config.get_float("ELASTIC_NEGOTIATE_POLL", 0.25)
            if poll is None else poll)
    clock = clock or time.monotonic
    sleep = sleep or time.sleep
    survivors = tuple(sorted(int(r) for r in survivors))
    with telemetry.span("elastic.negotiate", cat="elastic", epoch=epoch,
                        survivors=list(survivors)):
        if my_valid is None:
            my_valid = survey(ckpt_path)
        publish_lineage_view(ckpt_path, rank, epoch, my_valid)
        views: Dict[int, List[int]] = {int(rank): list(my_valid)}
        waiting = set(survivors) - {int(rank)}
        start = clock()
        while waiting:
            for r in sorted(waiting):
                doc = read_lineage_view(ckpt_path, r, min_epoch=epoch)
                if doc is not None:
                    views[r] = [int(n) for n in doc.get("valid", [])]
            waiting -= set(views)
            if not waiting:
                break
            if clock() - start >= timeout:
                logger.warning(
                    "elastic: survivors %s never published a lineage view "
                    "within %.1fs — negotiating without them (they will "
                    "converge on the quarantined lineage when they return)",
                    sorted(waiting), timeout)
                break
            # the wait is legitimate progress: refresh the supervising
            # watchdog's current phase so a long negotiation cannot be
            # mistaken for a stall (no-op without an active supervisor)
            from ..utils import supervisor as _supervision
            _supervision.notify()
            sleep(poll)
        responders = sorted(views)
        common = set(views[responders[0]])
        for r in responders[1:]:
            common &= set(views[r])
        if not common:
            raise ElasticNegotiationError(
                f"elastic negotiation (round {epoch}): no checkpoint "
                f"lineage entry is valid for all responding survivors "
                f"{responders} (views: "
                f"{ {r: v[:3] for r, v in views.items()} }) — nothing to "
                "resume from; the run is unrecoverable in place")
        chosen = max(common)
        if int(rank) == responders[0]:
            # the leader (lowest responding rank) owns the shared-store
            # mutation; doing it on every rank would race the renames
            quarantine_tail(ckpt_path, chosen)
        base = file_io._strip_file_scheme(str(ckpt_path))
        plan = ElasticPlan(
            neval=chosen,
            model_path=file_io._join(base, f"model.{chosen}"),
            optim_path=file_io._join(base, f"optimMethod.{chosen}"),
            survivors=tuple(sorted(set(responders) | {int(rank)})),
            epoch=int(epoch))
        telemetry.instant("elastic.agree", cat="elastic", neval=chosen,
                          epoch=epoch, survivors=list(plan.survivors))
        logger.warning("elastic: negotiated restore point = snapshot %d "
                       "(round %d, survivors %s)", chosen, epoch,
                       list(plan.survivors))
        return plan


# ---------------------------------------------------------------------------
# GROW: join intents, admission offers, announcement hygiene
# ---------------------------------------------------------------------------

#: subdirectory of the checkpoint dir holding the peer heartbeats (the
#: supervisor's default; announce_join cleans/restamps files in here)
HEARTBEAT_DIRNAME = "heartbeats"


def publish_join_intent(ckpt_path: str, rank: int, wall_time: float,
                        generation: int) -> str:
    """Announce 'rank `rank` (heartbeat generation `generation`) wants
    back in' — survivors admit it at their next checkpoint boundary."""
    return _write_json(elastic_dir(ckpt_path), f"join.{int(rank)}",
                       {"rank": int(rank), "generation": int(generation),
                        "time": float(wall_time)})


def read_join_intents(ckpt_path: str,
                      exclude_rank: Optional[int] = None) -> Dict[int, dict]:
    """rank -> intent doc for every pending ``join.<rank>``."""
    base = elastic_dir(ckpt_path)
    fs = file_io.get_filesystem(base)
    try:
        names = fs.listdir(base)
    except Exception:  # noqa: BLE001 — dir may not exist yet
        return {}
    intents = {}
    for name in names:
        head, _, tail = name.rpartition(".")
        if head != "join" or not tail.isdigit():
            continue
        rank = int(tail)
        if exclude_rank is not None and rank == exclude_rank:
            continue
        doc = _read_json(file_io._join(base, name))
        if doc:
            intents[rank] = doc
    return intents


def clear_join_intent(ckpt_path: str, rank: int) -> None:
    """Consume a join intent (admitted or abandoned) so a later boundary
    does not re-admit a rank that is already in — or long gone."""
    path = file_io._join(elastic_dir(ckpt_path), f"join.{int(rank)}")
    try:
        fs = file_io.get_filesystem(path)
        if fs.exists(path):
            fs.remove(path)
    except Exception as e:  # noqa: BLE001 — best-effort: a leftover
        # intent is filtered by the survivor-set check at the boundary
        logger.warning("elastic: could not clear join intent for rank "
                       "%d: %s", rank, e)


def protocol_keep() -> int:
    """Writer-side retention bound for numbered protocol files
    (``grow.<epoch>`` here, ``member.<idx>.<generation>`` in
    serve/fleet): generations kept beyond the current one."""
    return config.get_int("PROTOCOL_KEEP", 8)


def publish_grow_offer(ckpt_path: str, rank: int, epoch: int,
                       survivors: Sequence[int], wall_time: float) -> str:
    """The WRITER's admission offer for grow round `epoch`: the widened
    survivor set every party (joiner included) negotiates over.  The
    writer also sweeps offers from long-dead rounds (keep the newest
    ``BIGDL_TORCH_PROTOCOL_KEEP``) — without it a long-lived cluster
    accumulates one ``grow.<epoch>`` per grow episode forever."""
    base = elastic_dir(ckpt_path)
    path = _write_json(base, f"grow.{int(epoch)}",
                       {"epoch": int(epoch), "rank": int(rank),
                        "survivors": sorted(int(r) for r in survivors),
                        "time": float(wall_time)})
    file_io.sweep_numbered(base, r"grow\.(\d+)", keep=protocol_keep())
    return path


def latest_grow_epoch(ckpt_path: str) -> int:
    """Newest grow-offer round on storage (0 when none): the joiner
    records this BEFORE announcing so stale offers from earlier
    episodes can never admit it."""
    base = elastic_dir(ckpt_path)
    fs = file_io.get_filesystem(base)
    try:
        names = fs.listdir(base)
    except Exception:  # noqa: BLE001 — dir may not exist yet
        return 0
    newest = 0
    for name in names:
        head, _, tail = name.rpartition(".")
        if head == "grow" and tail.isdigit():
            newest = max(newest, int(tail))
    return newest


def read_grow_offer(ckpt_path: str, min_epoch: int,
                    rank: Optional[int] = None) -> Optional[dict]:
    """Newest grow offer with round > `min_epoch` (and, when `rank` is
    given, naming that rank in its survivor set); None when absent."""
    base = elastic_dir(ckpt_path)
    best = None
    for epoch in range(latest_grow_epoch(ckpt_path), min_epoch, -1):
        doc = _read_json(file_io._join(base, f"grow.{epoch}"))
        if doc is None:
            continue
        if rank is not None and int(rank) not in [
                int(r) for r in doc.get("survivors", [])]:
            continue
        best = doc
        break
    return best


def wait_for_admission(ckpt_path: str, rank: int, *, floor: int,
                       timeout: Optional[float] = None,
                       poll: Optional[float] = None,
                       clock=None, sleep=None) -> dict:
    """Joiner side: poll for a grow offer newer than `floor` naming this
    rank.  Raises the typed :class:`ElasticJoinError` — never hangs —
    when no survivor answers within the join timeout."""
    timeout = join_timeout_seconds() if timeout is None else timeout
    poll = join_poll_seconds() if poll is None else poll
    clock = clock or time.monotonic
    sleep = sleep or time.sleep
    start = clock()
    while True:
        offer = read_grow_offer(ckpt_path, min_epoch=floor, rank=rank)
        if offer is not None:
            logger.warning("elastic: rank %d admitted by grow round %d "
                           "(survivors %s)", rank, offer["epoch"],
                           offer.get("survivors"))
            return offer
        if clock() - start >= timeout:
            raise ElasticJoinError(
                f"elastic join: rank {rank} announced but no survivor "
                f"published an admission offer past round {floor} within "
                f"{timeout:.1f}s — is the cluster checkpointing?")
        from ..utils import supervisor as _supervision
        _supervision.notify()
        sleep(poll)


def previous_generation(ckpt_path: str, rank: int,
                        peer_dir: Optional[str] = None) -> Optional[int]:
    """Generation of the heartbeat `rank`'s PREVIOUS life left behind,
    or None when no heartbeat exists (a genuinely new rank)."""
    base = file_io._strip_file_scheme(str(ckpt_path))
    peer_dir = peer_dir or file_io._join(base, HEARTBEAT_DIRNAME)
    old = _read_json(file_io._join(peer_dir, f"heartbeat.{int(rank)}"))
    if not old:
        return None
    return int(old.get("generation", 0))


def death_certificate(ckpt_path: str, rank: int, *, floor: int = 0) -> int:
    """The recovery round (> `floor`, the last grow epoch) in which a
    survivor declared `rank` lost — 0 when the cluster has not noticed
    the loss yet.  A RETURNING rank must hold its announcement until
    this exists: publishing a generation-bumped heartbeat while the
    survivors still count the old life as live would reset the very
    publication silence they detect the loss by, and the shrink this
    grow must stack on would never run."""
    best = 0
    for doc in read_intents(ckpt_path, min_epoch=int(floor) + 1).values():
        if int(rank) in [int(r) for r in doc.get("lost", ())]:
            best = max(best, int(doc.get("epoch", 0)))
    return best


def announce_join(ckpt_path: str, rank: int, wall_time: float,
                  peer_dir: Optional[str] = None) -> dict:
    """Heartbeat hygiene + announcement, in that order.

    The returning rank's previous life left a FROZEN heartbeat and
    possibly stale ``recover.<rank>``/``lineage.<rank>`` protocol files;
    survivors must never read those as liveness or as a current view.
    So: bump the heartbeat GENERATION past the old file's (survivors
    treat a higher generation from a lost rank as 'returned', not as the
    old entry aging), delete the stale protocol files, record the grow
    floor, and only then publish the ``join.<rank>`` intent.  Returns
    ``{"generation": g, "floor": f}`` for the supervisor restamp and
    :func:`wait_for_admission`."""
    base = file_io._strip_file_scheme(str(ckpt_path))
    peer_dir = peer_dir or file_io._join(base, HEARTBEAT_DIRNAME)
    hb_path = file_io._join(peer_dir, f"heartbeat.{int(rank)}")
    old = _read_json(hb_path) or {}
    generation = int(old.get("generation", 0)) + 1
    edir = elastic_dir(ckpt_path)
    fs = file_io.get_filesystem(edir)
    for stale in (f"recover.{int(rank)}", f"lineage.{int(rank)}"):
        path = file_io._join(edir, stale)
        try:
            if fs.exists(path):
                fs.remove(path)
                logger.info("elastic: removed stale %s from rank %d's "
                            "previous life", stale, rank)
        except Exception as e:  # noqa: BLE001 — stale views are also
            # defeated by the epoch stamps; removal is belt-and-braces
            logger.warning("elastic: could not remove stale %s: %s",
                           stale, e)
    _write_json(peer_dir, f"heartbeat.{int(rank)}",
                {"rank": int(rank), "phase": "join", "count": 0,
                 "time": float(wall_time), "published": float(wall_time),
                 "generation": generation})
    floor = latest_grow_epoch(ckpt_path)
    publish_join_intent(ckpt_path, rank, wall_time, generation)
    telemetry.instant("elastic.join_intent", cat="elastic", rank=int(rank),
                      generation=generation)
    logger.warning("elastic: rank %d announced join (heartbeat "
                   "generation %d, grow floor %d)", rank, generation,
                   floor)
    return {"generation": generation, "floor": floor}


def cluster_position(ckpt_path: str) -> Optional[tuple]:
    """The cluster's training position ``(epoch, neval)`` as recorded by
    the newest loadable snapshot's driver_state.  The stored ``neval``
    is already incremented to the NEXT iteration — exactly the
    coordinate ``chaos.at_position`` publishes at the top of that
    iteration — so a joiner polling this can gate a
    ``host.return@<rank>=@epoch:iteration`` address deterministically.
    None when no snapshot is loadable yet."""
    for _mp, op, _n in file_io.checkpoint_lineage(ckpt_path):
        try:
            blob = file_io.load(op)
        except Exception:  # noqa: BLE001 — mid-write entry; try older
            continue
        ds = (blob or {}).get("driver_state") or {}
        if "epoch" in ds and "neval" in ds:
            return int(ds["epoch"]), int(ds["neval"])
    return None
