"""Topology-aware replica routing: mesh-sharded replicas on rank subsets.

Counterpart of ``bigdl_tpu/serve/router.py``.  The reference places real
replicas on DISJOINT device subsets of one host, each serving its
version fsdp/tp-sharded through ``LayoutSharding`` on its own mesh, and
routes each request by (bucket, per-replica queue depth).  Here a device
of a layout is a rank (``MeshLayout.build_mesh`` takes ranks), so:

- **placement**: the ranks (default: every rank of the world) are
  partitioned into disjoint contiguous runs, one a potential member, each
  of the member layout's size (:func:`plan_subsets`; a layout that does
  not fit raises a typed :class:`PlacementError` at construction).
  Every member's mesh is built on every rank, in member order, at
  construction (``new_group`` and ``DeviceMesh`` are collective), with
  its lead group (below).
- **one rank leads** (``serve/lead.py``): rank 0 runs the router, its
  tenant quotas, its autoscaler and every member's batcher and worker
  thread.  Member ``i``'s lead group is {rank 0} and its ranks, formed
  at construction on every rank; only member ``i``'s worker thread on
  rank 0 (and its swap, under the member's lock) sends on it.  The
  member's ranks follow: on each of them a thread of the router waits
  for the member's activation, serves its batches and swaps
  (``InferenceServer.follow``) until it is retired, and waits again,
  until the router stops.  Answers come back to rank 0 from the member's
  coordinate-0 rank (rank 0 itself for the member it sits on).
- **routing**: by (bucket, per-replica queue depth), as the reference:
  fewest pending full buckets, then joining a partial batch, then depth,
  then index.  Answers stay bit-identical to ``Predictor`` on the
  member's layout (the same ``_Forward`` arithmetic, pinned to the
  member's mesh).
- **degradation**: a member whose restart budget is spent flips
  unhealthy and receives no more traffic; only when no member survives
  does admission raise ``ReplicaLostError``.
- **elasticity**: ``scale_to(n)`` activates (an activation message, then
  the member's first version placed on its ranks and its bucket ladder
  warmed) or retires (drained, then a retire message) members.
  ``prewarm=True`` runs every planned subset's bucket ladder once at
  ``start()`` (activate, warm, retire): the port has no compile cache, so
  a later scale-up is judged by answers bit-equal to before, not by a
  count of lowerings; ``stats()`` has no ``"aot"`` key.

Construction, ``start`` and ``stop`` are called on every rank in the same
order; ``submit``, ``predict``, ``swap``, ``scale_to``, ``warmup`` and the
trace on rank 0 alone.  Tenant quotas live at the router; members run
with quotas off.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..utils import config, telemetry
from . import control, lead as lead_mod
from .batcher import ServeError

logger = logging.getLogger("bigdl_torch")

__all__ = ["PlacementError", "TopologyRouter", "plan_subsets"]

#: the rank that leads every member
LEADER = 0


class PlacementError(ServeError):
    """The requested replica layout cannot be placed: not enough ranks for
    `replicas` disjoint subsets of the member layout's size.  Raised at
    construction: a placement that cannot exist must not fail at traffic
    time."""


def plan_subsets(devices: Sequence, per_replica: int,
                 replicas: int) -> List[list]:
    """Partition ``devices`` (ranks) into ``replicas`` DISJOINT contiguous
    runs of ``per_replica``.  Typed :class:`PlacementError` when they
    cannot hold them."""
    devices = list(devices)
    need = per_replica * replicas
    if per_replica < 1 or replicas < 1:
        raise PlacementError(
            f"serve: placement needs >= 1 device per replica and >= 1 "
            f"replica (got {per_replica} x {replicas})")
    if need > len(devices):
        raise PlacementError(
            f"serve: cannot place {replicas} replica(s) x {per_replica} "
            f"device(s) = {need} on a {len(devices)}-device host — "
            "shrink the member layout or the replica count")
    return [devices[i * per_replica:(i + 1) * per_replica]
            for i in range(replicas)]


class TopologyRouter:
    """Route requests over mesh-sharded replicas on disjoint rank subsets
    (module docstring).

    Duck-type compatible with :class:`InferenceServer` where the HTTP
    front end, the autoscaler and the replayer need it: ``submit`` /
    ``predict`` / ``stats`` / ``healthy`` / ``version`` / ``swap`` /
    ``warmup`` / ``start`` / ``stop`` / ``scale_to`` /
    ``autoscale_signals`` / ``record_trace`` / ``stop_trace``."""

    def __init__(self, model, *, layout=None, replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 example: Optional[np.ndarray] = None,
                 prewarm: Optional[bool] = None,
                 tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 autoscale_min: Optional[int] = None,
                 autoscale_max: Optional[int] = None,
                 autoscale_target_wait_ms: Optional[float] = None,
                 autoscale_idle_s: Optional[float] = None,
                 autoscale_cooldown_s: Optional[float] = None,
                 autoscale_up_polls: Optional[int] = None,
                 autoscale_step: Optional[int] = None,
                 autoscale_poll_s: Optional[float] = None,
                 clock=None, **member_kwargs):
        import time as _time

        import torch.distributed as dist

        from ..parallel.layout import MeshLayout
        from ..utils.engine import DIST_TIMEOUT
        from . import autoscale as autoscale_mod
        self.model = model
        self.layout = layout if layout is not None else MeshLayout(1, 1, 1)
        if isinstance(self.layout, str):
            self.layout = MeshLayout.parse(self.layout)
        self.replicas = int(replicas if replicas is not None
                            else config.get_int("SERVE_REPLICAS", 1))
        self._example = None if example is None else np.asarray(example)
        self._member_kwargs = dict(member_kwargs)
        for k in ("replicas", "mesh", "lead", "strategy"):
            self._member_kwargs.pop(k, None)
        # quotas are ROUTER-level (one bucket per tenant across the pool);
        # members run with quotas off
        self._member_kwargs["tenant_qps"] = 0.0
        self.clock = clock or _time.monotonic
        qps = float(tenant_qps if tenant_qps is not None
                    else config.get_float("SERVE_TENANT_QPS", 0.0))
        burst = (tenant_burst if tenant_burst is not None
                 else config.get_float("SERVE_TENANT_BURST", 0.0))
        self._quotas = (control.TenantQuotas(qps, burst=burst,
                                             clock=self.clock)
                        if qps > 0 else None)
        self._autoscale_cfg = autoscale_mod.autoscale_knobs(
            self.replicas,
            {"min_replicas": autoscale_min, "max_replicas": autoscale_max,
             "target_wait_ms": autoscale_target_wait_ms,
             "idle_s": autoscale_idle_s,
             "cooldown_s": autoscale_cooldown_s,
             "up_polls": autoscale_up_polls, "step": autoscale_step,
             "poll_s": autoscale_poll_s})
        self._autoscaler = None
        self._recorder = None
        cap = max(self.replicas, self._autoscale_cfg["max_replicas"],
                  int(max_replicas or 0))
        world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = [int(r) for r in devices] if devices is not None \
            else list(range(world))
        # every POTENTIAL member's subset is planned up front: scale-up
        # must never discover at traffic time that the ranks are too few
        self._subsets = plan_subsets(ranks, self.layout.size, cap)
        self.rank = dist.get_rank()
        # collective, on every rank, in member order: each member's mesh
        # (its axis groups and its own lead group), then the lead group of
        # rank 0 and the member where rank 0 is not on it
        self._meshes = [self.layout.build_mesh(s) for s in self._subsets]
        self._leads = []
        for mesh, sub in zip(self._meshes, self._subsets):
            group = None
            if LEADER not in sub:
                group = dist.new_group(sorted({LEADER, *sub}),
                                       timeout=DIST_TIMEOUT, backend="gloo")
            on = self.rank == LEADER or self.rank in sub
            self._leads.append(lead_mod.Lead(mesh, LEADER, group)
                               if on else None)
        self._members: List[Optional[object]] = [None] * len(self._subsets)
        self._prewarm = prewarm
        self._lock = threading.Lock()   # member list mutations
        self._routed = [0] * len(self._subsets)
        self._started = False
        self._closed = False
        #: on a rank that follows: its member's index and follow thread
        self._mine = next((i for i, s in enumerate(self._subsets)
                           if self.rank in s and self.rank != LEADER), None)
        self._follow_thread: Optional[threading.Thread] = None

    @property
    def leading(self) -> bool:
        """True on the rank that runs the router (rank 0)."""
        return self.rank == LEADER

    def _leader_only(self, what: str) -> None:
        if not self.leading:
            raise ServeError(f"serve: router {what} on rank {self.rank}: "
                             f"rank {LEADER} runs the router")

    # -- members --------------------------------------------------------

    def _member_strategy(self, model):
        if self.layout.size == 1:
            return None   # a member of one rank holds the whole model
        from ..parallel import LayoutSharding
        return LayoutSharding(model)

    def _build_member(self, i: int):
        """One replica = one InferenceServer pinned to subset ``i``'s
        mesh and led from rank 0, with its own queue, worker and
        monitor; on the member's other ranks, its follower."""
        from .server import InferenceServer
        member = InferenceServer(
            self.model, example=self._example, replicas=1,
            strategy=self._member_strategy(self.model),
            mesh=self._meshes[i], lead=self._leads[i],
            autoscale_max=0,  # one controller (the router's), not N
            **self._member_kwargs)
        member._end_op = lead_mod.RETIRE
        return member

    def _activate(self, i: int) -> None:
        self._leads[i].send(lead_mod.ACTIVATE)
        member = self._build_member(i)
        member.start()
        with self._lock:
            self._members[i] = member
        telemetry.instant("serve.router", cat="serve", action="activate",
                          member=i, ranks=list(self._subsets[i]))

    def _deactivate(self, i: int) -> None:
        with self._lock:
            member, self._members[i] = self._members[i], None
        if member is not None:
            # graceful: everything already queued on this member is
            # answered before its worker exits (then its ranks are told
            # to retire); new traffic routes to the survivors the moment
            # it leaves the member list
            member.stop(drain=True)
            telemetry.instant("serve.router", cat="serve",
                              action="retire", member=i)

    def _follow(self) -> None:
        """A member rank's thread: wait for the member's activation, serve
        it as its follower until retired, and again, until the router
        stops."""
        lead = self._leads[self._mine]
        telemetry.thread_name(f"serve router member {self._mine}")
        while True:
            msg = lead.recv()
            if msg.op == lead_mod.STOP:
                return
            if msg.op != lead_mod.ACTIVATE:
                raise ServeError(f"serve: router member {self._mine} "
                                 f"expected activate, got "
                                 f"{lead_mod.OP_NAMES.get(msg.op)}")
            if self._build_member(self._mine).follow() == lead_mod.STOP:
                return

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "TopologyRouter":
        if self._started:
            return self
        if self._closed:
            raise ServeError("serve: cannot restart a stopped router")
        self._started = True
        if not self.leading:
            if self._mine is not None:
                self._follow_thread = threading.Thread(
                    target=self._follow, daemon=True,
                    name=f"bigdl-torch-router-member-{self._mine}")
                self._follow_thread.start()
            return self
        for lead in self._leads:
            lead.keep_alive()
        for i in range(self.replicas):
            self._activate(i)
        prewarm = bool(self._prewarm)
        if prewarm and self._example is not None:
            for i in range(self.replicas, len(self._subsets)):
                self._activate(i)
                self._deactivate(i)
        if self._autoscale_cfg["max_replicas"] > 0:
            from . import autoscale as autoscale_mod
            cfg = dict(self._autoscale_cfg)
            cfg["min_replicas"] = min(cfg["min_replicas"], self.replicas)
            cfg["max_replicas"] = min(
                max(cfg["max_replicas"], cfg["min_replicas"]),
                len(self._subsets))
            poll = cfg.pop("poll_s")
            self._autoscaler = autoscale_mod.AutoScaler(
                self, poll_s=poll, clock=self.clock, **cfg).start()
        logger.info(
            "serve: router started — %d/%d replica(s) live, %d rank(s) "
            "per replica (layout %s)%s", self.replicas, len(self._subsets),
            self.layout.size, self.layout.sizes,
            " [all subsets prewarmed]" if prewarm else "")
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Rank 0: stop every member (drained, then retired), then tell
        every member's ranks to stop.  A member rank: wait for that."""
        self._closed = True
        if not self.leading:
            t, self._follow_thread = self._follow_thread, None
            if t is not None:
                t.join()
            return
        if self._autoscaler is not None:
            self._autoscaler.stop()
        try:
            for i, m in enumerate(self._members):
                if m is not None:
                    m.stop(drain=drain, timeout=timeout)
        finally:
            if self._started:
                for lead in self._leads:
                    lead.send(lead_mod.STOP)
            self._started = False
            if self._recorder is not None and self._recorder.path:
                try:
                    self._recorder.save()
                except Exception:  # noqa: BLE001 - recording is best effort
                    logger.exception("serve: trace flush failed at shutdown")

    def __enter__(self) -> "TopologyRouter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- routing --------------------------------------------------------

    def _live_members(self):
        with self._lock:
            return [(i, m) for i, m in enumerate(self._members)
                    if m is not None]

    def _pick(self) -> Optional[int]:
        """The dispatch decision: (bucket, per-replica queue depth).

        Key, in order: fewest pending FULL buckets (``depth //
        max_batch``), then prefer a member with a PARTIAL batch
        coalescing (joining it raises fill and its flush window is already
        ticking), then raw depth, then index.  Unhealthy or closed members
        never receive traffic."""
        best = best_key = None
        for i, m in self._live_members():
            if not m.healthy() or m.batcher.closed:
                continue
            d = m.batcher.depth()
            key = (d // m.max_batch, 0 if d % m.max_batch else 1, d, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def submit(self, x, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None, priority: int = 0,
               request_id: Optional[str] = None):
        """Route one sample to the chosen member's queue.  Raises the
        member's typed admission errors, router-level QuotaExceeded, or
        ReplicaLostError when no member survives."""
        self._leader_only("submit")
        x = np.asarray(x)
        if self._recorder is not None:
            self._recorder.note(x, tenant=tenant, priority=priority,
                                deadline_ms=deadline_ms)
        if self._quotas is not None:
            self._quotas.admit(tenant)
        i = self._pick()
        if i is None:
            raise control.ReplicaLostError(
                "serve: router has no live healthy replica — every "
                "member is lost or retired")
        self._routed[i] += 1
        return self._members[i].submit(x, deadline_ms=deadline_ms,
                                       tenant=tenant, priority=priority,
                                       request_id=request_id)

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    # -- pool size (serve/autoscale.AutoScaler hooks) -------------------

    def scale_to(self, n: int) -> int:
        """Activate or retire members.  Growth activates the next planned
        subset: its ranks place a fresh first version and warm its ladder
        (the path a restart takes); shrink drains and retires the highest
        members, whose queued requests are answered first."""
        self._leader_only("scale_to")
        n = max(min(int(n), len(self._subsets)), 1)
        cur = self.replicas
        if n == cur or self._closed:
            return cur
        if n > cur:
            for i in range(cur, n):
                self._activate(i)
        else:
            for i in range(n, cur):
                self._deactivate(i)
        self.replicas = n
        logger.info("serve: router scaled %d -> %d replica(s)", cur, n)
        return n

    def autoscale_signals(self) -> dict:
        depth = batches = live = 0
        emas = []
        for _i, m in self._live_members():
            sig = m.autoscale_signals()
            depth += sig["depth"]
            batches += sig["batches"]
            live += sig["live"]
            if sig["row_s_ema"]:
                emas.append(sig["row_s_ema"])
        return {"depth": depth,
                "row_s_ema": (sum(emas) / len(emas)) if emas else None,
                "batches": batches, "live": live}

    # -- fleet operations ----------------------------------------------

    def warmup(self, example: Optional[np.ndarray] = None) -> None:
        self._leader_only("warmup")
        if example is not None:
            self._example = np.asarray(example)
        for _i, m in self._live_members():
            m.warmup(self._example)

    def swap(self, source, **kwargs) -> int:
        """Fan the swap out to every live member (each builds and warms
        it on its own ranks before its local flip: a multi-member swap is
        N independent zero-drop swaps; a path is read by every rank)."""
        self._leader_only("swap")
        vid = None
        for _i, m in self._live_members():
            vid = m.swap(source, **kwargs)
        if vid is None:
            raise control.ReplicaLostError(
                "serve: router swap with no live member")
        return vid

    def healthy(self) -> bool:
        """True while ANY member survives."""
        return any(m.healthy() for _i, m in self._live_members())

    @property
    def version(self):
        for _i, m in self._live_members():
            return m.version
        return None

    @property
    def max_batch(self) -> int:
        for _i, m in self._live_members():
            return m.max_batch
        return int(config.get_int("SERVE_MAX_BATCH", 8))

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

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        """The members' counts summed, and under ``"router"`` the layout,
        the plan, each member's ranks, routed count, depth and health
        (rank 0; another rank reports its member only)."""
        if not self.leading:
            return {"router": {"layout": list(self.layout.sizes),
                               "rank": self.rank, "member": self._mine}}
        members = {}
        agg = {"submitted": 0, "batches": 0, "batch_rows": 0,
               "shed_overload": 0, "shed_timeout": 0, "shed_priority": 0,
               "restarts": 0}
        for i, m in self._live_members():
            st = m.stats()
            members[str(i)] = {
                "devices": list(self._subsets[i]),
                "routed": self._routed[i],
                "queue_depth": st["queue_depth"],
                "healthy": st["healthy"],
                "version": st["version"],
                "batches": st["batches"],
                "batch_fill": st["batch_fill"],
                "restarts": st["restarts"],
                "shed_overload": st["shed_overload"],
                "shed_timeout": st["shed_timeout"],
                "messages": st["mesh"]["messages"]}
            for k in agg:
                agg[k] += st.get(k, 0)
        out = dict(agg)
        out["router"] = {
            "layout": list(self.layout.sizes),
            "devices_per_replica": self.layout.size,
            "replicas": self.replicas,
            "replicas_planned": len(self._subsets),
            "routed": list(self._routed),
            "members": members}
        out["replicas"] = self.replicas
        out["replicas_live"] = len(members)
        out["healthy"] = self.healthy()
        v = self.version
        out["version"] = v.id if v is not None else None
        if self._autoscaler is not None:
            out["autoscale"] = self._autoscaler.stats()
        if self._quotas is not None:
            out["quota"] = self._quotas.stats()
        if self._recorder is not None:
            out["trace_recording"] = self._recorder.stats()
        return out
