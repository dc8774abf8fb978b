"""Online inference server: replica pool, deadline shedding, hot model swap.

Counterpart of ``bigdl_tpu/serve/server.py``:

- each replica is a worker thread draining the shared
  :class:`~bigdl_torch.serve.batcher.DynamicBatcher` and running padded
  batches through the same eval forward ``Predictor`` uses
  (``optim.optimizer._Forward``, under a ``strategy`` where one is given),
  so online answers are the same arithmetic as bulk prediction; a batch's
  answer reaches the host through the version's pinned buffer
  (``HostCopy``), which waits for the device, so a batch's time is the
  device's time too;
- ``seq_buckets`` serves variable-length token requests: each request pads
  its trailing axis to the smallest sequence bucket that fits it, and each
  sequence bucket of a collect is its own device batch, so a request's
  answer never depends on its batch-mates' lengths;
- ``warmup()`` runs every (batch bucket x sequence bucket) shape once
  before traffic (it builds the CUDA kernels on first use); a swapped-in
  or restarted version warms the same ladder before it takes traffic;
- a :class:`ModelVersion` bundles a module and its forward; ``swap()``
  loads a new version (a checkpoint directory's newest snapshot, a
  snapshot file, a ``Module.save`` file or a built Module), optionally
  int8-quantizes it, warms it and then flips one reference: batches in
  flight finish on the old version, queued ones run on the new one.  A
  version from a checkpoint is a clone of the served architecture with
  tensors of its own, so the weights under running replicas (and under any
  CUDA graph bound to their addresses) never change;
- the control plane (``serve/control.py``): a replica that dies or goes
  silent is restarted on a fresh forward of the current version (bounded
  budget, exponential backoff; past the budget ``healthy()`` is False),
  ``swap(..., canary_fraction=f)`` canaries a version and promotes it or
  rolls it back, tenants are held to token-bucket quotas;
- ``scale_to`` and the queue-driven :class:`~bigdl_torch.serve.autoscale.
  AutoScaler` resize the pool; ``record_trace`` captures offered traffic
  (``serve/tracefile.py``); ``attach_deploy`` takes a
  ``DeployController`` (``serve/continuous.py``);
- replicas may heartbeat a ``Supervisor`` channel (phase ``serve``); a
  wedged one trips a stall with a crash report;
- instrumentation (``utils/telemetry``, ``utils/metrics_export``):
  ``serve.batch`` spans, the ``serve`` counter track (queue depth, batch
  fill), ``serve.swap`` / ``serve.canary`` / ``serve.replica_restart`` /
  ``serve.unhealthy`` instants, request flows, restarts on the metrics
  registry; and the fault points ``serve.batch``,
  ``serve.replica@<idx>`` and ``serve.canary`` (``utils/chaos``).  A
  fault in a batch fails that batch's requests typed and the server
  serves on.

``mesh=`` raises: a version pinned to a device subset needs the mesh
layouts (ROADMAP queue A item 8).  ``stats()`` has no ``"aot"`` key: the
compile cache is the reference's and is not ported (the decode engine's
CUDA graphs are the port's warm start).

Knobs (``utils/config``; constructor arguments override):
``BIGDL_TORCH_SERVE_MAX_BATCH`` (8), ``_MAX_WAIT_MS`` (5),
``_QUEUE_LIMIT`` (64), ``_REPLICAS`` (1), ``_DEADLINE_MS`` (0 = none),
``_STALL_SECONDS`` (0 = unwatched), ``_REPLICA_LOST`` (0 = monitor off),
``_RESTART_BUDGET`` (3), ``_RESTART_BACKOFF`` (0.1),
``_CANARY_MIN_BATCHES`` (8), ``_CANARY_WINDOW`` (64),
``_CANARY_LATENCY_RATIO`` (2.0), ``_CANARY_ERROR_MARGIN`` (0.05),
``_TENANT_QPS`` (0 = off), ``_TENANT_BURST`` (0 = 2 x qps),
``_AUTOSCALE_*`` (``serve/autoscale.py``), ``_TRACE_LIMIT`` (100000).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

import numpy as np

from ..common import resolve_device
from ..nn.module import Module, _read_blob
from ..optim.optimizer import HostCopy, _Forward
from ..utils import chaos, config, metrics_export, telemetry
from ..utils.supervisor import StallError, Supervisor
from . import control
from .batcher import (DynamicBatcher, PendingRequest, ServeError, fit_bucket,
                      pad_rows, pad_tail)

logger = logging.getLogger("bigdl_torch")

__all__ = ["ModelVersion", "InferenceServer"]

_MESH = ("mesh=: a version pinned to a device subset needs the mesh "
         "layouts, which are not ported yet (ROADMAP queue A item 8)")


class ModelVersion:
    """One servable (module, forward) bundle on one device.  The server
    flips between versions by replacing one reference."""

    def __init__(self, vid: int, module: Module, label: str,
                 strategy=None, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.id = int(vid)
        self.label = label
        self.module = module
        self._engine = _Forward(module, device, strategy)
        self._to_host = HostCopy()

    def predict(self, batch: np.ndarray) -> np.ndarray:
        """Forward one padded batch; returns its host rows through the
        version's pinned buffer (:class:`HostCopy`).  A bfloat16 output
        widens to float32 on the device, since numpy has no bfloat16; the
        widening is exact."""
        out, _ = self._engine(batch)
        return self._to_host(out[:len(batch)])


def _clone_with(module: Module, params, state) -> Module:
    """A clone of ``module`` serving another (params, state) tree: new
    tensors on the same device, so the original keeps serving its own
    weights untouched."""
    from ..utils.convert import load_reference_tree
    clone = module.clone_module()
    return load_reference_tree(clone, params, state)


class InferenceServer:
    """Online serving facade over a Module (see module docstring).

    Usage::

        server = InferenceServer(model, example=x0).start()
        y = server.predict(x)                  # blocking convenience
        h = server.submit(x, deadline_ms=50)   # async handle
        server.swap("/ckpts/run1")             # newest lineage snapshot
        server.stop()                          # graceful drain

    Also a context manager.  Runs on ``device`` (default: the CUDA device;
    raises without one)."""

    def __init__(self, model: Module, *,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 replicas: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 example: Optional[np.ndarray] = None,
                 strategy=None,
                 supervisor: Optional[Supervisor] = None,
                 stall_seconds: Optional[float] = None,
                 report_dir: Optional[str] = None,
                 clock=None,
                 replica_lost: Optional[float] = None,
                 restart_budget: Optional[int] = None,
                 restart_backoff: Optional[float] = None,
                 tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 canary_min_batches: Optional[int] = None,
                 canary_window: Optional[int] = None,
                 canary_latency_ratio: Optional[float] = None,
                 canary_error_margin: Optional[float] = None,
                 mesh=None,
                 autoscale_min: Optional[int] = None,
                 autoscale_max: Optional[int] = None,
                 autoscale_target_wait_ms: Optional[float] = None,
                 autoscale_idle_s: Optional[float] = None,
                 autoscale_cooldown_s: Optional[float] = None,
                 autoscale_up_polls: Optional[int] = None,
                 autoscale_step: Optional[int] = None,
                 autoscale_poll_s: Optional[float] = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.device = resolve_device(device)
        self.max_batch = int(max_batch if max_batch is not None
                             else config.get_int("SERVE_MAX_BATCH", 8))
        wait_ms = (max_wait_ms if max_wait_ms is not None
                   else config.get_float("SERVE_MAX_WAIT_MS", 5.0))
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else config.get_int("SERVE_QUEUE_LIMIT", 64))
        self.replicas = int(replicas if replicas is not None
                            else config.get_int("SERVE_REPLICAS", 1))
        self.default_deadline_ms = (
            deadline_ms if deadline_ms is not None
            else config.get_float("SERVE_DEADLINE_MS", 0.0))
        self._strategy = strategy
        self.batcher = DynamicBatcher(self.max_batch, wait_ms / 1000.0,
                                      self.queue_limit, buckets=buckets,
                                      clock=clock)
        self.seq_buckets = (tuple(sorted(int(b) for b in seq_buckets))
                            if seq_buckets else None)
        self._example = None if example is None else np.asarray(example)
        self._version = ModelVersion(1, model, "initial", strategy,
                                     device=self.device)
        self._vid = 1                       # monotonic version ids
        self._lock = threading.Lock()       # stats and the version flip
        self._swap_lock = threading.Lock()  # one swap at a time
        self._scale_lock = threading.Lock()  # one pool resize at a time
        self._threads: list = []
        # replica slot -> [thread, generation, last local heartbeat]; a
        # zombie whose generation moved on requeues its batch and exits
        self._replica: dict = {}
        self._monitor: Optional[control.ReplicaMonitor] = None
        self._unhealthy: Optional[Exception] = None
        self._canary: Optional[control.CanaryController] = None
        self._canary_last: Optional[dict] = None
        self._stats = {"batches": 0, "batch_rows": 0, "batch_errors": 0,
                       "bucket_rows": 0, "warmup_batches": 0, "swaps": 0,
                       "restarts": 0, "canary_rollbacks": 0}
        self._replica_lost = float(
            replica_lost if replica_lost is not None
            else config.get_float("SERVE_REPLICA_LOST", 0.0))
        self._restart_budget = int(
            restart_budget if restart_budget is not None
            else config.get_int("SERVE_RESTART_BUDGET", 3))
        self._restart_backoff = float(
            restart_backoff if restart_backoff is not None
            else config.get_float("SERVE_RESTART_BACKOFF", 0.1))
        self._canary_cfg = {
            "min_batches": int(
                canary_min_batches if canary_min_batches is not None
                else config.get_int("SERVE_CANARY_MIN_BATCHES", 8)),
            "window": int(
                canary_window if canary_window is not None
                else config.get_int("SERVE_CANARY_WINDOW", 64)),
            "latency_ratio": float(
                canary_latency_ratio if canary_latency_ratio is not None
                else config.get_float("SERVE_CANARY_LATENCY_RATIO", 2.0)),
            "error_margin": float(
                canary_error_margin if canary_error_margin is not None
                else config.get_float("SERVE_CANARY_ERROR_MARGIN", 0.05))}
        qps = float(tenant_qps if tenant_qps is not None
                    else config.get_float("SERVE_TENANT_QPS", 0.0))
        burst = (tenant_burst if tenant_burst is not None
                 else config.get_float("SERVE_TENANT_BURST", 0.0))
        self._quotas = (control.TenantQuotas(qps, burst=burst,
                                             clock=self.batcher.clock)
                        if qps > 0 else None)
        from . import autoscale as autoscale_mod
        self._autoscale_cfg = autoscale_mod.autoscale_knobs(
            self.replicas,
            {"min_replicas": autoscale_min, "max_replicas": autoscale_max,
             "target_wait_ms": autoscale_target_wait_ms,
             "idle_s": autoscale_idle_s, "cooldown_s": autoscale_cooldown_s,
             "up_polls": autoscale_up_polls, "step": autoscale_step,
             "poll_s": autoscale_poll_s})
        self._autoscaler = None
        self._recorder = None    # serve/tracefile.TraceRecorder when armed
        self._deploy = None      # serve/continuous.DeployController
        self._sup = supervisor
        self._own_sup = False
        if self._sup is None:
            d = (stall_seconds if stall_seconds is not None
                 else config.get_float("SERVE_STALL_SECONDS", 0.0))
            if d > 0:
                self._sup = Supervisor({"serve": d}, report_dir=report_dir,
                                       name="bigdl-torch-serve-supervisor")
                self._own_sup = True

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "InferenceServer":
        if self._threads:
            return self
        if self.batcher.closed:
            raise ServeError("serve: cannot restart a stopped server")
        if self._own_sup:
            self._sup.start()
        if self._example is not None:
            self.warmup()
        for i in range(self.replicas):
            self._spawn_replica(i)
        if self._replica_lost > 0:
            self._monitor = control.ReplicaMonitor(
                self, self._replica_lost, budget=self._restart_budget,
                backoff=self._restart_backoff).start()
        if self._autoscale_cfg["max_replicas"] > 0:
            from . import autoscale as autoscale_mod
            cfg = dict(self._autoscale_cfg)
            cfg["min_replicas"] = min(cfg["min_replicas"], self.replicas)
            cfg["max_replicas"] = max(cfg["max_replicas"],
                                      cfg["min_replicas"])
            poll = cfg.pop("poll_s")
            self._autoscaler = autoscale_mod.AutoScaler(
                self, poll_s=poll, clock=self.batcher.clock,
                **cfg).start()
        logger.info("serve: started %d replica(s) on %s, max_batch=%d, "
                    "buckets=%s, seq_buckets=%s%s", self.replicas,
                    self.device, self.max_batch, self.batcher.buckets,
                    self.seq_buckets,
                    f", replica_lost={self._replica_lost:g}s"
                    if self._monitor is not None else "")
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut down.  drain=True answers everything already queued before
        the workers exit; drain=False fails queued requests with
        ServerClosed.  Whatever is still queued once the workers are gone
        fails typed too, so no caller blocks on ``result()`` forever.  An
        armed trace with a path is written first."""
        if self._autoscaler is not None:
            self._autoscaler.stop()   # no resize of a pool shutting down
        if self._monitor is not None:
            self._monitor.stop()      # no respawn into a shutdown
        if self._recorder is not None and self._recorder.path:
            try:
                self._recorder.save()
            except Exception:  # noqa: BLE001 - recording is best effort
                logger.exception("serve: trace flush failed at shutdown")
        self.batcher.close(
            drain=drain and any(t.is_alive() for t in self._threads))
        for t in self._threads:
            t.join(timeout=timeout)
        leaked = [t.name for t in self._threads if t.is_alive()]
        self._threads = []
        stranded = self.batcher.fail_pending()
        if stranded:
            logger.warning("serve: failed %d still-queued request(s) with "
                           "ServerClosed at shutdown", stranded)
        if self._own_sup:
            self._sup.stop()
        if leaked:
            raise ServeError(f"serve: replica thread(s) did not exit "
                             f"within {timeout}s: {leaked}")

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- request path ---------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: int = 0,
               request_id: Optional[str] = None) -> PendingRequest:
        """Enqueue one sample (not a batch); returns a handle whose
        ``result()`` is the per-sample output row and whose ``version``
        names the version that answered.  Raises ServeError for a sample
        that does not fit, ReplicaLostError on an unhealthy pool with no
        live replica, QuotaExceeded / ServerOverloaded / ServerClosed at
        admission.  ``tenant`` is held to the token-bucket quotas,
        ``priority`` (higher = more important) decides who is shed first,
        ``request_id`` is an upstream flow id (``X-BigDL-Request-Id``)."""
        if self._unhealthy is not None and not self._pool_alive():
            raise control.ReplicaLostError(
                f"serve: pool unhealthy — {self._unhealthy}")
        x = np.asarray(x)
        if self._example is None:
            self._example = np.zeros_like(x)
        elif self.seq_buckets is not None:
            # leading dims fixed, trailing axis any length the ladder fits
            if x.ndim != self._example.ndim or \
                    x.shape[:-1] != self._example.shape[:-1]:
                raise ServeError(
                    f"serve: sample shape {x.shape} does not match the "
                    f"server's example shape {self._example.shape} "
                    "(leading dims must agree under seq_buckets)")
            if fit_bucket(x.shape[-1], self.seq_buckets) is None:
                raise ServeError(
                    f"serve: sample length {x.shape[-1]} exceeds the "
                    f"largest sequence bucket {self.seq_buckets[-1]} "
                    "(refusing to truncate)")
        elif x.shape != self._example.shape:
            raise ServeError(
                f"serve: sample shape {x.shape} does not match the "
                f"server's example shape {self._example.shape}")
        ms = (deadline_ms if deadline_ms is not None
              else self.default_deadline_ms)
        if self._recorder is not None:
            # offered traffic, shed requests included: they are real load
            self._recorder.note(x, tenant=tenant, priority=priority,
                                deadline_ms=ms if ms and ms > 0 else None)
        if self._quotas is not None:
            try:
                self._quotas.admit(tenant)
            except Exception:
                reg = metrics_export._REGISTRY
                if reg is not None:
                    reg.shed("quota")
                raise
        deadline = (self.batcher.clock() + ms / 1000.0) if ms and ms > 0 \
            else None
        return self.batcher.submit(x, deadline, tenant=tenant,
                                   priority=priority, request_id=request_id)

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit + wait."""
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    # -- replica lifecycle (serve/control.ReplicaMonitor's hooks) -------

    def _spawn_replica(self, idx: int) -> threading.Thread:
        """Start the worker of replica slot ``idx`` under a new
        generation: an earlier incarnation that wakes later sees it, hands
        its batch back and exits."""
        st = self._replica.setdefault(
            idx, [None, 0, self.batcher.clock()])
        st[1] += 1
        st[2] = self.batcher.clock()
        t = threading.Thread(target=self._worker, args=(idx, st[1]),
                             daemon=True,
                             name=f"bigdl-torch-serve-replica-{idx}")
        st[0] = t
        t.start()
        self._threads.append(t)
        return t

    def _condemn_replica(self, idx: int) -> None:
        """Retire the current incarnation of replica ``idx`` by a
        generation bump (a Python thread cannot be killed; it retires at
        its next loop turn)."""
        st = self._replica.get(idx)
        if st is not None:
            st[1] += 1

    def _restart_replica(self, idx: int) -> None:
        """Respawn replica ``idx`` on a fresh forward of the current
        version, its bucket ladder warmed before the flip (on the monitor's
        thread; the old forward answers until then).  The forward runs the
        same kernels as before."""
        if self.batcher.closed or idx >= self.replicas:
            # a slot a pool shrink emptied is not healed
            return
        with self._lock:
            old = self._version
        try:
            version = ModelVersion(old.id, old.module, old.label,
                                   self._strategy, device=self.device)
            if self._example is not None:
                self._warm_version(version, self._example)
            with self._lock:
                if self._version is old:  # a swap may have raced us
                    self._version = version
        except Exception:  # noqa: BLE001 - the old forward still works
            logger.exception("serve: replica %d forward rebuild failed; "
                             "respawning on the existing one", idx)
        with self._lock:
            self._stats["restarts"] += 1
        reg = metrics_export._REGISTRY
        if reg is not None:
            reg.counter_inc("bigdl_serve_restarts_total", 1.0,
                            help="replica respawns by the monitor")
        self._spawn_replica(idx)
        telemetry.instant("serve.replica_restart", cat="serve",
                          replica=idx)
        logger.info("serve: replica %d restarted (bucket ladder warmed "
                    "again)", idx)

    # -- elastic pool size (serve/autoscale.AutoScaler's hooks) ---------

    def scale_to(self, n: int) -> int:
        """Resize the worker pool to ``n`` replicas.  Growth spawns
        workers over the current version's warm forward; shrink condemns
        the highest slots (a parked worker exits at its next wait slice,
        one holding a batch requeues it first), and the monitor leaves
        retired slots alone."""
        n = max(int(n), 1)
        with self._scale_lock:
            if self.batcher.closed:
                return self.replicas
            cur = self.replicas
            if n == cur:
                return cur
            if n > cur:
                for idx in range(cur, n):
                    self._spawn_replica(idx)
            else:
                for idx in range(n, cur):
                    self._condemn_replica(idx)
                with self.batcher._cond:
                    self.batcher._cond.notify_all()
            self.replicas = n
        logger.info("serve: pool scaled %d -> %d replica(s)", cur, n)
        return n

    def autoscale_signals(self) -> dict:
        """The autoscaler's inputs: queued rows, EMA service seconds a
        row, served batches so far, live workers."""
        with self._lock:
            batches = self._stats["batches"]
        return {"depth": self.batcher.depth(),
                "row_s_ema": self.batcher.service_row_seconds(),
                "batches": batches, "live": self._live_replicas()}

    def _live_replicas(self) -> int:
        return sum(1 for idx, st in list(self._replica.items())
                   if idx < self.replicas and st[0] is not None
                   and st[0].is_alive())

    # -- traffic trace capture (serve/tracefile.py) ---------------------

    def record_trace(self, path: Optional[str] = None, *,
                     limit: Optional[int] = None):
        """Arm offered-traffic recording (the same path again is a no-op):
        every later ``submit()``, shed or served, is a trace event;
        ``stop_trace()`` (or ``stop()``, with a path armed) writes the
        file.  Returns the recorder."""
        from .tracefile import TraceRecorder
        if self._recorder is not None and (path is None or
                                           self._recorder.path == path):
            return self._recorder
        self._recorder = TraceRecorder(clock=self.batcher.clock,
                                       limit=limit, path=path)
        logger.info("serve: trace recording armed%s",
                    f" -> {path}" if path else " (in memory)")
        return self._recorder

    def stop_trace(self, path: Optional[str] = None):
        """Disarm recording; write the trace when a path is armed or
        given; return the captured events."""
        rec, self._recorder = self._recorder, None
        if rec is None:
            return []
        if path or rec.path:
            n = rec.save(path)
            logger.info("serve: trace recording stopped, %d event(s) -> "
                        "%s", n, path or rec.path)
        return rec.events()

    def attach_deploy(self, controller) -> None:
        """Register a ``DeployController`` so its state rides
        ``stats()["deploy"]`` and the HTTP front serves ``/v1/versions``
        from it."""
        self._deploy = controller

    def _mark_unhealthy(self, err: Exception) -> None:
        """The restart budget is spent: stop healing and say so
        (``/healthz`` answers 503); with no live worker left, queued
        requests fail typed."""
        self._unhealthy = err
        telemetry.instant("serve.unhealthy", cat="serve", reason=str(err))
        logger.error("serve: UNHEALTHY — %s (restart budget %d spent)",
                     err, self._restart_budget)
        if not self._pool_alive():
            n = self.batcher.fail_pending(err)
            if n:
                logger.error("serve: failed %d queued request(s) with the "
                             "replica-lost error", n)

    def _pool_alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def healthy(self) -> bool:
        """False once a replica's restart budget is spent."""
        return self._unhealthy is None

    # -- replica workers ------------------------------------------------

    def _worker(self, idx: int, gen: int = 1) -> None:
        telemetry.thread_name(f"serve replica {idx}")
        st = self._replica.setdefault(idx, [None, gen, self.batcher.clock()])
        chan = (self._sup.channel(f"serve-replica-{idx}", phase="serve")
                if self._sup is not None else None)

        def beat(phase: Optional[str] = None) -> None:
            # the local stamp feeds the replica monitor, the channel the
            # embedder's supervisor
            st[2] = self.batcher.clock()
            if chan is not None:
                chan.beat(phase)

        try:
            while True:
                try:
                    if st[1] != gen:
                        return  # condemned: a newer incarnation owns idx
                    beat()
                    reqs = self.batcher.collect(
                        heartbeat=beat, stop_when=lambda: st[1] != gen)
                    if reqs is None:
                        return
                    if st[1] != gen:
                        # condemned while collecting: hand the batch back
                        self._hand_back(reqs, idx)
                        return
                    if reqs:
                        try:
                            # exit ends this thread (after the requeue),
                            # wedge blocks it
                            chaos.fire(f"serve.replica@{idx}",
                                       thread_exc=control.ReplicaExit)
                        except control.ReplicaExit as e:
                            self._hand_back(reqs, idx)
                            logger.error("serve: replica %d killed by a "
                                         "chaos drill (%s); batch of %d "
                                         "requeued", idx, e, len(reqs))
                            return
                        if st[1] != gen:
                            # woke from a wedge condemned
                            self._hand_back(reqs, idx)
                            return
                        self._execute(reqs, beat)
                except StallError:
                    # a stall notice between batches (one during a batch
                    # fails that batch typed); the report is written
                    logger.warning("serve: replica %d received a stall "
                                   "notice between batches; continuing",
                                   idx)
                except Exception as e:  # noqa: BLE001 - replica backstop
                    # _execute answers its own batch's errors; anything
                    # that still escapes must not shrink the pool
                    logger.exception("serve: replica %d loop error (%s); "
                                     "continuing", idx, type(e).__name__)
        finally:
            if chan is not None:
                chan.close()

    def _hand_back(self, reqs, idx: int) -> None:
        if telemetry.get_active() is not None:
            for r in reqs:
                telemetry.flow_step(r.rid, hop="replica.lost", replica=idx)
        self.batcher.requeue(reqs)

    def _execute(self, reqs, beat=None) -> None:
        # one version per collect, chosen here (the canary's share too):
        # a swap mid-batch cannot split the collected requests
        with self._lock:
            version = self._version
            canary = self._canary
            is_canary = False
            if canary is not None and canary.state == "running" \
                    and canary.route():
                version = canary.version
                is_canary = True
        if self.seq_buckets is None:
            groups = [(None, reqs)]
        else:
            by: dict = {}
            for r in reqs:
                by.setdefault(fit_bucket(r.payload.shape[-1],
                                         self.seq_buckets), []).append(r)
            groups = sorted(by.items())
        for seq, group in groups:
            self._run_batch(group, version, canary, is_canary, seq)
        if beat is not None:
            beat()

    def _run_batch(self, reqs, version: ModelVersion, canary,
                   is_canary: bool, seq: Optional[int]) -> None:
        n = len(reqs)
        bucket = self.batcher.bucket_for(n)
        seq_extra = {} if seq is None else {"seq": seq}
        t0 = self.batcher.clock()
        if telemetry.get_active() is not None:
            for r in reqs:
                telemetry.flow_step(r.rid, hop="batch.assemble", size=n,
                                    bucket=bucket, **seq_extra)
        try:
            rows = ([r.payload for r in reqs] if seq is None
                    else [pad_tail(r.payload, seq) for r in reqs])
            batch = pad_rows(np.stack(rows), bucket)
            with telemetry.span("serve.batch", cat="serve", size=n,
                                bucket=bucket, version=version.id,
                                canary=is_canary, **seq_extra):
                chaos.fire("serve.batch")
                if is_canary:
                    chaos.fire("serve.canary")
                out = version.predict(batch)
        except Exception as e:  # noqa: BLE001 - typed per-request error
            # the batch fails to its callers; the replica and queue survive
            now = self.batcher.clock()
            for r in reqs:
                r._resolve(error=e, now=now)
            with self._lock:
                self._stats["batch_errors"] += 1
            logger.warning("serve: batch of %d failed: %s: %s", n,
                           type(e).__name__, e)
            self._canary_observe(canary, is_canary, now - t0, True)
            return
        now = self.batcher.clock()
        for i, r in enumerate(reqs):
            r._resolve(result=out[i], version=version.id, now=now)
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batch_rows"] += n
            self._stats["bucket_rows"] += bucket
        self.batcher.note_service(n, now - t0)
        telemetry.counter("serve", queue_depth=self.batcher.depth(),
                          batch_fill=n / bucket)
        self._canary_observe(canary, is_canary, now - t0, False)

    def _canary_observe(self, canary, is_canary: bool, dur_s: float,
                        errored: bool) -> None:
        """Feed one finished batch to the canary comparator and act on its
        verdict: promotion flips the reference as a plain swap does,
        rollback drops the candidate with a typed reason."""
        if canary is None:
            return
        with self._lock:
            if self._canary is not canary or canary.state != "running":
                return  # decided already, or superseded by a full swap
            decision = canary.observe(is_canary, dur_s, errored)
            if decision is None:
                return
            if decision == "promote":
                canary.state = "promoted"
                self._version = canary.version
                self._stats["swaps"] += 1
            else:
                canary.state = "rolled_back"
                self._stats["canary_rollbacks"] += 1
            self._canary = None
            self._canary_last = canary.summary()
        telemetry.instant("serve.canary", cat="serve",
                          decision=canary.state, version=canary.version.id,
                          reason=str(canary.reason or ""))
        if canary.state == "promoted":
            logger.info("serve: canary v%d promoted after %d canary "
                        "batches", canary.version.id, canary.routed)
        else:
            logger.error("serve: canary v%d ROLLED BACK — %s",
                         canary.version.id, canary.reason)

    # -- warmup ---------------------------------------------------------

    def warmup(self, example: Optional[np.ndarray] = None) -> None:
        """Run every bucket shape once on the current version before
        traffic (the first forward builds the CUDA kernels)."""
        ex = np.asarray(example) if example is not None else self._example
        if ex is None:
            raise ValueError("serve: warmup needs an example sample "
                             "(pass example= here or at construction)")
        self._example = ex
        self._warm_version(self._version, ex)

    def _warm_version(self, version: ModelVersion, ex: np.ndarray) -> None:
        """Every (batch bucket x sequence bucket) shape once on
        ``version``; each forward counts in ``stats()["warmup_batches"]``."""
        with telemetry.span("serve.warmup", cat="serve",
                            version=version.id):
            for b in self.batcher.buckets:
                if self.seq_buckets is None:
                    shapes = [np.stack([ex] * b)]
                else:
                    shapes = [np.stack([pad_tail(ex[..., :length],
                                                 length)] * b)
                              for length in self.seq_buckets]
                for batch in shapes:
                    version.predict(batch)
                    with self._lock:
                        self._stats["warmup_batches"] += 1

    # -- hot swap -------------------------------------------------------

    def swap(self, source, *, quantized: bool = False,
             state=None, canary_fraction: Optional[float] = None) -> int:
        """Install a new model version with no dropped request; returns
        its id.

        ``source``: a checkpoint directory (its newest snapshot,
        ``file_io.latest_checkpoint``), a snapshot file or a
        ``Module.save`` file, a reference (params, state) tree, or a built
        Module.  ``quantized=True`` int8-quantizes the loaded module
        (``bigdl_torch.quantize``).  The version is loaded, quantized,
        given its forward and warmed before one reference flip makes it
        live.

        ``canary_fraction`` in (0, 1) installs it as a canary instead:
        that share of device batches goes to it while the comparator
        (``serve/control.CanaryController``) promotes it after
        ``SERVE_CANARY_MIN_BATCHES`` clean batches or rolls it back on a
        regression (``stats()["canary"]``).  A later plain swap supersedes
        a running canary."""
        # the slow build runs under its own lock: _lock guards only the
        # flip and the per-batch stats, so replicas answer throughout
        with self._swap_lock:
            self._vid += 1
            vid = self._vid
            module, label = self._load_module(source, state)
            if quantized:
                from ..quantize import quantize
                module = quantize(module)
                label += "+int8"
            version = ModelVersion(vid, module, label, self._strategy,
                                   device=self.device)
            if self._example is not None:
                self._warm_version(version, self._example)
            if canary_fraction is not None:
                ctl = control.CanaryController(version, canary_fraction,
                                               **self._canary_cfg)
                with self._lock:
                    self._canary = ctl
                    self._canary_last = None
                telemetry.instant("serve.swap", cat="serve", version=vid,
                                  label=label,
                                  canary_fraction=float(canary_fraction))
                logger.info("serve: canary version %d (%s) taking %.0f%% "
                            "of batches", vid, label,
                            100.0 * float(canary_fraction))
                return vid
            with self._lock:
                self._version = version  # the flip
                self._canary = None      # a full swap supersedes a canary
                self._stats["swaps"] += 1
        telemetry.instant("serve.swap", cat="serve", version=vid,
                          label=label)
        logger.info("serve: hot-swapped to version %d (%s)", vid, label)
        return vid

    def _load_module(self, source, state):
        """(module, label) for ``swap``.  A tree, a snapshot or a
        checkpoint is loaded into a clone of the served architecture; a
        ``Module.save`` file is read onto this server's device.  A module
        file of the JAX package raises ``ReferenceModuleFile``."""
        from ..utils import file_io
        arch = self._version.module
        if isinstance(source, Module):
            if not source.built:
                source.build(self.device)
            return source, f"module:{type(source).__name__}"
        if isinstance(source, str):
            latest = file_io.latest_checkpoint(source)
            if latest is not None:  # checkpoint directory: newest snapshot
                mp, _op, neval = latest
                blob = file_io.load(mp)
                return (_clone_with(arch, blob["params"], blob["state"]),
                        f"ckpt:{source}@{neval}")
            blob = _read_blob(source)
            if isinstance(blob, dict) and \
                    blob.get("format") == "bigdl_torch-module-v1":
                return (Module.load(source, device=self.device),
                        f"file:{source}")
            if isinstance(blob, dict) and "params" in blob:
                return (_clone_with(arch, blob["params"],
                                    blob.get("state")), f"file:{source}")
            raise ValueError(f"serve: {source!r} is neither a checkpoint "
                             "directory, a model snapshot, nor a module "
                             "file")
        # a (params, state) tree handed in directly
        return _clone_with(arch, source, state), "params"

    # -- introspection --------------------------------------------------

    @property
    def version(self) -> ModelVersion:
        return self._version

    def stats(self) -> dict:
        """Admission and shed counts (batcher), batch counts and fill,
        warm-up batches, swaps, restarts, canary, quota and health state,
        the current version, the pool."""
        out = self.batcher.stats()
        with self._lock:
            out.update(self._stats)
            out["version"] = self._version.id
            out["version_label"] = self._version.label
            canary = self._canary
            canary_last = self._canary_last
        out["batch_fill"] = round(out["batch_rows"] /
                                  max(out["bucket_rows"], 1), 4)
        out["replicas"] = self.replicas
        out["replicas_live"] = self._live_replicas()
        out["healthy"] = self.healthy()
        if self._autoscaler is not None:
            out["autoscale"] = self._autoscaler.stats()
        if self._deploy is not None:
            out["deploy"] = self._deploy.stats()
        if self._recorder is not None:
            out["trace_recording"] = self._recorder.stats()
        if self._unhealthy is not None:
            out["unhealthy_reason"] = str(self._unhealthy)
            out["unhealthy_type"] = type(self._unhealthy).__name__
        if canary is not None:
            out["canary"] = canary.summary()
        elif canary_last is not None:
            out["canary"] = canary_last
        if self._monitor is not None:
            out["replica_monitor"] = self._monitor.stats()
        if self._quotas is not None:
            out["quota"] = self._quotas.stats()
        return out
