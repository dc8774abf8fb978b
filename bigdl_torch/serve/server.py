"""Online inference server: replica pool over a dynamic batcher.

Counterpart of ``bigdl_tpu/serve/server.py`` for the serving slice:

- each replica is a worker thread draining the shared
  :class:`~bigdl_torch.serve.batcher.DynamicBatcher` and running padded
  batches through the same eval forward ``Predictor`` uses, so online
  answers are the same arithmetic as bulk prediction;
- ``seq_buckets`` serves variable-length token requests: each request pads
  its trailing axis to the smallest sequence bucket that fits it, and each
  sequence bucket of a collect is its own device batch, so a request's
  answer never depends on its batch-mates' lengths;
- ``warmup()`` runs every (batch bucket x sequence bucket) shape once
  before traffic (it builds the CUDA kernels on first use);
- ``stop(drain=)`` shuts down gracefully, failing whatever is left typed.

Not ported yet: hot swap, canary, tenant quotas, the replica monitor,
autoscaling, supervision, trace recording and chaos points.

Knobs (``utils/config``; constructor arguments override):
``BIGDL_TORCH_SERVE_MAX_BATCH`` (8), ``_MAX_WAIT_MS`` (5),
``_QUEUE_LIMIT`` (64), ``_REPLICAS`` (1), ``_DEADLINE_MS`` (0 = none).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

import numpy as np

from ..common import resolve_device
from ..nn.module import Module
from ..optim.optimizer import HostCopy, _Forward
from ..utils import config
from .batcher import (DynamicBatcher, PendingRequest, ServeError, fit_bucket,
                      pad_rows, pad_tail)

logger = logging.getLogger("bigdl_torch")

__all__ = ["ModelVersion", "InferenceServer"]


class ModelVersion:
    """One servable (module, engine) bundle on one device."""

    def __init__(self, vid: int, module: Module, label: str, device):
        self.id = int(vid)
        self.label = label
        self.module = module
        self._engine = _Forward(module, device)
        self._to_host = HostCopy()

    def predict(self, batch: np.ndarray) -> np.ndarray:
        """Forward one padded batch; returns its host rows through the
        version's pinned buffer (:class:`HostCopy`).  A bfloat16 output
        widens to float32 on the device, since numpy has no bfloat16; the
        widening is exact."""
        out, _ = self._engine(batch)
        return self._to_host(out[:len(batch)])


class InferenceServer:
    """Online serving facade over a Module (see module docstring).

    Usage::

        server = InferenceServer(model, example=x0).start()
        y = server.predict(x)                  # blocking convenience
        h = server.submit(x, deadline_ms=50)   # async handle
        server.stop()                          # graceful drain

    Also a context manager.  Runs on ``device`` (default: the CUDA device;
    raises without one)."""

    def __init__(self, model: Module, *, device=None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 replicas: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 example: Optional[np.ndarray] = None,
                 clock=None):
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
        self.batcher = DynamicBatcher(self.max_batch, wait_ms / 1000.0,
                                      self.queue_limit, buckets=buckets,
                                      clock=clock)
        self.seq_buckets = (tuple(sorted(int(b) for b in seq_buckets))
                            if seq_buckets else None)
        self._example = None if example is None else np.asarray(example)
        self._version = ModelVersion(1, model, "initial", self.device)
        self._lock = threading.Lock()   # stats
        self._threads: list = []
        self._stats = {"batches": 0, "batch_rows": 0, "batch_errors": 0,
                       "bucket_rows": 0, "warmup_batches": 0}

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "InferenceServer":
        if self._threads:
            return self
        if self.batcher.closed:
            raise ServeError("serve: cannot restart a stopped server")
        if self._example is not None:
            self.warmup()
        for i in range(self.replicas):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True,
                                 name=f"bigdl-torch-serve-replica-{i}")
            t.start()
            self._threads.append(t)
        logger.info("serve: started %d replica(s) on %s, max_batch=%d, "
                    "buckets=%s, seq_buckets=%s", self.replicas, self.device,
                    self.max_batch, self.batcher.buckets, self.seq_buckets)
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut down.  drain=True answers everything already queued before
        the workers exit; drain=False fails queued requests with
        ServerClosed.  Whatever is still queued once the workers are gone
        fails typed too, so no caller blocks on ``result()`` forever."""
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
               priority: int = 0) -> PendingRequest:
        """Enqueue one sample (not a batch); returns a handle whose
        ``result()`` is the per-sample output row.  Raises ServeError for
        a sample that does not fit, ServerOverloaded / ServerClosed at
        admission."""
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
        deadline = (self.batcher.clock() + ms / 1000.0) if ms and ms > 0 \
            else None
        return self.batcher.submit(x, deadline, priority=priority)

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit + wait."""
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    # -- replica workers ------------------------------------------------

    def _worker(self, idx: int) -> None:
        while True:
            try:
                reqs = self.batcher.collect()
                if reqs is None:
                    return
                if reqs:
                    self._execute(reqs)
            except Exception:  # noqa: BLE001 - replica backstop
                # _execute answers its own batch's errors; anything that
                # still escapes must not take the replica down
                logger.exception("serve: replica %d loop error; continuing",
                                 idx)

    def _execute(self, reqs) -> None:
        version = self._version
        if self.seq_buckets is None:
            groups = [(None, reqs)]
        else:
            by: dict = {}
            for r in reqs:
                by.setdefault(fit_bucket(r.payload.shape[-1],
                                         self.seq_buckets), []).append(r)
            groups = sorted(by.items())
        for seq, group in groups:
            self._run_batch(group, version, seq)

    def _run_batch(self, reqs, version: ModelVersion,
                   seq: Optional[int]) -> None:
        n = len(reqs)
        bucket = self.batcher.bucket_for(n)
        t0 = self.batcher.clock()
        try:
            rows = ([r.payload for r in reqs] if seq is None
                    else [pad_tail(r.payload, seq) for r in reqs])
            out = version.predict(pad_rows(np.stack(rows), bucket))
        except Exception as e:  # noqa: BLE001 - typed per-request error
            # the batch fails to its callers; the replica and queue survive
            now = self.batcher.clock()
            for r in reqs:
                r._resolve(error=e, now=now)
            with self._lock:
                self._stats["batch_errors"] += 1
            logger.warning("serve: batch of %d failed: %s: %s", n,
                           type(e).__name__, e)
            return
        now = self.batcher.clock()
        for i, r in enumerate(reqs):
            r._resolve(result=out[i], now=now)
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batch_rows"] += n
            self._stats["bucket_rows"] += bucket
        self.batcher.note_service(n, now - t0)

    # -- warmup ---------------------------------------------------------

    def warmup(self, example: Optional[np.ndarray] = None) -> None:
        """Run every bucket shape once on the current version before
        traffic (the first forward builds the CUDA kernels)."""
        ex = np.asarray(example) if example is not None else self._example
        if ex is None:
            raise ValueError("serve: warmup needs an example sample "
                             "(pass example= here or at construction)")
        self._example = ex
        for b in self.batcher.buckets:
            if self.seq_buckets is None:
                shapes = [np.stack([ex] * b)]
            else:
                shapes = [np.stack([pad_tail(ex[..., :length], length)] * b)
                          for length in self.seq_buckets]
            for batch in shapes:
                self._version.predict(batch)
                with self._lock:
                    self._stats["warmup_batches"] += 1

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        """Admission/shed counts (batcher), batch counts and fill, warmup
        batches, version and replica liveness."""
        out = self.batcher.stats()
        with self._lock:
            out.update(self._stats)
        out["version"] = self._version.id
        out["version_label"] = self._version.label
        out["batch_fill"] = round(out["batch_rows"] /
                                  max(out["bucket_rows"], 1), 4)
        out["replicas"] = self.replicas
        out["replicas_live"] = sum(t.is_alive() for t in self._threads)
        return out
