"""Dynamic request batching: coalesce single requests into fixed shapes.

Counterpart of ``bigdl_tpu/serve/batcher.py`` (the host-side half of the
serving subsystem), without its chaos, tracing and metrics hooks:

- :class:`DynamicBatcher`: producers ``submit()`` single samples, replica
  workers ``collect()`` batches.  A batch flushes when ``max_batch``
  requests wait or the oldest has waited ``max_wait_s``.  Batch sizes come
  from a fixed ``buckets`` ladder (default: powers of two up to
  ``max_batch``) and are padded up to the bucket.
- Backpressure: the queue is bounded.  Admission past the bound first
  sweeps queued requests whose deadline passed, then evicts the
  lowest-priority queued request if the arrival outranks it, and only then
  raises :class:`ServerOverloaded` with a ``retry_after_s`` estimate.
- Deadlines: a request dequeued past its deadline is shed with
  :class:`RequestTimeout` and never reaches the device.
- Tenants: a request carries an optional ``tenant`` tag; the per-tenant
  token buckets that admit by it live in ``serve/control.py``.
- :class:`DecodeQueue`: the same queue with one *sequence* (prompt and
  token budget) per item, for the decode engine (``serve/decode.py``):
  ``take(n)`` pops without blocking, and ``retry_after_s`` scales with the
  queued token budget.
- :func:`pad_rows` pads a batch's rows to a bucket and, with ``length=``,
  its trailing axis too (zeros; it refuses to truncate).

Everything is clock-injectable.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["ServeError", "ServerOverloaded", "ServerClosed",
           "RequestTimeout", "PendingRequest", "DynamicBatcher",
           "DecodeQueue", "default_buckets", "fit_bucket", "pad_rows",
           "pad_tail", "predict_in_fixed_batches"]


class ServeError(RuntimeError):
    """Base class for typed serving rejections."""


class ServerOverloaded(ServeError):
    """Admission rejected: the bounded queue is full (or this request was
    evicted from it for a higher-priority arrival).  ``retry_after_s``
    estimates when the queue will have drained."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RequestTimeout(ServeError, TimeoutError):
    """The request's deadline passed while it was still queued; it was shed
    before reaching the device."""


class ServerClosed(ServeError):
    """submit() after shutdown began (stop() was called)."""


class PendingRequest:
    """Future-like handle for one submitted sample.  ``result(timeout)``
    blocks until a replica resolves it and returns the per-sample output
    row, or raises the typed error the server recorded."""

    __slots__ = ("payload", "enqueued", "deadline", "tenant", "priority",
                 "latency_s", "_event", "_result", "_error")

    def __init__(self, payload, enqueued: float,
                 deadline: Optional[float] = None,
                 tenant: Optional[str] = None, priority: int = 0):
        self.payload = payload
        self.enqueued = enqueued
        self.deadline = deadline
        self.tenant = tenant           # quota / accounting tag
        self.priority = int(priority)  # higher = shed later
        self.latency_s = None          # enqueue -> resolve
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _resolve(self, result=None, error=None,
                 now: Optional[float] = None) -> None:
        if self._event.is_set():  # first resolution wins
            return
        self._result = result
        self._error = error
        if now is not None:
            self.latency_s = max(now - self.enqueued, 0.0)
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"serve: no response within {timeout}s (request still "
                "queued or executing, not shed)")
        if self._error is not None:
            raise self._error
        return self._result


def default_buckets(max_batch: int) -> tuple:
    """The batch-shape ladder: powers of two up to ``max_batch``, with
    ``max_batch`` itself always included."""
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def fit_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= ``n`` from an ascending ladder, or None when
    ``n`` overflows the largest (a sequence cannot be split)."""
    for b in buckets:
        if b >= n:
            return b
    return None


def pad_tail(arr: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad only the trailing axis up to ``length``; refuses to
    truncate."""
    arr = np.asarray(arr)
    if arr.ndim < 1:
        raise ValueError("pad_tail: needs at least a 1-D array, got "
                         f"ndim={arr.ndim}")
    have = arr.shape[-1]
    if have > length:
        raise ValueError(f"pad_tail: trailing axis {have} exceeds "
                         f"length={length} (refusing to truncate)")
    if have == length:
        return arr
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, length - have)]
    return np.pad(arr, pad, mode="constant", constant_values=0)


def pad_rows(arr: np.ndarray, n: int,
             length: Optional[int] = None) -> np.ndarray:
    """Pad the batch dim up to ``n`` rows by repeating the last row, so the
    device sees only bucket shapes.

    ``length``, when given, also pads the trailing axis up to ``length``
    with zeros (ragged token rows); a row longer than ``length`` raises
    rather than being truncated.  The dtype is kept, also for a batch of
    zero rows, which then becomes ``n`` rows of zeros of the resized
    shape."""
    arr = np.asarray(arr) if length is None else pad_tail(arr, length)
    short = n - len(arr)
    if short <= 0:
        return arr
    if len(arr) == 0 and length is not None:
        # nothing to repeat: zero rows of the resized shape
        return np.zeros((n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, np.repeat(arr[-1:], short, axis=0)])


def predict_in_fixed_batches(forward: Callable, feats: np.ndarray,
                             batch_size: int) -> np.ndarray:
    """``feats`` in full batches of ``batch_size`` rows through
    ``forward`` (one call a batch, the last one padded by
    :func:`pad_rows`), the outputs cut back to the real rows and
    concatenated: the bulk counterpart of the online batcher's bucket
    padding (``serving.UDFPredictor``).  Zero rows return ``feats``
    without a call (the output's trailing shape is unknown without one)."""
    feats = np.asarray(feats)
    if len(feats) == 0:
        return feats
    outs = []
    for i in range(0, len(feats), batch_size):
        chunk = feats[i:i + batch_size]
        outs.append(np.asarray(forward(pad_rows(chunk, batch_size)))
                    [:len(chunk)])
    return np.concatenate(outs, axis=0)


class DynamicBatcher:
    """Bounded request queue + coalescing policy (see module docstring).

    Any number of producer threads call :meth:`submit`; any number of
    replica workers call :meth:`collect`.  ``close(drain=True)`` lets
    workers finish the queue before :meth:`collect` returns None;
    ``drain=False`` fails everything still queued with
    :class:`ServerClosed`."""

    #: wait slice of a parked worker
    _SLICE = 0.05

    def __init__(self, max_batch: int, max_wait_s: float,
                 queue_limit: int, buckets: Optional[Sequence[int]] = None,
                 clock=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.queue_limit = int(queue_limit)
        self.buckets = tuple(sorted(buckets)) if buckets else \
            default_buckets(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")
        self.clock = clock or time.monotonic
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self.submitted = 0
        self.shed_overload = 0
        self.shed_timeout = 0
        self.shed_priority = 0        # evicted for a higher-priority arrival
        self.shed_by_priority: dict = {}
        self._row_s_ema = None        # EMA service seconds/row (retry-after)

    # -- producers ------------------------------------------------------

    def _count_shed(self, priority: int) -> None:
        # caller holds self._cond
        self.shed_by_priority[priority] = \
            self.shed_by_priority.get(priority, 0) + 1

    def _sweep_expired_locked(self, now: float) -> List[PendingRequest]:
        """Drop queued requests whose deadline passed (caller holds the
        lock; they are resolved outside it)."""
        live, expired = collections.deque(), []
        for r in self._q:
            if r.deadline is not None and now > r.deadline:
                expired.append(r)
                self.shed_timeout += 1
                self._count_shed(r.priority)
            else:
                live.append(r)
        self._q = live
        return expired

    def retry_after_s(self) -> float:
        """Seconds a rejected caller should back off: the estimated time
        to drain a full queue, never below the coalesce window."""
        per_row = self._row_s_ema or 0.0
        return round(max(per_row * self.queue_limit, self.max_wait_s,
                         0.05), 3)

    def note_service(self, rows: int, seconds: float) -> None:
        """Feed the service-rate EMA behind the retry-after estimate."""
        per = seconds / max(rows, 1)
        self._row_s_ema = per if self._row_s_ema is None else \
            0.8 * self._row_s_ema + 0.2 * per

    def submit(self, payload, deadline: Optional[float] = None, *,
               tenant: Optional[str] = None,
               priority: int = 0) -> PendingRequest:
        """Enqueue one sample; raises :class:`ServerOverloaded` when the
        bounded queue is full, :class:`ServerClosed` after shutdown.
        ``deadline`` is absolute, on this batcher's clock; ``tenant`` tags
        the request for quotas and accounting."""
        expired: List[PendingRequest] = []
        victim: Optional[PendingRequest] = None
        with self._cond:
            if self._closed:
                raise ServerClosed("serve: server is shutting down")
            if len(self._q) >= self.queue_limit:
                expired = self._sweep_expired_locked(self.clock())
            if len(self._q) >= self.queue_limit:
                # newest of the lowest-priority queued requests: it has
                # waited least, so evicting it wastes the least work
                cand = min(reversed(self._q), key=lambda r: r.priority)
                if cand.priority < int(priority):
                    self._q.remove(cand)
                    victim = cand
                    self.shed_priority += 1
                    self._count_shed(cand.priority)
                else:
                    self.shed_overload += 1
                    self._count_shed(int(priority))
                    retry = self.retry_after_s()
                    raise ServerOverloaded(
                        f"serve: request queue full ({self.queue_limit} "
                        f"waiting, none below priority {int(priority)}); "
                        f"retry in {retry}s", retry_after_s=retry)
            req = PendingRequest(payload, self.clock(), deadline,
                                 tenant=tenant, priority=priority)
            self._q.append(req)
            self.submitted += 1
            self._cond.notify_all()
        now = self.clock()
        for r in expired:
            r._resolve(error=RequestTimeout(
                f"serve: deadline expired after {now - r.enqueued:.3f}s "
                "in queue (swept at admission)"), now=now)
        if victim is not None:
            retry = self.retry_after_s()
            victim._resolve(error=ServerOverloaded(
                f"serve: shed from a full queue for a priority-"
                f"{int(priority)} arrival (this request: priority "
                f"{victim.priority}); retry in {retry}s",
                retry_after_s=retry), now=now)
        return req

    def depth(self) -> int:
        """Requests queued now."""
        with self._cond:
            return len(self._q)

    # -- workers --------------------------------------------------------

    def collect(self) -> Optional[List[PendingRequest]]:
        """Block until a batch is ready, the coalesce window expires, or
        shutdown.  Returns up to ``max_batch`` live requests (possibly []
        when every dequeued one had expired), or None when the batcher is
        closed and, if draining, empty."""
        with self._cond:
            while not self._q:
                if self._closed:
                    return None
                self._cond.wait(self._SLICE)
            # from the oldest request's enqueue time, hold the flush up to
            # max_wait_s hoping to fill the batch
            flush_at = self._q[0].enqueued + self.max_wait_s
            while len(self._q) < self.max_batch and not self._closed:
                remaining = flush_at - self.clock()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, self._SLICE))
            reqs = [self._q.popleft()
                    for _ in range(min(len(self._q), self.max_batch))]
        return self._shed_expired(reqs)

    def _shed_expired(self, reqs, where: str = "") -> List[PendingRequest]:
        """Deadline shedding at dequeue: resolve every request of ``reqs``
        past its deadline with :class:`RequestTimeout` (it never reaches
        the device) and return the live ones."""
        now = self.clock()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                with self._cond:
                    self.shed_timeout += 1
                    self._count_shed(r.priority)
                r._resolve(error=RequestTimeout(
                    f"serve: deadline exceeded after "
                    f"{now - r.enqueued:.3f}s in queue{where}"), now=now)
            else:
                live.append(r)
        return live

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n is capped at max_batch by collect)."""
        return fit_bucket(n, self.buckets) or self.buckets[-1]

    def fail_pending(self, error: Optional[Exception] = None) -> int:
        """Resolve everything still queued with a typed error (default
        :class:`ServerClosed`); returns how many there were."""
        with self._cond:
            pending = [r for r in self._q if not r.done()]
            self._q.clear()
        now = self.clock()
        err = error if error is not None else ServerClosed(
            "serve: server stopped before this request ran")
        for r in pending:
            r._resolve(error=err, now=now)
        return len(pending)

    # -- shutdown -------------------------------------------------------

    def close(self, drain: bool = True) -> None:
        """Stop admissions.  drain=True lets workers finish the queue;
        drain=False fails everything still queued with ServerClosed."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if not drain:
            self.fail_pending()

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        with self._cond:
            return {"queue_depth": len(self._q),
                    "submitted": self.submitted,
                    "shed_overload": self.shed_overload,
                    "shed_timeout": self.shed_timeout,
                    "shed_priority": self.shed_priority,
                    "shed_by_priority": {str(k): v for k, v in
                                         sorted(self.shed_by_priority
                                                .items())}}


class DecodeQueue(DynamicBatcher):
    """Per-sequence admission queue of the decode engine
    (``serve/decode.py``), ported from ``bigdl_tpu/serve/batcher.py``.

    The bounded queue, deadlines and priority eviction of
    :class:`DynamicBatcher`, but a queued item is one sequence (a payload
    dict with its ``max_tokens`` budget) and the consumer is the engine's
    step loop:

    - :meth:`take` pops up to ``n`` live sequences without blocking or
      coalescing: the loop admits into whatever slots just freed and must
      never park while other slots are decoding.
    - :meth:`note_service` is fed (tokens, seconds), so the service-rate
      EMA learns seconds per token and :meth:`retry_after_s` scales with
      the queued token budget, not the request count.
    """

    def __init__(self, queue_limit: int, max_wait_s: float = 0.0,
                 clock=None):
        # slots and the cache-page ladder live in the engine
        super().__init__(max_batch=1, max_wait_s=max_wait_s,
                         queue_limit=queue_limit, buckets=(1,),
                         clock=clock)
        self._pending_tokens = 0  # queued generation budget (retry-after)

    @staticmethod
    def _budget(payload) -> int:
        return int(payload.get("max_tokens", 1)) \
            if isinstance(payload, dict) else 1

    def submit(self, payload, deadline: Optional[float] = None, *,
               tenant: Optional[str] = None,
               priority: int = 0) -> PendingRequest:
        req = super().submit(payload, deadline, tenant=tenant,
                             priority=priority)
        with self._cond:
            self._pending_tokens += self._budget(payload)
        return req

    def retry_after_s(self) -> float:
        """Back-off for a rejected sequence: EMA seconds per token times
        the queued token budget (8 sequences of 256 tokens are 2048 steps
        of work, not 8)."""
        per_tok = self._row_s_ema or 0.0
        return round(max(per_tok * max(self._pending_tokens, 1),
                         self.max_wait_s, 0.05), 3)

    def take(self, n: int) -> List[PendingRequest]:
        """Pop up to ``n`` live sequences, non-blocking; [] when the queue
        is empty.  A sequence whose deadline (time to last token) already
        passed is shed at dequeue with :class:`RequestTimeout` and never
        occupies a slot."""
        if n <= 0:
            return []
        with self._cond:
            reqs = [self._q.popleft()
                    for _ in range(min(len(self._q), n))]
            for r in reqs:
                self._pending_tokens = max(
                    0, self._pending_tokens - self._budget(r.payload))
        return self._shed_expired(reqs, " (decode admission)")

    def wait_for_work(self, timeout: float) -> bool:
        """Park the step loop until a sequence is queued, the queue closes
        or ``timeout`` passes.  True when there may be work."""
        with self._cond:
            if self._q or self._closed:
                return True
            self._cond.wait(timeout)
            return bool(self._q) or self._closed
