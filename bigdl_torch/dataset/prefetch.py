"""Asynchronous input pipeline: one worker thread ahead of the consumer.

Counterpart of ``bigdl_tpu/dataset/prefetch.py`` (``prefetch_depth``,
``PrefetchIterator``).  The training loop's only serial dependency on the
host is the transformer chain (record order, collation) and the copy of
each batch to the device; :class:`PrefetchIterator` moves both onto a
background worker feeding a bounded queue of ``BIGDL_TORCH_PREFETCH_DEPTH``
ready items (default 2), so the next batch is assembled and staged while
the current step runs.  The Optimizer hands it a ``transform`` that stages
each batch on the device (``optim/optimizer.py``).

Contracts kept from the reference, the reason for ONE worker and not a
pool:

- deterministic order: items come out exactly as the source yields them;
- an exception raised by the source, ``pre_fire`` or ``transform`` is
  captured at its item's position and re-raised at the consumer's
  ``next()``, after every item before it;
- clean shutdown: ``close()`` signals the worker, drains the queue (so a
  worker parked on a full queue wakes), joins it and closes the source;
  it is idempotent, and the context manager calls it;
- supervision: given a ``supervisor`` (``utils/supervisor.py``) the worker
  beats a channel of its own under ``phase`` (``"data"``) before each item
  and while it waits on a full queue, so only a worker stuck producing
  goes silent; the ``StallError`` the supervisor raises into the worker is
  forwarded to the consumer's ``next()`` like any other error.

:class:`ThreadedShardReader` (the reference's, ``:221-329``) is the Python
route of the native shard prefetcher (``utils/native.py``
``NativePrefetchReader``): N threads each stream whole shards into one
bounded queue, records interleaved across shards, each shard's in order.

Telemetry (``utils/telemetry.py``): the worker names its own thread track
and times each item's production (the source's ``next`` and the
transform, staging included) as a ``prefetch.item`` span there, apart from
the loop's ``data`` wait.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

from ..utils import config, telemetry

logger = logging.getLogger("bigdl_torch")

__all__ = ["PrefetchIterator", "ThreadedShardReader", "prefetch_depth"]

# queue item tags: (kind, payload)
_ITEM, _ERR, _DONE = 0, 1, 2


def prefetch_depth(default: int = 2) -> int:
    """The ``BIGDL_TORCH_PREFETCH_DEPTH`` knob, read when a pipeline is
    opened (once per epoch, so it can change between runs).  0 turns
    prefetching off: the synchronous path."""
    return max(0, config.get_int("PREFETCH_DEPTH", default))


class PrefetchIterator:
    """Bounded-depth background prefetcher over any iterator.

    One worker thread runs ``pre_fire()``, pulls ``next(source)`` and
    applies ``transform`` to each item, then parks the result in a queue
    of at most ``depth`` ready items.  ``queue_depth()`` says how many
    items were ready at call time."""

    def __init__(self, source, depth: Optional[int] = None,
                 transform: Optional[Callable] = None,
                 pre_fire: Optional[Callable[[], None]] = None,
                 supervisor=None, phase: str = "data",
                 name: str = "bigdl-prefetch"):
        self._source = iter(source)
        self.depth = prefetch_depth() if depth is None else max(1, int(depth))
        self._transform = transform
        self._pre_fire = pre_fire
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._finished = False
        self._phase = phase
        self._chan = (supervisor.channel(name, phase=phase)
                      if supervisor is not None else None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    # -- worker ---------------------------------------------------------

    def _beat(self) -> None:
        if self._chan is not None:
            self._chan.beat(self._phase)

    def _run(self) -> None:
        kind, payload = _DONE, None
        telemetry.thread_name(self._thread.name)
        try:
            while not self._stop.is_set():
                self._beat()
                if self._pre_fire is not None:
                    self._pre_fire()
                t0 = time.perf_counter()
                try:
                    item = next(self._source)
                except StopIteration:
                    break
                if self._transform is not None:
                    item = self._transform(item)
                telemetry.complete("prefetch.item", time.perf_counter() - t0)
                if not self._put((_ITEM, item)):
                    return  # closed while the queue was full
        except BaseException as e:  # noqa: BLE001 - forwarded to next(),
            # a StallError raised into this thread included
            kind, payload = _ERR, e
        try:
            self._put((kind, payload))
        finally:
            if self._chan is not None:
                self._chan.close()

    def _put(self, item) -> bool:
        """A bounded put that notices close() within 50 ms; a worker
        waiting on a full queue is paced by the consumer, so each wait
        slice beats the channel."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                self._beat()
        return False

    # -- consumer -------------------------------------------------------

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        while True:
            try:
                kind, payload = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    # the worker always parks a sentinel before it exits;
                    # dead with an empty queue means even that failed
                    self._finished = True
                    raise RuntimeError(
                        "prefetch worker exited without a result")
        if kind == _ITEM:
            return payload
        self._finished = True
        if kind == _ERR:
            raise payload
        raise StopIteration

    def queue_depth(self) -> int:
        """Ready items right now (approximate, like ``Queue.qsize``)."""
        return self._q.qsize()

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        """Stop the worker and join it, then close the source; safe to call
        repeatedly."""
        self._stop.set()
        # a worker blocked on put sees the stop within its 50 ms slice;
        # drain what is parked so close never waits on a full queue
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():  # pragma: no cover - wedged in C
            logger.warning("prefetch worker did not exit within 10 s")
        close = getattr(self._source, "close", None)
        if close is not None and not self._thread.is_alive():
            try:
                close()
            except Exception:  # noqa: BLE001 - finalization is best-effort
                logger.exception("prefetch source close failed")
        if self._chan is not None:
            self._chan.close()
        self._finished = True

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class ThreadedShardReader:
    """N Python threads each stream whole shards (``read_fn(path)`` ->
    a record iterator) into one bounded queue: the route of the native
    prefetcher where the library is absent.  Record order interleaves
    across shards, each shard's order is kept, and the first reader error
    is raised at the consumer after the records read before it."""

    def __init__(self, paths: Iterable[str], num_threads: int,
                 read_fn: Callable[[str], Iterator], capacity: int = 256):
        self._paths = list(paths)
        self._read_fn = read_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(2, capacity))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._next = 0
        self._finished = False
        self._errored = False
        n = max(1, min(int(num_threads), max(len(self._paths), 1)))
        self._active = n
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"bigdl-torch-shard-reader-{i}")
            for i in range(n)]
        for t in self._threads:
            t.start()

    def _take_path(self) -> Optional[str]:
        with self._lock:
            if self._next >= len(self._paths):
                return None
            p = self._paths[self._next]
            self._next += 1
            return p

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                path = self._take_path()
                if path is None:
                    break
                for rec in self._read_fn(path):
                    if not self._put((_ITEM, rec)):
                        return
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            # one rotten shard ends the pass: the error goes behind the
            # records already queued, then the other readers stop
            self._errored = True
            self._put((_ERR, e))
            self._stop.set()
            return
        finally:
            with self._lock:
                self._active -= 1
                last = self._active == 0
            if last and not self._errored:
                self._put((_DONE, None))

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> "ThreadedShardReader":
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        while True:
            try:
                kind, payload = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not any(t.is_alive() for t in self._threads):
                    self._finished = True
                    raise RuntimeError(
                        "shard reader threads exited without a result")
        if kind == _ITEM:
            return payload
        self._finished = True
        if kind == _ERR:
            raise payload
        raise StopIteration

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=10.0)
        self._finished = True

    def __enter__(self) -> "ThreadedShardReader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
