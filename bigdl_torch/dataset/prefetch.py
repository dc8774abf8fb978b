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
  it is idempotent, and the context manager calls it.

The reference's supervisor heartbeat channel and telemetry spans are not
ported (they come with the port's supervisor and telemetry modules).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

from ..utils import config

logger = logging.getLogger("bigdl_torch")

__all__ = ["PrefetchIterator", "prefetch_depth"]

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
                 name: str = "bigdl-prefetch"):
        self._source = iter(source)
        self.depth = prefetch_depth() if depth is None else max(1, int(depth))
        self._transform = transform
        self._pre_fire = pre_fire
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    # -- worker ---------------------------------------------------------

    def _run(self) -> None:
        kind, payload = _DONE, None
        try:
            while not self._stop.is_set():
                if self._pre_fire is not None:
                    self._pre_fire()
                try:
                    item = next(self._source)
                except StopIteration:
                    break
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put((_ITEM, item)):
                    return  # closed while the queue was full
        except BaseException as e:  # noqa: BLE001 - forwarded to next()
            kind, payload = _ERR, e
        self._put((kind, payload))

    def _put(self, item) -> bool:
        """A bounded put that notices close() within 50 ms."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
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
        self._finished = True

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
