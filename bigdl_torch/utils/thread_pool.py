"""ThreadPool: the host-side worker pool.

Counterpart of ``bigdl_tpu/utils/thread_pool.py``.

Reference: utils/ThreadPool.scala:32 — wraps an ExecutionContext with
`invoke` (async), `invokeAndWait` (:92), `invokeAndWait2` (java futures +
timeout, :106), `sync` (:176), and `setMKLThread` (:73).  BigDL used it as
`Engine.default` (framework tasks) and `Engine.model` (intra-layer work).

Intra-layer work belongs to the device; the pool serves the HOST
side — data decoding, batch assembly (MTSampleToMiniBatch), checkpoint IO.
`set_native_threads` plays setMKLThread's role for the host kernels of
``csrc/host/hostops.cc``."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, TimeoutError, wait
from typing import Callable, List, Optional, Sequence

__all__ = ["ThreadPool"]


class ThreadPool:
    def __init__(self, max_threads: int):
        self.max_threads = max_threads
        self._pool = ThreadPoolExecutor(max_workers=max_threads)

    def invoke(self, tasks: Sequence[Callable]) -> List:
        """Submit without waiting (ThreadPool.invoke :142) -> futures."""
        return [self._pool.submit(t) for t in tasks]

    def invoke_and_wait(self, tasks: Sequence[Callable],
                        timeout: Optional[float] = None) -> List:
        """Run all, return results in order (invokeAndWait :92 /
        invokeAndWait2 :106 with timeout)."""
        futures = self.invoke(tasks)
        done, not_done = wait(futures, timeout=timeout)
        if not_done:
            for f in not_done:
                f.cancel()
            raise TimeoutError(f"{len(not_done)} tasks timed out")
        return [f.result() for f in futures]

    def sync(self, futures) -> List:
        """Block on previously-invoked futures (ThreadPool.sync :176)."""
        return [f.result() for f in futures]

    def set_native_threads(self, n: int) -> "ThreadPool":
        """(reference: setMKLThread :73 — pins the native math threads)."""
        from . import native
        native.set_num_threads(n)
        return self

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
