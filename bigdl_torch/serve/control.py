"""Serving control plane: per-tenant admission quotas.

Counterpart of the quota part of ``bigdl_tpu/serve/control.py``
(``QuotaExceeded`` and ``TenantQuotas``), through which the decode engine
(``serve/decode.py``) admits.  The replica monitor and the canary
controller of that module are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .batcher import ServerOverloaded

__all__ = ["QuotaExceeded", "TenantQuotas"]


class QuotaExceeded(ServerOverloaded):
    """A tenant exceeded its token-bucket admission quota.  A kind of
    :class:`ServerOverloaded`; ``retry_after_s`` says when the bucket next
    has a token."""


class TenantQuotas:
    """Per-tenant token-bucket admission quotas.

    Each tenant owns a bucket refilled at ``qps`` tokens a second up to
    ``burst`` (default ``max(2 * qps, 1)``); one admission takes one token.
    An empty bucket raises :class:`QuotaExceeded` with ``retry_after_s`` =
    seconds until the next token, so one chatty tenant exhausts its own
    quota instead of the shared queue.  ``qps <= 0`` admits everything.
    Clock-injectable."""

    def __init__(self, qps: float, burst: Optional[float] = None,
                 clock=None):
        self.qps = float(qps)
        self.burst = float(burst) if burst and float(burst) > 0 \
            else max(2.0 * self.qps, 1.0)
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._buckets: Dict[str, tuple] = {}  # tenant -> (tokens, stamp)
        self.denied = 0
        self.denied_by_tenant: Dict[str, int] = {}

    def admit(self, tenant: Optional[str]) -> None:
        """Take one token from ``tenant``'s bucket (created full on first
        sight); raise :class:`QuotaExceeded` when it is empty."""
        if self.qps <= 0:
            return
        key = tenant or "default"
        now = self.clock()
        with self._lock:
            tokens, stamp = self._buckets.get(key, (self.burst, now))
            tokens = min(self.burst, tokens + (now - stamp) * self.qps)
            if tokens >= 1.0:
                self._buckets[key] = (tokens - 1.0, now)
                return
            self._buckets[key] = (tokens, now)
            self.denied += 1
            self.denied_by_tenant[key] = \
                self.denied_by_tenant.get(key, 0) + 1
            retry = (1.0 - tokens) / self.qps
        raise QuotaExceeded(
            f"serve: tenant {key!r} over quota ({self.qps:g} req/s, "
            f"burst {self.burst:g}); retry in {retry:.3f}s",
            retry_after_s=retry)

    def stats(self) -> dict:
        with self._lock:
            return {"qps": self.qps, "burst": self.burst,
                    "denied": self.denied,
                    "denied_by_tenant": dict(self.denied_by_tenant)}
