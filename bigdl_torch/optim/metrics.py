"""Metrics: named timing counters of the driver loop.

Counterpart of ``bigdl_tpu/optim/metrics.py`` (reference
``optim/Metrics.scala:31``): host-side sums and counts by name, which the
Optimizer fills with ``"get batch time average"`` (seconds the loop waited
for its next batch) and ``"computing time average"`` (seconds from taking
the batch to the host reading the step's loss).
"""

from __future__ import annotations

from collections import defaultdict

__all__ = ["Metrics"]


class Metrics:
    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def add(self, name: str, value: float):
        self._sums[name] += value
        self._counts[name] += 1

    def get(self, name: str):
        """(total, count) of the counter ``name``."""
        return self._sums[name], self._counts[name]
