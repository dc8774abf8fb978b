"""Misc utilities: ``kth_largest``.

Counterpart of ``bigdl_tpu/utils/util.py`` (reference ``utils/Util.scala``).
"""

from __future__ import annotations

import random
from typing import List, Sequence

__all__ = ["kth_largest"]


def kth_largest(values: Sequence[float], k: int) -> float:
    """The k-th largest element (1-based k) by quickselect (reference
    ``utils/Util.scala:20`` ``kthLargest``, the straggler threshold of
    ``DistriOptimizer.scala:302-330``).  The pivots are random; the answer
    is not."""
    if not 1 <= k <= len(values):
        raise ValueError(f"k={k} out of range for {len(values)} values")
    vals: List[float] = list(values)
    target = k - 1  # index in descending order
    lo, hi = 0, len(vals) - 1
    while True:
        if lo == hi:
            return vals[lo]
        pivot = vals[random.randint(lo, hi)]
        i, j = lo, hi
        while i <= j:
            while vals[i] > pivot:
                i += 1
            while vals[j] < pivot:
                j -= 1
            if i <= j:
                vals[i], vals[j] = vals[j], vals[i]
                i += 1
                j -= 1
        if target <= j:
            hi = j
        elif target >= i:
            lo = i
        else:
            return vals[target]
