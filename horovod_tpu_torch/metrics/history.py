"""Sliding-window quantiles for the serving SLO controller.

Counterpart of `quantile` and `SortedWindow` in
`horovod_tpu/metrics/history.py` (copied); the history rings
(`MetricsHistory`) wait for the port of the rest of `metrics/`.
`SortedWindow` is the incremental sliding-window quantile behind
`serve/slo.py`: one bisect per insert instead of a full re-sort per
query, numerically identical to `np.percentile`.
"""

from __future__ import annotations

import bisect
import math
from collections import deque
from typing import List, Sequence

__all__ = ["SortedWindow", "quantile"]


def quantile(sorted_vals: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) of an ascending sequence, linear
    interpolation between closest ranks — bitwise-compatible with
    `np.percentile(..., q)` so the SLO controller's ring-backed p99
    pins the exact values its deque+re-sort predecessor produced."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("quantile of empty sequence")
    if n == 1:
        return float(sorted_vals[0])
    pos = (n - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo]) + (
        float(sorted_vals[hi]) - float(sorted_vals[lo])) * frac


class SortedWindow:
    """Sliding window that stays sorted incrementally.

    `append` is one deque push plus two bisects (insert the new value,
    remove the evicted one) — O(log n + n) worst case on the list
    shift, but with no full re-sort and no numpy round trip per query,
    which is what `SloController.p99_ms()` paid on every step."""

    __slots__ = ("_fifo", "_sorted")

    def __init__(self, maxlen: int):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self._fifo: deque = deque(maxlen=maxlen)
        self._sorted: List[float] = []

    def append(self, value: float) -> None:
        value = float(value)
        if len(self._fifo) == self._fifo.maxlen:
            evicted = self._fifo[0]
            del self._sorted[bisect.bisect_left(self._sorted, evicted)]
        self._fifo.append(value)
        bisect.insort(self._sorted, value)

    def quantile(self, q: float) -> float:
        if not self._sorted:
            return 0.0
        return quantile(self._sorted, q)

    def __len__(self) -> int:
        return len(self._fifo)

    def __iter__(self):
        return iter(self._fifo)
