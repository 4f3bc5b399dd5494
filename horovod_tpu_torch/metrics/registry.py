"""Metric primitives and the process-wide registry (counterpart of
`horovod_tpu/metrics/registry.py`, copied: pure Python).

Hot-path cost is O(1): a child lookup is one dict get keyed by the
label-value tuple, and an update holds a tiny per-child lock for one
add.  Histograms use fixed log-scale buckets, so percentiles come from
the bucket counts alone.  Metric creation takes the registry lock,
updates never do.  Names follow the Prometheus conventions of the JAX
package (`hvd_*_total` counters, `_seconds` histograms); exposition.py
renders them in the Prometheus text format and fleet.py merges the
ranks' snapshots.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "default_latency_buckets",
]


def default_latency_buckets() -> List[float]:
    """Fixed log2-scale latency bounds: 1us .. ~67s, factor 4 per bucket.

    Ten buckets span seven decades, which brackets everything from a
    cache-hit eager dispatch (~100us) to a stalled collective, while the
    whole histogram stays 12 floats of state."""
    return [4.0 ** k * 1e-6 for k in range(14)]  # 1e-6 .. ~67.1s


class _Child:
    """One labeled time series.  Base for counter/gauge children."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def get(self) -> float:
        return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]):
        self._lock = threading.Lock()
        self._bounds = list(bounds)
        # one count per bound + the +Inf overflow bucket
        self._counts = [0] * (len(self._bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    # -- read side (exposition / snapshots; not the hot path) -----------
    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs ending with +Inf."""
        out, total = [], 0
        with self._lock:
            counts = list(self._counts)
            for b, c in zip(self._bounds, counts):
                total += c
                out.append((b, total))
            out.append((float("inf"), total + counts[-1]))
        return out

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count


class _Metric:
    """A named metric family: label names + child table."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kwvalues):
        """Child for one label-value combination (created on first use).

        Steady state is a single dict lookup: children are interned by
        their value tuple, so hot paths should hold on to the returned
        child when the labels are loop-invariant."""
        if not kwvalues:
            # Fast path: interned keys are str tuples, so a caller
            # passing strings (the instrumented hot paths all do) hits
            # with zero normalization; anything else falls through.
            child = self._children.get(values)
            if child is not None:
                return child
        if kwvalues:
            if values:
                raise ValueError("pass labels positionally OR by name")
            values = tuple(str(kwvalues[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    values, self._make_child())
        return child

    def samples(self):
        """[(label_values, child)] — read side only."""
        return list(self._children.items())

    # Unlabeled convenience: metric with no labels acts as its own child.
    def _solo(self):
        return self.labels()


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._solo().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames)
        self.buckets = (list(buckets) if buckets is not None
                        else default_latency_buckets())

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._solo().observe(value)


class MetricsRegistry:
    """Process-wide metric table (reference analog: the global
    HorovodGlobalState's timeline/parameter tables, but numeric)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self.created_at = time.time()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name} re-registered with a different "
                f"type/labels ({m.kind}{m.labelnames})")
        return m

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric (tests + elastic re-init)."""
        with self._lock:
            self._metrics.clear()


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry
