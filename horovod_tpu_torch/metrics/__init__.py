"""Numeric telemetry (counterpart of `horovod_tpu/metrics/`): the
registry of counters, gauges and histograms, the catalog of every
`hvd_*` series, SLO error budgets and the sliding-window quantile.  The
Prometheus endpoint, the fleet view, the history rings and the anomaly
monitor are not ported yet.
"""

from . import catalog  # noqa: F401  (declares every hvd_* series)
from .budget import SloBudget  # noqa: F401
from .history import SortedWindow, quantile  # noqa: F401
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
