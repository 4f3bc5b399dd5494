"""Cluster-wide numeric telemetry (counterpart of `horovod_tpu/metrics/`).

A lock-cheap registry of counters, gauges and histograms, the catalog
of every `hvd_*` series (the collectives, the step hooks, the
optimizers, serving, the fault points and the fleet tracer write
theirs), a per-worker Prometheus endpoint with `/healthz`
(HOROVOD_METRICS_PORT), and a fleet view merged from the snapshots each
rank publishes on the process group's store.

Quick start::

    HOROVOD_METRICS_PORT=9090 <launch> python train.py
    curl :9090/metrics                                  # per-worker scrape
    python -m horovod_tpu_torch.metrics --scrape h:9090 # merged view
    python -m horovod_tpu_torch.metrics top --scrape h:9090

The telemetry plane on top of the registry: history.py keeps bounded
in-process rings of every series (HOROVOD_METRICS_HISTORY_INTERVAL),
budget.py tracks SLO error budgets with multi-window burn rates,
anomaly.py trips EWMA z-score and counter-stall detectors, and top.py
renders the live console.
"""

from . import catalog  # noqa: F401  (declares every hvd_* series)
from .anomaly import (  # noqa: F401
    Anomaly,
    AnomalyMonitor,
    CounterStallDetector,
    EwmaDetector,
)
from .budget import SloBudget  # noqa: F401
from .exposition import (  # noqa: F401
    render,
    start_server,
    stop_server,
    server_port,
)
from .fleet import (  # noqa: F401
    aggregate,
    publish,
    read_fleet,
    render_fleet,
    snapshot,
)
from .history import (  # noqa: F401
    MetricsHistory,
    Ring,
    SortedWindow,
    get_history,
    quantile,
    start_history,
    stop_history,
)
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
