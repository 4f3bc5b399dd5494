"""horovod_tpu_torch.trace — the fleet tracer (counterpart of
`horovod_tpu/trace/`).

    python -m horovod_tpu_torch.trace merge   name.json name.rank1.json -o fleet.json
    python -m horovod_tpu_torch.trace analyze name.json name.rank1.json

The inputs are the per-rank timelines of a run with HOROVOD_TIMELINE,
HOROVOD_TIMELINE_ALL_RANKS=1 and HOROVOD_TIMELINE_MARK_CYCLES=1.  `core`
is pure stdlib; `measure.TraceMeasurements` feeds the analysis back
into the metrics catalog and the autotuner, and
`reaction.StragglerReactionPolicy` rebalances the gradient buckets away
from a rank blamed window after window.
"""

from .core import (  # noqa: F401
    analyze,
    analyze_serve,
    clock_offsets,
    cycle_arrivals,
    load_events,
    load_flightrec,
    load_rank_traces,
    merge,
    flightrec_to_trace,
    write_merged,
)
from .measure import TraceMeasurements  # noqa: F401
from .reaction import (  # noqa: F401
    ReactionDecision,
    StragglerReactionPolicy,
)

__all__ = ["analyze", "analyze_serve", "clock_offsets", "cycle_arrivals",
           "flightrec_to_trace", "load_events", "load_flightrec",
           "load_rank_traces", "merge", "write_merged",
           "TraceMeasurements", "ReactionDecision",
           "StragglerReactionPolicy"]
