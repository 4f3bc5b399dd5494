"""The metric catalog: every `hvd_*` series of the JAX package, declared
in the port's registry (counterpart of `horovod_tpu/metrics/catalog.py`,
copied whole).

The port writes the series of what it has ported (the collectives, the
step hooks, the optimizers, serving, the fault points, the stall
inspector, the anomaly monitor and the fleet tracer); the others are
declared so that names and help text stay one list with the JAX
package's.  `enabled()` gates every write (HOROVOD_METRICS_DISABLE=1
turns them off).
"""

from __future__ import annotations

from ..common import util
from .registry import get_registry

_REG = get_registry()

# Labels shared by the per-collective series.  `process_set` is the set
# id (0 = global), matching the reference's per-process-set controllers.
COLLECTIVE_LABELS = ("kind", "dtype", "process_set")

# -- ops hot path (ops/collectives.py `_traced` / `_cached_program`) --------
collective_calls = _REG.counter(
    "hvd_collective_calls_total",
    "Eager collective dispatches, by collective kind/dtype/process set.",
    COLLECTIVE_LABELS)
collective_bytes = _REG.counter(
    "hvd_collective_bytes_total",
    "Global payload bytes entering eager collectives (the staged "
    "global-mesh array, all ranks' shards).",
    COLLECTIVE_LABELS)
collective_latency = _REG.histogram(
    "hvd_collective_latency_seconds",
    "Host-side eager dispatch latency (bracket enter to exit; device "
    "completion belongs to jax.profiler), log4 buckets 1us..67s.",
    COLLECTIVE_LABELS)
compile_cache_hits = _REG.counter(
    "hvd_compile_cache_hits_total",
    "Eager collective program-cache hits (reference: response cache).",
    ("kind",))
compile_cache_misses = _REG.counter(
    "hvd_compile_cache_misses_total",
    "Eager collective program-cache misses (trace+compile on this call).",
    ("kind",))

# -- training step layer (parallel/data_parallel.py, parallel/optimizer.py) -
steps = _REG.counter(
    "hvd_steps_total",
    "Compiled data-parallel step invocations (hvd.data_parallel).")
grad_bytes_reduced = _REG.counter(
    "hvd_grad_bytes_reduced_total",
    "Gradient bytes cross-rank reduced on the eager path "
    "(allreduce_gradients outside jit).")
grad_bytes_per_step = _REG.gauge(
    "hvd_grad_bytes_per_step",
    "Static gradient bytes per compiled step (recorded at trace time; "
    "multiply by hvd_steps_total for in-jit traffic).")
buckets_per_step = _REG.gauge(
    "hvd_buckets_per_step",
    "Gradient fusion buckets per reduction (one collective issues per "
    "bucket; recorded at trace time for compiled steps).")
bucket_bytes = _REG.gauge(
    "hvd_bucket_bytes",
    "Mean raw gradient payload bytes per fusion bucket (recorded "
    "alongside hvd_buckets_per_step).")
optimizer_syncs = _REG.counter(
    "hvd_optimizer_syncs_total",
    "DistributedOptimizer cross-rank gradient syncs executed eagerly.")
opt_state_bytes = _REG.gauge(
    "hvd_opt_state_bytes",
    "Per-chip resident inner optimizer-state bytes (recorded at init; "
    "sharded states count their 1/N shard — the ZeRO-1 denominator).")
wire_bytes_saved = _REG.counter(
    "hvd_wire_bytes_saved",
    "Gradient bytes the per-bucket wire policy kept off the wire on "
    "eager reductions (raw bytes minus block-scaled wire bytes, "
    "HOROVOD_WIRE_POLICY; see docs/WIRE.md).")
wire_bytes_saved_per_step = _REG.gauge(
    "hvd_wire_bytes_saved_per_step",
    "Static gradient bytes per compiled step the per-bucket wire policy "
    "keeps off the wire (recorded at trace time; multiply by "
    "hvd_steps_total for in-jit savings).")
wire_format_bytes = _REG.gauge(
    "hvd_wire_format_bytes",
    "Static wire bytes shipped per compiled step by wire format "
    "(payload plus block scales, recorded at trace time alongside "
    "hvd_wire_bytes_saved_per_step).",
    ("format",))
rs_bytes = _REG.gauge(
    "hvd_rs_bytes",
    "Static bytes entering the sharded-optimizer gradient reduce-"
    "scatter per step, at wire width (trace time; multiply by "
    "hvd_steps_total).")
param_ag_bytes = _REG.gauge(
    "hvd_param_ag_bytes",
    "Static bytes entering the sharded-optimizer param allgather per "
    "step, at wire width (trace time; multiply by hvd_steps_total).")
grad_shard_bytes = _REG.gauge(
    "hvd_grad_shard_bytes",
    "Per-chip resident gradient-accumulator bytes across the "
    "backward_passes_per_step window (recorded at init; ZeRO-2 counts "
    "its 1/N shard — the stage-2 denominator).")
param_resident_bytes = _REG.gauge(
    "hvd_param_resident_bytes",
    "Per-chip resident parameter bytes outside the live bucket window "
    "under ZeRO-3 (zero3_placement; recorded at trace time — the full "
    "replicated bytes are the numerator, see docs/SHARDED_OPTIMIZER.md).")
fused_steps = _REG.counter(
    "hvd_fused_steps",
    "Compiled steps executed with the fused computation-collective "
    "pipeline armed (HOROVOD_FUSED_COLLECTIVES=1; see "
    "docs/FUSED_COLLECTIVES.md).")
fused_chunk_bytes = _REG.gauge(
    "hvd_fused_chunk_bytes",
    "Live chunk size of the fused pipeline's software-pipelined "
    "collectives (trace time; the fused_chunk_bytes autotuner knob).")

# -- observability / control plane ------------------------------------------
stall_warnings = _REG.counter(
    "hvd_stall_warnings_total",
    "Stall-inspector warnings issued (collectives past the warn "
    "threshold).")
stall_aborts = _REG.counter(
    "hvd_stall_aborts_total",
    "Stall-inspector aborts triggered (shutdown threshold exceeded).")
stall_laggards = _REG.gauge(
    "hvd_stall_laggards",
    "Ranks behind the fleet at the most recent stall warning (0 when "
    "the last warning named no laggard).")

# -- fleet tracer (horovod_tpu/trace, docs/TRACE.md) -------------------------
critical_path_ms = _REG.gauge(
    "hvd_critical_path_ms",
    "Host-side wall time of the last dispatched step (ms); overwritten "
    "with the cross-rank per-step critical path when trace analysis "
    "runs (TraceMeasurements.apply_to_metrics).")
step_skew_ms = _REG.gauge(
    "hvd_step_skew_ms",
    "Cross-rank arrival skew at the per-step barrier from the last "
    "trace analysis (ms; max minus min CYCLE_n arrival).")
straggler_rank = _REG.gauge(
    "hvd_straggler_rank",
    "Rank most often last to arrive at the step barrier in the last "
    "trace analysis (-1 = none identified).")
straggler_streak = _REG.gauge(
    "hvd_straggler_streak",
    "Consecutive analysis windows the current straggler has been "
    "blamed (trace/reaction.py; resets on a different blame, a "
    "reaction, or a generation change).")
straggler_reactions = _REG.counter(
    "hvd_straggler_reactions_total",
    "Straggler reactions fired by the trace reaction policy.",
    ("action",))
reaction_max_buckets = _REG.gauge(
    "hvd_reaction_max_buckets",
    "Bucket-count cap armed by the straggler rebalance (0 = no "
    "override active).")

# -- chaos soak (faults/chaos.py, docs/CHAOS.md) -----------------------------
chaos_events = _REG.counter(
    "hvd_chaos_events_total",
    "Injected chaos-soak events by kind and terminal outcome "
    "(recovered / degraded / skipped).", ("kind", "outcome"))
recovery_ms = _REG.gauge(
    "hvd_recovery_ms",
    "Measured MTTR of the most recent chaos-soak event of each kind: "
    "injection to digest-verified recovery (ms).", ("kind",))
chaos_generations = _REG.gauge(
    "hvd_chaos_generations",
    "Analysis-window generations the running chaos soak has completed "
    "(digest-verified and split-brain-checked).")

# -- elastic driver (runner/elastic/driver.py) ------------------------------
elastic_rank_added = _REG.counter(
    "hvd_elastic_rank_added_total",
    "Worker slots added across elastic generation transitions.")
elastic_rank_removed = _REG.counter(
    "hvd_elastic_rank_removed_total",
    "Worker slots removed (failure/scale-down) across generations.")
elastic_restarts = _REG.counter(
    "hvd_elastic_restarts_total",
    "Elastic generation resets (driver reset_count increments).")
elastic_slots = _REG.gauge(
    "hvd_elastic_slots",
    "Worker slots in the currently-published generation (driver-side; "
    "below the requested np = degraded mode).")

# -- fault tolerance (faults/, runner/elastic/driver.py, checkpoint) --------
fault_injections = _REG.counter(
    "hvd_fault_injections_total",
    "Faults injected by the HOROVOD_FAULT_SPEC schedule, by point/mode.",
    ("point", "mode"))
retries = _REG.counter(
    "hvd_retries_total",
    "RetryPolicy retries (sleep-then-reattempt events), by call site.",
    ("site",))
worker_lease_expired = _REG.counter(
    "hvd_worker_lease_expired_total",
    "Workers declared failed because their heartbeat lease expired "
    "while the process was still alive (driver-side).")
worker_respawns = _REG.counter(
    "hvd_worker_respawns_total",
    "Worker processes respawned after a failure (driver-side).")
hosts_blacklisted = _REG.counter(
    "hvd_hosts_blacklisted_total",
    "Hosts blacklisted (failure strikes or respawn budget exhausted).")
checkpoint_rollbacks = _REG.counter(
    "hvd_checkpoint_rollbacks_total",
    "Corrupt durable checkpoints skipped during restore (rolled back "
    "to an older good step).")

# -- training-health guardian (guard/, parallel/optimizer.py) ---------------
nonfinite_steps = _REG.counter(
    "hvd_nonfinite_steps_total",
    "Training steps whose cross-rank non-finite sentinel flagged (the "
    "optimizer apply was skipped in lockstep on every rank).")
loss_scale = _REG.gauge(
    "hvd_loss_scale",
    "Current dynamic loss scale (halved on flagged steps, grown after "
    "loss_scale_growth_interval clean applies; see docs/GUARD.md).")
guard_rollbacks = _REG.counter(
    "hvd_guard_rollbacks_total",
    "Guard escalations: restores of the last digest-verified checkpoint "
    "after K consecutive non-finite steps or a digest mismatch.")
digest_mismatch = _REG.counter(
    "hvd_digest_mismatch_total",
    "Cross-replica parameter-digest mismatches detected (silent replica "
    "divergence, attributed to a bucket).")

# -- serving (horovod_tpu/serve, docs/SERVING.md) ---------------------------
serve_queue_depth = _REG.gauge(
    "hvd_serve_queue_depth",
    "Requests waiting for a batch row / KV pages (admission "
    "back-pressure; sampled each server step).")
serve_batch_occupancy = _REG.gauge(
    "hvd_serve_batch_occupancy",
    "Active rows / max_batch of the compiled serving decode step "
    "(continuous batching keeps this near 1 under load).")
serve_pool_pages_free = _REG.gauge(
    "hvd_serve_pool_pages_free",
    "Free pages in the paged KV-cache pool (0 = admissions stall until "
    "an eviction returns pages).")
serve_p99_ms = _REG.gauge(
    "hvd_serve_p99_ms",
    "Observed p99 per-token decode latency over the SLO controller's "
    "sliding window (the signal that toggles speculative decoding "
    "against HOROVOD_SERVE_SLO_MS).")
serve_ttft = _REG.histogram(
    "hvd_serve_ttft_seconds",
    "Time to first token: request submit to its first emitted token "
    "(queue wait + prefill + the first decode dispatch), log4 buckets "
    "1us..67s.")
serve_intertoken = _REG.histogram(
    "hvd_serve_intertoken_seconds",
    "Inter-token latency: server step wall time divided by tokens "
    "decided that step (speculative rounds amortize over accepted "
    "drafts), observed once per decode step.")
serve_queue_delay = _REG.histogram(
    "hvd_serve_queue_delay_seconds",
    "Admission queue delay: request submit to batch-row admission "
    "(back-pressure from rows or KV pages).")
serve_e2e_latency = _REG.histogram(
    "hvd_serve_e2e_latency_seconds",
    "End-to-end request latency: submit to completion/eviction "
    "(= queue delay + prefill + decode).")

# -- autoscaling (horovod_tpu/serve/autoscale.py, docs/AUTOSCALE.md) --------
autoscale_fleet_size = _REG.gauge(
    "hvd_autoscale_fleet_size",
    "Live decode replicas under autoscale control (after the last "
    "scale event's convergence; borrowed training chips count while "
    "on loan).")
autoscale_events = _REG.counter(
    "hvd_autoscale_events_total",
    "Scale events by verdict (grow/shrink/borrow/handback/shed; an "
    "event that hits a mid-actuation fault also counts under "
    "'aborted').",
    ("verdict",))
autoscale_shed = _REG.counter(
    "hvd_autoscale_shed_total",
    "Requests dropped by priority load-shedding — the degrade rung "
    "below shrink: lowest tenant SLO class first, newest first, "
    "queued only (admitted work always finishes).")

# -- telemetry plane (metrics/{budget,anomaly}.py, docs/TELEMETRY.md) -------
slo_budget_remaining = _REG.gauge(
    "hvd_slo_budget_remaining",
    "Fraction of the SLO error-budget window's failure allowance left "
    "(1 = untouched, 0 = exhausted, negative = overdrawn), per named "
    "budget (serve_latency, train_step).",
    ("slo",))
slo_burn_rate = _REG.gauge(
    "hvd_slo_burn_rate",
    "Error-budget burn rate over the fast/slow alert windows (1.0 "
    "exactly exhausts the budget over its window; a breach needs both "
    "windows over threshold — Google-SRE multi-window alerting).",
    ("slo", "window"))
anomaly_events = _REG.counter(
    "hvd_anomaly_events_total",
    "Anomaly-detector trips by offending series and detector kind "
    "(ewma_z spike / counter_stall; see docs/TELEMETRY.md).",
    ("series", "kind"))
anomaly_active = _REG.gauge(
    "hvd_anomaly_active",
    "Series currently held anomalous by the monitor (trips that have "
    "not yet cleared back inside the detector envelope).")

# -- live resharding (horovod_tpu/parallel/reshard.py, docs/RESHARD.md) -----
reshard_bytes = _REG.gauge(
    "hvd_reshard_bytes",
    "Payload bytes this host published + fetched during the last "
    "reshard (elastic shrink/grow, train-to-serve handoff, or "
    "cross-mesh checkpoint load).")
reshard_peak_bytes = _REG.gauge(
    "hvd_reshard_peak_bytes",
    "Measured peak of transiently staged reshard bytes on this host — "
    "asserted, not eyeballed, against the HOROVOD_RESHARD_PEAK_BYTES "
    "ceiling (a reshard that would exceed it fails into the restore "
    "fallback instead).")
reshard_ms = _REG.gauge(
    "hvd_reshard_ms",
    "Wall time of the last reshard on this host, publish through "
    "verdict (compare against the checkpoint restore it replaced; "
    "bench.py's reshard extra records both).")

_enabled = not util.env_bool("METRICS_DISABLE", False)


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Test/embedding hook; HOROVOD_METRICS_DISABLE=1 sets the default."""
    global _enabled
    _enabled = bool(value)
