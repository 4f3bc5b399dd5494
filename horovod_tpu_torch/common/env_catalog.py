"""Catalog of every `HOROVOD_*` environment variable the port reads.

The port's own copy of the entries of `horovod_tpu/common/env_catalog.py`
for the variables it reads, with what each does here.  Reads go through
`common/util.py` (`getenv`, `env_bool`, `env_int`), which also accepts
the `HVD_TPU_` prefix; the catalog lists the canonical name.
tests/test_torch_port_surface.py checks that the variables the port's
sources read and this catalog name the same set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

PREFIXES = ("HOROVOD_", "HVD_TPU_")


@dataclass(frozen=True)
class EnvVar:
    name: str
    default: str      # human-readable default ("" = unset)
    component: str    # grouping key
    description: str


def _v(name, default, component, description):
    return EnvVar(name, default, component, description)


CATALOG: Tuple[EnvVar, ...] = (
    # -- topology: the launcher's contract, read by basics.init ------------
    _v("HOROVOD_COORDINATOR_ADDR", "", "topology",
       "host:port of rank 0's store, or a full tcp:// or file:// init "
       "URL; its presence makes init() join a process group."),
    _v("HOROVOD_NUM_PROCESSES", "1", "topology",
       "World size of the process group."),
    _v("HOROVOD_PROCESS_ID", "0", "topology",
       "This process's rank in the process group."),
    _v("HOROVOD_LOCAL_RANK", "rank", "topology",
       "Rank among the processes on this host; picks the card "
       "(local_rank mod the card count)."),
    _v("HOROVOD_LOCAL_SIZE", "size", "topology",
       "Processes on this host; more than the cards selects gloo."),
    _v("HOROVOD_CROSS_RANK", "rank // local_size", "topology",
       "Index of this process's host among the hosts."),
    _v("HOROVOD_CROSS_SIZE", "size // local_size", "topology",
       "Number of hosts."),
    _v("HOROVOD_RANK", "0", "topology",
       "Global rank of this process; set by the launcher for every "
       "worker (reference: gloo_run's env contract); `run()`'s and the "
       "Executor's workers key their results by it."),
    _v("HOROVOD_SLOT", "(unset)", "topology",
       "Slot index of this worker; names its heartbeat key."),
    _v("HOROVOD_ELASTIC_GEN", "0", "elastic",
       "Elastic generation; scopes the join and consistency-check keys."),
    _v("HOROVOD_ELASTIC_JOINING", "0", "elastic",
       "1 for a worker joining an already-running generation "
       "(`elastic_worker.is_joining_worker`)."),
    _v("HOROVOD_ELASTIC_LEASE_TTL", "15.0", "elastic",
       "Seconds a worker heartbeat lease lives; /healthz answers 503 "
       "once the last beat is older."),
    _v("HOROVOD_HEARTBEAT_INTERVAL", "lease_ttl/3 (min 0.5)", "elastic",
       "Seconds between worker heartbeat-lease publishes; defaults to a "
       "third of HOROVOD_ELASTIC_LEASE_TTL."),
    _v("HOROVOD_ELASTIC", "0", "elastic",
       "1 in a worker the elastic driver spawned: hvd.init() registers "
       "with the driver first, and hvd.elastic.run watches the "
       "generation and beats the heartbeat lease."),
    _v("HOROVOD_ELASTIC_START_GRACE", "60.0", "elastic",
       "Seconds after a spawn before the elastic driver fails a worker "
       "that has never beaten its heartbeat (--lease-start-grace)."),
    _v("HOROVOD_MAX_RESPAWNS_PER_HOST", "3", "elastic",
       "Respawns the elastic driver allows a host before it blacklists "
       "the host outright (--max-respawns)."),
    _v("HOROVOD_BLACKLIST_THRESHOLD", "1", "elastic",
       "Failure strikes before a host is blacklisted from respawn."),
    _v("HOROVOD_RESPAWN_BACKOFF_BASE", "1.0", "elastic",
       "Base seconds of the exponential respawn backoff per host."),
    _v("HOROVOD_RESPAWN_BACKOFF_MAX", "30.0", "elastic",
       "Cap in seconds of the exponential respawn backoff."),
    _v("HOROVOD_COORDINATOR_BASE_PORT", "(derived)", "topology",
       "Base port the elastic driver advances from, a generation at a "
       "time, for a remote rank 0's TCPStore (default: 46327 plus a "
       "hash of the job's secret)."),
    # -- the rendezvous KV: the launcher's control plane --------------------
    _v("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1", "rendezvous",
       "Address of the launcher's rendezvous/KV server workers connect "
       "back to; set, it also routes the metrics fleet there."),
    _v("HOROVOD_RENDEZVOUS_PORT", "(assigned)", "rendezvous",
       "Port of the rendezvous/KV server."),
    _v("HOROVOD_SECRET_KEY", "(generated)", "rendezvous",
       "Shared HMAC secret authenticating every rendezvous/KV request."),
    _v("HOROVOD_COLLECTIVE_CONSISTENCY_CHECK", "0", "ops",
       "1 holds every outermost eager collective's signature (kind, "
       "shapes, dtypes, op) to every rank's of its process set over the "
       "rendezvous KV before it runs (utils/consistency.py)."),
    _v("HOROVOD_CONSISTENCY_TIMEOUT", "30.0", "ops",
       "Seconds the consistency check waits for peers' collective "
       "signatures before declaring them divergent/stalled (read per "
       "check)."),
    # -- the data-parallel optimizer and the ZeRO ladder --------------------
    _v("HOROVOD_FUSION_THRESHOLD", "67108864", "autotune",
       "Gradient-fusion bucket size in bytes; also sets the ZeRO shard "
       "groups."),
    _v("HOROVOD_BUCKET_ORDER", "reverse", "autotune",
       "Gradient bucketing order: reverse, forward, or a comma "
       "permutation."),
    _v("HOROVOD_MIN_BUCKETS", "1", "autotune",
       "Lower bound on gradient buckets per step."),
    _v("HOROVOD_SHARD_OPTIMIZER", "0", "ops",
       "1: ZeRO-1 (the older name of HOROVOD_ZERO_STAGE=1)."),
    _v("HOROVOD_ZERO_STAGE", "0 (1 if HOROVOD_SHARD_OPTIMIZER)", "ops",
       "ZeRO rung 0..3: 1 shards the optimizer state, 2 adds sharded "
       "gradient accumulation, 3 adds parameter sharding through "
       "zero3_placement."),
    _v("HOROVOD_WIRE_POLICY", "(unset)", "ops",
       "Per-bucket wire policy of the gradient reductions (the hook "
       "optimizer, allreduce_gradients, the ZeRO reduce-scatter): auto, "
       "exact, or big=<codec>,small=<codec>[,threshold=<bytes>]."),
    _v("HOROVOD_SHARD_AG_WIRE", "(exact)", "ops",
       "Wire of the sharded optimizer's parameter allgather: any "
       "registered codec (the f32 master shards stay exact on their "
       "owner)."),
    _v("HOROVOD_HIERARCHICAL_ALLREDUCE", "0", "ops",
       "1 routes the gradient reductions over a create_hierarchical_mesh "
       "(axis_name=) through the ici reduce-scatter -> dcn allreduce -> "
       "ici allgather (reference knob name)."),
    _v("HOROVOD_HIERARCHICAL_DCN_WIRE", "(exact)", "ops",
       "Wire of the dcn leg of the hierarchical allreduce, float leaves "
       "under Average: any registered codec (none/fp16/bf16/int8/int4/"
       "fp8_*)."),
    _v("HOROVOD_ZERO_GATHER_WIRE", "(exact)", "ops",
       "Wire of the ZeRO-3 parameter gather: any registered codec (the "
       "rows at rest stay exact; every rank holds the decoded row)."),
    # -- the fused collective pipeline --------------------------------------
    _v("HOROVOD_FUSED_COLLECTIVES", "0", "ops",
       "1 routes the ZeRO scatter and gather through the chunked "
       "collective pipeline."),
    _v("HOROVOD_FUSED_PALLAS", "0", "ops",
       "1 runs the fused matmul chunks through K3 (csrc/tiled_matmul.cu) "
       "instead of torch.matmul."),
    _v("HOROVOD_FUSED_CHUNK_BYTES", "1048576", "autotune",
       "Chunk size of the fused collective pipeline."),
    # -- attention and join --------------------------------------------------
    _v("HOROVOD_FLASH_ATTENTION", "auto", "ops",
       "1 forces the flash-attention kernels, 0 the dense attention; "
       "unset: flash on the card from HOROVOD_FLASH_ATTENTION_MIN_T."),
    _v("HOROVOD_FLASH_ATTENTION_MIN_T", "512", "ops",
       "Sequence length from which attention routes to flash when "
       "HOROVOD_FLASH_ATTENTION is unset: 512, the smallest length at "
       "which the flash kernels beat dense attention forward and "
       "backward on an H100 (the JAX package's TPU default is 16384)."),
    _v("HOROVOD_JOIN_MODE", "0", "ops",
       "1 arms join mode: joined ranks contribute masked zeros to every "
       "collective."),
    # -- the autotuner (utils/autotune.py) -----------------------------------
    _v("HOROVOD_AUTOTUNE", "0", "autotune",
       "1: init() builds the online tuner (fusion threshold, bucket order, "
       "min buckets, ...); the training loop feeds it through "
       "autotune_record_step."),
    _v("HOROVOD_AUTOTUNE_LOG", "(unset)", "autotune",
       "CSV file the tuner appends its warmup, sample and frozen rows "
       "to."),
    _v("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "3", "autotune",
       "Throughput samples discarded before the search starts."),
    _v("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "10", "autotune",
       "Training steps per throughput sample."),
    _v("HOROVOD_AUTOTUNE_MAX_SAMPLES", "40", "autotune",
       "Samples after which the tuner freezes at the best seen."),
    _v("HOROVOD_SHARD_AG_FUSION", "0", "autotune",
       "1 gathers the sharded optimizer's new shards in one allgather "
       "per dtype (current_ag_fusion); also the initial value of the "
       "tuner's ag_fusion knob."),
    _v("HOROVOD_WIRE_THRESHOLD", "1048576", "autotune",
       "Initial value of the tuner's wire_threshold knob: buckets of at "
       "least this many raw bytes take the wire policy's big codec."),
    _v("HOROVOD_WIRE_BIG_FORMAT", "int8", "autotune",
       "Initial value of the tuner's wire_big_format knob: the codec "
       "HOROVOD_WIRE_POLICY=auto gives big buckets."),
    _v("HOROVOD_SERVE_PAGE_TOKENS", "16", "autotune",
       "KV-cache pool page size in tokens (the tuner's serve_page_tokens "
       "knob; read when an InferenceServer is built)."),
    _v("HOROVOD_SERVE_MAX_BATCH", "8", "autotune",
       "Row count of the continuous-batching decode step (the tuner's "
       "serve_max_batch knob)."),
    _v("HOROVOD_SERVE_SPEC_GAMMA", "4", "autotune",
       "Speculative draft length per serving round (the tuner's "
       "serve_spec_gamma knob; the verify chunk's width)."),
    _v("HOROVOD_SERVE_FLIGHTREC_DEPTH", "512", "autotune",
       "Flight-recorder ring depth in events (the tuner's "
       "serve_flightrec_depth knob, host only); <= 0 turns the recorder "
       "off."),
    _v("HOROVOD_RESHARD_CHUNK_BYTES", "0 (4 MiB)", "autotune",
       "Reshard chunk-grid cell size in bytes (parallel/reshard.py); 0 "
       "takes the tuner's reshard_chunk_bytes knob (4 MiB without it), "
       "clamped to HOROVOD_RESHARD_PEAK_BYTES / 4."),
    _v("HOROVOD_RESHARD_PEAK_BYTES", "67108864", "reshard",
       "Per-host staging ceiling of a live reshard in bytes: chunks are "
       "at most a quarter of it, and the measured peak "
       "(hvd_reshard_peak_bytes) over it fails the reshard."),
    _v("HOROVOD_RESHARD_TIMEOUT", "60", "reshard",
       "Seconds a reshard fetch waits for a peer's chunk or verdict "
       "before it declares the peer dead (ReshardError, then the "
       "restore path)."),
    _v("HOROVOD_RESHARD_WIRE", "none", "reshard",
       "Wire of the chunks ShardedTorchState publishes: none (exact, "
       "bitwise) or a cast wire (bf16, fp16); cooperative codecs are "
       "refused."),
    # -- serving (serve/) -----------------------------------------------------
    # -- training-health guard (guard/, utils/checkpoint.py) -----------
    _v("HOROVOD_GUARD", "0", "guard",
       "1 arms the training-health guard in DistributedOptimizer: the "
       "per-bucket non-finite sentinel plus the coordinated skip-step."),
    _v("HOROVOD_GUARD_LOSS_SCALE", "(unset)", "guard",
       "Initial dynamic loss scale (e.g. 65536).  Unset keeps a static "
       "scale of 1.0: skip-step only, clean steps bitwise the unguarded "
       "ones."),
    _v("HOROVOD_GUARD_GROWTH_INTERVAL", "2000", "guard",
       "Clean steps before the dynamic loss scale doubles; the tuner's "
       "loss_scale_growth_interval knob."),
    _v("HOROVOD_GUARD_DIGEST_INTERVAL", "100", "guard",
       "Steps between TrainingGuard's cross-replica parameter-digest "
       "checks (0 disables); the tuner's guard_digest_interval knob."),
    _v("HOROVOD_GUARD_MAX_NONFINITE", "3", "guard",
       "Consecutive flagged steps TrainingGuard tolerates before it "
       "rolls back to the last digest-verified checkpoint."),
    _v("HOROVOD_CKPT_QUARANTINE_KEEP", "3", "guard",
       "Corrupt checkpoints (step_N.corrupt) CheckpointManager keeps for "
       "forensics; older ones are pruned."),
    _v("HOROVOD_SERVE_POOL_PAGES", "0", "serve",
       "KV pool size in pages; 0 = max_batch full-length sequences."),
    _v("HOROVOD_SERVE_SLO_MS", "(unset)", "serve",
       "Per-token p99 latency SLO in ms; when the observed p99 exceeds it "
       "the server turns speculative decoding on (unset or 0: the "
       "controller is off)."),
    _v("HOROVOD_SERVE_METRICS_INTERVAL", "16", "serve",
       "Steps between serving-gauge samples (queue depth, occupancy, "
       "pool pages, p99); one flush runs at drain and at exit."),
    _v("HOROVOD_SERVE_FLIGHTREC_DIR", "$TMPDIR/horovod_flightrec", "serve",
       "Directory of the flight recorder's dumps (crash, pool "
       "exhaustion, SLO breach, an injected exit)."),
    _v("HOROVOD_SERVE_REPLICA_ID", "(set by ReplicaManager)", "serve",
       "Replica index handed to each `python -m "
       "horovod_tpu_torch.serve.replica` worker by its manager (the spawn "
       "handshake, like the rendezvous address and port); a "
       "flight-recorder dump records it."),
    _v("HOROVOD_AUTOSCALE_MIN_REPLICAS", "1", "serve",
       "Floor of the autoscaled decode fleet; a shrink never retires "
       "below it (the budget latch also forbids any shrink while the SLO "
       "budget is breaching)."),
    _v("HOROVOD_AUTOSCALE_MAX_REPLICAS", "8", "serve",
       "Ceiling of the autoscaled decode fleet; pressure beyond it walks "
       "the degrade ladder instead (borrow training chips, then priority "
       "shed)."),
    _v("HOROVOD_AUTOSCALE_COOLDOWN", "32", "serve",
       "Observations after a scale event during which no further event "
       "fires; reversals wait twice as long (anti-flap).  The tuner's "
       "autoscale_cooldown knob, host only."),
    _v("HOROVOD_AUTOSCALE_DWELL", "8", "serve",
       "Consecutive observations a pressure or relief condition must "
       "persist before a scale event fires (the hysteresis dwell).  The "
       "tuner's autoscale_dwell knob, host only."),
    _v("HOROVOD_AUTOSCALE_OCC_HIGH", "0.85", "serve",
       "Occupancy high watermark: sustained occupancy at or above it with "
       "a backlog is scale-up pressure."),
    _v("HOROVOD_AUTOSCALE_OCC_LOW", "0.30", "serve",
       "Occupancy low watermark: sustained occupancy at or below it with "
       "an empty queue and a healthy error budget is scale-down relief."),
    _v("HOROVOD_AUTOSCALE_QUEUE_MS", "1000", "serve",
       "Head-of-line queue-wait threshold in ms: the oldest queued "
       "request waiting past it is scale-up pressure whatever the "
       "occupancy (0 turns the signal off)."),
    _v("HOROVOD_AUTOSCALE_TENANT_CLASSES", "premium:0,standard:1,batch:2",
       "serve",
       "Tenant SLO classes as name:priority pairs (lower = more "
       "important); the priority shed drops the highest-number class "
       "first, newest requests first."),
    # -- metrics and the timeline (metrics/, utils/timeline.py) ---------------
    _v("HOROVOD_METRICS_DISABLE", "0", "metrics",
       "1 disables all metric recording."),
    _v("HOROVOD_SLO_BUDGET_TARGET", "0.99", "metrics",
       "Target of an SLO error budget: 0.99 lets 1% of events be bad "
       "before the budget is spent."),
    _v("HOROVOD_SLO_BUDGET_WINDOW", "3600", "metrics",
       "Seconds of history one error budget is computed over."),
    _v("HOROVOD_SLO_BUDGET_FAST", "60", "metrics",
       "Fast burn-rate window in seconds (a breach needs fast and slow "
       "over the threshold)."),
    _v("HOROVOD_SLO_BUDGET_SLOW", "600", "metrics",
       "Slow burn-rate window in seconds."),
    _v("HOROVOD_METRICS_PORT", "-1", "metrics",
       "Port of the Prometheus endpoint (/metrics, /healthz) that "
       "`hvd.init()` starts; -1 disables, 0 picks a free port; with "
       "several processes each adds its rank."),
    _v("HOROVOD_METRICS_KV_INTERVAL", "5.0", "metrics",
       "Seconds between fleet snapshot publishes of the fallback "
       "publisher (a rank whose stall watchdog, which publishes at its "
       "own cadence, is off)."),
    _v("HOROVOD_METRICS_HISTORY_INTERVAL", "0 (off)", "metrics",
       "Seconds between history-ring samples of every metric series "
       "(metrics/history.py); 0/unset disables the sampler."),
    _v("HOROVOD_METRICS_HISTORY_DEPTH", "512", "metrics",
       "Points kept per series ring before the oldest are evicted."),
    _v("HOROVOD_METRICS_HISTORY_DIR", "(system temp)", "metrics",
       "Directory for the history JSONL dumps written on "
       "flight-recorder triggers."),
    _v("HOROVOD_SLO_STEP_MS", "(unset)", "metrics",
       "Training step-time SLO in ms; set, the chaos soak keeps a "
       "train_step error budget (metrics/budget.py)."),
    _v("HOROVOD_ANOMALY_Z", "4.0", "metrics",
       "EWMA z-score threshold of the anomaly detectors "
       "(metrics/anomaly.py); higher = fewer, louder trips."),
    _v("HOROVOD_STALL_CHECK_DISABLE", "0", "metrics",
       "1 disables the stall inspector watchdog."),
    _v("HOROVOD_STALL_CHECK_TIME_SECONDS", "60.0", "metrics",
       "Seconds a collective must be outstanding before a stall "
       "warning (reference: stall_inspector.cc)."),
    _v("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "0.0", "metrics",
       "Seconds after which a stalled job aborts (exit code 57); 0 "
       "disables shutdown."),
    _v("HOROVOD_TIMELINE", "(unset)", "timeline",
       "Path of the Chrome-trace timeline file; `hvd.init()` starts "
       "the timeline when it is set (the serving benchmark, which calls "
       "no `init`, starts it itself)."),
    _v("HOROVOD_TRACE_STEP_SPANS", "1", "timeline",
       "1 emits one host span (ph=X, cat=step) per optimizer step or "
       "megastep call when the timeline is active."),
    _v("HOROVOD_TIMELINE_ALL_RANKS", "0", "timeline",
       "1 records a timeline on every rank instead of rank 0 only."),
    _v("HOROVOD_TIMELINE_MARK_CYCLES", "0", "timeline",
       "1 marks step/cycle boundaries in the timeline."),
    _v("HOROVOD_TIMELINE_DISABLE_NATIVE", "0", "timeline",
       "1 keeps the timeline on the Python writer thread instead of the "
       "native C++ writer (used when its library is built)."),
    # -- the fleet tracer (trace/) -------------------------------------------
    _v("HOROVOD_TRACE_ALIGN", "cycle", "trace",
       "Cross-rank clock alignment of trace merge/analyze: 'cycle' "
       "aligns ranks on the CYCLE_n per-step instants, 'wall' trusts "
       "the raw per-rank clocks."),
    _v("HOROVOD_TRACE_FLOW_EVENTS", "1", "trace",
       "1 links the same collective across ranks with Chrome flow "
       "events (s/t/f) in the merged trace."),
    _v("HOROVOD_STRAGGLER_PATIENCE", "3", "trace",
       "Consecutive analysis windows one rank must be blamed before "
       "the straggler reaction policy acts (trace/reaction.py)."),
    _v("HOROVOD_STRAGGLER_SKEW_THRESHOLD", "0.75", "trace",
       "Skew share (straggler wait / critical path) at or above which "
       "the reaction escalates straight to degrade instead of a bucket "
       "rebalance."),
    _v("HOROVOD_STRAGGLER_COOLDOWN", "2", "trace",
       "Analysis windows the reaction policy sleeps after firing."),
    # -- fault injection and retries (faults/) -------------------------------
    _v("HOROVOD_FAULT_SPEC", "(unset)", "faults",
       "Fault schedule, point[@N]:mode[:arg] entries separated by commas "
       "(faults/spec.py); the port fires the collective.* points, "
       "chaos.straggler_delay and state.commit."),
    _v("HOROVOD_BENCH_CHAOS_NP", "2", "faults",
       "Ranks of `bench.py --chaos`'s soak."),
    _v("HOROVOD_CHAOS_GENERATIONS", "8", "faults",
       "Generations one chaos soak runs (faults/chaos.py; each ends in "
       "an analysis window, a digest check and a commit)."),
    _v("HOROVOD_CHAOS_STEPS_PER_GEN", "6", "faults",
       "Training steps per chaos-soak generation (at least 2)."),
    _v("HOROVOD_FAULT_SEED", "0", "faults",
       "Seed of the schedule's per-point RNGs: the same spec and seed "
       "replay the same faults."),
    _v("HOROVOD_FAULT_HOSTS", "(all)", "faults",
       "Comma list of HOROVOD_HOSTNAME values the spec is armed on."),
    _v("HOROVOD_HOSTNAME", "(unset)", "topology",
       "This host's name, matched against HOROVOD_FAULT_HOSTS; names its "
       "heartbeat key."),
    _v("HOROVOD_RETRY_MAX_ATTEMPTS", "5", "faults",
       "Attempts of a retried operation (HOROVOD_<SITE>_RETRY_MAX_ATTEMPTS "
       "overrides per site, e.g. RESET: the elastic re-rendezvous)."),
    _v("HOROVOD_RETRY_BASE_DELAY", "0.5", "faults",
       "First backoff delay in seconds (HOROVOD_<SITE>_RETRY_BASE_DELAY "
       "per site)."),
    _v("HOROVOD_RETRY_MAX_DELAY", "30.0", "faults",
       "Backoff cap in seconds (HOROVOD_<SITE>_RETRY_MAX_DELAY per "
       "site)."),
    _v("HOROVOD_RETRY_MULTIPLIER", "2.0", "faults",
       "Backoff multiplier (HOROVOD_<SITE>_RETRY_MULTIPLIER per site)."),
    _v("HOROVOD_RETRY_JITTER", "0.1", "faults",
       "Random extra fraction of each delay (HOROVOD_<SITE>_RETRY_JITTER "
       "per site)."),
    _v("HOROVOD_RETRY_DEADLINE", "(none)", "faults",
       "Wall-clock cap in seconds over all attempts "
       "(HOROVOD_<SITE>_RETRY_DEADLINE per site)."),
)

BY_NAME: Dict[str, EnvVar] = {v.name: v for v in CATALOG}

__all__ = ["BY_NAME", "CATALOG", "EnvVar", "PREFIXES"]
