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
    _v("HOROVOD_ELASTIC_GEN", "0", "elastic",
       "Elastic generation; scopes the join keys in the store."),
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
       "Initial value of the tuner's reshard_chunk_bytes knob "
       "(parallel/reshard.py is not ported yet)."),
    _v("HOROVOD_AUTOSCALE_COOLDOWN", "32", "autotune",
       "Initial value of the tuner's autoscale_cooldown knob (serve/ is "
       "not ported yet)."),
    _v("HOROVOD_AUTOSCALE_DWELL", "8", "autotune",
       "Initial value of the tuner's autoscale_dwell knob (serve/ is not "
       "ported yet)."),
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
    _v("HOROVOD_SERVE_REPLICA_ID", "(unset)", "serve",
       "Replica index a flight-recorder dump records (set by the JAX "
       "package's replica manager; the port's is not ported yet)."),
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
    _v("HOROVOD_TIMELINE", "(unset)", "timeline",
       "Path of the Chrome-trace timeline file; `init_from_env` starts "
       "the timeline when it is set (the serving benchmark calls it)."),
    _v("HOROVOD_TIMELINE_ALL_RANKS", "0", "timeline",
       "1 records a timeline on every rank instead of rank 0 only."),
    _v("HOROVOD_TIMELINE_MARK_CYCLES", "0", "timeline",
       "1 marks step/cycle boundaries in the timeline."),
    # -- fault injection and retries (faults/) -------------------------------
    _v("HOROVOD_FAULT_SPEC", "(unset)", "faults",
       "Fault schedule, point[@N]:mode[:arg] entries separated by commas "
       "(faults/spec.py); the port fires the collective.* points, "
       "chaos.straggler_delay and state.commit."),
    _v("HOROVOD_FAULT_SEED", "0", "faults",
       "Seed of the schedule's per-point RNGs: the same spec and seed "
       "replay the same faults."),
    _v("HOROVOD_FAULT_HOSTS", "(all)", "faults",
       "Comma list of HOROVOD_HOSTNAME values the spec is armed on."),
    _v("HOROVOD_HOSTNAME", "(unset)", "topology",
       "This host's name, matched against HOROVOD_FAULT_HOSTS."),
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
