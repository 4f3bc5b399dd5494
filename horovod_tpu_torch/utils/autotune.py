"""Autotuner: online Bayesian optimization of the runtime's tunables.

Counterpart of `horovod_tpu/utils/autotune.py` (reference:
parameter_manager.cc, optim/gaussian_process.cc,
optim/bayesian_optimization.cc).  HOROVOD_AUTOTUNE=1 makes `init()`
build a `ParameterManager` over the JAX package's knobs, in its order
and with its bounds, so that the search space has the same dimension
and the same rate samples give the same proposals.  Training loops feed
it one step at a time (`hvd.autotune_record_step(items)`); every
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE steps close one throughput sample, the
first HOROVOD_AUTOTUNE_WARMUP_SAMPLES are discarded, and after
HOROVOD_AUTOTUNE_MAX_SAMPLES it freezes at the best configuration seen.
Progress is appended to HOROVOD_AUTOTUNE_LOG as CSV.

The `current_*` readers are live: each returns the tuner's value while
one is active, else its env value (HOROVOD_*), validated as the JAX
readers validate it.  The port reads `fusion_threshold` on every
gradient enqueue of `DistributedOptimizer`, `fused_chunk_bytes` on
every chunk plan, `bucket_order`, `min_buckets` and `zero_stage` where
a sharded optimizer or a placement is built, the wire policy's
`wire_threshold` and `wire_big_format`, and `serve_page_tokens`,
`serve_max_batch`, `serve_spec_gamma` and `serve_flightrec_depth` where
an `InferenceServer` is built (with the plain env read
`current_serve_pool_pages`).  The other knobs stay registered for the
search space; their readers come with the modules that read them
(guard, resharding, autoscaling).

Ranks: every rank runs the same manager from the same seed.  With more
than one rank, rank 0's measured rate is broadcast when a sample closes
(`_rank0_rate`), so every rank observes the same rates and proposes the
same values in the same step, and the ranks' gradient buckets agree.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import util

logger = logging.getLogger("horovod_tpu_torch.autotune")


class GaussianProcess:
    """GP regression with an RBF kernel (reference: gaussian_process.cc).

    Inputs are normalized to [0, 1]^d by the caller; outputs are
    z-scored internally for conditioning.
    """

    def __init__(self, length_scale: float = 0.2, noise: float = 1e-4):
        self.length_scale = length_scale
        self.noise = noise
        self._x: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.length_scale ** 2))

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yz = (y - self._y_mean) / self._y_std
        k = self._kernel(x, x) + self.noise * np.eye(len(x))
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yz))
        self._x = x

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) in the units of y."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        if self._x is None:
            return (np.full(len(x), self._y_mean),
                    np.full(len(x), self._y_std))
        ks = self._kernel(x, self._x)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return (mu * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class BayesianOptimizer:
    """Expected-improvement search over [0, 1]^d (reference:
    bayesian_optimization.cc `NextSample`: fit the GP, sample
    candidates, return the EI argmax)."""

    def __init__(self, dims: int, seed: int = 0, xi: float = 0.01,
                 n_candidates: int = 256):
        self.dims = dims
        self.xi = xi
        self.n_candidates = n_candidates
        self._rng = np.random.RandomState(seed)
        self._gp = GaussianProcess()
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []

    def observe(self, x: Sequence[float], y: float) -> None:
        self._xs.append(np.asarray(x, np.float64))
        self._ys.append(float(y))

    def next_sample(self) -> np.ndarray:
        if len(self._xs) < 2:
            return self._rng.uniform(size=self.dims)
        self._gp.fit(np.stack(self._xs), np.asarray(self._ys))
        cand = self._rng.uniform(size=(self.n_candidates, self.dims))
        mu, sigma = self._gp.predict(cand)
        best = max(self._ys)
        z = (mu - best - self.xi) / sigma
        ei = (mu - best - self.xi) * _norm_cdf(z) + sigma * _norm_pdf(z)
        return cand[int(np.argmax(ei))]

    @property
    def best(self) -> Tuple[Optional[np.ndarray], float]:
        if not self._ys:
            return None, float("-inf")
        i = int(np.argmax(self._ys))
        return self._xs[i], self._ys[i]


@dataclasses.dataclass
class _Tunable:
    name: str
    low: float
    high: float
    log_scale: bool = False
    integer: bool = False
    #: Host-only knobs are left out of `values()`; the optimizer still
    #: proposes over them.
    host_only: bool = False
    current: float = 0.0

    def denorm(self, u: float) -> float:
        u = min(max(float(u), 0.0), 1.0)
        if self.log_scale:
            val = math.exp(math.log(self.low)
                           + u * (math.log(self.high) - math.log(self.low)))
        else:
            val = self.low + u * (self.high - self.low)
        return round(val) if self.integer else val

    def norm(self, val: float) -> float:
        if self.log_scale:
            return ((math.log(val) - math.log(self.low))
                    / (math.log(self.high) - math.log(self.low)))
        return (val - self.low) / (self.high - self.low)


class ParameterManager:
    """Online tuner of registered knobs, driven by throughput samples
    (reference: parameter_manager.cc).

        pm = ParameterManager()
        pm.register("fusion_threshold", 1<<20, 256<<20, log_scale=True,
                    integer=True, initial=64<<20)
        ...each step: pm.record_step(n_samples)   # or record_sample(rate)
        current = pm.value("fusion_threshold")

    Every `steps_per_sample` steps the observed rate closes one sample;
    the first `warmup_samples` are discarded, then the Bayesian
    optimizer proposes the next configuration; after `max_samples` it
    freezes at the best seen.  `rate_sync`, when given, maps each
    measured rate to the one observed (the ranks' agreement, see the
    module docstring).

    Where a value is read once, it stays: `DistributedOptimizer` reads
    the fusion threshold on every gradient, but a `_ShardedOptimizer`
    (ZeRO 1-3) keeps the shard groups that the threshold, the bucket
    order and the minimum bucket count gave when it was built, and the
    ZeRO stage is read when the optimizer is built.  That is the JAX
    package's caveat for a step the user jitted: rebuild after the tuner
    freezes (`frozen`) to pick up the tuned values.
    """

    def __init__(self, warmup_samples: int = 3, steps_per_sample: int = 10,
                 max_samples: int = 40, log_file: Optional[str] = None,
                 seed: int = 0,
                 on_change: Optional[Callable[[Dict[str, float]], None]] = None,
                 rate_sync: Optional[Callable[[float], float]] = None):
        self._tunables: Dict[str, _Tunable] = {}
        self._order: List[str] = []
        self._bo: Optional[BayesianOptimizer] = None
        self._warmup = warmup_samples
        self._steps_per_sample = steps_per_sample
        self._max_samples = max_samples
        self._samples = 0
        self._log_file = log_file
        self._on_change = on_change
        self._rate_sync = rate_sync
        self._seed = seed
        self._lock = threading.Lock()
        self._frozen = False
        self._step_count = 0
        self._item_count = 0.0
        self._t0: Optional[float] = None

    # -- setup -----------------------------------------------------------
    def register(self, name: str, low: float, high: float,
                 log_scale: bool = False, integer: bool = False,
                 initial: Optional[float] = None,
                 host_only: bool = False) -> None:
        t = _Tunable(name, low, high, log_scale, integer,
                     host_only=host_only)
        t.current = initial if initial is not None else t.denorm(0.5)
        self._tunables[name] = t
        self._order.append(name)
        self._bo = BayesianOptimizer(len(self._order), seed=self._seed)

    def value(self, name: str) -> float:
        t = self._tunables[name]
        return int(t.current) if t.integer else t.current

    def values(self) -> Dict[str, float]:
        """The knobs that are not `host_only`, by name."""
        return {n: self.value(n) for n in self._order
                if not self._tunables[n].host_only}

    @property
    def frozen(self) -> bool:
        return self._frozen

    # -- sampling --------------------------------------------------------
    def record_step(self, items: float = 1.0,
                    now: Optional[float] = None) -> None:
        """Count one training step of `items` samples or tokens; every
        `steps_per_sample` steps close one throughput sample."""
        with self._lock:
            now = now if now is not None else time.perf_counter()
            if self._t0 is None:
                self._t0 = now
                return
            self._step_count += 1
            self._item_count += items
            if self._step_count < self._steps_per_sample:
                return
            elapsed = now - self._t0
            rate = self._item_count / elapsed if elapsed > 0 else 0.0
            self._step_count = 0
            self._item_count = 0.0
            self._t0 = now
            if self._rate_sync is not None:
                rate = self._rate_sync(rate)
            self._record_sample_locked(rate)

    def record_sample(self, rate: float) -> None:
        """Report a throughput measurement of the current
        configuration."""
        with self._lock:
            self._record_sample_locked(rate)

    def record_trace(self, step_ms: float, items_per_step: float = 1.0,
                     bucket_ms: Optional[dict] = None) -> None:
        """A measured per-step time replaces the wall-clock sampling of
        `record_step`; `bucket_ms` (per-bucket collective ms) is
        appended to the log."""
        if step_ms <= 0:
            return
        if bucket_ms and self._log_file:
            try:
                with open(self._log_file, "a") as f:
                    per = ";".join(f"{k}={v:.3f}"
                                   for k, v in sorted(bucket_ms.items()))
                    f.write(f"{time.time():.3f},trace_buckets,{per}\n")
            except OSError as e:
                logger.warning("autotune log %s: %s", self._log_file, e)
        with self._lock:
            self._record_sample_locked(items_per_step / (step_ms / 1e3))

    def _record_sample_locked(self, rate: float) -> None:
        if self._frozen or self._bo is None:
            return
        self._samples += 1
        if self._samples <= self._warmup:
            self._log("warmup", rate)
            return
        x = [self._tunables[n].norm(self._tunables[n].current)
             for n in self._order]
        self._bo.observe(x, rate)
        self._log("sample", rate)
        if self._samples - self._warmup >= self._max_samples:
            bx, brate = self._bo.best
            if bx is not None:
                self._apply(bx)
            self._frozen = True
            self._log("frozen", brate)
            logger.info("autotune frozen at %s (%.1f items/sec)",
                        self.values(), brate)
            return
        self._apply(self._bo.next_sample())

    def _apply(self, xnorm: np.ndarray) -> None:
        for n, u in zip(self._order, xnorm):
            t = self._tunables[n]
            t.current = t.denorm(float(u))
        if self._on_change:
            self._on_change(self.values())

    def _log(self, kind: str, rate: float) -> None:
        if not self._log_file:
            return
        try:
            with open(self._log_file, "a") as f:
                vals = ",".join(f"{self.value(n)}" for n in self._order)
                f.write(f"{time.time():.3f},{kind},{rate:.3f},{vals}\n")
        except OSError as e:
            logger.warning("autotune log %s: %s", self._log_file, e)


# ---------------------------------------------------------------------------
# The process's manager, built by init() when HOROVOD_AUTOTUNE=1
# ---------------------------------------------------------------------------

_manager: Optional[ParameterManager] = None


def get_manager() -> Optional[ParameterManager]:
    return _manager


def _rank0_rate(rate: float) -> float:
    """Rank 0's rate on every rank (one small broadcast), so that the
    ranks' managers observe the same samples."""
    from ..common import basics

    if not basics.is_initialized() or basics.size() == 1:
        return rate
    import torch

    from ..ops import collectives as C

    t = torch.tensor([rate], dtype=torch.float64, device=basics.device())
    return float(C.broadcast(t, root_rank=0)[0])


def init_from_env() -> Optional[ParameterManager]:
    """HOROVOD_AUTOTUNE=1 builds the manager (the JAX package's knobs,
    order and bounds; each initial value from its HOROVOD_* variable);
    HOROVOD_AUTOTUNE_LOG names the CSV log."""
    global _manager
    if not util.env_bool("AUTOTUNE", False):
        return None
    if _manager is not None:
        return _manager
    pm = ParameterManager(
        warmup_samples=util.env_int("AUTOTUNE_WARMUP_SAMPLES", 3),
        steps_per_sample=util.env_int("AUTOTUNE_STEPS_PER_SAMPLE", 10),
        max_samples=util.env_int("AUTOTUNE_MAX_SAMPLES", 40),
        log_file=util.getenv("AUTOTUNE_LOG"),
        rate_sync=_rank0_rate,
    )
    # The JAX package's `_invalidate` clears its compiled collective
    # programs on a change; the port compiles none, and every reader
    # below is live, so there is nothing to clear.
    pm.register("fusion_threshold", 1 << 20, 256 << 20, log_scale=True,
                integer=True,
                initial=util.env_int("FUSION_THRESHOLD", 64 << 20))
    pm.register("bucket_order", 0, len(_BUCKET_ORDERS) - 1, integer=True,
                initial=_BUCKET_ORDERS.index(_env_bucket_order()))
    pm.register("min_buckets", 1, 16, integer=True,
                initial=util.env_int("MIN_BUCKETS", 1))
    pm.register("ag_fusion", 0, 1, integer=True,
                initial=1 if util.env_bool("SHARD_AG_FUSION", False)
                else 0)
    pm.register("wire_threshold", 64 << 10, 64 << 20, log_scale=True,
                integer=True,
                initial=util.env_int("WIRE_THRESHOLD", 1 << 20))
    pm.register("wire_big_format", 0, len(_WIRE_BIG_FORMATS) - 1,
                integer=True,
                initial=_WIRE_BIG_FORMATS.index(_env_wire_big_format()))
    pm.register("fused_chunk_bytes", 64 << 10, 16 << 20, log_scale=True,
                integer=True,
                initial=util.env_int("FUSED_CHUNK_BYTES", 1 << 20))
    pm.register("loss_scale_growth_interval", 10, 10000, log_scale=True,
                integer=True,
                initial=util.env_int("GUARD_GROWTH_INTERVAL", 2000))
    pm.register("guard_digest_interval", 10, 10000, log_scale=True,
                integer=True,
                initial=util.env_int("GUARD_DIGEST_INTERVAL", 100))
    pm.register("zero_stage", 0, 3, integer=True,
                initial=_env_zero_stage())
    pm.register("serve_page_tokens", 8, 256, log_scale=True,
                integer=True,
                initial=util.env_int("SERVE_PAGE_TOKENS", 16))
    pm.register("serve_max_batch", 1, 64, log_scale=True,
                integer=True,
                initial=util.env_int("SERVE_MAX_BATCH", 8))
    pm.register("serve_spec_gamma", 1, 16, integer=True,
                initial=util.env_int("SERVE_SPEC_GAMMA", 4))
    pm.register("serve_flightrec_depth", 64, 8192, log_scale=True,
                integer=True, host_only=True,
                initial=max(64, util.env_int("SERVE_FLIGHTREC_DEPTH",
                                             512)))
    pm.register("reshard_chunk_bytes", 4 << 10, 64 << 20,
                log_scale=True, integer=True, host_only=True,
                initial=(util.env_int("RESHARD_CHUNK_BYTES", 0)
                         or (4 << 20)))
    pm.register("autoscale_cooldown", 4, 512, log_scale=True,
                integer=True, host_only=True,
                initial=max(4, util.env_int("AUTOSCALE_COOLDOWN", 32)))
    pm.register("autoscale_dwell", 1, 128, log_scale=True,
                integer=True, host_only=True,
                initial=max(1, util.env_int("AUTOSCALE_DWELL", 8)))
    _manager = pm
    logger.info("autotune enabled: %s", pm.values())
    return pm


def shutdown_manager() -> None:
    global _manager
    _manager = None


# ---------------------------------------------------------------------------
# Live readers: the tuner's value while it is active, else the env's
# ---------------------------------------------------------------------------

# Bucket-formation orders the tuner picks between (the knob's value is
# the index).
_BUCKET_ORDERS = ("forward", "reverse")

# Big-bucket codecs of the wire-format knob (the knob's value is the
# index): the cooperative block-scaled formats and the cast wires, all
# that compress; "none" stays reachable through HOROVOD_WIRE_POLICY=exact.
# The wire policy reads it (`current_wire_big_format`).
_WIRE_BIG_FORMATS = ("int8", "int4", "fp8_e4m3", "fp8_e5m2", "bf16",
                     "fp16")


def _tuned(name: str) -> Optional[float]:
    if _manager is not None and name in _manager._tunables:
        return _manager.value(name)
    return None


def _env_bucket_order() -> str:
    order = util.bucket_order()
    if order not in _BUCKET_ORDERS:
        raise ValueError(f"HOROVOD_BUCKET_ORDER must be one of "
                         f"{_BUCKET_ORDERS}, got {order!r}")
    return order


def _env_wire_big_format() -> str:
    fmt = util.getenv("WIRE_BIG_FORMAT") or "int8"
    if fmt not in _WIRE_BIG_FORMATS:
        raise ValueError(f"HOROVOD_WIRE_BIG_FORMAT must be one of "
                         f"{_WIRE_BIG_FORMATS}, got {fmt!r}")
    return fmt


def _env_zero_stage() -> int:
    stage = util.zero_stage()
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"HOROVOD_ZERO_STAGE must be 0..3, got {stage}")
    return stage


def tuned_bucket_order(default: str) -> str:
    v = _tuned("bucket_order")
    return default if v is None else _BUCKET_ORDERS[int(v)]


def current_bucket_order() -> str:
    """The live bucket-formation order: HOROVOD_BUCKET_ORDER ("reverse"
    by default, backward-availability order), or the tuner's."""
    return tuned_bucket_order(_env_bucket_order())


def tuned_min_buckets(default: int) -> int:
    v = _tuned("min_buckets")
    return default if v is None else max(1, int(v))


def current_min_buckets() -> int:
    """The live floor on the bucket count: HOROVOD_MIN_BUCKETS (1 = no
    floor), or the tuner's."""
    return tuned_min_buckets(util.min_buckets())


def tuned_ag_fusion(default: bool) -> bool:
    v = _tuned("ag_fusion")
    return default if v is None else bool(int(v))


def current_ag_fusion() -> bool:
    """The live parameter-allgather fusion of the sharded optimizer:
    HOROVOD_SHARD_AG_FUSION (off by default: per-group gathers overlap
    better), or the tuner's `ag_fusion`."""
    return tuned_ag_fusion(util.env_bool("SHARD_AG_FUSION", False))


def tuned_zero_stage(default: int) -> int:
    v = _tuned("zero_stage")
    return default if v is None else int(v)


def current_zero_stage() -> int:
    """The live ZeRO stage: HOROVOD_ZERO_STAGE (default 0, or 1 when
    HOROVOD_SHARD_OPTIMIZER is set), or the tuner's."""
    return tuned_zero_stage(_env_zero_stage())


def tuned_fusion_threshold(default: int) -> int:
    v = _tuned("fusion_threshold")
    return default if v is None else int(v)


def current_fusion_threshold() -> int:
    """The live fusion threshold in bytes: HOROVOD_FUSION_THRESHOLD (64
    MiB by default), or the tuner's."""
    return tuned_fusion_threshold(util.fusion_threshold())


def tuned_fused_chunk_bytes(default: int) -> int:
    v = _tuned("fused_chunk_bytes")
    return default if v is None else int(v)


def current_fused_chunk_bytes() -> int:
    """The live chunk size of the fused pipeline:
    HOROVOD_FUSED_CHUNK_BYTES (1 MiB by default), or the tuner's."""
    return tuned_fused_chunk_bytes(util.fused_chunk_bytes())


def tuned_wire_threshold(default: int) -> int:
    v = _tuned("wire_threshold")
    return default if v is None else int(v)


def current_wire_threshold() -> int:
    """The live wire-policy threshold in bytes: HOROVOD_WIRE_THRESHOLD (1
    MiB by default; buckets at or above it take the policy's big codec),
    or the tuner's.  Read only when the HOROVOD_WIRE_POLICY spec gives no
    threshold=."""
    return tuned_wire_threshold(util.env_int("WIRE_THRESHOLD", 1 << 20))


def tuned_wire_big_format(default: str) -> str:
    v = _tuned("wire_big_format")
    return default if v is None else _WIRE_BIG_FORMATS[int(v)]


def current_wire_big_format() -> str:
    """The live big-bucket codec of HOROVOD_WIRE_POLICY=auto:
    HOROVOD_WIRE_BIG_FORMAT (int8 by default), or the tuner's."""
    return tuned_wire_big_format(_env_wire_big_format())


def tuned_guard_growth_interval(default: int) -> int:
    """The loss-scale growth interval, the tuner's while it is active
    (read by guard.DynamicLossScale)."""
    v = _tuned("loss_scale_growth_interval")
    return default if v is None else max(1, int(v))


def current_guard_growth_interval() -> int:
    """The live loss-scale growth interval: HOROVOD_GUARD_GROWTH_INTERVAL
    (2000 clean steps, GradScaler's default), overridden by the tuner
    when it is active.  Read at every schedule update."""
    return tuned_guard_growth_interval(
        max(1, util.env_int("GUARD_GROWTH_INTERVAL", 2000)))


def tuned_guard_digest_interval(default: int) -> int:
    """The cross-replica digest interval, the tuner's while it is active
    (read by guard.TrainingGuard)."""
    v = _tuned("guard_digest_interval")
    return default if v is None else max(1, int(v))


def current_guard_digest_interval() -> int:
    """The live digest-check cadence: HOROVOD_GUARD_DIGEST_INTERVAL
    (every 100 steps; 0 disables), overridden by the tuner when it is
    active.  Read on the host at every step."""
    env = util.env_int("GUARD_DIGEST_INTERVAL", 100)
    if env <= 0:
        return 0
    return tuned_guard_digest_interval(env)


def tuned_serve_page_tokens(default: int) -> int:
    v = _tuned("serve_page_tokens")
    return default if v is None else max(1, int(v))


def current_serve_page_tokens() -> int:
    """The live KV-pool page size in tokens: HOROVOD_SERVE_PAGE_TOKENS
    (16), or the tuner's.  Shape-changing: read once when a server is
    built."""
    return tuned_serve_page_tokens(
        max(1, util.env_int("SERVE_PAGE_TOKENS", 16)))


def tuned_serve_max_batch(default: int) -> int:
    v = _tuned("serve_max_batch")
    return default if v is None else max(1, int(v))


def current_serve_max_batch() -> int:
    """The live row count of the serving decode step:
    HOROVOD_SERVE_MAX_BATCH (8), or the tuner's.  Read once when a server
    is built."""
    return tuned_serve_max_batch(max(1, util.env_int("SERVE_MAX_BATCH", 8)))


def tuned_serve_spec_gamma(default: int) -> int:
    v = _tuned("serve_spec_gamma")
    return default if v is None else max(1, int(v))


def current_serve_spec_gamma() -> int:
    """The live speculative draft length: HOROVOD_SERVE_SPEC_GAMMA (4), or
    the tuner's.  Read once when a server is built (it is the verify
    chunk's width)."""
    return tuned_serve_spec_gamma(
        max(1, util.env_int("SERVE_SPEC_GAMMA", 4)))


def tuned_serve_flightrec_depth(default: int) -> int:
    v = _tuned("serve_flightrec_depth")
    return default if v is None else max(1, int(v))


def current_serve_flightrec_depth() -> int:
    """The live flight-recorder ring depth: HOROVOD_SERVE_FLIGHTREC_DEPTH
    (512 events; <= 0 turns the recorder off, whatever the tuner says),
    or the tuner's."""
    env = util.env_int("SERVE_FLIGHTREC_DEPTH", 512)
    if env <= 0:
        return 0
    return tuned_serve_flightrec_depth(env)


def current_serve_pool_pages() -> int:
    """KV-pool size in pages: HOROVOD_SERVE_POOL_PAGES (0 = the server
    sizes the pool to max_batch full-length sequences).  Not a tuner
    knob: the pool's size is a capacity decision."""
    return max(0, util.env_int("SERVE_POOL_PAGES", 0))


def tuned_reshard_chunk_bytes(default: int) -> int:
    v = _tuned("reshard_chunk_bytes")
    return default if v is None else max(1, int(v))


def current_reshard_chunk_bytes() -> int:
    """The live reshard chunk-grid cell size: HOROVOD_RESHARD_CHUNK_BYTES
    (0 = the tuner's value, 4 MiB without it), before the executor's
    clamp to HOROVOD_RESHARD_PEAK_BYTES / 4 (`parallel/reshard.py`)."""
    env = util.env_int("RESHARD_CHUNK_BYTES", 0)
    if env > 0:
        return env
    return tuned_reshard_chunk_bytes(4 << 20)
