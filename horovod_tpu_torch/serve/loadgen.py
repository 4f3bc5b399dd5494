"""Seeded load generation and bench accounting for the serving stack.

Counterpart of `horovod_tpu/serve/loadgen.py`.  ``make_trace`` produces
a deterministic mixed-length request trace, (arrival_step, prompt,
max_new_tokens) tuples from a seeded `np.random.RandomState` over a few
discrete prompt lengths, bitwise the JAX package's for the same
arguments (as is ``make_shaped_trace``).  ``run_trace`` replays a trace
against an ``InferenceServer``, submitting each request when the
server's step clock reaches its arrival, and returns the stats record.
The same trace replayed against ``policy="fifo"`` and
``policy="static"`` servers is the continuous-vs-static A/B
(`serve_benchmark.py`).  The JAX package's BENCH_serve.json records are
its own; the port writes none.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np

from ..common.exceptions import InvalidRequestError
from ..metrics import catalog as _met
from .server import InferenceServer


#: Flat traces are 3-tuples; shaped traces append the tenant SLO class
#: as a 4th element.  Every consumer (`run_trace`, the autoscale bench,
#: the chaos soak) accepts either arity.
Trace = List[Tuple[int, np.ndarray, int]]

SHAPES = ("diurnal", "burst", "multi_tenant")

#: Tenant mix used when a shaped trace tags classes itself:
#: (class, weight).  Priorities live in scheduler.DEFAULT_TENANT_PRIORITY.
TENANT_MIX = (("premium", 0.2), ("standard", 0.5), ("batch", 0.3))


def make_trace(seed: int, n_requests: int, vocab_size: int,
               prompt_lens: Tuple[int, ...] = (8, 16, 32),
               max_new_lo: int = 8, max_new_hi: int = 64,
               long_frac: float = 0.0, long_lo: int = 0,
               long_hi: int = 0,
               arrival_every: float = 2.0) -> Trace:
    """Mixed-length trace: request i arrives at step
    ``round(i * arrival_every)`` with a seeded prompt length and token
    budget.  Pure function of its arguments — replaying the same seed
    gives byte-identical traces (the determinism anchor for the
    scheduler tests and the A/B bench).

    ``long_frac`` > 0 makes the budget distribution BIMODAL: that
    fraction of requests draws from [long_lo, long_hi] instead — the
    realistic serving mix (mostly short answers, a tail of long
    generations) where wave batching wastes the most, because one long
    request pins every row of its wave."""
    if n_requests < 1:
        raise InvalidRequestError(
            f"n_requests must be >= 1, got {n_requests}")
    if not 0.0 <= long_frac <= 1.0:
        raise InvalidRequestError(
            f"long_frac must be in [0, 1], got {long_frac}")
    rng = np.random.RandomState(seed)
    trace: Trace = []
    for i in range(n_requests):
        T0 = int(rng.choice(prompt_lens))
        if long_frac and rng.random_sample() < long_frac:
            mn = int(rng.randint(long_lo, long_hi + 1))
        else:
            mn = int(rng.randint(max_new_lo, max_new_hi + 1))
        prompt = rng.randint(0, vocab_size, size=T0).astype(np.int32)
        trace.append((int(round(i * arrival_every)), prompt, mn))
    return trace


def _tag_classes(rng: "np.random.RandomState", n: int) -> List[str]:
    names = [c for c, _ in TENANT_MIX]
    weights = np.asarray([w for _, w in TENANT_MIX], np.float64)
    weights /= weights.sum()
    return [str(rng.choice(names, p=weights)) for _ in range(n)]


def make_shaped_trace(shape: str, seed: int, n_requests: int,
                      vocab_size: int,
                      prompt_lens: Tuple[int, ...] = (8, 16, 32),
                      max_new_lo: int = 8, max_new_hi: int = 64,
                      base_every: float = 4.0,
                      period: int = 256, amplitude: float = 0.9,
                      burst_every: int = 64, burst_size: int = 12
                      ) -> Trace:
    """Seeded traffic SHAPES for the autoscale bench and the chaos
    soak — 4-tuples ``(arrival_step, prompt, max_new_tokens,
    slo_class)``, deterministic per (shape, seed, args):

      - ``diurnal``       arrival rate rides a sinusoid with the given
                          ``period`` and ``amplitude`` around the base
                          rate ``1/base_every`` — the day/night cycle
                          that makes a static fleet either waste chips
                          at the trough or violate SLOs at the peak.
      - ``burst``         steady base arrivals plus a ``burst_size``
                          clump every ``burst_every`` steps — the
                          flash crowd; hysteresis/dwell tuning is
                          exactly the question of which bursts are
                          worth a scale event.
      - ``multi_tenant``  the TENANT_MIX classes with distinct
                          behaviours: premium arrives steadily,
                          standard diurnally, batch in bulk clumps —
                          the trace that exercises priority shedding.

    Tenant tags come from the same seeded RNG for every shape, so the
    scheduler's shed order is replayable."""
    if shape not in SHAPES:
        raise InvalidRequestError(
            f"shape must be one of {SHAPES}, got {shape!r}")
    if n_requests < 1:
        raise InvalidRequestError(
            f"n_requests must be >= 1, got {n_requests}")
    rng = np.random.RandomState(seed)
    arrivals: List[int] = []
    classes: List[str] = []
    if shape == "diurnal":
        base_rate = 1.0 / max(1e-9, base_every)
        acc, t = 0.0, 0
        while len(arrivals) < n_requests:
            rate = base_rate * (1.0 + amplitude
                                * math.sin(2.0 * math.pi * t / period))
            acc += max(0.0, rate)
            while acc >= 1.0 and len(arrivals) < n_requests:
                arrivals.append(t)
                acc -= 1.0
            t += 1
        classes = _tag_classes(rng, n_requests)
    elif shape == "burst":
        t, i = 0, 0
        acc = 0.0
        while i < n_requests:
            if t and t % burst_every == 0:
                for _ in range(min(burst_size, n_requests - i)):
                    arrivals.append(t)
                    i += 1
            acc += 1.0 / max(1e-9, base_every)
            while acc >= 1.0 and i < n_requests:
                arrivals.append(t)
                acc -= 1.0
                i += 1
            t += 1
        arrivals.sort()
        classes = _tag_classes(rng, n_requests)
    else:                               # multi_tenant
        n_prem = max(1, int(0.2 * n_requests))
        n_std = max(1, int(0.5 * n_requests))
        n_batch = max(0, n_requests - n_prem - n_std)
        horizon = int(n_requests * base_every)
        tagged: List[Tuple[int, str]] = []
        # premium: evenly spaced (a steady interactive tenant)
        for k in range(n_prem):
            tagged.append((int(k * horizon / n_prem), "premium"))
        # standard: diurnal sinusoid over the same horizon
        base_rate = n_std / max(1, horizon)
        acc = 0.0
        emitted = 0
        for t in range(horizon):
            rate = base_rate * (1.0 + amplitude
                                * math.sin(2.0 * math.pi * t
                                           / max(1, period)))
            acc += max(0.0, rate)
            while acc >= 1.0 and emitted < n_std:
                tagged.append((t, "standard"))
                acc -= 1.0
                emitted += 1
        while emitted < n_std:          # remainder lands at the end
            tagged.append((horizon - 1, "standard"))
            emitted += 1
        # batch: bulk clumps (an offline tenant submitting in waves)
        n_clumps = max(1, n_batch // max(1, burst_size))
        for k in range(n_batch):
            clump = min(k // max(1, burst_size), n_clumps - 1)
            t = int((clump + 0.5) * horizon / n_clumps)
            tagged.append((t, "batch"))
        tagged.sort(key=lambda p: p[0])
        arrivals = [t for t, _ in tagged]
        classes = [c for _, c in tagged]
    trace: Trace = []
    for t, cls in zip(arrivals, classes):
        T0 = int(rng.choice(prompt_lens))
        mn = int(rng.randint(max_new_lo, max_new_hi + 1))
        prompt = rng.randint(0, vocab_size, size=T0).astype(np.int32)
        trace.append((int(t), prompt, mn, cls))
    return trace


def hist_cumulative(hist) -> List[Tuple[float, int]]:
    """Snapshot of an UNLABELED histogram's cumulative bucket counts —
    (upper_bound, cumulative_count) pairs ending with +Inf."""
    return hist._solo().cumulative()


def hist_delta_quantile(before: List[Tuple[float, int]],
                        after: List[Tuple[float, int]],
                        q: float) -> float:
    """Quantile `q` (percent) of the observations a histogram gained
    BETWEEN two `hist_cumulative` snapshots, linearly interpolated
    within the containing bucket.  Delta-based on purpose: the metrics
    registry is process-global, so an absolute read would mix every
    earlier bench rep / warmup into this rep's percentile."""
    target_total = after[-1][1] - before[-1][1]
    if target_total <= 0:
        return 0.0
    target = q / 100.0 * target_total
    lo, prev_cum = 0.0, 0
    for (ub, ca), (_, cb) in zip(after, before):
        cum = ca - cb
        if cum >= target:
            in_bucket = cum - prev_cum
            if math.isinf(ub) or not in_bucket:
                return lo
            return lo + (target - prev_cum) / in_bucket * (ub - lo)
        if not math.isinf(ub):
            lo = ub
        prev_cum = cum
    return lo


def run_trace(server: InferenceServer, trace: Trace,
              max_steps: int = 200000) -> Dict:
    """Replay a trace to completion; returns the stats record, with
    TTFT / inter-token percentiles read from the serving histograms
    (delta over this replay only)."""
    pending = sorted(range(len(trace)), key=lambda i: trace[i][0])
    hist0 = None
    if _met.enabled():
        hist0 = (hist_cumulative(_met.serve_ttft),
                 hist_cumulative(_met.serve_intertoken))
    peak_util = 0.0
    t0 = time.perf_counter()
    steps = 0
    while steps < max_steps:
        while pending and trace[pending[0]][0] <= server.step_no:
            item = trace[pending.pop(0)]
            server.submit(item[1], item[2],
                          slo_class=(item[3] if len(item) > 3
                                     else "standard"))
        if not pending and server.sched.drained():
            break
        server.step()
        peak_util = max(peak_util, server.pool.utilization())
        steps += 1
    if pending or not server.sched.drained():
        raise InvalidRequestError(
            f"trace did not drain within {max_steps} steps")
    wall_s = time.perf_counter() - t0
    server.flush_metrics()
    stats = server_stats(server, wall_s, peak_util)
    if hist0 is not None:
        ttft1 = hist_cumulative(_met.serve_ttft)
        itl1 = hist_cumulative(_met.serve_intertoken)
        stats.update({
            "ttft_p50_ms":
                hist_delta_quantile(hist0[0], ttft1, 50) * 1e3,
            "ttft_p99_ms":
                hist_delta_quantile(hist0[0], ttft1, 99) * 1e3,
            "itl_p50_ms":
                hist_delta_quantile(hist0[1], itl1, 50) * 1e3,
            "itl_p99_ms":
                hist_delta_quantile(hist0[1], itl1, 99) * 1e3,
        })
    return stats


def _pct(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), q))


def server_stats(server: InferenceServer, wall_s: float,
                 peak_util: float, n_chips: int = 1) -> Dict:
    """The run's record: tokens/sec per chip, request and per-token
    latency percentiles, TTFT percentiles from the server's own list
    (the histograms' delta percentiles are added by `run_trace` when
    metrics are on), occupancy and the pool's peak utilisation."""
    return {
        "wall_s": wall_s,
        "device_steps": server.device_steps,
        "spec_steps": server.spec_steps,
        "tokens_out": server.tokens_out,
        "tokens_per_sec_per_chip":
            server.tokens_out / wall_s / max(1, n_chips) if wall_s else 0.0,
        "request_p50_ms": _pct(server.request_latencies_ms, 50),
        "request_p99_ms": _pct(server.request_latencies_ms, 99),
        "token_p50_ms": _pct(server.token_latencies_ms, 50),
        "token_p99_ms": _pct(server.token_latencies_ms, 99),
        "ttft_list_p50_ms": _pct(server.ttft_ms, 50),
        "ttft_list_p99_ms": _pct(server.ttft_ms, 99),
        "batch_occupancy_mean": server.occupancy_mean(),
        "kv_pool_peak_utilization": peak_util,
        "slo_decisions": list(server.slo.decisions),
    }


__all__ = ["SHAPES", "TENANT_MIX", "Trace", "hist_cumulative",
           "hist_delta_quantile", "make_shaped_trace", "make_trace",
           "run_trace", "server_stats"]
