"""Chaos soak: fault-loaded fleet training with a closed-loop reaction.

Counterpart of `horovod_tpu/faults/chaos.py`.  One `ChaosSoak` trains a
real np=N fleet for HOROVOD_CHAOS_GENERATIONS generations of
HOROVOD_CHAOS_STEPS_PER_GEN steps while a seeded plan fires a rotating
mix of injections across ranks:

  straggler_delay        a per-collective slowdown on one rank, armed
                         for a block of generations; the trace reaction
                         policy must blame it and rebalance
  worker_stall           one rank sleeps at the top of a step
                         (`chaos.step`); the peers ride it out inside
                         the collective
  nan_grad               one rank's batch is poisoned; the guard's
                         sentinel skips the step on every rank
  param_bitflip          one rank's replica silently diverges; the
                         digest check catches it and every rank
                         restores the committed snapshot
  collective_abort       the next allreduce raises HorovodInternalError
                         on every rank in lockstep; all restore the
                         committed snapshot
  reshard_chunk_corrupt  a live-reshard drill publishes corrupt chunks;
                         every rank falls back to its local copy
  reshard_peer_die       a reshard peer abandons mid-publish; the same
                         all-rank fallback

After every event the soak checks that the fleet converged again (the
cross-replica parameter digests clean, or a deliberate restore of the
committed snapshot, and every rank agreeing on (generation, step,
digest)) and records its MTTR in `hvd_recovery_ms{kind}` and
`hvd_chaos_events_total{kind,outcome}`.

Each generation ends in an online analysis window (CYCLE_t marks the end
of global step t, as the optimizer's step marks it; the JAX package's
soak marks each step's start): every rank reads its
own (partial) timeline back, the fleet allgathers the window's events,
`trace.core.analyze` attributes the critical path alike on every rank,
and the measurements feed the metrics, the tuner
(`ParameterManager.record_trace`) and the `StragglerReactionPolicy`,
whose rebalance trips the fused optimizer's loud re-init ValueError at
the next step (the soak builds the optimizer again and counts it).

The model is `n_leaves` f32 vectors on hvd's device, trained eagerly
under `DistributedOptimizer(SGD, guard=DynamicLossScale(...),
fused_apply=True, fusion_threshold_bytes=512)`.  Gradients come from
`torch.autograd.grad` and are handed to the optimizer's step (stage 0
pinned: the tuner's `zero_stage` knob does not move this rung), whose
bucket reductions run through the traced bracket (so the timeline has
bucket spans and `chaos.straggler_delay` lands per bucket) after its
partition check: a rebalance raises before any bucket is in flight.
The committed snapshot is host copies of the parameters, of the
optimizer's `state_dict` and of the guard's state.

Everything is deterministic from (seed, np): all ranks build the same
plan, so collective injections stay in lockstep.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import FaultInjected
from .. import faults as _faults
from ..common import util
from ..common.exceptions import HorovodInternalError

logger = logging.getLogger("horovod_tpu_torch.faults.chaos")

__all__ = ["KINDS", "ChaosEvent", "ChaosInjection", "ChaosSoak",
           "build_plan"]

#: Every fault kind the soak can inject, in rotation order.
KINDS = (
    "straggler_delay",
    "worker_stall",
    "nan_grad",
    "param_bitflip",
    "collective_abort",
    "reshard_chunk_corrupt",
    "reshard_peer_die",
)
_ROTATION = tuple(k for k in KINDS if k != "straggler_delay")


@dataclasses.dataclass(frozen=True)
class ChaosInjection:
    """One planned injection: fire `kind` at (generation, step) against
    `target` (-1: every rank, the lockstep collective abort)."""
    gen: int
    step: int
    kind: str
    target: int


@dataclasses.dataclass
class ChaosEvent:
    """One injection's measured outcome."""
    kind: str
    gen: int
    step: int
    target: int
    outcome: str        # "recovered" | "degraded" | "skipped"
    mttr_ms: float
    steps_lost: int = 0
    detail: str = ""


def build_plan(generations: int, steps_per_gen: int, n: int,
               seed: int = 0, straggler_gens: int = 0,
               kinds=_ROTATION) -> List[ChaosInjection]:
    """The soak's plan.  The straggler block takes the first
    `straggler_gens` generations alone (its delay stays armed, which a
    one-shot event would clobber); the later generations cycle through
    `kinds`, two injections a generation at an early and a middle step,
    targets from a seeded RNG, one full rotation at most.  Every rank
    builds the same plan from (seed, n)."""
    rng = random.Random(f"chaos:{seed}:{n}")
    plan: List[ChaosInjection] = []
    straggler_gens = min(straggler_gens, generations)
    if straggler_gens > 0 and n > 1:
        target = rng.randrange(n)
        plan.append(ChaosInjection(0, 0, "straggler_delay", target))
    slots = [1] if steps_per_gen < 4 else [1, steps_per_gen - 2]
    ki = 0
    for g in range(straggler_gens, generations):
        for s in slots:
            if ki >= len(kinds) * 2:
                break  # one full rotation; the tail generations stay clean
            kind = kinds[ki % len(kinds)]
            ki += 1
            target = -1 if kind == "collective_abort" else rng.randrange(n)
            plan.append(ChaosInjection(g, s, kind, target))
    return plan


def _host(t):
    return t.detach().to("cpu", copy=True)


class ChaosSoak:
    """One fault-loaded training soak (module docstring).  Build it on
    every rank of an initialized fleet and `run()`; the result is JSON
    serializable (the rank main writes it, `bench.py --chaos`
    aggregates the MTTRs)."""

    def __init__(
        self,
        generations: Optional[int] = None,
        steps_per_gen: Optional[int] = None,
        seed: int = 0,
        straggler_gens: Optional[int] = None,
        straggler_delay_ms: int = 20,
        stall_ms: int = 250,
        dim: int = 64,
        n_leaves: int = 8,
        local_batch: int = 4,
        lr: float = 0.05,
        fusion_threshold_bytes: int = 512,
        reshard_timeout: float = 8.0,
        kinds=_ROTATION,
    ):
        self.generations = (util.env_int("CHAOS_GENERATIONS", 8)
                            if generations is None else int(generations))
        self.steps_per_gen = (util.env_int("CHAOS_STEPS_PER_GEN", 6)
                              if steps_per_gen is None
                              else int(steps_per_gen))
        if self.steps_per_gen < 2:
            raise ValueError("chaos soak needs >= 2 steps per generation")
        self.seed = int(seed)
        self.straggler_gens = straggler_gens
        self.straggler_delay_ms = int(straggler_delay_ms)
        self.stall_ms = int(stall_ms)
        self.dim = int(dim)
        self.n_leaves = int(n_leaves)
        self.local_batch = int(local_batch)
        self.lr = float(lr)
        self.fusion_threshold_bytes = int(fusion_threshold_bytes)
        self.reshard_timeout = float(reshard_timeout)
        self.kinds = tuple(kinds)
        self.events: List[ChaosEvent] = []
        self.windows: List[dict] = []
        self.reactions: List[dict] = []
        self.loud_reinits = 0
        self._drill_seq = 0

    # -- bookkeeping -----------------------------------------------------
    def _record(self, kind: str, gen: int, step: int, target: int,
                outcome: str, t0: float, steps_lost: int = 0,
                detail: str = "") -> ChaosEvent:
        from ..metrics import catalog as _met
        mttr = (time.perf_counter() - t0) * 1e3
        ev = ChaosEvent(kind=kind, gen=gen, step=step, target=target,
                        outcome=outcome, mttr_ms=round(mttr, 3),
                        steps_lost=steps_lost, detail=detail)
        self.events.append(ev)
        if _met.enabled():
            _met.chaos_events.labels(kind, outcome).inc()
            _met.recovery_ms.labels(kind).set(ev.mttr_ms)
        logger.warning("chaos event %s g%d s%d target=%d -> %s (MTTR %.1f "
                       "ms, %d steps lost) %s", kind, gen, step, target,
                       outcome, ev.mttr_ms, steps_lost, detail)
        return ev

    # -- recovery verification -------------------------------------------
    def _digest_mismatch(self, w) -> Optional[int]:
        from ..guard import digest as _gdigest
        return _gdigest.check_replica_divergence(
            _gdigest.param_digests(list(w.values())))

    def _digest_head(self, w) -> str:
        from ..guard import digest as _gdigest
        return str(_gdigest.param_digests(list(w.values()))[0])[:16]

    # -- timeline window -------------------------------------------------
    @staticmethod
    def _timeline_path(rank: int) -> Optional[str]:
        import os
        base = util.getenv("TIMELINE")
        if not base:
            return None
        if rank != 0 and util.env_bool("TIMELINE_ALL_RANKS", False):
            stem, ext = os.path.splitext(base)
            return f"{stem}.rank{rank}{ext or '.json'}"
        return base if rank == 0 else None

    @staticmethod
    def _window_events(events: List[dict], lo: int, hi: int) -> List[dict]:
        """The window's slice of one rank's timeline: CYCLE instants
        lo-1..hi (step n's critical path needs the n-1 boundary) and the
        collective spans whose issue-step stamp is in the window (the
        stamp is the completed-cycle count: steps lo..hi carry stamps
        lo-1..hi-1)."""
        out = []
        for ev in events:
            name = str(ev.get("name", ""))
            if ev.get("ph") == "i" and name.startswith("CYCLE_"):
                try:
                    c = int(name[6:])
                except ValueError:
                    continue
                if lo - 1 <= c <= hi:
                    out.append(ev)
            elif ev.get("ph") == "X" and ev.get("cat") == "collective":
                st = ev.get("step")
                if st is not None and lo - 1 <= int(st) <= hi - 1:
                    out.append(ev)
        return out

    def _analyze_window(self, rank: int, n: int, lo: int, hi: int):
        """The merged trace's analysis of global steps [lo, hi], the same
        on every rank (the same allgathered events, the same float
        math), so that the reaction and the tuner decide in lockstep."""
        from ..ops import functions as F
        from ..trace import core as _tcore
        from ..trace.measure import TraceMeasurements
        path = self._timeline_path(rank)
        if path is None:
            return None
        time.sleep(0.05)  # let the writer thread drain its queue
        try:
            mine = self._window_events(_tcore.load_events(path), lo, hi)
        except (OSError, ValueError):
            mine = []
        per_rank = F.allgather_object(mine)
        report = _tcore.analyze({r: evs for r, evs in enumerate(per_rank)})
        return TraceMeasurements.from_report(report)

    # -- reshard drill ---------------------------------------------------
    def _reshard_drill(self, inj: ChaosInjection, rank: int, n: int,
                       w: Dict[str, Any]) -> None:
        """A same-N identity reshard of the flat parameters through the
        launch's rendezvous KV with `reshard.chunk_corrupt` or
        `reshard.peer_die` armed on the target: every rank must fall
        back alike to its local copy (the parameters are replicated: the
        local copy is the checkpoint), then the fleet is digest-checked."""
        from ..ops import functions as F
        from ..parallel import reshard as rs
        t0 = time.perf_counter()
        self._drill_seq += 1
        if n < 2 or not util.getenv("RENDEZVOUS_ADDR"):
            self._record(inj.kind, inj.gen, inj.step, inj.target, "skipped",
                         t0, detail="no KV transport")
            return
        transport = rs.KVTransport.from_env(f"chaos{self._drill_seq - 1}")
        flat = np.concatenate([_host(v).numpy().astype(np.float32).ravel()
                               for v in w.values()])
        spec = rs.StreamSpec("chaosw", int(flat.size), "float32", "shard")
        lo, hi = rs._owned_range(flat.size, n, rank)
        local = {"chaosw": flat[lo:hi].copy()}
        point = ("reshard.chunk_corrupt"
                 if inj.kind == "reshard_chunk_corrupt"
                 else "reshard.peer_die")
        if rank == inj.target:
            _faults.install(f"{point}:err", seed=self.seed)
        degraded = False
        detail = ""
        try:
            out, _ = rs.reshard_streams(
                [spec], local, n, n, rank, rank, transport,
                tag=f"drill{self._drill_seq}", chunk_bytes=256,
                timeout=self.reshard_timeout)
            # Success means the armed fault never fired: still check the
            # payload came back bitwise.
            ok = np.array_equal(out["chaosw"], local["chaosw"])
            detail = f"reshard completed (bitwise={ok})"
        except (rs.ReshardError, FaultInjected) as e:
            degraded = True
            detail = f"{type(e).__name__}: fell back to local copy"
        finally:
            if rank == inj.target:
                _faults.clear()
        # The drill moved a copy, so the parameters were never touched:
        # the fleet must still be digest-clean and agree it degraded.
        verdicts = F.allgather_object(degraded)
        mism = self._digest_mismatch(w)
        if all(verdicts) and mism is None:
            self._record(inj.kind, inj.gen, inj.step, inj.target,
                         "recovered", t0, detail=detail)
        else:
            self._record(inj.kind, inj.gen, inj.step, inj.target,
                         "degraded", t0, detail=f"{detail}; verdicts="
                         f"{verdicts} mismatch={mism}")

    # -- the soak --------------------------------------------------------
    def run(self) -> dict:
        import torch

        import horovod_tpu_torch as hvd
        from ..metrics import anomaly as _anomaly
        from ..metrics import budget as _budget
        from ..metrics import catalog as _met
        from ..ops import functions as F
        from ..trace.reaction import StragglerReactionPolicy
        from ..utils import autotune as _at
        from ..utils import timeline as _tl

        if not hvd.is_initialized():
            hvd.init()
        rank, n = hvd.rank(), hvd.size()
        dev = hvd.device()
        policy = StragglerReactionPolicy()
        straggler_gens = self.straggler_gens
        if straggler_gens is None:
            # Long enough to build the blame streak, react, cool down and
            # measure one settled window after the reaction.
            straggler_gens = min(self.generations - 1,
                                 policy.patience + policy.cooldown + 1)
        plan = build_plan(self.generations, self.steps_per_gen, n,
                          seed=self.seed, straggler_gens=straggler_gens,
                          kinds=self.kinds)
        by_step: Dict[tuple, List[ChaosInjection]] = {}
        straggler_target = -1
        for inj in plan:
            if inj.kind == "straggler_delay":
                straggler_target = inj.target
            else:
                by_step.setdefault((inj.gen, inj.step), []).append(inj)

        # The anomaly monitor's recall: each step's wall time feeds the
        # z-score detector under the series the runtime publishes it as
        # (hvd_critical_path_ms), the step counter the stall detector;
        # after the soak every trip is matched to the injection (or the
        # armed straggler block) it landed on, and a trip on a clean step
        # is a false positive.
        monitor = _anomaly.AnomalyMonitor()
        step_slo_ms = util.env_float("SLO_STEP_MS", 0.0)
        train_budget = (_budget.SloBudget("train_step")
                        if step_slo_ms > 0 else None)
        inj_steps: Dict[int, List[str]] = {}
        for inj in plan:
            if inj.kind != "straggler_delay":
                g_step = inj.gen * self.steps_per_gen + inj.step + 1
                inj_steps.setdefault(g_step, []).append(inj.kind)

        # -- model, optimizer and guard ------------------------------------
        keys = [f"p{i:02d}" for i in range(self.n_leaves)]
        host = np.random.RandomState(0)
        true_w = {k: host.uniform(-1, 1, (self.dim,)).astype(np.float32)
                  for k in keys}
        x_all = host.uniform(-1, 1, (n * self.local_batch,
                                     self.dim)).astype(np.float32)
        rows = slice(rank * self.local_batch, (rank + 1) * self.local_batch)
        x_local = torch.from_numpy(x_all[rows].copy()).to(dev)
        y_local = {k: torch.from_numpy((x_all @ true_w[k])[rows].copy())
                   .to(dev) for k in keys}

        scaler = hvd.DynamicLossScale(init_scale=256.0,
                                      growth_interval=100000)
        w = {k: torch.zeros((self.dim,), dtype=torch.float32, device=dev,
                            requires_grad=True) for k in keys}
        sgd = torch.optim.SGD(list(w.values()), lr=self.lr)

        def make_opt():
            return hvd.DistributedOptimizer(
                sgd, named_parameters=list(w.items()), guard=scaler,
                fused_apply=True, zero_stage=0,
                fusion_threshold_bytes=self.fusion_threshold_bytes)

        opt = make_opt()
        guard = hvd.TrainingGuard(scaler=scaler, digest_interval=0,
                                  max_nonfinite=100)

        def grads_of(x, y, scale):
            loss = sum(torch.mean((x @ w[k] - y[k]) ** 2) for k in keys)
            return torch.autograd.grad(loss * scale, list(w.values()))

        def update(grads):
            """The step: the optimizer's per-bucket reduce and fused
            apply.  A partition change (a reaction's rebalance, a tuner
            proposal) trips the loud re-init contract: build the
            optimizer again and retry, counting it."""
            nonlocal opt
            for p, g in zip(w.values(), grads):
                p.grad = g
            try:
                opt.step()
            except ValueError as e:
                if "re-init the optimizer state" not in str(e):
                    raise
                self.loud_reinits += 1
                logger.warning("loud re-init #%d: %s", self.loud_reinits, e)
                opt = make_opt()
                for p, g in zip(w.values(), grads):
                    p.grad = g
                opt.step()
            finally:
                for p in w.values():
                    p.grad = None

        def snap():
            gs = opt.guard_state
            return ({k: _host(v) for k, v in w.items()},
                    type(gs)(*(_host(t) for t in gs)))

        def thaw(saved):
            with torch.no_grad():
                for k, v in saved[0].items():
                    w[k].copy_(v)
            opt.guard_state = type(saved[1])(*(t.to(dev) for t in saved[1]))
            opt.reset_step_state()

        pm = _at.get_manager()
        tl = _tl.get_timeline()
        committed = (snap(), 0)
        pending_nan: Optional[dict] = None
        pending_flip: Optional[dict] = None
        split_brain = False
        t = 0

        for g in range(self.generations):
            gen_lo = t + 1
            straggling = straggler_target >= 0 and g < straggler_gens
            if straggling and g == 0 and rank == straggler_target:
                _faults.install(f"chaos.straggler_delay:delay:"
                                f"{self.straggler_delay_ms}ms",
                                seed=self.seed)
            for s in range(self.steps_per_gen):
                t += 1
                step_t0 = time.perf_counter()
                injs = by_step.get((g, s), ())
                stall = next((i for i in injs
                              if i.kind == "worker_stall"), None)
                stall_t0 = time.perf_counter()
                if stall is not None and rank == stall.target:
                    _faults.install(f"chaos.step:delay:{self.stall_ms}ms",
                                    seed=self.seed)
                if _faults.active():
                    try:
                        _faults.point("chaos.step")
                    except FaultInjected:
                        pass  # an err-mode step failure rides into recovery
                if stall is not None and rank == stall.target:
                    _faults.clear()

                nan = next((i for i in injs if i.kind == "nan_grad"), None)
                flip = next((i for i in injs
                             if i.kind == "param_bitflip"), None)
                armed_guard = False
                if nan is not None and rank == nan.target:
                    _faults.install("guard.nan_grad@1:err", seed=self.seed)
                    armed_guard = True
                if flip is not None and rank == flip.target:
                    _faults.install("guard.param_bitflip@1:err",
                                    seed=self.seed)
                    armed_guard = True
                batch = {"x": x_local, "y": y_local}
                batch, _ = guard.maybe_inject(batch, w)
                if armed_guard:
                    _faults.clear()
                if nan is not None:
                    pending_nan = {"inj": nan, "t0": time.perf_counter(),
                                   "flagged": 0}
                if flip is not None:
                    pending_flip = {"inj": flip, "t0": time.perf_counter()}

                abort = next((i for i in injs
                              if i.kind == "collective_abort"), None)
                abort_t0 = time.perf_counter()
                if abort is not None:
                    _faults.install("collective.allreduce@1:err",
                                    seed=self.seed)
                scale = float(opt.guard_state.loss_scale)
                grads = grads_of(batch["x"], batch["y"], scale)
                try:
                    update(grads)
                    failed = False
                except HorovodInternalError:
                    failed = True
                    # The optimizer's step marks each step's cycle as it
                    # ends (`data_parallel.record_step`); a step that
                    # raised marks none, so the soak marks it.
                    if tl is not None:
                        tl.mark_cycle()
                if abort is not None:
                    _faults.clear()
                    # The abort hit every rank: restore the committed
                    # snapshot fleet-wide and check.
                    thaw(committed[0])
                    mism = self._digest_mismatch(w)
                    self._record(
                        "collective_abort", g, s, -1,
                        "recovered" if (failed and mism is None)
                        else "degraded", abort_t0,
                        steps_lost=t - committed[1],
                        detail=f"raised={failed} mismatch={mism}")
                elif failed:
                    raise HorovodInternalError(
                        f"unplanned collective failure in chaos soak at "
                        f"g{g} s{s}")

                v = guard.observe(opt, w, t)
                if stall is not None:
                    # The step completed: the fleet rode the stall out
                    # inside the step's first collective.
                    self._record("worker_stall", g, s, stall.target,
                                 "recovered", stall_t0)
                if pending_nan is not None:
                    if v.flagged:
                        pending_nan["flagged"] += 1
                    elif pending_nan["flagged"] > 0:
                        inj = pending_nan["inj"]
                        self._record(
                            "nan_grad", inj.gen, inj.step, inj.target,
                            "recovered", pending_nan["t0"],
                            steps_lost=pending_nan["flagged"],
                            detail=f"loss scale {v.loss_scale:g} after "
                                   "lockstep skip")
                        pending_nan = None
                    elif t - (pending_nan["inj"].gen
                              * self.steps_per_gen) > 2 * self.steps_per_gen:
                        inj = pending_nan["inj"]
                        self._record("nan_grad", inj.gen, inj.step,
                                     inj.target, "degraded",
                                     pending_nan["t0"],
                                     detail="sentinel never flagged")
                        pending_nan = None
                if pending_flip is not None:
                    mism = self._digest_mismatch(w)
                    if mism is not None:
                        inj = pending_flip["inj"]
                        thaw(committed[0])
                        clean = self._digest_mismatch(w)
                        self._record(
                            "param_bitflip", inj.gen, inj.step, inj.target,
                            "recovered" if clean is None else "degraded",
                            pending_flip["t0"], steps_lost=t - committed[1],
                            detail=f"digest bucket {mism}; restored "
                                   f"committed step {committed[1]}")
                        pending_flip = None

                for inj in injs:
                    if inj.kind in ("reshard_chunk_corrupt",
                                    "reshard_peer_die"):
                        self._reshard_drill(inj, rank, n, w)

                step_ms = (time.perf_counter() - step_t0) * 1e3
                # A generation's first step pays the rotation's overhead,
                # which dwarfs the faults: only steady-state steps train
                # (and trip) the detector.
                if s != 0:
                    monitor.observe("hvd_critical_path_ms", step_ms, step=t)
                monitor.observe_counter("hvd_steps_total", float(t), step=t)
                if train_budget is not None:
                    train_budget.record_latency(step_ms, step_slo_ms)

            # -- end of generation: the window's analysis, then commit ----
            if (straggling and g == straggler_gens - 1
                    and rank == straggler_target):
                _faults.clear()
            m = self._analyze_window(rank, n, gen_lo, t)
            decision = policy.observe(m) if m is not None else None
            if decision is not None and decision.fired:
                self.reactions.append({
                    "gen": g, "action": decision.action,
                    "rank": decision.rank, "streak": decision.streak,
                    "skew_share": decision.skew_share,
                    "reason": decision.reason})
            if m is not None:
                m.apply_to_metrics()
                if pm is not None:
                    m.feed_autotune(pm, items_per_step=self.local_batch * n)
            best = samples = None
            if pm is not None:
                _, brate = pm._bo.best
                best = None if brate == float("-inf") else round(brate, 3)
                samples = len(pm._bo._ys)
            self.windows.append({
                "gen": g,
                "steps": [gen_lo, t],
                "straggler_armed": bool(straggling),
                "skew_share": (round(m.skew_share, 4)
                               if m is not None else None),
                "wait_ms_per_step": (round(m.wait_ms_per_step, 3)
                                     if m is not None else None),
                "straggler_rank": (m.straggler_rank
                                   if m is not None else None),
                "critical_path_ms": (round(m.critical_path_ms, 3)
                                     if m is not None else None),
                "reaction": (decision.action
                             if decision is not None else "none"),
                "autotune_best": best,
                "autotune_samples": samples,
            })
            if _met.enabled():
                _met.chaos_generations.set(g + 1)
            if train_budget is not None:
                train_budget.export()

            mism = self._digest_mismatch(w)
            if mism is None:
                committed = (snap(), t)
            else:
                # A corruption slipped past the per-step checks (a flip
                # on the last step): restore loudly.
                thaw(committed[0])
                self._record("param_bitflip", g, self.steps_per_gen - 1, -1,
                             "recovered", time.perf_counter(),
                             steps_lost=t - committed[1],
                             detail=f"window digest bucket {mism}")
            fleet = F.allgather_object((g, t, self._digest_head(w)))
            if any(f != fleet[0] for f in fleet[1:]):
                split_brain = True
                logger.error("split brain at g%d: %s", g, fleet)

        _faults.clear()
        final_mism = self._digest_mismatch(w)

        # -- the sensors' recall: attribute every anomaly trip ------------
        straggler_steps = (
            set(range(1, straggler_gens * self.steps_per_gen + 1))
            if straggler_target >= 0 else set())
        injected_kinds = {k for ks in inj_steps.values() for k in ks}
        if straggler_steps:
            injected_kinds.add("straggler_delay")
        detections: List[dict] = []
        detected_kinds: set = set()
        false_positives = 0
        for a in monitor.events:
            st = a.step or 0
            # A spike lands on the injection's step; its recovery tail
            # may spill one step.
            kinds_here = inj_steps.get(st) or inj_steps.get(st - 1)
            if kinds_here:
                matched = kinds_here[0]
            elif st in straggler_steps:
                matched = "straggler_delay"
            else:
                matched = None
                false_positives += 1
            if matched is not None:
                detected_kinds.add(matched)
            detections.append({
                "step": st, "series": a.series, "kind": a.kind,
                "score": a.score, "value": round(a.value, 3),
                "matched": matched})

        return {
            "rank": rank,
            "np": n,
            "generations": self.generations,
            "steps_per_gen": self.steps_per_gen,
            "total_steps": t,
            "seed": self.seed,
            "plan": [dataclasses.asdict(i) for i in plan],
            "events": [dataclasses.asdict(e) for e in self.events],
            "kinds_injected": sorted({e.kind for e in self.events}),
            "windows": self.windows,
            "reactions": self.reactions,
            "loud_reinits": self.loud_reinits,
            "split_brain": split_brain,
            "final_digest_mismatch": final_mism,
            "final_w": {k: _host(v).tolist() for k, v in w.items()},
            "straggler_target": straggler_target,
            "straggler_gens": straggler_gens,
            "autotune_enabled": pm is not None,
            "anomaly": {
                "z_thresh": monitor.z_thresh,
                "events": detections,
                "detected_kinds": sorted(detected_kinds),
                "injected_kinds": sorted(injected_kinds),
                "false_positives": false_positives,
                "recall": round(len(detected_kinds & injected_kinds)
                                / max(1, len(injected_kinds)), 3),
            },
        }
