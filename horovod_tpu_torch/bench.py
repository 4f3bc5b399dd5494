"""Headline benchmark of the port: the zoo's synthetic step through
horovod.torch against torch's own two ways of taking the same step.

Counterpart of the headline of `bench.py` (`run_bench`, `build_step`):
ResNet-50 by default (`--model` takes any zoo name), synthetic data made
from a seed per rank, SGD with momentum (lr 0.0125, momentum 0.9),
train-mode batch norm with its statistics local to each rank, bf16
compute with f32 weights.  Three rows take that step on the same model
(the same seed), data and optimizer, each on a model of its own:

- `hvd`: the optimizer wrapped in `hvd.DistributedOptimizer` after
  `broadcast_parameters` / `broadcast_optimizer_state`;
- `plain`: the bare `torch.optim` optimizer, no framework;
- `ddp`: the model wrapped in `torch.nn.parallel.DistributedDataParallel`
  on the port's own process group, `broadcast_buffers=False` (batch-norm
  statistics stay local, as here) and `bucket_cap_mb` the fusion
  threshold in force.

The rows' timed iterations run in turns (hvd, plain, ddp, hvd, ...).
One JSON line on stdout: `value` (img/sec per rank of the hvd row),
`plain`, `ddp`, `vs_baseline = value / plain`, `vs_ddp = value / ddp`,
and per row its mean, ±1.96σ over the iterations, its idle share of the
card from a `--profile` trace and its parameters' SHA-256 after the run.

Without a coordinator in the environment the bench makes a one-rank one
of its own, so that DDP has a process group: at one rank the port's
collectives exchange nothing while DDP's reducer still runs, and that
cost is what `vs_ddp` measures there.  The JAX bench's simulated
eight-device scaling efficiency has no counterpart: one card cannot
measure scaling.  Nor does it fall back: with no card and no
`--device cpu` it raises and prints no number.

Run:  python -m horovod_tpu_torch.bench
      python -m horovod_tpu_torch.bench --model vgg16 --batch-size 32
Multi-process: HOROVOD_COORDINATOR_ADDR, HOROVOD_NUM_PROCESSES and
HOROVOD_PROCESS_ID per rank, as for the synthetic benchmark; rank 0
prints the line.

Two extras (the JAX bench's, :440-601), each in child processes of its
own, print one JSON line each and write no file:

- `--reshard`: a live reshard 2->1 of two old ranks' ZeRO-3 rows (two
  groups of 2^19 f32, 4 MB in all, made on the card from a seed) through
  the in-memory transport under the default peak, against a checkpoint
  save, restore and local restack of the same rows: both wall times, the
  measured staging peak, the chunks, and whether the two agree bitwise.
- `--chaos`: one fault-loaded `ChaosSoak` (faults/chaos.py) at np =
  HOROVOD_BENCH_CHAOS_NP (2) under the port's launcher: MTTR p50 / p99
  of the recovered events, steps lost per injection, the reactions, the
  tuner's final best and the invariants' flags.

Their times come from the card (`--device cpu` runs them on the host).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import util
from horovod_tpu_torch.models import zoo_build, zoo_models
from horovod_tpu_torch.synthetic_benchmark import param_digest, \
    profile_summary
from horovod_tpu_torch.utils.autotune import current_fusion_threshold

ROWS = ("hvd", "plain", "ddp")


class _Row:
    """One way of taking the step: its model, optimizer and step."""

    def __init__(self, kind: str, args, dev: torch.device):
        self.kind = kind
        self.model = zoo_build(args.model, args.num_classes,
                               compute_dtype=torch.bfloat16, seed=0,
                               image_size=args.image_size).to(dev)
        self.model.train()
        opt = torch.optim.SGD(self.model.parameters(), lr=0.0125,
                              momentum=0.9)
        self.net = self.model
        if kind == "hvd":
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=self.model.named_parameters())
            hvd.broadcast_parameters(self.model.state_dict(), root_rank=0)
            hvd.broadcast_optimizer_state(opt, root_rank=0)
        elif kind == "ddp":
            self.net = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=[dev] if dev.type == "cuda" else None,
                broadcast_buffers=False,
                bucket_cap_mb=current_fusion_threshold() / 2 ** 20)
        self.opt = opt
        self.img_secs = []
        self.profiled = None

    def step(self, x, y) -> None:
        self.opt.zero_grad(set_to_none=True)
        F.cross_entropy(self.net(x), y).backward()
        self.opt.step()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> dict:
    """The three rows on an initialized runtime; returns the result
    line (on every rank)."""
    dev = hvd.device()
    if dev.type == "cuda":
        # f32 work (batch-norm statistics, the optimizer) in full
        # precision, as the synthetic benchmark.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(hvd.rank())
    x = torch.rand((args.batch_size, 3, args.image_size, args.image_size),
                   generator=g).to(dev)
    y = torch.randint(0, args.num_classes, (args.batch_size,),
                      generator=g).to(dev)
    rows = [_Row(kind, args, dev) for kind in ROWS]
    for row in rows:
        for _ in range(args.num_warmup_batches):
            row.step(x, y)
        _sync(dev)
    for _ in range(args.num_iters):
        for row in rows:
            t0 = time.perf_counter()
            for _ in range(args.num_batches_per_iter):
                row.step(x, y)
            _sync(dev)
            row.img_secs.append(args.batch_size * args.num_batches_per_iter
                                / (time.perf_counter() - t0))
    if args.profile:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        for row in rows:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(args.profile):
                    row.step(x, y)
                _sync(dev)
                wall = time.perf_counter() - t0
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    trace = json.load(f)
            row.profiled = profile_summary(trace, wall, args.profile,
                                           on_card=dev.type == "cuda")
    out = {}
    for row in rows:
        mean = float(np.mean(row.img_secs))
        out[row.kind] = {
            "img_sec": mean, "ci95": 1.96 * float(np.std(row.img_secs)),
            "img_secs": row.img_secs,
            "idle_share": (row.profiled or {}).get("device_idle_share"),
            "device_busy_ms_per_step": (row.profiled or {}).get(
                "device_busy_ms_per_step"),
            "digest": param_digest(row.model)}
    value, plain, ddp = (out[k]["img_sec"] for k in ROWS)
    return {
        "metric": f"{args.model}_synthetic_img_sec_per_rank",
        "value": value, "unit": "img/sec/rank", "plain": plain, "ddp": ddp,
        "vs_baseline": value / plain, "vs_ddp": value / ddp, "rows": out,
        "model": args.model, "batch_size": args.batch_size,
        "image_size": args.image_size, "size": hvd.size(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "fusion_threshold": current_fusion_threshold(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_reshard_child(device=None) -> dict:
    """The reshard extra's child: two old ranks' ZeRO-3 rows (two groups
    of 2^19 f32) on the rank's device, moved 2->1 through the in-memory
    transport under the default peak, then saved, restored and
    restacked through a checkpoint.  One JSON line."""
    from horovod_tpu_torch.parallel import reshard as rs
    from horovod_tpu_torch.utils.checkpoint import CheckpointManager

    hvd.init(device=device)
    dev = hvd.device()
    gen = torch.Generator(device="cpu").manual_seed(0)
    ge = (1 << 19, 1 << 19)
    n_old = 2
    rows = tuple(torch.randn(n_old, -(-e // n_old), generator=gen).to(dev)
                 for e in ge)
    peak = rs.default_peak_bytes()
    t = rs.LocalTransport()
    _sync(dev)
    t0 = time.perf_counter()
    for r in range(n_old):
        specs, data = rs.param_streams(rows, ge, n_old, r)
        rs.reshard_streams(specs, data, n_old, 1, r, None, t, tag="bench",
                           peak_bytes=peak)
    specs, _ = rs.param_streams(rows, ge, n_old, 0)
    streams, rep = rs.reshard_streams(specs, None, n_old, 1, None, 0, t,
                                      tag="bench", peak_bytes=peak)
    live = rs.streams_to_param_rows(streams, ge,
                                    tuple(np.float32 for _ in ge), 1, 0,
                                    device=dev)
    _sync(dev)
    live_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(0, {"rows": list(rows)})
        restored = mgr.restore(0)
        ck = tuple(torch.from_numpy(rs.reshard_shard_rows(
            r_.numpy(), e, 1)).to(dev)
            for r_, e in zip(restored["rows"], ge))
        _sync(dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
    bitwise = all(torch.equal(a, b) for a, b in zip(live, ck))
    rec = {"n_old": n_old, "n_new": 1,
           "state_bytes": int(sum(r_.numel() * 4 for r_ in rows)),
           "live_ms": round(live_ms, 2), "restore_ms": round(restore_ms, 2),
           "speedup": round(restore_ms / max(live_ms, 1e-6), 2),
           "peak_bytes": rep.peak_bytes, "peak_ceiling": peak,
           "chunks": rep.chunks, "bitwise_vs_restore": bitwise,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    hvd.shutdown()
    return rec


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reshard_report(device=None, timeout: float = 600.0) -> dict:
    """The reshard extra, in a child process: live reshard against
    checkpoint restore at n=2 -> 1."""
    import subprocess

    cmd = [sys.executable, "-m", "horovod_tpu_torch.bench", "--reshard-child"]
    if device:
        cmd += ["--device", device]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_COORDINATOR")}
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env)
    if r.returncode != 0:
        _log(f"reshard child rc={r.returncode} stderr tail: "
             f"{r.stderr[-1000:]}")
        return {}
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    _log(f"reshard n=2->1: live {rec['live_ms']} ms vs save+restore+restack "
         f"{rec['restore_ms']} ms ({rec['speedup']}x), peak "
         f"{rec['peak_bytes']} / {rec['peak_ceiling']} bytes, bitwise="
         f"{rec['bitwise_vs_restore']}")
    return rec


def run_chaos_child(device=None) -> None:
    """A launched rank of the chaos extra: one `ChaosSoak` per rank, its
    result written to $HVD_CHAOS_OUT/rank{r}.json."""
    from horovod_tpu_torch.faults.chaos import ChaosSoak

    hvd.init(device=device)
    res = ChaosSoak(seed=int(os.environ.get("HVD_CHAOS_SEED", "7"))).run()
    with open(os.path.join(os.environ["HVD_CHAOS_OUT"],
                           f"rank{hvd.rank()}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()


def _pctl(xs, q):
    """Nearest-rank percentile of a sorted list."""
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def chaos_report(device=None, timeout: float = 600.0) -> dict:
    """The chaos extra: MTTR percentiles and steps lost per injection from
    an np >= 2 soak (HOROVOD_BENCH_CHAOS_NP, default 2)."""
    import subprocess

    np_ = int(os.environ.get("HOROVOD_BENCH_CHAOS_NP", "2"))
    out = tempfile.mkdtemp(prefix="bench_chaos_")
    env = dict(os.environ, HVD_CHAOS_OUT=out)
    env.setdefault("HOROVOD_CHAOS_GENERATIONS", "6")
    env.setdefault("HOROVOD_CHAOS_STEPS_PER_GEN", "5")
    env.setdefault("HOROVOD_AUTOTUNE", "1")
    env.setdefault("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    env.setdefault("HOROVOD_TIMELINE", os.path.join(out, "tl.json"))
    env.setdefault("HOROVOD_TIMELINE_ALL_RANKS", "1")
    env.setdefault("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    env.setdefault("HOROVOD_TIMELINE_DISABLE_NATIVE", "1")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(np_), sys.executable, "-m", "horovod_tpu_torch.bench",
           "--chaos-child"] + (["--device", device] if device else [])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env)
    if r.returncode != 0:
        _log(f"chaos fleet rc={r.returncode} stderr tail: "
             f"{(r.stdout + r.stderr)[-1500:]}")
        return {}
    with open(os.path.join(out, "rank0.json")) as f:
        res = json.load(f)
    events = res["events"]
    mttr = sorted(float(e["mttr_ms"]) for e in events
                  if e["outcome"] == "recovered")
    lost = [int(e["steps_lost"]) for e in events]
    bests = [w["autotune_best"] for w in res["windows"]
             if w.get("autotune_best") is not None]
    return {
        "bench": "chaos", "np": np_,
        "generations": len(res["windows"]),
        "events": len(events),
        "kinds": sorted(res["kinds_injected"]),
        "recovered": sum(1 for e in events if e["outcome"] == "recovered"),
        "degraded": sum(1 for e in events if e["outcome"] == "degraded"),
        "mttr_p50_ms": round(_pctl(mttr, 0.50), 2) if mttr else None,
        "mttr_p99_ms": round(_pctl(mttr, 0.99), 2) if mttr else None,
        "steps_lost_total": sum(lost),
        "steps_lost_per_injection": (round(sum(lost) / len(lost), 3)
                                     if lost else 0.0),
        "loud_reinits": res["loud_reinits"],
        "reactions": res["reactions"],
        "autotune_best_final": bests[-1] if bests else None,
        "split_brain": res["split_brain"],
        "final_digest_mismatch": res["final_digest_mismatch"],
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = next((a for a in argv if a in (
        "--reshard", "--reshard-child", "--chaos", "--chaos-child")), None)
    if extra is not None:
        q = argparse.ArgumentParser()
        q.add_argument(extra, action="store_true")
        q.add_argument("--device", default=None)
        device = q.parse_args(argv).device
        if extra == "--chaos-child":
            run_chaos_child(device)
            return 0
        rec = (run_reshard_child(device) if extra == "--reshard-child"
               else reshard_report(device) if extra == "--reshard"
               else chaos_report(device))
        print(json.dumps(rec), flush=True)
        return 0 if rec else 1
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50", choices=zoo_models())
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=None,
                   help="default: 299 for inception3, 224 otherwise")
    p.add_argument("--num-warmup-batches", type=int, default=5)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=5)
    p.add_argument("--profile", type=int, default=3,
                   help="steps of each row traced for its idle share "
                        "(0: none)")
    p.add_argument("--device", default=None,
                   help="default: the rank's card; 'cpu' runs on the host")
    args = p.parse_args(argv)
    if args.image_size is None:
        args.image_size = 299 if args.model == "inception3" else 224

    with tempfile.TemporaryDirectory() as tmp:
        if util.getenv("COORDINATOR_ADDR"):
            hvd.init(device=args.device)
        else:
            # One rank on a process group of its own: DDP needs one.
            hvd.init(coordinator_address=f"file://{tmp}/rendezvous",
                     num_processes=1, process_id=0, device=args.device)
        try:
            rank, result = hvd.rank(), run(args)
        finally:
            hvd.shutdown()
    if rank == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
