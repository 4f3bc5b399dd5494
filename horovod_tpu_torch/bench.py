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


def main(argv=None) -> int:
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
