"""ResNet synthetic benchmark on the port (BASELINE config 2; config 4
with --use-adasum).

Counterpart of `examples/synthetic_benchmark.py` and the measured step of
`bench.py` (`build_step`): synthetic ImageNet-shaped data made from a
seed per rank, SGD with momentum (lr 0.0125, momentum 0.9), bf16
compute with f32 weights and batch-norm statistics local to each rank,
and the horovod.torch loop:

    hvd.init() → DistributedOptimizer → broadcast_parameters /
    broadcast_optimizer_state → forward, backward, step()

Prints img/sec like the reference's pytorch_synthetic_benchmark.py.
`--log-steps` adds one JSON line per step (loss, kernel launch counts,
SHA-256 of the parameters, the fusion threshold in force and the
gradient buckets flushed so far) for checks across ranks.  Each step
feeds the autotuner (`hvd.autotune_record_step`; HOROVOD_AUTOTUNE=1).

Run:  python -m horovod_tpu_torch.synthetic_benchmark --num-iters 3
      python -m horovod_tpu_torch.synthetic_benchmark --use-adasum
Multi-process: set HOROVOD_COORDINATOR_ADDR, HOROVOD_NUM_PROCESSES,
HOROVOD_PROCESS_ID (and HOROVOD_LOCAL_RANK / HOROVOD_LOCAL_SIZE) per rank.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet, num_params
from horovod_tpu_torch.ops import adasum, adasum_kernels
from horovod_tpu_torch.utils.autotune import current_fusion_threshold


def param_digest(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        # A copy: a numpy view would mark a CPU parameter's storage as
        # never resizable, and ZeRO-3 releases it between steps.
        h.update(p.detach().float().cpu().clone().numpy().tobytes())
    return h.hexdigest()


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_summary(trace: dict, wall_s: float, steps: int, on_card: bool,
                    top: int = 8) -> dict:
    """Per-step times from a torch.profiler chrome trace: wall clock; the
    card's busy time (the union of this process's kernel, memcpy and
    memset intervals) and so its idle share as this process sees it
    (None off the card); host time inside each `hvd.*` / `bench.*`
    range; the kernels that took the most device time, and the copies'
    total (gloo moves a CUDA tensor through host memory)."""
    ranges: dict = {}
    kernels: dict = {}
    launchers: dict = {}  # kernel -> the torch ops that launched it
    runtime: dict = {}    # CUDA runtime call -> [host us, calls]
    spans = []
    copies = 0.0
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    for e in events:
        cat, name, dur = e.get("cat"), e.get("name", ""), float(e["dur"])
        if cat == "user_annotation" and name.startswith(("hvd.", "bench.")):
            ranges[name] = ranges.get(name, 0.0) + dur
        elif cat == "cuda_runtime":
            rec = runtime.setdefault(name, [0.0, 0])
            rec[0] += dur
            rec[1] += 1
        elif cat in _DEVICE_CATS:
            spans.append((float(e["ts"]), float(e["ts"]) + dur))
            if cat == "kernel":
                # Long enough to keep an elementwise kernel's functor.
                key = name[:300]
                kernels[key] = kernels.get(key, 0.0) + dur
                op = ops.get(e.get("args", {}).get("External id"))
                if op is not None:
                    launchers.setdefault(key, set()).add(op)
            elif cat == "gpu_memcpy":
                copies += dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    wall_ms = wall_s * 1e3 / steps
    per_step = 1e-3 / steps  # trace microseconds -> ms per step
    device_ms = busy * per_step
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": device_ms if on_card else None,
        "device_idle_share": 1.0 - device_ms / wall_ms if on_card else None,
        "ranges_ms_per_step": {k: v * per_step for k, v in ranges.items()},
        "memcpy_ms_per_step": copies * per_step if on_card else None,
        "top_kernels_ms_per_step": sorted(
            ((k, v * per_step, sorted(launchers.get(k, ())))
             for k, v in kernels.items()),
            key=lambda kv: -kv[1])[:top],
        # Host time inside CUDA runtime calls (launches, syncs, mallocs)
        # and their count, per step.
        "runtime_ms_calls_per_step": sorted(
            ((k, v[0] * per_step, v[1] / steps) for k, v in runtime.items()),
            key=lambda kv: -kv[1])[:top],
    }


def _check_plain_combine(opt) -> dict:
    """Wrap the Adasum optimizer's delta reduction for one step: gather
    the fused delta buffer (in the wire dtype of the optimizer's
    compression), rerun the tree with the plain versions of the kernels,
    and return the largest difference from the kernels' result (on
    rank 0; nothing elsewhere)."""
    reduce = opt._reduce_deltas
    result = {}

    def checked(deltas):
        out = reduce(deltas)
        fused, ctx = opt._compression.compress(
            torch.cat([d.reshape(-1) for d in deltas]))
        stack = hvd.allgather(fused[None])
        if hvd.rank() == 0:
            plain = opt._compression.decompress(
                adasum.adasum_tree_reduce(stack, plain=True), ctx)
            got = torch.cat([o.reshape(-1) for o in out])
            result["diff"] = float((got - plain).abs().max())
            result["max_abs"] = float(plain.abs().max())
        return out

    opt._reduce_deltas = checked
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--use-adasum", action="store_true",
                   help="Adasum delta aggregation (reference --use-adasum)")
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="fp16 wire compression (reference --fp16-allreduce)")
    p.add_argument("--device", default=None,
                   help="default: the rank's card; 'cpu' runs on the host")
    p.add_argument("--log-steps", action="store_true",
                   help="one JSON line per step: loss, launches, digest")
    p.add_argument("--profile", type=int, default=0,
                   help="after timing, profile this many steps and print "
                        "a PROFILE line (per-step breakdown)")
    p.add_argument("--check-plain-step", type=int, default=-1,
                   help="Adasum: on this step, rank 0 reruns the combine "
                        "with the plain versions and prints the difference")
    args = p.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    if dev.type == "cuda":
        # f32 convolutions in full precision, as the reference computes.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = ResNet(args.depth, args.num_classes,
                   compute_dtype=torch.bfloat16,
                   seed=hvd.rank()).to(dev)
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=0.0125, momentum=0.9)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(),
        compression=(hvd.Compression.fp16 if args.fp16_allreduce
                     else hvd.Compression.none),
        op=hvd.Adasum if args.use_adasum else hvd.Average)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    g = torch.Generator().manual_seed(hvd.rank())
    x = torch.rand((args.batch_size, 3, args.image_size, args.image_size),
                   generator=g).to(dev)
    y = torch.randint(0, args.num_classes, (args.batch_size,),
                      generator=g).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step_no = 0
    last_loss = float("nan")

    def one_step():
        nonlocal step_no, last_loss
        check = None
        if args.use_adasum and step_no == args.check_plain_step:
            check = _check_plain_combine(opt)
        threshold = current_fusion_threshold()
        opt.zero_grad(set_to_none=True)
        with record_function("bench.forward_backward"):
            loss = F.cross_entropy(model(x), y)
            loss.backward()
        with record_function("bench.optimizer_step"):
            opt.step()
        hvd.autotune_record_step(args.batch_size)
        if check is not None:
            opt.__dict__.pop("_reduce_deltas")
        last_loss = loss.detach()
        if args.log_steps:
            sync()
            rec = {"step": step_no, "rank": hvd.rank(),
                   "loss": float(last_loss),
                   "launches": adasum_kernels.launch_counts(),
                   "digest": param_digest(model),
                   "fusion_threshold": threshold,
                   "flushes": getattr(opt, "total_flushes", None)}
            if check is not None and "diff" in check:
                rec["plain_max_abs_diff"] = check["diff"]
                rec["plain_max_abs"] = check["max_abs"]
            print("STEP " + json.dumps(rec), flush=True)
        step_no += 1

    if hvd.rank() == 0:
        print(f"Model: resnet{args.depth} ({num_params(model)} params), "
              f"batch {args.batch_size}/rank, {hvd.size()} rank(s), "
              f"device {dev}, backend {hvd.backend()}", flush=True)
    adasum_kernels.reset_launch_counts()
    for _ in range(args.num_warmup_batches):
        one_step()
    sync()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            one_step()
        sync()
        dt = time.perf_counter() - t0
        img_sec = args.batch_size * args.num_batches_per_iter / dt
        if hvd.rank() == 0:
            print(f"Iter #{i}: {img_sec:.1f} img/sec per rank", flush=True)
        img_secs.append(img_sec)

    if args.profile:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.profile):
                one_step()
            sync()
            wall = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        profiled = profile_summary(trace, wall, args.profile,
                                   on_card=dev.type == "cuda")
        print("PROFILE " + json.dumps(dict(profiled, rank=hvd.rank())),
              flush=True)

    mean, std = float(np.mean(img_secs)), float(np.std(img_secs))
    summary = {"rank": hvd.rank(), "size": hvd.size(),
               "img_sec_per_rank": mean, "img_sec_std": std,
               "steps": step_no, "last_loss": float(last_loss),
               "launches": adasum_kernels.launch_counts(),
               "flushes": getattr(opt, "total_flushes", None),
               "device": str(dev), "backend": hvd.backend()}
    if hvd.rank() == 0:
        print(f"Img/sec per rank: {mean:.1f} +- {1.96 * std:.1f}")
        print(f"Total img/sec on {hvd.size()} rank(s): "
              f"{mean * hvd.size():.1f} +- {1.96 * std * hvd.size():.1f}")
    print("SUMMARY " + json.dumps(summary), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
