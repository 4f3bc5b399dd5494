"""Serving benchmark: continuous against static batching on one seeded
trace, one configuration, one process.

Counterpart of one child of the JAX package's `decode_bench.py` (its
`CONFIGS`: mha; gqa4, `n_kv_heads=2`; gqa4+int8; b16).  The same
seeded mixed-length trace (`make_trace`: mostly short answers and a
quarter of long generations) is replayed against two `InferenceServer`s
that differ only in admission policy, ``fifo`` (continuous batching)
and ``static`` (a wave drains before the next boards).  As there, each
policy runs once to warm up and then REPS times on fresh servers; the
fastest replay is reported.

    python -m horovod_tpu_torch.serve_benchmark --config gqa4
    python -m horovod_tpu_torch.serve_benchmark --device cpu --small

The model is the default `TransformerConfig` (vocab 32000, d_model 512,
8 x 64 heads, d_ff 2048, 8 layers, bf16) with seeded random weights;
`--small` is a CPU-sized model and trace.  Prints one line
``SERVE {json}`` with, per policy, tokens/sec, request p50 / p99
latency, TTFT p50 / p99, per-token p50 / p99, batch occupancy and the
pool's peak utilisation, and the continuous-over-static speedup.  Runs
on the card unless ``--device cpu``; the JAX package's BENCH_serve.json
is its own, and nothing is appended to it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .common.exceptions import HorovodTpuError
from .models.transformer import TransformerConfig, transformer_init
from .serve import InferenceServer
from .serve.loadgen import make_trace, run_trace
from .utils import timeline

# tag -> (config fields, quantize, max_batch, requests): decode_bench.py's.
CONFIGS = {
    "mha": ({}, None, 8, 48),
    "gqa4": ({"n_kv_heads": 2}, None, 8, 48),
    "gqa4+int8": ({"n_kv_heads": 2}, "int8", 8, 48),
    "b16": ({"n_kv_heads": 2}, None, 16, 96),
}
# The trace's shape (decode_bench.py): prompt lengths, short budgets, the
# long tail's budgets, the per-sequence token budget.
FULL_TRACE = dict(prompt_lens=(64, 128, 256), max_new_lo=16,
                  max_new_hi=64, long_frac=0.25, long_lo=192, long_hi=256,
                  arrival_every=0.5)
FULL_MAX_SEQ = 256 + 256
TRACE_SEED = 7
# decode_bench.py's protocol: a warm-up replay, then the best of REPS.
REPS = 3
# --small: a CPU-sized model and a trace of SMALL_REQUESTS requests of
# the same bimodal shape, scaled down.
SMALL_TRACE = dict(prompt_lens=(4, 8), max_new_lo=2, max_new_hi=6,
                   long_frac=0.25, long_lo=12, long_hi=16, arrival_every=0.5)
SMALL_MAX_SEQ = 8 + 16
SMALL_REQUESTS = 3
SMALL_MODEL = dict(vocab_size=512, d_model=64, n_heads=4, d_head=16,
                   d_ff=256, n_layers=1, compute_dtype=torch.float32)


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="mha", choices=sorted(CONFIGS))
    p.add_argument("--device", default=None,
                   help="cpu, or the card (the default)")
    p.add_argument("--small", action="store_true",
                   help="a CPU-sized model and trace")
    return p


def run(args) -> dict:
    if args.device is None and not torch.cuda.is_available():
        raise HorovodTpuError("serve_benchmark runs on the card; pass "
                              "--device cpu to run on the CPU")
    device = torch.device(args.device or "cuda")
    fields, quantize, max_batch, n_requests = CONFIGS[args.config]
    if args.small:
        n_requests = SMALL_REQUESTS
    cfg = TransformerConfig(**(SMALL_MODEL if args.small else {}), **fields)
    params = transformer_init(0, cfg)
    trace = make_trace(TRACE_SEED, n_requests, cfg.vocab_size,
                       **(SMALL_TRACE if args.small else FULL_TRACE))
    max_seq = SMALL_MAX_SEQ if args.small else FULL_MAX_SEQ
    timeline.init_from_env(0)
    out = {"config": args.config, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "model": {k: (str(v) if isinstance(v, torch.dtype) else v)
                     for k, v in cfg.__dict__.items()},
           "quantize": quantize, "max_batch": max_batch,
           "requests": len(trace),
           "tokens_requested": sum(mn for _, _, mn in trace)}
    for policy in ("fifo", "static"):
        best = None
        for rep in range(1 + REPS):
            srv = InferenceServer(params, cfg, max_seq_tokens=max_seq,
                                  max_batch=max_batch, quantize=quantize,
                                  policy=policy, seed=0, device=device)
            stats = run_trace(srv, trace)
            if srv.pool.pages_free() != srv.pool.total_pages:
                raise HorovodTpuError(
                    f"{policy}: {srv.pool.total_pages - srv.pool.pages_free()}"
                    " pages leaked")
            stats.pop("slo_decisions")
            if rep and (best is None or stats["wall_s"] < best["wall_s"]):
                best = stats
        out[policy] = best
    out["speedup_tokens_per_sec"] = (
        out["fifo"]["tokens_per_sec_per_chip"]
        / out["static"]["tokens_per_sec_per_chip"])
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    t0 = time.perf_counter()
    out = run(args)
    out["seconds"] = time.perf_counter() - t0
    print("SERVE " + json.dumps(out), flush=True)
    for policy in ("fifo", "static"):
        s = out[policy]
        print(f"{args.config} {policy}: {s['tokens_per_sec_per_chip']:.1f} "
              f"tok/s, request p50/p99 {s['request_p50_ms']:.1f}/"
              f"{s['request_p99_ms']:.1f} ms, ttft p50/p99 "
              f"{s['ttft_list_p50_ms']:.1f}/{s['ttft_list_p99_ms']:.1f} ms, "
              f"token p50/p99 {s['token_p50_ms']:.2f}/"
              f"{s['token_p99_ms']:.2f} ms, occupancy "
              f"{s['batch_occupancy_mean']:.2f}, pool peak "
              f"{s['kv_pool_peak_utilization']:.2f}", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
