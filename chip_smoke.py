#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`horovod_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. env           the card's name and power limit (nvidia-smi), torch and
                 CUDA versions;
2. build         builds every CUDA source of the port (csrc/*.cu) with
                 nvcc, one process per source, all started together;
3. kernels       each kernel against its plain PyTorch version on the card,
                 at the main paths' shapes and at others, with the stated
                 tolerance; kernel, plain and library times and the bound.
                 The Adasum kernels K1, K2 at the fused ResNet-50 delta;
                 the flash kernels K4, K5, K6 over causal, non-causal,
                 window, GQA, MQA, segment-id, lse-cotangent cases, D in
                 {32, 40, 64, 128, 256}, f32, bf16 and f16, T up to
                 16384 (bf16 and f16 at D 64 and 128 on the tensor-core
                 K4, K5 and K6 of flash_attention_sm90.cu, the rest on
                 the CUDA-core kernels of flash_attention.cu, each case
                 checking which route ran), each output held to its
                 plain version both against its largest value and row
                 by row; then forward and backward timed at the
                 transformer's shape (1, 16384, 8, 64) and at the same
                 width in 128-wide heads (1, 16384, 4, 128), bf16
                 causal, beside F.scaled_dot_product_attention and the
                 CUDA-core K4, K5 and K6 at the same shapes (each must
                 be the slower); the tiled matmul K3 in f32, bf16 and f16
                 at the ZeRO-3 head's chunk shapes
                 (16384, 512) @ (512, 512 / 256 / 128) and at unaligned
                 ones (M, N, K off multiples of 128 and of K3's 32-deep
                 stage, 1x1x1, a column band of a wider output), on both
                 load paths (a base one element off, an operand strided
                 along K and an odd ldc take the strided one; each case
                 checks which ran), then timed at the head chunk beside
                 torch.matmul (TF32 off) and on the strided path;
4. train_adasum  main path 1: two ranks share the card over gloo and run
                 `python -m horovod_tpu_torch.synthetic_benchmark
                 --use-adasum` on full-width ResNet-50 (25,557,032 params,
                 224x224, 1000 classes, batch 32 per rank, bf16), 3 steps
                 after broadcast_parameters; every step's loss must be
                 finite, both ranks must have launched both kernels, and
                 the parameters' SHA-256 must agree across ranks; on one
                 step rank 0 reruns the combine with the plain versions;
5. train_average one rank on NCCL, op=Average, batch 64: img/sec and the
                 number of fused buckets flushed;
6. train_transformer  main path 2: two ranks share the card over gloo and
                 run `python -m horovod_tpu_torch.transformer_benchmark`
                 on the default TransformerConfig (vocab 32000, d_model
                 512, 8 x 64 heads, d_ff 2048, 8 layers) at T = 16384,
                 batch 1 per rank, bf16, DistributedOptimizer(AdamW),
                 op=Average, 3 steps after broadcast_parameters: finite
                 losses, one digest per step, K4, K5 and K6 each launched
                 n_layers times per step on each rank (every one on the
                 tensor-core route), and on one step
                 rank 0's logits with the plain attention within
                 LOGITS_RTOL (and those of the plain attention made
                 non-causal, a fault, beyond it), its loss within
                 LOSS_TOL;
7. transformer_nccl  one rank on NCCL at the same configuration: tok/sec;
8. train_zero3   main path 3: two ranks share the card over gloo and run
                 the transformer trainer as in phase 6 with
                 `--zero-stage 3` under HOROVOD_FUSED_COLLECTIVES=1,
                 HOROVOD_FUSED_PALLAS=1 and HOROVOD_FUSION_THRESHOLD=
                 33554432 (the embedding a shard group of its own), 3
                 steps and one held-out forward whose tied head is
                 `gather_matmul`: finite losses within LOSS_TOL of phase
                 6's (stage 0, same seeds and data), one digest per step,
                 K4-K6 n_layers launches per step (all on the
                 tensor-core route), resident parameters at
                 most half the full bytes plus one pad element per group,
                 and in the eval forward exactly 64 K3 launches per rank,
                 all on the vector load path,
                 logits within K3_RTOL (f32) of the plain head, a finite
                 eval loss;
9. zero3_nccl    one rank on NCCL at stage 3: tok/sec beside phase 7's,
                 63 K3 launches in its eval forward, all on the vector
                 load path;
10. surface_np2  two ranks share the card over gloo and run the
                 collective half of the horovod.torch surface on CUDA
                 tensors (`python -m chip_smoke --surface-rank`): a
                 ragged allgather, grouped allgather, alltoall with and
                 without splits, an uneven and a grouped reducescatter,
                 their async handles, a process set that leaves rank 0
                 out, the autograd wrappers' gradients, and join with
                 uneven steps; every result held bitwise to a numpy
                 reference computed here (integer-valued inputs, so
                 every sum is exact); then, each rank checking against a
                 reference it computes itself: `sparse_allreduce_async`
                 of the gradient of nn.Embedding(32000, 512,
                 sparse=True) over 16,384 token ids per rank (the
                 transformer's embedding at full width) against the
                 dense allreduce of the same gradient densified, within
                 SPARSE_RTOL of the largest value, and
                 DistributedOptimizer's two sparse routes (the sparse
                 allreduce, and sparse_as_dense: bitwise the dense
                 allreduce); and hvd.SyncBatchNorm(256) on (32, 256, 56,
                 56) bf16 per rank against one BatchNorm2d over both
                 ranks' batches (output and input gradient within
                 SYNC_BN_TOL of their largest value, the running
                 statistics within SYNC_BN_STAT_TOL, the sum of the
                 ranks' weight and bias gradients within SYNC_BN_TOL);
11. train_elastic main path 4: two ranks share the card over gloo and
                 run `python -m horovod_tpu_torch.elastic_resnet` at its
                 full-width defaults (ResNet-50, 224x224, 1000 classes,
                 batch 32 per rank, bf16, synchronized batch norm over
                 the global set, DistributedOptimizer(SGD), TorchState
                 with an ElasticSampler) for 2 epochs x 4 batches,
                 committing every 2, twice: fault-free, then under one
                 seeded HOROVOD_FAULT_SPEC on `collective.allreduce`
                 (`elastic_fault_spec`: the first fault falls in the
                 backward of the fourth step, after the first commit,
                 and the next one past the run).
                 Each rank resets at least once and as often as the
                 other; after each restore its digest is the one of its
                 last commit, after each sync the ranks' digests agree,
                 every loss is finite, the last epoch's losses are within
                 LOSS_TOL of the fault-free run's, and each epoch covers
                 its indices exactly once; img/sec per rank for both runs
                 and the seconds each reset took;
12. autotune_np2 two ranks over gloo run the ResNet-50 synthetic
                 benchmark (batch 32) under HOROVOD_AUTOTUNE=1 with a
                 short search (1 warmup sample, 2 steps a sample, 3
                 samples): each rank's log has warmup, sample and frozen
                 rows, the threshold takes at least two values, the
                 ranks use the same threshold in every step, and in
                 every step each rank flushed the bucket count that the
                 threshold in force gives for ResNet-50's gradients in
                 the order the backward makes them final (recorded here
                 from a ResNet-50 of its own on the card).

Phases 6 to 9 also hold the tied head (`TiedHead`: bf16 x bf16 -> f32 on
the tensor cores) to the f32 path it replaced: in the kernels phase at
the main shape (logits within HEAD_RTOL, both gradients equal, the
forward GEMM's ms beside the f32 GEMM's), and on the check step of each
transformer run (rank 0's logits within HEAD_RTOL).  At stage 3 every
parameter's storage must be 0 bytes between steps, the measured
resident bytes at most full / n plus one pad element per group, and
train_zero3's peak memory at most train_transformer's, rank by rank.

`python3 chip_smoke.py --ranks N [--transformer] ARGS` instead runs N
ranks of the ResNet benchmark (or, with --transformer, the transformer
trainer) with ARGS (rank r on card r mod the card count), holds them to
the same checks as the training phases, and prints each rank's SUMMARY
and, with `--profile K`, its PROFILE line (a torch.profiler breakdown
of K steps: device time, idle share, host time in each `hvd.*` and
`bench.*` range).

Then one JSON line with every kernel's numbers, and as the last line
`{"ok": true, "device": {...}}`.  Any failure raises and exits non-zero
with no result line; so does a host without CUDA.  Full logs of the
training ranks go to chiprun_out/.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(HERE, "chiprun_out")
# H100 SXM data sheet: device memory 3.35 TB/s; f32 outside the tensor
# cores 67 TFLOP/s (the kernels compute in f32 for bf16 inputs too).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Dense bf16 / f16 tensor-core peak: the least time of the attention
# kernels' work at the main shape (bf16), whatever units compute it.
HALF_FLOPS = 989e12
MAIN_N = 25_557_032  # ResNet-50 params: one fused f32 delta
K1_RTOL = 2e-5       # K1 vs plain, relative to sqrt(|a|^2|b|^2), |a|^2, |b|^2
K2_F32_RTOL = 1e-6   # K2 f32 vs plain, relative to max|plain| (expect 0)
K2_HALF_ULP = 1      # K2 bf16 and f16 vs plain, in ulps (expect 0)
COMBINE_RTOL = 1e-4  # Adasum step: kernels vs plain, relative to max|result|
# K4-K6 vs plain, relative to max|plain| of each output.  f32: sums in
# another order, expf, and the online softmax's running max against the
# plain row max.  bf16 / f16: in addition p (or ds) rounded from values
# that differ in the last f32 bits, and the output's own rounding: a
# few ulps of the largest value (bf16 ulp 2^-8, f16 2^-11).
FLASH_RTOL = {"torch.float32": 1e-4, "torch.bfloat16": 2 ** -6,
              "torch.float16": 2 ** -9}
# The same limits row by row: for each (b, t, h), |got - want| over the
# row's D values relative to |want| of that row, so that late causal rows
# (values ~sqrt(e / t), far below the largest) are held to a few ulps of
# their own size.  A row under 2^-8 of the rows' RMS size (a key that one
# query sees, its dp - delta near 0) is measured against that floor.
ROW_FLOOR = 2 ** -8
LSE_RTOL = 1e-5      # lse is f32 whatever the inputs: sums in another order
# K3 vs plain, relative to max|plain|: both sum K in f32 and round once,
# in another order inside each 128-wide K tile.  f32: the sums' last
# bits at K = 512; bf16 / f16: in addition one rounding of the output
# apart, at most one ulp of the largest value (2^-7, 2^-10 of it).
K3_RTOL = {"torch.float32": 1e-5, "torch.bfloat16": 2 ** -7,
           "torch.float16": 2 ** -10}
HEAD_CHUNK = (16384, 512, 512)  # the ZeRO-3 eval head's K3 chunk: M, K, N
# The tied head (bf16 x bf16, f32 sums) vs the f32 GEMM of the same
# bf16-rounded operands, relative to the largest logit: the products are
# exact in f32 in both, the sums over D = 512 run in another order.
HEAD_RTOL = 1e-5
HEAD_SHAPE = (16384, 512, 32000)  # tokens, d_model, vocab
ZERO3_ENV = {"HOROVOD_FUSED_COLLECTIVES": "1", "HOROVOD_FUSED_PALLAS": "1",
             "HOROVOD_FUSION_THRESHOLD": "33554432"}
# Transformer at T = 16384, kernels vs plain attention (both bf16): the
# two round p, o and every later bf16 activation at other points, through
# 8 layers.  The loss is a mean over 16384 tokens of values ~10.4; the
# logits are compared entry by entry, relative to their largest value,
# and must also tell a known fault apart (the plain attention made
# non-causal reads above LOGITS_RTOL).
LOSS_TOL = 2e-3
LOGITS_RTOL = 5e-2
# Sparse allreduce vs the dense allreduce of the densified gradient,
# relative to the largest value: each value is divided by n before the
# duplicates are summed (the JAX order), the dense path sums then
# divides.
SPARSE_RTOL = 1e-6
# SyncBatchNorm (bf16 input, f32 statistics) vs one BatchNorm2d in f32
# over both ranks' batches: the bf16 output and input gradient are one
# bf16 rounding (half an ulp: up to 2^-8 of a value) from f32 results
# whose statistics sum in another order, so one ulp of the largest
# value; the running statistics and the weight and bias gradients are
# f32.
SYNC_BN_TOL = 2 ** -7
SYNC_BN_STAT_TOL = 1e-4
EMBED = (32000, 512, 16384)    # vocab, d_model, token ids per rank
SYNC_BN_SHAPE = (32, 256, 56, 56)
ELASTIC_ARGS = ["--epochs", "2", "--batches-per-epoch", "4",
                "--commit-every", "2", "--log-steps"]
# collective.allreduce hits per ResNet-50 step with sync_bn: 53 batch
# norms, one allreduce each way, and 2 gradient buckets at the default
# 64 MiB threshold (102 MB of f32 gradients).
ELASTIC_HITS_PER_STEP = 2 * 53 + 2
AUTOTUNE_ENV = {"HOROVOD_AUTOTUNE": "1",
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                "HOROVOD_AUTOTUNE_MAX_SAMPLES": "3"}
ADASUM_GROW = {"fused_dot_norms": None, "fused_scaled_add": None}
MAIN_ATTN = (1, 16384, 8, 64)  # the transformer's [B, T, H, D] per layer
WIDE_ATTN = (1, 16384, 4, 128)  # the same width in 128-wide heads
# K4-K6 per step per rank at 8 layers, all on the tensor cores.
FLASH_GROW = {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
              "flash_fwd_sm90": 8, "flash_bwd_dq_sm90": 8,
              "flash_bwd_dkv_sm90": 8}


def require(ok: bool, msg) -> None:
    """A check of the run: raises (and so fails the script) when false."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, peak: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _half_ulps(x, y) -> int:
    """Largest distance in ulps between two bf16 or two f16 tensors."""
    import torch

    xi = x.contiguous().view(torch.int16).int()
    yi = y.contiguous().view(torch.int16).int()
    # Map sign-magnitude bit patterns onto a monotone integer line.
    xi = torch.where(xi < 0, -32768 - xi, xi)
    yi = torch.where(yi < 0, -32768 - yi, yi)
    return int((xi - yi).abs().max()) if x.numel() else 0


def check_kernels(K):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}
    # float16 is the wire dtype of Compression.fp16 (--fp16-allreduce).
    cases = [((1, MAIN_N), torch.float32), ((1, MAIN_N), torch.bfloat16),
             ((1, MAIN_N), torch.float16),
             ((3, 1000), torch.float32), ((3, 1000), torch.bfloat16),
             ((3, 1000), torch.float16),
             ((2, 7), torch.float32), ((2, 7), torch.bfloat16)]
    for (k, n), dtype in cases:
        # a and b are the even and odd rows of one stacked buffer, as the
        # Adasum tree hands them to the kernels.
        xs = torch.randn((2 * k, n), generator=gen, device=dev).to(dtype)
        a, b = xs[0::2], xs[1::2]
        label = f"({k}, {n}) {str(dtype).replace('torch.', '')}"

        got = K.fused_dot_norms(a, b)
        want = K.fused_dot_norms_plain(a, b)
        torch.cuda.synchronize()
        scale = torch.stack([(want[:, 1] * want[:, 2]).sqrt(), want[:, 1],
                             want[:, 2]], -1).clamp_min(1e-30)
        k1_err = float((got - want).abs().max())
        k1_rel = float(((got - want).abs() / scale).max())
        require(math.isfinite(k1_rel) and k1_rel <= K1_RTOL,
                f"K1 {label}: scaled error {k1_rel} > {K1_RTOL}")

        dot, na, nb = want[:, 0], want[:, 1], want[:, 2]
        ca = (1.0 - dot / (2.0 * na)).contiguous()
        cb = (1.0 - dot / (2.0 * nb)).contiguous()
        got2 = K.fused_scaled_add(ca, cb, a, b)
        want2 = K.fused_scaled_add_plain(ca, cb, a, b)
        torch.cuda.synchronize()
        k2_err = float((got2.float() - want2.float()).abs().max())
        if dtype == torch.float32:
            tol = K2_F32_RTOL * float(want2.abs().max())
            require(k2_err <= tol, f"K2 {label}: error {k2_err} > {tol}")
            k2_note = f"max_abs_err={k2_err:.3g} (tol {tol:.3g})"
        else:
            ulps = _half_ulps(got2, want2)
            require(ulps <= K2_HALF_ULP, f"K2 {label}: {ulps} ulps")
            k2_note = f"max_abs_err={k2_err:.3g} ({ulps} ulp, tol " \
                      f"{K2_HALF_ULP})"
        line1 = f"fused_dot_norms {label}: max_abs_err={k1_err:.3g} " \
                f"scaled_err={k1_rel:.3g} (tol {K1_RTOL})"
        line2 = f"fused_scaled_add {label}: {k2_note}"

        if n == MAIN_N:
            es = a.element_size()
            k1_ms = cuda_time_ms(lambda: K.fused_dot_norms(a, b))
            k1_plain = cuda_time_ms(lambda: K.fused_dot_norms_plain(a, b))
            # One library call with the same three sums: the Gram matrix
            # of the stacked rows (cuBLAS).
            k1_lib = cuda_time_ms(lambda: torch.mm(xs, xs.t()))
            k1_bound = bound_ms(2 * k * n * es + 12 * k, 6 * k * n)
            k2_ms = cuda_time_ms(lambda: K.fused_scaled_add(ca, cb, a, b))
            k2_plain = cuda_time_ms(
                lambda: K.fused_scaled_add_plain(ca, cb, a, b))
            coef = torch.stack([ca, cb], -1).to(dtype)
            k2_lib = cuda_time_ms(lambda: torch.mm(coef, xs))
            k2_bound = bound_ms(3 * k * n * es + 8 * k, 3 * k * n)
            line1 += (f" ms={k1_ms:.4f} plain_ms={k1_plain:.4f} "
                      f"library_ms={k1_lib:.4f} bound_ms={k1_bound[0]:.4f}")
            line2 += (f" ms={k2_ms:.4f} plain_ms={k2_plain:.4f} "
                      f"library_ms={k2_lib:.4f} bound_ms={k2_bound[0]:.4f}")
            results[str(dtype)] = {
                "fused_dot_norms": dict(max_abs_err=k1_err, ms=k1_ms,
                                        plain_ms=k1_plain, library_ms=k1_lib,
                                        bound_ms=k1_bound[0],
                                        bound_by=k1_bound[1]),
                "fused_scaled_add": dict(max_abs_err=k2_err, ms=k2_ms,
                                         plain_ms=k2_plain,
                                         library_ms=k2_lib,
                                         bound_ms=k2_bound[0],
                                         bound_by=k2_bound[1]),
            }
        log("kernels", line1)
        log("kernels", line2)
        del xs, a, b, got, want, got2, want2
    torch.cuda.empty_cache()
    return results


def _flash_case_inputs(case, gen, dev):
    import torch

    B, T, Hq, Hkv, D, dtype, causal, window, n_seg = case
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, T, Hq, D), (B, T, Hkv, D),
                                 (B, T, Hkv, D), (B, T, Hq, D)))
    seg = None
    if n_seg:
        seg = torch.sort(torch.randint(0, n_seg, (B, T), generator=gen,
                                       device=dev), dim=1)[0].int()
    return q, k, v, do, seg


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _row_err(got, want) -> float:
    """Largest error of a row (the last dim) relative to that row's size
    in `want`, floored at ROW_FLOOR of the rows' RMS size."""
    got, want = got.double(), want.double()
    err = (got - want).norm(dim=-1)
    size = want.norm(dim=-1)
    floor = ROW_FLOOR * float(size.square().mean().sqrt())
    return float((err / size.clamp_min(max(floor, 1e-30))).max())


def _check_flash_case(FA, case, gen, dev, sm90=None) -> dict:
    """K4, K5, K6 on one case against their plain versions, fed the same
    inputs (the backward kernels the plain lse, and a delta with a
    nonzero lse cotangent folded in), each on the route `sm90` names
    (default: the wrappers' own).  Every output within the
    dtype's FLASH_RTOL of its largest value and, row by row, of each
    row's size.  Returns each kernel's largest absolute error."""
    import torch

    B, T, Hq, Hkv, D, dtype, causal, window, n_seg = case
    q, k, v, do, seg = _flash_case_inputs(case, gen, dev)
    tol = FLASH_RTOL[str(dtype)]
    label = (f"B{B} T{T} H{Hq}/{Hkv} D{D} {str(dtype)[6:]} causal={causal}"
             f" window={window} segments={n_seg}")
    sm90_before = FA.sm90_launch_counts()
    o, lse = FA.flash_fwd(q, k, v, causal, window, seg, sm90=sm90)
    po, plse = FA.flash_fwd_plain(q, k, v, causal, window, seg)
    dlse = torch.randn(plse.shape, generator=gen, device=dev)
    delta = (do.float() * po.float()).sum(-1) - dlse
    dq = FA.flash_bwd_dq(q, k, v, do, plse, delta, causal, window, seg,
                         sm90=sm90)
    pdq = FA.flash_bwd_dq_plain(q, k, v, do, plse, delta, causal, window, seg)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, plse, delta, causal, window, seg,
                              sm90=sm90)
    pdk, pdv = FA.flash_bwd_dkv_plain(q, k, v, do, plse, delta, causal,
                                      window, seg)
    torch.cuda.synchronize()
    routed = FA._sm90_route(dtype, D) if sm90 is None else sm90
    pairs = {"o": (o, po), "dq": (dq, pdq), "dk": (dk, pdk), "dv": (dv, pdv)}
    errs = {n: _rel_err(*p) for n, p in pairs.items()}
    rows = {n: _row_err(*p) for n, p in pairs.items()}
    lse_err = _rel_err(lse, plse)
    log("kernels", f"flash {label} [K4-K6 on the "
        f"{'tensor' if routed else 'CUDA'} cores]: relative errors "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" lse={lse_err:.2e}; by row "
        + " ".join(f"{n}={e:.2e}" for n, e in rows.items())
        + f" (tol {tol:.2e}, lse {LSE_RTOL})")
    require(FA.sm90_launch_counts() == {n: c + routed for n, c in
                                        sm90_before.items()},
            f"flash {label}: K4-K6 took the wrong route (tensor cores "
            f"expected: {routed})")
    for name in pairs:
        require(math.isfinite(errs[name]) and errs[name] <= tol,
                f"flash {label}: {name} error {errs[name]} > {tol}")
        require(math.isfinite(rows[name]) and rows[name] <= tol,
                f"flash {label}: {name} row error {rows[name]} > {tol}")
    require(lse_err <= LSE_RTOL, f"flash {label}: lse error {lse_err}")
    require(o.dtype == dtype and dq.dtype == dtype and lse.dtype ==
            torch.float32, f"flash {label}: output dtypes")
    return {"flash_fwd": float((o.float() - po.float()).abs().max()),
            "flash_bwd_dq": float((dq.float() - pdq.float()).abs().max()),
            "flash_bwd_dkv": max(float((dk.float() - pdk.float()).abs().max()),
                                 float((dv.float() - pdv.float()).abs().max()))}


def _check_flash_autograd(FA, gen, dev) -> None:
    """flash_attention_lse through autograd (GQA, a nonzero lse
    cotangent): its gradients against the plain chain."""
    import torch

    case = (2, 1024, 8, 2, 64, torch.float32, True, None, 0)
    q, k, v, do, _ = _flash_case_inputs(case, gen, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = FA.flash_attention_lse(*leaves, causal=True)
    dlse = torch.randn(lse.shape, generator=gen, device=dev)
    torch.autograd.backward((o, lse), (do, dlse))
    po, plse = FA.flash_fwd_plain(q, k, v, True)
    delta = (do * po).sum(-1) - dlse
    pdq = FA.flash_bwd_dq_plain(q, k, v, do, plse, delta, True)
    pdk, pdv = FA.flash_bwd_dkv_plain(q, k, v, do, plse, delta, True)
    want = {"dq": pdq, "dk": FA._group_sum(pdk, 2, k.dtype),
            "dv": FA._group_sum(pdv, 2, v.dtype)}
    tol = FLASH_RTOL[str(torch.float32)]
    errs = {n: max(_rel_err(t.grad, want[n]), _row_err(t.grad, want[n]))
            for n, t in zip(want, leaves)}
    for n, e in errs.items():
        require(e <= tol, f"flash_attention_lse autograd: {n} error {e}")
    log("kernels", "flash_attention_lse autograd, GQA 8/2, dlse != 0, "
        "the larger of the relative and the row error: "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" (tol {tol:.0e})")


def _flash_work(shape, element_size):
    """(bytes, operations) of K4, K5, K6 at a causal [B, T, H, D]: each
    input read once and each output written once; 4, 6 and 8 D
    operations per unmasked (query, key) pair."""
    B, T, H, D = shape
    n = B * T * H * D * element_size
    rows = B * T * H * 4
    pairs = B * H * T * (T + 1) // 2
    return {"flash_fwd": (4 * n + rows, 4 * D * pairs),
            "flash_bwd_dq": (5 * n + 2 * rows, 6 * D * pairs),
            "flash_bwd_dkv": (6 * n + 2 * rows, 8 * D * pairs)}


def _time_flash(FA, shape, gen, dev, with_plain: bool) -> dict:
    """K4, K5, K6 at a bf16 causal [B, T, H, D], each timed alone (10
    launches after 2), on both routes; one PyTorch call of the
    same function (F.scaled_dot_product_attention forward, and its
    backward for dq, dk and dv at once); the plain versions (3 calls
    after 1) where `with_plain`; the bound."""
    import torch
    import torch.nn.functional as F

    B, T, H, D = shape
    q, k, v, do, _ = _flash_case_inputs(
        (B, T, H, H, D, torch.bfloat16, True, None, 0), gen, dev)
    o, lse = FA.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    runs = {
        "flash_fwd": (
            lambda: FA.flash_fwd(q, k, v, True),
            lambda: FA.flash_fwd(q, k, v, True, sm90=False),
            lambda: FA.flash_fwd_plain(q, k, v, True)),
        "flash_bwd_dq": (
            lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                    sm90=False),
            lambda: FA.flash_bwd_dq_plain(q, k, v, do, lse, delta, True)),
        "flash_bwd_dkv": (
            lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, True,
                                     sm90=False),
            lambda: FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True)),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=10)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), iters=10)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    work = _flash_work(shape, q.element_size())
    results = {}
    for name, (kernel, cuda_core, plain) in runs.items():
        bound = bound_ms(*work[name], peak=HALF_FLOPS)
        r = dict(ms=cuda_time_ms(kernel, iters=10, warmup=2),
                 library_ms=library[name], bound_ms=bound[0],
                 bound_by=bound[1])
        line = (f"{name} {shape} bf16 causal: ms={r['ms']:.4f} "
                f"library_ms={library[name]:.4f} bound_ms={bound[0]:.4f} "
                f"({bound[1]}, {bound[0] / r['ms']:.1%} of it)")
        if with_plain:
            r["plain_ms"] = cuda_time_ms(plain, iters=3, warmup=1)
            line += f" plain_ms={r['plain_ms']:.4f}"
        r["cuda_core_ms"] = cuda_time_ms(cuda_core, iters=10, warmup=2)
        line += (f"; tensor cores (flash_attention_sm90.cu), the CUDA-core "
                 f"kernel at this shape ms={r['cuda_core_ms']:.4f} "
                 f"({r['cuda_core_ms'] / r['ms']:.1f}x)")
        # The route `_sm90_route` fixes for bf16 at this D must be the
        # faster one.
        require(r["ms"] < r["cuda_core_ms"],
                f"{name} {shape}: the tensor-core kernel ({r['ms']:.4f} ms) "
                f"is not faster than the CUDA-core one "
                f"({r['cuda_core_ms']:.4f} ms)")
        log("kernels", line)
        results[name] = r
    # The library's backward computes dq, dk and dv in one call: both
    # backward rows carry its time, which covers the two kernels' work.
    bwd = results["flash_bwd_dq"]["ms"] + results["flash_bwd_dkv"]["ms"]
    log("kernels", f"flash backward {shape}, flash_bwd_dq + flash_bwd_dkv:"
        f" ms={bwd:.4f} against one library backward (dq, dk, dv) "
        f"library_ms={lib_bwd:.4f}: {bwd / lib_bwd:.1f}x")
    del q, k, v, do, o, lse, delta, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return results


def check_flash(FA):
    """The flash kernels against their plain versions, then timed at the
    transformer's attention shape and at the same width in 128-wide
    heads."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (B, T, Hq, Hkv, D, dtype, causal, window, segments)
    cases = [(1, 4096, 8, 8, 64, bf16, True, None, 0),
             (2, 1024, 4, 4, 64, f32, False, None, 0),
             (1, 2048, 4, 4, 64, f16, True, 256, 0),
             (2, 1024, 8, 2, 64, bf16, True, None, 0),
             (1, 1024, 8, 1, 128, f32, True, None, 0),
             (2, 512, 4, 4, 32, f32, True, None, 4),
             (2, 512, 4, 4, 128, bf16, False, None, 3),
             (1, 512, 2, 2, 256, f32, True, None, 0),
             (1, 512, 2, 2, 256, bf16, False, None, 0),
             (1, 384, 4, 2, 40, f16, True, 100, 0),
             (1, 2048, 4, 4, 128, bf16, True, None, 0),
             (1, 1024, 4, 1, 128, f16, True, 300, 0),
             (2, 1024, 8, 2, 64, bf16, True, 200, 3)]
    for case in cases:
        _check_flash_case(FA, case, gen, dev)
    _check_flash_autograd(FA, gen, dev)

    # At the two timed shapes, K4-K6 on both routes against the plain
    # versions before they are timed.
    def both_routes(shape):
        B, T, H, D = shape
        case = (B, T, H, H, D, bf16, True, None, 0)
        _check_flash_case(FA, case, gen, dev, sm90=False)
        return _check_flash_case(FA, case, gen, dev)

    errs = both_routes(MAIN_ATTN)
    both_routes(WIDE_ATTN)
    results = _time_flash(FA, MAIN_ATTN, gen, dev, with_plain=True)
    wide = _time_flash(FA, WIDE_ATTN, gen, dev, with_plain=False)
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        r["d128"] = wide[name]
    return results


def _k3_case(gen, dev, mm, kk, nn, dtype, layout):
    """Operands of one K3 case: a (mm, kk), b = w.t() for a (nn, kk)
    weight band (as `fused_allgather_matmul` hands them) and the output,
    laid out as `layout` says: "head" (a, w and the output contiguous),
    "band" (the output the first nn columns of a wider one whose row
    pitch is a multiple of 4), "offset" (a's base one element past an
    aligned one), "k_strided" (a stored K-major, so that its rows are
    strided along K), "odd_ldc" (the output the first nn columns of one
    2 nn + 1 wide)."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    a, w = randn(mm, kk), randn(nn, kk)
    out = torch.zeros((mm, nn), dtype=dtype, device=dev)
    if layout == "band":
        out = torch.zeros((mm, nn + 4 - nn % 4), dtype=dtype,
                          device=dev)[:, :nn]
    elif layout == "offset":
        a = randn(mm * kk + 1)[1:].view(mm, kk)
    elif layout == "k_strided":
        a = randn(kk, mm).t()
    elif layout == "odd_ldc":
        out = torch.zeros((mm, 2 * nn + 1), dtype=dtype, device=dev)[:, :nn]
    return a, w.t(), out


def check_k3(MK):
    """K3 against its plain version at the ZeRO-3 head's chunk shapes and
    at unaligned ones, on both load paths (each case checks which one
    ran: `vector_path`), then timed at the head chunk.  b is the
    transposed view of a (N, K) weight band, as `fused_allgather_matmul`
    hands it."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(777)
    m, k, n = HEAD_CHUNK
    # (M, K, N, layout, vector path in f32, in bf16 / f16): the head's
    # chunks; K off the kernel's 32-deep stage (304: a 16-deep tail; 300,
    # whose 16-bit rows are not 16-byte multiples); row pitches off 16
    # bytes (257); ldc off 4 (3, 513); 1x1x1; N off 4 into a band whose
    # pitch is a multiple of 4; then a base one element off, an operand
    # strided along K and an odd ldc, each at two sizes.
    cases = [(m, k, n, "head", True, True), (m, k, 256, "head", True, True),
             (m, k, 128, "head", True, True),
             (200, 304, 132, "head", True, True),
             (200, 300, 132, "head", True, False),
             (129, 257, 3, "head", False, False),
             (7, 1000, 512, "head", True, True),
             (7, 1000, 513, "head", False, False),
             (1, 1, 1, "head", True, True),
             (300, 512, 130, "band", True, True)]
    cases += [(mm, kk, nn, layout, False, False)
              for layout in ("offset", "k_strided", "odd_ldc")
              for (mm, kk, nn) in ((300, 512, 256), (129, 96, 77))]
    errs = {}
    for (mm, kk, nn, layout, vec32, vec16) in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            a, b, c = _k3_case(gen, dev, mm, kk, nn, dtype, layout)
            vec = MK.vector_path(
                a.element_size(), mm, nn, kk, a.data_ptr(), a.stride(0),
                a.stride(1), b.data_ptr(), b.stride(0), b.stride(1),
                c.data_ptr(), c.stride(0) if mm > 1 else nn)
            require(vec == (vec32 if dtype == torch.float32 else vec16),
                    f"K3 ({mm}, {kk}) @ ({kk}, {nn}) {dtype} {layout}: "
                    f"vector path {vec}")
            before = MK.tiled_matmul.strided_launches
            got = MK.tiled_matmul(a, b, out=c)
            want = MK.tiled_matmul_plain(a, b)
            torch.cuda.synchronize()
            require(MK.tiled_matmul.strided_launches - before == (not vec),
                    f"K3 {layout}: the strided path ran "
                    f"{MK.tiled_matmul.strided_launches - before} times")
            tol = K3_RTOL[str(dtype)]
            rel = _rel_err(got, want)
            require(got.dtype == dtype and math.isfinite(rel) and rel <= tol,
                    f"K3 ({mm}, {kk}) @ ({kk}, {nn}) {dtype} {layout}: "
                    f"{rel} > {tol}")
            if (mm, kk, nn) == HEAD_CHUNK and dtype == torch.float32:
                errs["max_abs_err"] = float((got - want).abs().max())
            log("kernels", f"tiled_matmul ({mm}, {kk}) @ ({kk}, {nn}) "
                f"{str(dtype)[6:]} {layout}, "
                f"{'vector' if vec else 'strided'} path: relative error "
                f"{rel:.2e} (tol {tol:.2e})")
    # Into a column band of a wider output, as the fused head writes it.
    a = torch.randn((300, 384), generator=gen, device=dev)
    w = torch.randn((130, 384), generator=gen, device=dev)
    wide = torch.zeros((300, 400), device=dev)
    MK.tiled_matmul(a, w.t(), out=wide[:, 7:137])
    want = MK.tiled_matmul_plain(a, w.t())
    rel = _rel_err(wide[:, 7:137], want)
    require(rel <= K3_RTOL["torch.float32"] and not wide[:, :7].any()
            and not wide[:, 137:].any(), f"K3 into a column band: {rel}")
    log("kernels", f"tiled_matmul into columns 7:137 of (300, 400): "
        f"relative error {rel:.2e}, the rest untouched")

    a = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((n, k), generator=gen, device=dev)
    b = w.t()
    ms = cuda_time_ms(lambda: MK.tiled_matmul(a, b))
    plain_ms = cuda_time_ms(lambda: MK.tiled_matmul_plain(a, b))
    # One library call of the same function: cuBLAS SGEMM (TF32 off).
    lib_ms = cuda_time_ms(lambda: torch.matmul(a, b))
    # The strided path at the same shape: a's base one element off.
    a_off = torch.empty((m * k + 1,), device=dev)[1:].view(m, k).copy_(a)
    strided_ms = cuda_time_ms(lambda: MK.tiled_matmul(a_off, b))
    bound = bound_ms(4 * (m * k + k * n + m * n), 2 * m * n * k)
    log("kernels", f"tiled_matmul {HEAD_CHUNK[0]}x{k} @ {k}x{n} f32: "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
        f"bound_ms={bound[0]:.4f} ({bound[1]}, {bound[0] / ms:.1%} of it) "
        f"max_abs_err={errs['max_abs_err']:.3g}; the strided path "
        f"ms={strided_ms:.4f}")
    del a, w, b, wide, got, want, a_off
    torch.cuda.empty_cache()
    return {"tiled_matmul": dict(errs, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bound[0],
                                 bound_by=bound[1], strided_ms=strided_ms)}


def check_head():
    """The tied head at the transformer's shape: `TiedHead` (bf16 x bf16
    with f32 output on the tensor cores) against the f32 einsum of the
    bf16-rounded operands that it replaced: logits within HEAD_RTOL of
    their largest value, both gradients equal; both forwards timed, and
    the bf16 GEMM with a bf16 output beside them."""
    import torch
    from horovod_tpu_torch.models.transformer import TiedHead

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(77)
    t, d, v = HEAD_SHAPE
    dt = torch.bfloat16
    h = torch.randn((1, t, d), generator=gen, device=dev).to(dt)
    e = torch.randn((v, d), generator=gen, device=dev) / math.sqrt(d)
    g = torch.randn((1, t, v), generator=gen, device=dev) / t

    def run(fn):
        hh, ee = h.clone().requires_grad_(), e.clone().requires_grad_()
        out = fn(hh, ee)
        out.backward(g)
        return out.detach(), hh.grad, ee.grad

    def old(hh, ee):
        return torch.einsum("btd,vd->btv", hh.to(dt).float(),
                            ee.to(dt).float())

    want, wh, we = run(old)
    got, gh, ge = run(lambda hh, ee: TiedHead.apply(hh, ee, dt))
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    require(got.dtype == torch.float32 and rel <= HEAD_RTOL,
            f"tied head: logits {rel} off the f32 path (tol {HEAD_RTOL})")
    require(torch.equal(gh, wh) and torch.equal(ge, we),
            "tied head: gradients differ from the f32 path's "
            f"(h {float((gh.float() - wh.float()).abs().max())}, "
            f"embed {float((ge - we).abs().max())})")
    del want, got, wh, we, gh, ge
    hb, eb = h[0], e.to(dt)
    with torch.no_grad():
        ms = cuda_time_ms(lambda: TiedHead.apply(h, e, dt), iters=10)
        f32_ms = cuda_time_ms(lambda: old(h, e), iters=10)
        bf16_ms = cuda_time_ms(lambda: hb @ eb.t(), iters=10)
    bound = bound_ms(2 * t * d + 4 * v * d + 4 * t * v, 2 * t * d * v,
                     peak=HALF_FLOPS)
    log("kernels", f"tied head {HEAD_SHAPE} bf16 -> f32: logits rel err "
        f"{rel:.3g} (tol {HEAD_RTOL}), gradients equal to the f32 "
        f"path's; forward GEMM ms={ms:.4f} (torch.mm out_dtype=float32), "
        f"f32 path ms={f32_ms:.4f}, bf16-output GEMM ms={bf16_ms:.4f}, "
        f"bound_ms={bound[0]:.4f} ({bound[1]})")
    torch.cuda.empty_cache()
    return {"ms": ms, "f32_ms": f32_ms, "bf16_ms": bf16_ms, "rel": rel}


# ---------------------------------------------------------------------------
# Phases 4 to 9: the training paths in subprocess ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RESNET = "horovod_tpu_torch.synthetic_benchmark"
TRANSFORMER = "horovod_tpu_torch.transformer_benchmark"


def run_ranks(phase: str, nranks: int, module: str, args, timeout: float,
              env=None, rank_env=None):
    """Run `python -m module args` as `nranks` processes, rank r on card
    r mod the card count (all on card 0 when there is one), with `env`
    (and `rank_env(r)`) added to the environment; return each rank's
    stdout lines.  Raises if a rank fails or times out."""
    port = _free_port()
    os.makedirs(LOG_DIR, exist_ok=True)
    procs = []
    try:
        for r in range(nranks):
            renv = dict(os.environ, **(env or {}),
                        **(rank_env(r) if rank_env else {}),
                        HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                        HOROVOD_NUM_PROCESSES=str(nranks),
                        HOROVOD_PROCESS_ID=str(r),
                        HOROVOD_LOCAL_RANK=str(r),
                        HOROVOD_LOCAL_SIZE=str(nranks),
                        PYTHONPATH=os.pathsep.join(
                            [HERE] + [p for p in [os.environ.get(
                                "PYTHONPATH")] if p]))
            out = open(os.path.join(LOG_DIR, f"{phase}_rank{r}.log"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", module, *args], cwd=HERE, env=renv, stdout=out,
                stderr=subprocess.STDOUT, text=True), out))
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        outputs = []
        for r, (p, out) in enumerate(procs):
            out.seek(0)
            text = out.read()
            if p.returncode != 0:
                raise RuntimeError(f"{phase}: rank {r} exited "
                                   f"{p.returncode}:\n{text[-4000:]}")
            outputs.append(text.splitlines())
        return outputs
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()


def _records(lines, tag):
    return [json.loads(l[len(tag) + 1:]) for l in lines
            if l.startswith(tag + " ")]


def launch(phase: str, nranks: int, args, module: str = RESNET,
           grow=None, timeout: float = 900, env=None, rank_env=None):
    """Run `nranks` ranks of `module` with `args` (and `env`) and hold
    them to the checks every training run shares; return each rank's
    SUMMARY, with its STEP losses added as `step_losses` and its EVAL
    records as `evals`.

    Every rank's last loss is finite.  With `--log-steps`, every rank
    logged one STEP line per step it took, and on every step: each loss
    is finite, the parameters' SHA-256 is the same on every rank, and
    each kernel named in `grow` launched on every rank: exactly
    grow[name] times, or at least once where that is None.  With
    `--check-plain-step`, rank 0's rerun with the plain versions agrees
    with the kernels: the Adasum combine within COMBINE_RTOL of the
    result's largest value; the transformer's logits within LOGITS_RTOL
    of their largest value (and the non-causal fault's beyond it), its
    loss within LOSS_TOL.  A held-out forward's launches (an EVAL line
    after a step's STEP line) do not count toward the next step's."""
    outs = run_ranks(phase, nranks, module, args, timeout, env=env,
                     rank_env=rank_env)
    steps = [_records(lines, "STEP") for lines in outs]
    evals = [_records(lines, "EVAL") for lines in outs]
    summaries = [_records(lines, "SUMMARY")[-1] for lines in outs]
    for lines, s, recs, ev in zip(outs, summaries, steps, evals):
        require(math.isfinite(s["last_loss"]), f"non-finite loss {s}")
        s["step_losses"] = [rec["loss"] for rec in recs]
        s["evals"] = ev
        for tag in ("SUMMARY", "PROFILE", "EVAL"):
            for rec in _records(lines, tag):
                log(phase, f"{tag} {json.dumps(rec)}")
    if "--log-steps" not in args:
        return summaries
    grow = grow or {}
    for s, recs in zip(summaries, steps):
        require(len(recs) == s["steps"] > 0,
                f"rank {s['rank']} logged {len(recs)} of {s['steps']} steps")
    before = [dict.fromkeys(steps[0][0]["launches"], 0)] * nranks
    checked = False
    for i, recs in enumerate(zip(*steps)):
        for r, rec in enumerate(recs):
            require(math.isfinite(rec["loss"]), f"non-finite loss {rec}")
            for name, n in grow.items():
                got = rec["launches"][name] - before[r][name]
                require(got == n if n is not None else got > 0,
                        f"step {i}, rank {r}: {name} launched {got} times "
                        f"(want {n if n is not None else '> 0'})")
            before[r] = rec["launches"]
            for ev in evals[r]:
                if ev["step"] == rec["step"]:
                    before[r] = ev["launches"]
        digests = {rec["digest"] for rec in recs}
        require(len(digests) == 1, f"step {i}: parameters differ {digests}")
        line = (f"step {i}: loss " + ", ".join(f"{r['loss']:.4f}" for r in recs)
                + f"; launches {[r['launches'] for r in recs]}; one digest "
                f"{recs[0]['digest'][:16]}")
        if "plain_max_abs_diff" in recs[0]:
            diff = recs[0]["plain_max_abs_diff"]
            tol = COMBINE_RTOL * recs[0]["plain_max_abs"]
            require(diff <= tol, f"combine: kernels vs plain {diff} > {tol}")
            line += f"; rank 0 combine, kernels vs plain max_abs_diff=" \
                    f"{diff:.3g} (tol {tol:.3g})"
            checked = True
        if "plain_loss" in recs[0]:
            rec = recs[0]
            diff = abs(rec["plain_loss"] - rec["loss"])
            rel, bad = rec["plain_logits_rel"], rec["faulted_logits_rel"]
            require(diff <= LOSS_TOL, f"loss: kernels {rec['loss']} vs "
                    f"plain attention {rec['plain_loss']}")
            require(rel <= LOGITS_RTOL, f"logits: kernels vs plain "
                    f"attention {rel} > {LOGITS_RTOL}")
            require(bad > LOGITS_RTOL, f"logits: the non-causal fault "
                    f"reads {bad}, within {LOGITS_RTOL}")
            head = rec["head_logits_rel"]
            require(head <= HEAD_RTOL, f"tied head: logits {head} off the "
                    f"f32 path (tol {HEAD_RTOL})")
            line += f"; tied head vs f32 path {head:.3g} (tol {HEAD_RTOL})"
            line += (f"; rank 0 with plain attention: logits rel diff "
                     f"{rel:.3g} (tol {LOGITS_RTOL}), loss "
                     f"{rec['plain_loss']:.6f}, diff {diff:.3g} (tol "
                     f"{LOSS_TOL}); made non-causal: logits rel diff "
                     f"{bad:.3g}, loss diff "
                     f"{abs(rec['faulted_loss'] - rec['loss']):.3g}")
            checked = True
        log(phase, line)
    if "--check-plain-step" in args and (module == TRANSFORMER or
                                         "--use-adasum" in args):
        require(checked, "no step compared the kernels with the plain "
                "versions")
    return summaries


def train_adasum():
    summaries = launch("train_adasum", 2, [
        "--use-adasum", "--depth", "50", "--num-classes", "1000",
        "--image-size", "224", "--batch-size", "32",
        "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
        "--num-iters", "3", "--log-steps", "--check-plain-step", "1"],
        grow=ADASUM_GROW, timeout=600)
    require(all(s["steps"] == 3 for s in summaries),
            f"steps per rank: {[s['steps'] for s in summaries]}")
    for s in summaries:
        log("train_adasum", f"rank {s['rank']}: {s['img_sec_per_rank']:.2f} "
            f"img/sec (3 steps, checks included), backend {s['backend']}, "
            f"launches {s['launches']}")
    return summaries


def train_average():
    (s,) = launch("train_average", 1, [
        "--depth", "50", "--num-classes", "1000", "--image-size", "224",
        "--batch-size", "64", "--num-warmup-batches", "3",
        "--num-batches-per-iter", "5", "--num-iters", "3"], timeout=400)
    require(s["backend"] == "nccl", s)
    log("train_average", f"{s['img_sec_per_rank']:.2f} img/sec "
        f"(+- {1.96 * s['img_sec_std']:.2f}), batch 64, backend "
        f"{s['backend']}, buckets flushed {s['flushes']} over "
        f"{s['steps']} steps, last loss {s['last_loss']:.4f}")
    return s


def train_transformer():
    summaries = launch("train_transformer", 2, [
        "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
        "--num-iters", "3", "--log-steps", "--check-plain-step", "1"],
        module=TRANSFORMER, timeout=600, grow=FLASH_GROW)
    require(all(s["steps"] == 3 and s["n_layers"] == 8 for s in summaries),
            f"steps per rank: {[s['steps'] for s in summaries]}")
    for s in summaries:
        log("train_transformer", f"rank {s['rank']}: "
            f"{s['tok_sec_per_rank']:.1f} tok/sec (3 steps, checks "
            f"included), backend {s['backend']}, peak memory "
            f"{s['peak_mem_gb']:.2f} GB, launches {s['launches']}")
    return summaries


def transformer_nccl():
    (s,) = launch("transformer_nccl", 1, [
        "--num-warmup-batches", "2", "--num-batches-per-iter", "3",
        "--num-iters", "3"], module=TRANSFORMER, timeout=400)
    require(s["backend"] is None or s["backend"] == "nccl", s)
    log("transformer_nccl", f"{s['tok_sec_per_rank']:.1f} tok/sec "
        f"(+- {1.96 * s['tok_sec_std']:.1f}), T 16384, batch 1, one rank "
        f"on the card, peak memory {s['peak_mem_gb']:.2f} GB, last loss "
        f"{s['last_loss']:.4f}")
    return s


def train_zero3(stage0):
    """Main path 3 (see the module docstring); `stage0`: phase 6's
    summaries, the same seeds and data at stage 0."""
    summaries = launch("train_zero3", 2, [
        "--zero-stage", "3", "--num-warmup-batches", "0",
        "--num-batches-per-iter", "1", "--num-iters", "3", "--log-steps",
        "--eval-every", "3", "--check-plain-step", "2"],
        module=TRANSFORMER, timeout=600, env=ZERO3_ENV, grow=FLASH_GROW)
    tol = K3_RTOL["torch.float32"]
    for s, s0 in zip(summaries, stage0):
        r = s["rank"]
        require(s["steps"] == 3 and s["n_layers"] == 8 and
                s["zero_stage"] == 3, f"rank {r}: {s}")
        diffs = [abs(a - b) for a, b in zip(s["step_losses"],
                                            s0["step_losses"])]
        require(len(diffs) == 3 and max(diffs) <= LOSS_TOL,
                f"rank {r}: stage-3 losses {s['step_losses']} vs stage 0 "
                f"{s0['step_losses']}")
        cap = s["param_full_bytes"] // 2 + 4 * s["shard_groups"]
        require(s["param_resident_bytes"] <= cap,
                f"rank {r}: resident {s['param_resident_bytes']} > {cap}")
        require(s["param_storage_bytes"] == 0,
                f"rank {r}: parameters hold {s['param_storage_bytes']} "
                "bytes between steps (want 0)")
        require(s["peak_mem_gb"] <= s0["peak_mem_gb"],
                f"rank {r}: stage 3 peaks at {s['peak_mem_gb']:.3f} GB, "
                f"stage 0 at {s0['peak_mem_gb']:.3f}")
        (ev,) = s["evals"]
        require(ev["k3_launches"] == 64 and ev["k3_plain_calls"] == 0
                and ev["k3_strided_launches"] == 0,
                f"rank {r}: eval forward launched K3 {ev['k3_launches']} "
                f"times (want 64), {ev['k3_strided_launches']} on the "
                "strided path (want 0)")
        require(ev["eval_logits_rel"] <= tol and
                math.isfinite(ev["eval_loss"]),
                f"rank {r}: eval logits vs the plain head "
                f"{ev['eval_logits_rel']} (tol {tol}), loss {ev['eval_loss']}")
        log("train_zero3", f"rank {r}: {s['tok_sec_per_rank']:.1f} tok/sec "
            f"(3 steps, checks included); losses vs stage 0 max diff "
            f"{max(diffs):.3g} (tol {LOSS_TOL}); params resident "
            f"{s['param_resident_bytes']} of {s['param_full_bytes']} bytes "
            f"in {s['shard_groups']} shard groups (parameters' storage "
            f"{s['param_storage_bytes']}); peak memory "
            f"{s['peak_mem_gb']:.3f} GB (stage 0 {s0['peak_mem_gb']:.3f}), "
            f"between steps {s['between_steps_mem_gb']:.3f} GB (stage 0 "
            f"{s0['between_steps_mem_gb']:.3f}); "
            f"optimizer state "
            f"{s['opt_state_bytes']} bytes; eval forward: K3 launches "
            f"{ev['k3_launches']} (strided path "
            f"{ev['k3_strided_launches']}), logits vs plain head "
            f"{ev['eval_logits_rel']:.3g} (tol {tol}), loss "
            f"{ev['eval_loss']:.4f}; launches {s['launches']}")
    return summaries


def zero3_nccl(stage0):
    """One rank on NCCL at stage 3; `stage0`: phase 7's summary."""
    (s,) = launch("zero3_nccl", 1, [
        "--zero-stage", "3", "--num-warmup-batches", "2",
        "--num-batches-per-iter", "3", "--num-iters", "3",
        "--eval-every", "11"], module=TRANSFORMER, timeout=400,
        env=ZERO3_ENV)
    require(s["backend"] == "nccl", s)
    cap = s["param_full_bytes"] + 4 * s["shard_groups"]
    require(s["param_storage_bytes"] == 0 and
            s["param_resident_bytes"] <= cap,
            f"parameters hold {s['param_storage_bytes']} bytes between "
            f"steps (want 0), resident {s['param_resident_bytes']} (cap "
            f"{cap})")
    (ev,) = s["evals"]
    require(ev["k3_launches"] == 63 and ev["k3_strided_launches"] == 0
            and math.isfinite(ev["eval_loss"]),
            f"eval forward launched K3 {ev['k3_launches']} times (want 63), "
            f"{ev['k3_strided_launches']} on the strided path (want 0)")
    log("zero3_nccl", f"{s['tok_sec_per_rank']:.1f} tok/sec "
        f"(+- {1.96 * s['tok_sec_std']:.1f}) at stage 3 against "
        f"{stage0['tok_sec_per_rank']:.1f} (+- "
        f"{1.96 * stage0['tok_sec_std']:.1f}) at stage 0, T 16384, one "
        f"rank; resident parameter bytes {s['param_resident_bytes']}, "
        f"their storage {s['param_storage_bytes']}; peak memory "
        f"{s['peak_mem_gb']:.2f} GB (stage 0 "
        f"{stage0['peak_mem_gb']:.2f}); eval forward K3 launches "
        f"{ev['k3_launches']} (strided path {ev['k3_strided_launches']}), "
        f"loss {ev['eval_loss']:.4f}")
    return s


# ---------------------------------------------------------------------------
# Phase 10: the collective surface on the card
# ---------------------------------------------------------------------------

SURFACE_STEPS = (1, 2)  # join: rank r takes SURFACE_STEPS[r] steps


def _surface_inputs(r: int, n: int) -> dict:
    """Rank r's inputs: integer-valued f32 (every sum below is exact),
    ragged where the op allows it."""
    import numpy as np

    rng = np.random.RandomState(600 + r)

    def ints(*shape):
        return rng.randint(-8, 9, size=shape).astype(np.float32)

    splits = [1 + (r + k) % 3 for k in range(n)]
    return {"rag": ints(r + 2, 3), "bf": ints(2 * r + 1, 4),
            "a2a": ints(2 * n, 5), "a2av": ints(sum(splits), 2),
            "splits": np.asarray(splits, np.int64), "rs": ints(2 * n + 1, 3),
            "x": ints(6), "w": ints(6), "wrag": ints(n * (n + 3) // 2, 3),
            "join": ints(max(SURFACE_STEPS), 4)}


def surface_rank() -> int:
    """One rank of phase 10 (run by `surface_np2` through run_ranks):
    every new collective, join and the autograd wrappers on CUDA
    tensors; the results go to LOG_DIR/surface_rank<r>.pt."""
    import torch
    import horovod_tpu_torch as hvd

    hvd.init()
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    require(dev.type == "cuda", f"rank {r} runs on {dev}")
    d = {k: torch.from_numpy(v).to(dev)
         for k, v in _surface_inputs(r, n).items()}
    res, ms = {"backend": hvd.backend()}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    res["allgather"] = timed("allgather", lambda: hvd.allgather(d["rag"]))
    res["grouped_allgather"] = timed("grouped_allgather", lambda: (
        hvd.grouped_allgather([d["rag"], d["bf"].bfloat16()])))
    res["alltoall"] = timed("alltoall", lambda: hvd.alltoall(d["a2a"]))
    res["alltoallv"] = timed("alltoallv", lambda: hvd.alltoall(
        d["a2av"], splits=d["splits"].tolist()))
    res["reducescatter"] = timed("reducescatter", lambda: (
        hvd.reducescatter(d["rs"], op=hvd.Sum)))
    res["grouped_reducescatter"] = timed("grouped_reducescatter", lambda: (
        hvd.grouped_reducescatter([d["rs"], d["a2a"]], op=hvd.Average)))
    handles = [hvd.allgather_async(d["rag"]),
               hvd.grouped_allgather_async([d["bf"]]),
               hvd.alltoall_async(d["a2av"], splits=d["splits"].tolist()),
               hvd.reducescatter_async(d["rs"], op=hvd.Sum)]
    res["async"] = [hvd.synchronize(h) for h in handles]
    sub = hvd.add_process_set([1])
    if sub.included():
        res["subset"] = hvd.allreduce(d["x"], op=hvd.Sum, process_set=sub)
    hvd.barrier()
    hvd.remove_process_set(sub)

    def grad(fn, x, w):
        x = x.clone().requires_grad_()
        y = fn(x)
        y = y[0] if isinstance(y, tuple) else y
        (y * w).sum().backward()
        return x.grad

    res["grad_allreduce"] = grad(lambda x: hvd.allreduce(x, op=hvd.Sum),
                                 d["x"], d["w"])
    res["grad_allgather"] = grad(hvd.allgather, d["rag"], d["wrag"])
    res["grad_broadcast"] = grad(lambda x: hvd.broadcast(x, root_rank=1),
                                 d["x"], d["w"])
    rows = res["reducescatter"].shape[0]
    res["grad_reducescatter"] = grad(
        lambda x: hvd.reducescatter(x, op=hvd.Sum), d["rs"],
        d["wrag"][:rows].sum(1, keepdim=True).expand(rows, 3))
    recv = res["alltoallv"][0].shape[0]
    res["grad_alltoall"] = grad(
        lambda x: hvd.alltoall(x, splits=d["splits"].tolist()), d["a2av"],
        torch.arange(recv * 2, dtype=torch.float32, device=dev
                     ).reshape(recv, 2))
    res.update(surface_sparse_and_syncbn(hvd, dev, timed))
    hvd.join_mode()
    res["join_steps"] = [
        timed(f"join_allreduce_{s}", lambda s=s: hvd.allreduce(
            d["join"][s], op=hvd.Average))
        for s in range(SURFACE_STEPS[r])]
    res["join_last"] = timed("join", hvd.join)
    res["ms"] = ms
    torch.save(torch.utils._pytree.tree_map(
        lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, res),
        os.path.join(LOG_DIR, f"surface_rank{r}.pt"))
    hvd.shutdown()
    return 0


def surface_sparse_and_syncbn(hvd, dev, timed, embed=EMBED,
                              bn_shape=SYNC_BN_SHAPE) -> dict:
    """The sparse allreduce and SyncBatchNorm cases of phase 10, on this
    rank (see the module docstring).  Each rank makes every rank's
    inputs from their seeds and computes the references itself, so only
    the errors leave the rank.  Returns the errors and their scales."""
    import torch

    r, n = hvd.rank(), hvd.size()
    out = {}
    vocab, width, tokens = embed

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    g = gen(900 + r)
    ids = torch.randint(0, vocab, (tokens,), generator=g, device=dev)
    w = torch.randn((tokens, width), generator=g, device=dev)

    def embedding_grad(opt_kw=None):
        emb = torch.nn.Embedding(vocab, width, sparse=True, device=dev)
        opt = None
        if opt_kw is not None:
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(emb.parameters(), lr=0.1), **opt_kw)
        (emb(ids) * w).sum().backward()
        if opt is not None:
            opt.synchronize()
        return emb.weight.grad

    grad = embedding_grad()
    sparse = timed("sparse_allreduce", lambda: hvd.synchronize(
        hvd.sparse_allreduce_async(grad)))
    dense = timed("dense_allreduce", lambda: hvd.allreduce(grad.to_dense()))
    scale = float(dense.abs().max())
    out["sparse"] = {"is_sparse": sparse.is_sparse, "nnz": sparse._nnz(),
                     "scale": scale, "err": float(
                         (sparse.to_dense() - dense).abs().max())}
    for as_dense in (False, True):
        got = embedding_grad({"sparse_as_dense": as_dense})
        out[f"sparse_opt_{as_dense}"] = {
            "is_sparse": got.is_sparse,
            "err": float((got.to_dense() - dense).abs().max())}

    # SyncBatchNorm against one BatchNorm2d over every rank's batch.
    c = bn_shape[1]
    xs = [torch.randn(bn_shape, generator=gen(950 + q), device=dev)
          .mul_(2).add_(0.5).bfloat16() for q in range(n)]
    ws = [torch.randn(bn_shape, generator=gen(970 + q), device=dev)
          .bfloat16() for q in range(n)]
    g = gen(990)
    scale_w = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev)
    sbn = hvd.SyncBatchNorm(c).to(dev)
    ref = torch.nn.BatchNorm2d(c).to(dev)
    with torch.no_grad():
        for m in (sbn, ref):
            m.weight.copy_(scale_w)
            m.bias.copy_(bias)
    x = xs[r].clone().requires_grad_()
    y = timed("sync_batchnorm_forward", lambda: sbn(x))
    timed("sync_batchnorm_backward", lambda: (
        y.float() * ws[r].float()).sum().backward())
    xa = torch.cat(xs).float().requires_grad_()
    ya = ref(xa)
    (ya * torch.cat(ws).float()).sum().backward()
    mine = slice(r * bn_shape[0], (r + 1) * bn_shape[0])
    wsum = hvd.allreduce(sbn.weight.grad, op=hvd.Sum)
    bsum = hvd.allreduce(sbn.bias.grad, op=hvd.Sum)

    def rel(got, want):
        got, want = got.detach().float(), want.detach().float()
        return float((got - want).abs().max() / want.abs().max())

    out["sync_bn"] = {
        "dtype": str(y.dtype), "y": rel(y, ya[mine]),
        "grad_x": rel(x.grad, xa.grad[mine]),
        "running_mean": rel(sbn.running_mean, ref.running_mean),
        "running_var": rel(sbn.running_var, ref.running_var),
        "grad_weight": rel(wsum, ref.weight.grad),
        "grad_bias": rel(bsum, ref.bias.grad)}
    return out


def surface_np2() -> None:
    """Phase 10: two ranks on the card over gloo (see the module
    docstring); every result against numpy, bitwise."""
    import numpy as np
    import torch

    n = 2
    run_ranks("surface_np2", n, "chip_smoke", ["--surface-rank"], 300)
    res = [torch.load(os.path.join(LOG_DIR, f"surface_rank{r}.pt"),
                      weights_only=False) for r in range(n)]
    ins = [_surface_inputs(r, n) for r in range(n)]

    def same(got, want, what):
        got = got.float().numpy() if isinstance(got, torch.Tensor) else got
        require(np.array_equal(np.asarray(got, np.float64),
                               np.asarray(want, np.float64)),
                f"surface_np2 {what}: {got} != {want}")

    rag = np.concatenate([i["rag"] for i in ins])
    bf = np.concatenate([i["bf"] for i in ins])
    rs_sum = sum(i["rs"] for i in ins)
    c = -(-rs_sum.shape[0] // n)
    a2a_sum = sum(i["a2a"] for i in ins)
    wsum = sum(i["w"] for i in ins)
    for r, d in enumerate(res):
        require(d["backend"] == "gloo", f"rank {r}: backend {d['backend']}")
        recv = [ins[s]["splits"][r] for s in range(n)]
        offs = [[int(sum(ins[s]["splits"][:k])) for k in range(n + 1)]
                for s in range(n)]
        a2av = np.concatenate([ins[s]["a2av"][offs[s][r]:offs[s][r + 1]]
                               for s in range(n)])
        a2a = np.concatenate([ins[s]["a2a"][2 * r:2 * r + 2]
                              for s in range(n)])
        same(d["allgather"], rag, "ragged allgather")
        same(d["grouped_allgather"][0], rag, "grouped allgather")
        same(d["grouped_allgather"][1], bf, "grouped allgather bf16")
        require(d["grouped_allgather"][1].dtype == torch.bfloat16,
                "grouped allgather: bf16 lost its dtype")
        same(d["alltoall"], a2a, "alltoall")
        same(d["alltoallv"][0], a2av, "alltoall with splits")
        same(d["alltoallv"][1], recv, "alltoall received splits")
        same(d["reducescatter"], rs_sum[r * c:(r + 1) * c], "reducescatter")
        grs = d["grouped_reducescatter"]
        same(grs[0], rs_sum[r * c:(r + 1) * c] / n, "grouped reducescatter")
        same(grs[1], (a2a_sum / n)[2 * r:2 * r + 2],
             "grouped reducescatter, second tensor")
        same(d["async"][0], rag, "allgather_async")
        same(d["async"][1][0], bf, "grouped_allgather_async")
        same(d["async"][2][0], a2av, "alltoall_async")
        same(d["async"][3], rs_sum[r * c:(r + 1) * c], "reducescatter_async")
        if r == 1:
            same(d["subset"], ins[1]["x"], "allreduce over the set [1]")
        else:
            require("subset" not in d, "rank 0 ran the set [1]'s allreduce")
        same(d["grad_allreduce"], wsum, "allreduce gradient")
        begin = sum(ins[s]["rag"].shape[0] for s in range(r))
        same(d["grad_allgather"],
             sum(i["wrag"] for i in ins)[begin:begin + r + 2],
             "allgather gradient")
        same(d["grad_broadcast"], wsum if r == 1 else 0 * wsum,
             "broadcast gradient")
        same(d["join_last"], n - 1, "join's last rank")
        for s, got in enumerate(d["join_steps"]):
            active = [q for q in range(n) if s < SURFACE_STEPS[q]]
            same(got, sum(ins[q]["join"][s] for q in active) / len(active),
                 f"masked Average at step {s}")
    # Gradients that cross ranks: reducescatter's is the allgather of
    # the row gradients, alltoall's goes back with the received splits.
    rs_w = [np.repeat(ins[r]["wrag"][:res[r]["reducescatter"].shape[0]]
                      .sum(1, keepdims=True), 3, 1) for r in range(n)]
    for r, d in enumerate(res):
        same(d["grad_reducescatter"], np.concatenate(rs_w),
             "reducescatter gradient")
    back = []
    for r in range(n):
        recv = res[r]["alltoallv"][0].shape[0]
        back.append(np.arange(recv * 2, dtype=np.float32).reshape(recv, 2))
    for r, d in enumerate(res):
        rows = []
        for s in range(n):
            # What rank s received from r sits after what it received
            # from the ranks before r.
            start = sum(ins[q]["splits"][s] for q in range(r))
            rows.append(back[s][start:start + ins[r]["splits"][s]])
        same(d["grad_alltoall"], np.concatenate(rows), "alltoall gradient")
    for r, d in enumerate(res):
        sp = d["sparse"]
        tol = SPARSE_RTOL * sp["scale"]
        require(sp["is_sparse"] and sp["err"] <= tol,
                f"rank {r}: sparse allreduce vs dense {sp}, tol {tol}")
        for as_dense in (False, True):
            got = d[f"sparse_opt_{as_dense}"]
            require(got["is_sparse"] != as_dense and got["err"] <= tol,
                    f"rank {r}: DistributedOptimizer(sparse_as_dense="
                    f"{as_dense}) gradient {got}, tol {tol}")
        bn = d["sync_bn"]
        require(bn["dtype"] == "torch.bfloat16", f"rank {r}: {bn}")
        for k in ("y", "grad_x", "grad_weight", "grad_bias"):
            require(bn[k] <= SYNC_BN_TOL, f"rank {r}: SyncBatchNorm {k} "
                    f"{bn[k]} > {SYNC_BN_TOL} of the largest value")
        for k in ("running_mean", "running_var"):
            require(bn[k] <= SYNC_BN_STAT_TOL, f"rank {r}: SyncBatchNorm "
                    f"{k} {bn[k]} > {SYNC_BN_STAT_TOL}")
        log("surface_np2", f"rank {r}: every result bitwise the numpy "
            f"reference; sparse allreduce of the embedding gradient "
            f"({sp['nnz']} entries) vs the dense allreduce: max abs "
            f"{sp['err']:.3g} (tol {tol:.3g}), the optimizer's sparse "
            f"route {d['sparse_opt_False']['err']:.3g}, sparse_as_dense "
            f"{d['sparse_opt_True']['err']:.3g}; SyncBatchNorm{SYNC_BN_SHAPE} "
            "bf16 vs BatchNorm2d over both batches, relative: " + ", ".join(
                f"{k} {v:.3g}" for k, v in bn.items() if k != "dtype")
            + f" (tol {SYNC_BN_TOL:.3g}, statistics {SYNC_BN_STAT_TOL}); "
            "host ms " + ", ".join(
                f"{k} {v:.2f}" for k, v in d["ms"].items()))


# ---------------------------------------------------------------------------
# Phase 11: elastic ResNet-50 under an injected fault
# ---------------------------------------------------------------------------

ELASTIC = "horovod_tpu_torch.elastic_resnet"


def elastic_fault_spec(steps: int, hits: int = ELASTIC_HITS_PER_STEP):
    """A seeded spec on `collective.allreduce` whose first fault falls in
    the backward of the fourth step (the second of its commit interval:
    the ranks roll a finished step back and replay it; past the step's
    hits/2 forward batch-norm allreduces, so the error comes out of the
    autograd engine) and whose next fault falls past everything the run
    can replay.  Found with the port's own schedule: a draw depends only
    on the seed, the point and the hit index, so every rank decides
    alike.  Returns (spec, seed, first hit)."""
    import logging

    from horovod_tpu_torch.faults import FaultSchedule, parse_spec

    start, end, p = 3 * hits + hits // 2 + 6, 4 * hits - 4, 0.001
    spec = f"collective.allreduce@{start}:err:{p}"
    quiet = logging.getLogger("horovod_tpu_torch.faults")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    try:
        for seed in range(100_000):
            sched = FaultSchedule(parse_spec(spec), seed=seed)
            fires = []
            for k in range(1, 3 * steps * hits):
                if sched._decide("collective.allreduce") is not None:
                    fires.append(k)
                if len(fires) == 2 or (k >= end and not fires) or \
                        (fires and fires[0] >= end):
                    break
            if (fires and fires[0] < end and
                    (len(fires) == 1 or fires[1] > 2 * steps * hits)):
                return spec, seed, fires[0]
    finally:
        quiet.setLevel(level)
    raise RuntimeError(f"no seed places one fault of {spec}")


def _elastic_run(name: str, env=None):
    outs = run_ranks(name, 2, ELASTIC, ELASTIC_ARGS, timeout=600, env=env)
    runs = []
    for r, lines in enumerate(outs):
        (summary,) = _records(lines, "SUMMARY")
        commits, resets = [], 0
        for line in lines:
            if line.startswith("COMMIT "):
                commits.append(json.loads(line[7:])["digest"])
            elif line.startswith("RESET "):
                resets += 1
                rec = json.loads(line[6:])
                require(commits and rec["digest"] == commits[-1],
                        f"{name}, rank {r}: after reset {resets} the "
                        f"parameters are not the last commit's")
        steps = _records(lines, "STEP")
        require(steps and all(math.isfinite(s["loss"]) for s in steps),
                f"{name}, rank {r}: a non-finite loss")
        epochs = _records(lines, "EPOCH")
        require(len(epochs) == 2 and all(e["covered"] and e["no_repeats"]
                                         for e in epochs),
                f"{name}, rank {r}: the sampler's epochs {epochs}")
        require(summary["resets"] == resets, f"{name}, rank {r}: {summary}")
        runs.append({"summary": summary,
                     "enters": [e["digest"] for e in
                                _records(lines, "ENTER")]})
    require(runs[0]["enters"] == runs[1]["enters"],
            f"{name}: the ranks' parameters differ after a sync")
    require(runs[0]["summary"]["digest"] == runs[1]["summary"]["digest"],
            f"{name}: the ranks end with different parameters")
    return [run["summary"] for run in runs]


def train_elastic():
    clean = _elastic_run("train_elastic_clean")
    steps = 2 * 4
    spec, seed, first = elastic_fault_spec(steps)
    faulted = _elastic_run("train_elastic_fault", env={
        "HOROVOD_FAULT_SPEC": spec, "HOROVOD_FAULT_SEED": str(seed)})
    require(all(s["resets"] == 0 for s in clean), f"fault-free run reset "
            f"{[s['resets'] for s in clean]} times")
    resets = [s["resets"] for s in faulted]
    require(resets[0] == resets[1] >= 1,
            f"resets per rank under {spec} (seed {seed}): {resets}")
    diffs = []
    for s, c in zip(faulted, clean):
        last = [k for k in c["losses"] if k.startswith("1.")]
        require(sorted(last) == sorted(k for k in s["losses"]
                                       if k.startswith("1.")),
                f"rank {s['rank']}: the last epoch's steps differ")
        diffs += [abs(s["losses"][k] - c["losses"][k]) for k in last]
    require(max(diffs) <= LOSS_TOL, f"the faulted run's last losses are "
            f"{max(diffs)} off the fault-free run's (tol {LOSS_TOL})")
    for c, s in zip(clean, faulted):
        log("train_elastic", f"rank {c['rank']}: fault-free "
            f"{c['img_sec_per_rank']:.2f} img/sec ({c['steps_run']} "
            f"steps, {c['wall_s']:.2f} s, checks included); under {spec} "
            f"seed {seed} (first fault at hit {first}; "
            f"{s['allreduce_hits']} allreduce hits in the run): "
            f"{s['img_sec_per_rank']:.2f} img/sec ({s['steps_run']} steps "
            f"with the replays, {s['wall_s']:.2f} s), {s['resets']} "
            f"reset(s) taking " + ", ".join(
                f"{t:.3f}" for t in s["reset_seconds"])
            + f" s; the last epoch's losses within {max(diffs):.3g} of "
            f"the fault-free run's (tol {LOSS_TOL}); backend "
            f"{s['backend']}; host ms a step, fault-free: " + ", ".join(
                f"{k} {v:.1f}" for k, v in c["host_ms"].items()))
    return clean, faulted


# ---------------------------------------------------------------------------
# Phase 12: the live fusion-threshold tuner at np=2
# ---------------------------------------------------------------------------

def resnet50_hook_order():
    """The bytes of ResNet-50's gradients in the order the backward makes
    them final (post-accumulate-grad hooks of a model of its own: the
    order does not depend on the image size)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet

    model = ResNet(50, 1000, compute_dtype=torch.bfloat16).cuda()
    order = []
    for p in model.parameters():
        p.register_post_accumulate_grad_hook(
            lambda p: order.append(p.numel() * p.element_size()))
    x = torch.rand((2, 3, 64, 64), device="cuda")
    F.cross_entropy(model(x), torch.tensor([1, 2], device="cuda")).backward()
    del model
    torch.cuda.empty_cache()
    return order


def expected_buckets(sizes, threshold: int) -> int:
    """The hook path's bucket count: a bucket is dispatched once its
    bytes reach the threshold, and the rest at synchronize."""
    count, filled = 0, 0
    for size in sizes:
        filled += size
        if filled >= threshold:
            count, filled = count + 1, 0
    return count + (1 if filled else 0)


def autotune_np2():
    sizes = resnet50_hook_order()
    logs = [os.path.join(LOG_DIR, f"autotune_rank{r}.csv") for r in (0, 1)]
    for path in logs:
        if os.path.exists(path):
            os.remove(path)
    summaries = launch("autotune_np2", 2, [
        "--depth", "50", "--num-classes", "1000", "--image-size", "224",
        "--batch-size", "32", "--num-warmup-batches", "1",
        "--num-batches-per-iter", "4", "--num-iters", "3", "--log-steps"],
        env=AUTOTUNE_ENV, timeout=600,
        rank_env=lambda r: {"HOROVOD_AUTOTUNE_LOG": logs[r]})
    steps = [_records(open(os.path.join(LOG_DIR, f"autotune_np2_rank{r}.log"))
                      .read().splitlines(), "STEP") for r in (0, 1)]
    thresholds = [[s["fusion_threshold"] for s in rec] for rec in steps]
    require(thresholds[0] == thresholds[1],
            f"the ranks' thresholds differ: {thresholds}")
    require(len(set(thresholds[0])) >= 2,
            f"the threshold took one value: {thresholds[0]}")
    for r, rec in enumerate(steps):
        before = 0
        for s in rec:
            got, before = s["flushes"] - before, s["flushes"]
            want = expected_buckets(sizes, s["fusion_threshold"])
            require(got == want, f"rank {r}, step {s['step']}: {got} "
                    f"buckets at threshold {s['fusion_threshold']} (want "
                    f"{want})")
    for r, path in enumerate(logs):
        with open(path) as f:
            kinds = [line.split(",")[1] for line in f]
        require({"warmup", "sample", "frozen"} <= set(kinds),
                f"rank {r}: autotune log rows {kinds}")
    for s in summaries:
        log("autotune_np2", f"rank {s['rank']}: {s['img_sec_per_rank']:.2f} "
            f"img/sec over {s['steps']} steps, thresholds by step "
            f"{thresholds[0]}, buckets by step "
            f"{[expected_buckets(sizes, t) for t in thresholds[0]]}, each "
            "as the threshold in force implies; log rows " + ", ".join(
                line.split(",")[1] for line in open(logs[s["rank"]])))
    return summaries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.ops import adasum_kernels as K
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.ops import matmul_kernels as MK

    if sys.argv[1:2] == ["--surface-rank"]:
        return surface_rank()
    if sys.argv[1:2] == ["--ranks"]:
        t0 = time.perf_counter()
        _build.build(_build.sources())
        n, rest = int(sys.argv[2]), sys.argv[3:]
        module, grow = RESNET, None
        if rest[:1] == ["--transformer"]:
            module, rest = TRANSFORMER, rest[1:]
        elif "--use-adasum" in rest and n > 1:
            grow = ADASUM_GROW
        launch(f"ranks{n}", n, rest, module=module, grow=grow)
        log(f"ranks{n}", f"{time.perf_counter() - t0:.1f} s")
        return 0
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(_build.sources())
    log("build", f"{time.perf_counter() - t0:.2f} s for "
        f"{_build.sources()} (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name in _build.sources():
        with open(_build._library_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("build", line.strip())

    t0 = time.perf_counter()
    measured = check_kernels(K)
    flash = check_flash(FA)
    k3 = check_k3(MK)
    check_head()
    log("kernels", "port kernels: " + ", ".join(
        f"{fn.__name__} (comparison launches {fn.launches})"
        for fn in K.KERNELS + FA.KERNELS + MK.KERNELS)
        + f"; {time.perf_counter() - t0:.1f} s")

    # Each main path runs in fresh rank processes, whose counts start at
    # 0 and are reset again just before the training loop.
    K.reset_launch_counts()
    FA.reset_launch_counts()
    MK.reset_launch_counts()
    t0 = time.perf_counter()
    adasum_summaries = train_adasum()
    log("train_adasum", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_average()
    log("train_average", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    transformer_summaries = train_transformer()
    log("train_transformer", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nccl_summary = transformer_nccl()
    log("transformer_nccl", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zero3_summaries = train_zero3(transformer_summaries)
    log("train_zero3", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zero3_nccl(nccl_summary)
    log("zero3_nccl", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    surface_np2()
    log("surface_np2", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_elastic()
    log("train_elastic", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    autotune_np2()
    log("autotune_np2", f"{time.perf_counter() - t0:.1f} s")

    rows = [(fn.__name__, measured[str(torch.float32)][fn.__name__],
             adasum_summaries[0]["launches"], "adasum_kernels.cu")
            for fn in K.KERNELS]
    # The main path's bf16 flash kernels at D = 64 are the tensor-core
    # ones (each row below requires all its launches there).
    rows += [(fn.__name__, flash[fn.__name__],
              transformer_summaries[0]["launches"], "flash_attention_sm90.cu")
             for fn in FA.KERNELS]
    rows += [(fn.__name__, k3[fn.__name__], zero3_summaries[0]["launches"],
              "tiled_matmul.cu") for fn in MK.KERNELS]
    replaces = {"fused_dot_norms": "horovod_tpu/ops/pallas_kernels.py:117",
                "fused_scaled_add": "horovod_tpu/ops/pallas_kernels.py:147",
                "flash_fwd": "horovod_tpu/ops/flash_attention.py:242",
                "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:393",
                "flash_bwd_dkv": "horovod_tpu/ops/flash_attention.py:427",
                "tiled_matmul": "horovod_tpu/ops/fused_collectives.py:286"}
    kernels = []
    for name, m, launches, src in rows:
        row = {
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{src}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
        if "cuda_core_ms" in m:
            # K4-K6: the tensor-core kernel's launches on the main path
            # (all of them), the CUDA-core kernel's time at this shape,
            # and both routes' times at WIDE_ATTN.
            row.update(cores="tensor (wgmma, sm90)",
                       sm90_launches=launches[name + "_sm90"],
                       cuda_core_ms=m["cuda_core_ms"], d128=m["d128"])
            require(launches[name + "_sm90"] == launches[name],
                    f"{name}: {launches[name + '_sm90']} of "
                    f"{launches[name]} launches on the tensor cores")
        if name == "tiled_matmul":
            # The launches of the main path's eval forward that took the
            # strided load path (train_zero3 and zero3_nccl require 0),
            # and that path's time at the head chunk.
            row.update(strided_launches=zero3_summaries[0]["evals"][0][
                "k3_strided_launches"], strided_ms=m["strided_ms"])
        kernels.append(row)
        require(launches[name] > 0, f"{name}: no launch on its main path")
    log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
