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
                 The Adasum kernels K1, K2 at the fused ResNet-50 delta,
                 and in f32 at the fused VGG-16 (138,357,544) and
                 Inception V3 (23,834,568) deltas;
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
                 causal, and at the sp=2 ring's pair shape (1, 8192, 8,
                 64) non-causal (checked against the plain versions
                 first), beside F.scaled_dot_product_attention (with
                 the same is_causal) and the CUDA-core K4, K5 and K6 at
                 the same shapes (each must be the slower); the tiled matmul K3 in f32, bf16 and f16
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
                 the parameters' SHA-256 must agree across ranks.  The
                 combine is the XOR ladder (`adasum_in_axis`: one
                 point-to-point hop a level, staged through host memory
                 over gloo); on one step rank 0 gathers the deltas and
                 reruns the tree on the stack with the plain versions
                 (within COMBINE_RTOL) and with the kernels (the ladder
                 must be bitwise that), the wall ms of the ladder, the
                 allgather and the tree printed side by side;
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
                 from a ResNet-50 of its own on the card);
13. train_zoo    main path 5: two ranks share the card over gloo and run
                 the synthetic benchmark `--model vgg16 --use-adasum` at
                 full width (138,357,544 params, 224x224, 1000 classes,
                 batch 32 per rank, bf16) for 3 steps with the checks of
                 phase 4 (finite losses, one digest per step, K1 and K2
                 launched on both ranks, rank 0's plain rerun of the
                 combine within COMBINE_RTOL); then one rank on NCCL runs
                 `--model inception3` (299x299, 23,834,568 params) and
                 `--model vgg16` (224x224) under Average with
                 `--profile 3`: img/sec, peak memory, the profile, and
                 for VGG-16 the buckets it flushed, which must be in
                 every step the count of the JAX package's greedy
                 partition of its gradients (in the order the backward
                 makes them final, from a VGG-16 of its own on the card)
                 at the 64 MiB threshold;
14. mnist        BASELINE config 1: two ranks share the card over gloo and
                 run `python -m horovod_tpu_torch.torch_mnist` for 2
                 epochs: finite losses and one digest per step, each
                 rank's mean loss lower in the second epoch, the
                 held-out accuracy above MNIST_MIN_ACC;
15. bench        `python -m horovod_tpu_torch.bench` at one rank on NCCL
                 (ResNet-50, batch 64) and at two ranks sharing the card
                 over gloo (batch 32, DDP on gloo): the hvd, plain and
                 DDP rows' img/sec, vs_baseline and vs_ddp, each row's
                 +-1.96 sigma and idle share;
16. train_wire   the wire layer (ops/wire.py, ops/quantized.py).  (a) The
                 codecs int8, int4, fp8_e4m3 and fp8_e5m2 encode a seeded
                 ResNet-50-sized flat gradient (25,557,032 f32, padded to
                 128; an all-zero block, a NaN block, a +-inf block,
                 values at the clip, a NaN block of values past 448) on
                 the card: payload bytes and scales bitwise the CPU
                 encode of the same input, the decode bitwise the CPU
                 decode (NaN by position: an fp8 NaN code matches any
                 other, since inf / inf is x86's negative default NaN
                 and CUDA's positive one); encode and decode timed
                 beside their byte bound.  (b) Main path 6: two ranks
                 share the card over gloo and run the synthetic
                 benchmark `--model resnet50 --compression int8` at full
                 width (batch 32 per rank, bf16) for 3 steps and 3
                 profiled ones: finite losses, one digest per step, every
                 bucket of every step on the ring, and on step 1 rank 0's
                 ring results bitwise the plain ring model over both
                 ranks' inputs and within the model's bound of the exact
                 mean; then under HOROVOD_WIRE_POLICY=big=int4,small=none,
                 threshold=1048576 (each bucket's codec, raw and wire
                 bytes those of `wire_policy_plan` over ResNet-50's
                 gradients in hook order), and under `--compression
                 fp8_e4m3`; img/sec and the host ms in `hvd.ring`.
                 (c) Main path 7: phase 8's stage-3 transformer (8
                 layers, full width) with HOROVOD_ZERO_GATHER_WIRE=int8
                 and HOROVOD_WIRE_POLICY=auto: finite losses within
                 WIRE_LOSS_TOL of phase 8's, one digest per step, K4-K6
                 n_layers launches per step on the tensor cores, and in
                 the eval forward exactly phase 8's 64 K3 launches, all
                 on the vector load path, logits within K3_RTOL of the
                 plain head on the same decoded weights and within
                 WIRE_LOGITS_RTOL of the exactly gathered head's.
                 (d) ZeRO-1's wired allgather: the stage-1 transformer at
                 2 layers under HOROVOD_SHARD_AG_WIRE=int8 and
                 HOROVOD_WIRE_POLICY=auto: parameters bitwise equal
                 across ranks each step, each rank's f32 masters not
                 equal to its decoded parameters.

17. train_mesh  main path 8: the transformer over a mesh through
                 `make_train_step` (`python -m
                 horovod_tpu_torch.transformer_benchmark --sp 2` etc.),
                 two ranks sharing the card over gloo, the default
                 TransformerConfig (vocab 32000, d_model 512, 8 x 64
                 heads, d_ff 2048; 4 of its 8 layers) at T = 16384,
                 AdamW, under HOROVOD_FLASH_ATTENTION=1, 2 steps and
                 one profiled:
                 (b) sp=2 ring attention (T_local = 8192 on the flash
                 ring: causal diagonal pairs, non-causal past pairs,
                 skipped future pairs whose K/V hops still happen),
                 batch 1; (c) sp=2 Ulysses (flash at T = 16384 on 4
                 heads a rank); (d) tp=2; (e) ep=2 with moe_every=2 and
                 8 experts, batch 2 (one row a rank); (f) pp=2 with 2
                 microbatches, batch 2.  Each: finite losses, one
                 SHA-256 of the full parameters (gathered from the
                 shards) per step across ranks, step 0's loss within
                 LOSS_TOL of rank 0's one-rank `reference_loss` on the
                 same weights and tokens (the dense layers; under ep the
                 MoE layers route each shard's rows on their own, as the
                 mesh does), and on every step every K4-K6 launch on the
                 tensor cores, as many per rank as `expected_flash`
                 says; tok/sec per rank, idle share and host ms in the
                 mesh ranges (hvd.sp.hop, hvd.sp.a2a, hvd.tp.psum,
                 hvd.ep.a2a, hvd.pp.hop, ...).
18. serve        main path 9: decode and the continuous-batching server
                 on the default TransformerConfig at full width, bf16,
                 seeded random weights, one process (after the kernels
                 phase has timed dense against flash attention at (1, T,
                 8, 64) bf16 causal, T in 512..16384, forward and forward
                 + backward, the table that sets the port's default
                 HOROVOD_FLASH_ATTENTION_MIN_T, and K4 at the prefill
                 shape (2, T0, 8, 64)).  (a) `transformer_generate`
                 greedy on 2 prompts of T0 = max(2048, MIN_T) tokens, 32
                 new, plain, int8 cache, n_kv_heads=2 and attn_window
                 512: K4 launched n_layers times per call, all on the
                 tensor cores, none in the decode steps; the prefill
                 logits within SERVE_RTOL of the dense prefill's
                 largest (and a prefill with one head dropped above
                 it); every generated token held to the dense-
                 prefill chain fed the same tokens (`teacher_forced`:
                 equal up to the first near-tie, SERVE_TIE, and within
                 SERVE_TIE of the best after it).  (b) InferenceServer at
                 max_batch 8 over a seeded make_trace of 24 requests
                 (serve_benchmark's FULL_TRACE, decode_bench.py's mix)
                 plus one of T0 prompt tokens, under fifo, static and
                 speculation (a 2-layer draft, gamma from the knob):
                 every request's tokens held to its own batch-1 chain,
                 no page leaked, K4 launched once a layer for each
                 prompt that routes to flash; tok/sec, request, TTFT and
                 per-token p50 / p99, occupancy and pool peak.  (c) Two
                 ranks share the card over gloo (`python -m chip_smoke
                 --decode-rank`): `make_decode_step` at tp=2, prefill and
                 8 steps within SERVE_RTOL of the one-rank chain (and
                 the chain with layer 0's attention sum dropped above
                 it).  The phase must end within SERVE_BUDGET_S.
19. train_guard  main path 10: the training-health guard (guard/) and the
                 checkpoint manager (utils/checkpoint.py).  (a) The
                 synthetic benchmark on ResNet-50 at one rank on NCCL
                 (batch 32, bf16), unguarded and under
                 HOROVOD_GUARD=1 at the static scale: the final
                 parameters' SHA-256 equal, img/sec of both.  (b) Two
                 ranks share the card over gloo (`python -m chip_smoke
                 --guard-rank`) and run the default TransformerConfig at
                 T = 16384, batch 1 a rank, DistributedOptimizer(AdamW,
                 guard=DynamicLossScale(1024)) at stage 0 under a
                 TrainingGuard (tests/data/guard_main.py's recipe: digest
                 every 4 steps, the checkpoint at step 4, rank 1 alone
                 poisoning its batch's loss weight at step 3 and flipping
                 a parameter bit at step 6, 12 steps): the per-step trace
                 (flag, scale, consecutive flags) the same on both ranks,
                 only step 3 flagged, the scale 1024 -> 512 there,
                 AdamW's step count and exp_avg after step 3 those after
                 step 2, a rollback at step 8 naming one bucket on both
                 ranks to step 4 (generation 1), the restore on the card,
                 the final parameters finite and one SHA-256, K4-K6 on
                 the tensor cores; the checkpoint's save and restore
                 times.  Then steps 0-4 again on the int8 ring with
                 rank 1's NaN at step 3 and `crossrank_or` made the
                 identity: the ranks' SHA-256 must differ.  (c) The same
                 model at stage 3 (ZERO3_ENV), rank 1's NaN at step 2:
                 both ranks flag it, the updates are zero, the shard
                 optimizer state and the rows unchanged; then one
                 held-out forward through `gather_matmul`, 64 K3
                 launches a rank on the vector path, the logits finite
                 and the same on both ranks.  The phase must end within
                 GUARD_BUDGET_S.
20. train_hier   main path 11: the hierarchical (dcn x ici) data plane
                 (parallel/hierarchical.py).  Four ranks share the card
                 over gloo as `create_hierarchical_mesh(dcn=2, ici=2)`
                 (`--dcn 2`) and run the default TransformerConfig at
                 T = 16384, batch 1 a rank, bf16, AdamW, two passes a
                 step (`--backward-passes-per-step 2`).  (a) Stage 0
                 under HOROVOD_HIERARCHICAL_ALLREDUCE=1 with
                 `--fused-apply --early-reduction --guard` (the static
                 scale, no poison), 3 steps and one profiled: finite
                 losses, no flagged step, one SHA-256 across the four
                 ranks every step, K4-K6 n_layers launches a pass on
                 every rank, all on the tensor cores; on step 1 rank 0's
                 hierarchically reduced gradients within HIER_RTOL of a
                 flat allreduce of the same local gradients over the
                 global set, and the same gradients through
                 `hierarchical_allreduce(dcn_wire="int8")` off the
                 exact leg by more than 0 and at most two int8 encodes.
                 (b) ZeRO-3 over the pair (ZERO3_ENV plus
                 HOROVOD_SHARD_AG_FUSION=1), 2 steps and one held-out
                 forward whose head gathers its group (`gather_matmul`
                 refuses the pair, so no K3): step 0's losses within
                 LOSS_TOL of (a)'s (same seeds and data), one SHA-256 a
                 step, K4-K6 as in (a), a finite eval loss.  Per-rank
                 tok/sec, peak GB beside the card's total and host ms in
                 `hvd.synchronize` and the `hvd.hier.*` legs (four
                 ranks on one card over gloo: correctness, not
                 scaling).  The phase must end within HIER_BUDGET_S.

Phases 6 to 9 also hold the tied head (`TiedHead`: bf16 x bf16 -> f32 on
the tensor cores) to the f32 path it replaced: in the kernels phase at
the main shape (logits within HEAD_RTOL, both gradients equal, the
forward GEMM's ms beside the f32 GEMM's), and on the check step of each
transformer run (rank 0's logits within HEAD_RTOL).  At stage 3 every
parameter's storage must be 0 bytes between steps, the measured
resident bytes at most full / n plus one pad element per group, and
train_zero3's peak memory at most train_transformer's, rank by rank.

`python3 chip_smoke.py --serve` runs only the MIN_T table, K4 at the
prefill shape and phase 18 (with their own builds of the flash sources).
`python3 chip_smoke.py --guard` runs only phase 19 (with the builds of the
sources it runs); `--hier` only phase 20.
`python3 chip_smoke.py --ranks N [--transformer] ARGS` instead runs N
ranks of the ResNet benchmark (or, with --transformer, the transformer
trainer) with ARGS (rank r on card r mod the card count), holds them to
the same checks as the training phases, and prints each rank's SUMMARY
and, with `--profile K`, its PROFILE line (a torch.profiler breakdown
of K steps: device time, idle share, host time in each `hvd.*` and
`bench.*` range).

Then one JSON line with every kernel's numbers (K1 and K2 also at the
zoo deltas, with their launches on main path 5, and their launches on
main path 1 net of the ladder check's tree; K3 with its launches on
main path 7 as `wire_launches`; K4-K6 with their times at the ring's
pair shape as `ring_pair`, their errors at the ring's causal diagonal
pair and at the 4 heads a rank of Ulysses and tp=2, and their launches
per rank on each run of main path 8 as `mesh_launches`, and K4-K6's
launches on main path 9 as `serve_launches` and on main path 10 per
rank as `guard_launches` (the ladder) and `guard_zero3_launches`, and on
main path 11 per rank as `hier_launches` and `hier_zero3_launches`, K3's
on main path 10 as `guard_launches`, K4 with its prefill-shape
times as `prefill` and the MIN_T table as `min_t`), and as the last
line
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
# The other zoo models' fused f32 deltas: K1 and K2 at these sizes too.
ZOO_N = {"vgg16": 138_357_544, "inception3": 23_834_568}
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
# The MNIST trainer's held-out accuracy after 2 epochs must beat chance
# (ten classes) by a margin.
MNIST_MIN_ACC = 0.5
MAIN_ATTN = (1, 16384, 8, 64)  # the transformer's [B, T, H, D] per layer
WIDE_ATTN = (1, 16384, 4, 128)  # the same width in 128-wide heads
RING_PAIR = (1, 8192, 8, 64)  # one pair of the sp=2 ring (main path 8)
HALF_HEADS = (1, 16384, 4, 64)  # a rank's heads under Ulysses or tp=2
# K4-K6 per step per rank at 8 layers, all on the tensor cores.
FLASH_GROW = {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
              "flash_fwd_sm90": 8, "flash_bwd_dq_sm90": 8,
              "flash_bwd_dkv_sm90": 8}


# Phase 16.  The stage-3 transformer with its head gathered over int8 and
# its big shard groups reduce-scattered over int8 (error feedback on):
# the forward reads weights that moved by at most half an int8 step of
# their block (1/254 of the block's largest value), so each step's loss
# moves from the exact-wire run's (phase 8, the same seeds and data) by
# far less than the 1e-2 allowed here on a loss of ~10.4; the logits of
# the eval head move by ~0.4% of a weight's size over d_model = 512
# products, well inside 2e-2 of the largest logit.
WIRE_LOSS_TOL = 1e-2
WIRE_LOGITS_RTOL = 2e-2
WIRE_ENV = {"HOROVOD_ZERO_GATHER_WIRE": "int8", "HOROVOD_WIRE_POLICY": "auto"}
WIRE_POLICY_INT4 = "big=int4,small=none,threshold=1048576"
COOPERATIVE = ("int8", "int4", "fp8_e4m3", "fp8_e5m2")


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
             ((1, ZOO_N["vgg16"]), torch.float32),
             ((1, ZOO_N["inception3"]), torch.float32),
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

        if n == MAIN_N or n in ZOO_N.values():
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
            key = str(dtype) if n == MAIN_N else next(
                m for m, zn in ZOO_N.items() if zn == n)
            results[key] = {
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


def _flash_work(shape, element_size, causal=True):
    """(bytes, operations) of K4, K5, K6 at a [B, T, H, D]: each input
    read once and each output written once; 4, 6 and 8 D operations per
    unmasked (query, key) pair (all T² of them when not causal)."""
    B, T, H, D = shape
    n = B * T * H * D * element_size
    rows = B * T * H * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    return {"flash_fwd": (4 * n + rows, 4 * D * pairs),
            "flash_bwd_dq": (5 * n + 2 * rows, 6 * D * pairs),
            "flash_bwd_dkv": (6 * n + 2 * rows, 8 * D * pairs)}


def _time_flash(FA, shape, gen, dev, with_plain: bool,
                causal: bool = True) -> dict:
    """K4, K5, K6 at a bf16 [B, T, H, D], each timed alone (10 launches
    after 2), on both routes; one PyTorch call of the same function
    (F.scaled_dot_product_attention forward, and its backward for dq,
    dk and dv at once, with the same `causal`); the plain versions (3
    calls after 1) where `with_plain`; the bound."""
    import torch
    import torch.nn.functional as F

    B, T, H, D = shape
    c = causal
    q, k, v, do, _ = _flash_case_inputs(
        (B, T, H, H, D, torch.bfloat16, c, None, 0), gen, dev)
    o, lse = FA.flash_fwd(q, k, v, c)
    delta = (do.float() * o.float()).sum(-1)
    runs = {
        "flash_fwd": (
            lambda: FA.flash_fwd(q, k, v, c),
            lambda: FA.flash_fwd(q, k, v, c, sm90=False),
            lambda: FA.flash_fwd_plain(q, k, v, c)),
        "flash_bwd_dq": (
            lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, c),
            lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, c,
                                    sm90=False),
            lambda: FA.flash_bwd_dq_plain(q, k, v, do, lse, delta, c)),
        "flash_bwd_dkv": (
            lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, c),
            lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, c,
                                     sm90=False),
            lambda: FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, c)),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=c)
    dot = do.transpose(1, 2)
    lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=c), iters=10)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), iters=10)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    work = _flash_work(shape, q.element_size(), c)
    mode = "causal" if c else "non-causal"
    results = {}
    for name, (kernel, cuda_core, plain) in runs.items():
        bound = bound_ms(*work[name], peak=HALF_FLOPS)
        r = dict(ms=cuda_time_ms(kernel, iters=10, warmup=2),
                 library_ms=library[name], bound_ms=bound[0],
                 bound_by=bound[1])
        line = (f"{name} {shape} bf16 {mode}: ms={r['ms']:.4f} "
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
    log("kernels", f"flash backward {shape} {mode}, flash_bwd_dq + "
        f"flash_bwd_dkv:"
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
    # Main path 8's other shapes: the ring's past pairs (the first main
    # path to run the kernels non-causally) and its diagonal pair, and
    # the 4 heads a rank that Ulysses and tp=2 run at the full T (ep and
    # pp run MAIN_ATTN, held above).
    B, T, H, D = RING_PAIR
    ring_errs = _check_flash_case(FA, (B, T, H, H, D, bf16, False, None, 0),
                                  gen, dev)
    diag_errs = _check_flash_case(FA, (B, T, H, H, D, bf16, True, None, 0),
                                  gen, dev)
    B, T, H, D = HALF_HEADS
    half_errs = _check_flash_case(FA, (B, T, H, H, D, bf16, True, None, 0),
                                  gen, dev)
    results = _time_flash(FA, MAIN_ATTN, gen, dev, with_plain=True)
    wide = _time_flash(FA, WIDE_ATTN, gen, dev, with_plain=False)
    ring = _time_flash(FA, RING_PAIR, gen, dev, with_plain=True,
                       causal=False)
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        r["d128"] = wide[name]
        r["ring_pair"] = dict(ring[name], max_abs_err=ring_errs[name])
        r["ring_diag_max_abs_err"] = diag_errs[name]
        r["half_heads_max_abs_err"] = half_errs[name]
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
        s["step_launches"] = [rec["launches"] for rec in recs]
        s["evals"] = ev
        # Launches of a check's comparison (not of the main path).
        s["check_launches"] = {}
        for rec in recs:
            for k, n in rec.get("check_launches", {}).items():
                s["check_launches"][k] = s["check_launches"].get(k, 0) + n
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
            lc = recs[0]["ladder_check"]
            require(lc["tree_bitwise"], "the XOR ladder's result is not "
                    "bitwise the allgather-then-tree's on the same deltas")
            line += (f"; the ladder bitwise the allgather + tree: ladder "
                     f"{lc['ladder_ms']:.2f} ms, allgather "
                     f"{lc['allgather_ms']:.2f} + tree {lc['tree_ms']:.2f} "
                     f"ms (wall, between syncs)")
            checked = True
        if "dense_loss" in recs[0]:
            rec = recs[0]
            diff = abs(rec["dense_loss"] - rec["loss"])
            require(diff <= LOSS_TOL, f"loss: mesh {rec['loss']} vs one "
                    f"rank {rec['dense_loss']} (tol {LOSS_TOL})")
            line += (f"; rank 0's one-rank loss {rec['dense_loss']:.6f}, "
                     f"diff {diff:.3g} (tol {LOSS_TOL})")
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
    if "--check-dense-step" in args:
        require(checked, "no step compared the mesh's loss with one rank's")
    if "--check-plain-step" in args and (module == TRANSFORMER or
                                         "--use-adasum" in args):
        require(checked, "no step compared the kernels with the plain "
                "versions")
    return summaries


def train_adasum():
    summaries = launch("train_adasum", 2, [
        "--use-adasum", "--model", "resnet50", "--num-classes", "1000",
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
        "--model", "resnet50", "--num-classes", "1000", "--image-size", "224",
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

def hook_order(model: str = "resnet50", image_size: int = 64):
    """The bytes of a zoo model's gradients in the order the backward
    makes them final (post-accumulate-grad hooks of a model of its own;
    the order does not depend on the image size, the sizes do for
    VGG-16's fc1)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import zoo_build

    net = zoo_build(model, 1000, compute_dtype=torch.bfloat16,
                    image_size=image_size).cuda()
    order = []
    for p in net.parameters():
        p.register_post_accumulate_grad_hook(
            lambda p: order.append(p.numel() * p.element_size()))
    x = torch.rand((2, 3, image_size, image_size), device="cuda")
    F.cross_entropy(net(x), torch.tensor([1, 2], device="cuda")).backward()
    del net
    torch.cuda.empty_cache()
    return order


def expected_buckets(sizes, threshold: int) -> int:
    """The hook path's bucket count: the JAX package's greedy partition
    (`gradient_bucket_partition`, as `parallel/data_parallel.py`
    `_buckets_by_nbytes` ports it) over the sizes in hook order."""
    from horovod_tpu_torch.parallel.data_parallel import _buckets_by_nbytes

    return len([b for b in _buckets_by_nbytes(sizes, threshold) if b])


def autotune_np2():
    sizes = hook_order()
    logs = [os.path.join(LOG_DIR, f"autotune_rank{r}.csv") for r in (0, 1)]
    for path in logs:
        if os.path.exists(path):
            os.remove(path)
    summaries = launch("autotune_np2", 2, [
        "--model", "resnet50", "--num-classes", "1000", "--image-size", "224",
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


# ---------------------------------------------------------------------------
# Phases 13 to 15: the rest of the zoo, the MNIST trainer, the bench
# ---------------------------------------------------------------------------

MNIST = "horovod_tpu_torch.torch_mnist"
BENCH = "horovod_tpu_torch.bench"
FUSION_THRESHOLD = 64 * 1024 * 1024  # HOROVOD_FUSION_THRESHOLD's default


def train_zoo():
    """Main path 5 (see the module docstring)."""
    phase = "train_zoo"
    summaries = launch(phase, 2, [
        "--model", "vgg16", "--use-adasum", "--num-classes", "1000",
        "--image-size", "224", "--batch-size", "32",
        "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
        "--num-iters", "3", "--log-steps", "--check-plain-step", "1"],
        grow=ADASUM_GROW, timeout=900)
    require(all(s["steps"] == 3 and s["params"] == ZOO_N["vgg16"]
                for s in summaries), f"vgg16 Adasum: {summaries}")
    for s in summaries:
        log(phase, f"vgg16 Adasum rank {s['rank']}: "
            f"{s['img_sec_per_rank']:.2f} img/sec (3 steps, checks "
            f"included), backend {s['backend']}, peak memory "
            f"{s['peak_mem_gb']:.2f} GB, launches {s['launches']}")
    vgg_sizes = hook_order("vgg16", 224)
    buckets = expected_buckets(vgg_sizes, FUSION_THRESHOLD)
    require(sum(vgg_sizes) == 4 * ZOO_N["vgg16"], "vgg16 gradient bytes")
    singles = {}
    for model in ("inception3", "vgg16"):
        (s,) = launch(f"{phase}_{model}", 1, [
            "--model", model, "--num-classes", "1000", "--batch-size", "32",
            "--num-warmup-batches", "3", "--num-batches-per-iter", "5",
            "--num-iters", "3", "--profile", "3"], timeout=600)
        require(s["backend"] == "nccl" and s["params"] == ZOO_N[model], s)
        if model == "vgg16":
            require(s["flushes"] == buckets * s["steps"],
                    f"vgg16: {s['flushes']} buckets over {s['steps']} steps, "
                    f"want {buckets} a step (the JAX partition of its "
                    f"gradients in hook order at {FUSION_THRESHOLD} bytes)")
        log(phase, f"{model} at {s['image_size']}x{s['image_size']}, one "
            f"rank on NCCL: {s['img_sec_per_rank']:.2f} img/sec (+- "
            f"{1.96 * s['img_sec_std']:.2f}), batch 32, buckets flushed "
            f"{s['flushes']} over {s['steps']} steps "
            f"({s['flushes'] / s['steps']:g} a step), peak memory "
            f"{s['peak_mem_gb']:.2f} GB, last loss {s['last_loss']:.4f}")
        singles[model] = s
    log(phase, f"vgg16 buckets a step at {FUSION_THRESHOLD} bytes: "
        f"{buckets} (gradient bytes in hook order: {vgg_sizes[:6]} ...)")
    return summaries, singles


def mnist_np2():
    """BASELINE config 1's trainer at two ranks on the card over gloo."""
    summaries = launch("mnist", 2, ["--epochs", "2", "--log-steps"],
                       module=MNIST, timeout=300)
    for s in summaries:
        losses, acc = s["epoch_losses"], s["test_acc"]
        require(len(losses) == 2 and losses[1] < losses[0],
                f"rank {s['rank']}: epoch losses {losses} do not fall")
        require(acc[-1] > MNIST_MIN_ACC, f"rank {s['rank']}: held-out "
                f"accuracy {acc} not above {MNIST_MIN_ACC}")
    require(len({s["digest"] for s in summaries}) == 1, "mnist: the ranks' "
            "final parameters differ")
    for s in summaries:
        log("mnist", f"rank {s['rank']}: epoch mean losses "
            f"{s['epoch_losses']}, held-out accuracy {s['test_acc']}, "
            f"{s['img_sec_per_rank']:.1f} img/sec, {s['steps']} steps, "
            f"backend {s['backend']}")
    return summaries


def bench_rows():
    """`python -m horovod_tpu_torch.bench` at one rank on NCCL (its
    defaults: ResNet-50, batch 64) and at two ranks sharing the card over
    gloo (batch 32)."""
    results = {}
    for name, nranks, args in (
            ("bench_np1", 1, []),
            ("bench_np2", 2, ["--batch-size", "32", "--num-warmup-batches",
                              "2", "--num-batches-per-iter", "5",
                              "--num-iters", "3"])):
        outs = run_ranks(name, nranks, BENCH, args, timeout=600)
        lines = [l for l in outs[0] if l.startswith("{")]
        require(len(lines) == 1, f"{name}: {len(lines)} result lines")
        r = json.loads(lines[0])
        for key in ("value", "plain", "ddp", "vs_baseline", "vs_ddp"):
            require(math.isfinite(r[key]) and r[key] > 0, f"{name}: {key}")
        require(r["size"] == nranks and r["backend"] == (
            "nccl" if nranks == 1 else "gloo"), f"{name}: {r}")
        rows = r["rows"]
        log(name, f"{r['model']} batch {r['batch_size']}/rank, {nranks} "
            f"rank(s) on {r['backend']}: value {r['value']:.2f} img/sec "
            f"(hvd), plain {r['plain']:.2f}, ddp {r['ddp']:.2f}, "
            f"vs_baseline {r['vs_baseline']:.4f}, vs_ddp {r['vs_ddp']:.4f}; "
            + "; ".join(f"{k} +- {v['ci95']:.2f}, idle {v['idle_share']}"
                        for k, v in rows.items()))
        log(name, "RESULT " + json.dumps(r))
        results[name] = r
    return results


# ---------------------------------------------------------------------------
# Phase 16: the wire layer
# ---------------------------------------------------------------------------

def wire_mismatch(enc_cpu, enc_card) -> list:
    """Where an encoding on the card differs from the CPU's, as (part,
    byte index, cpu byte, card byte), at most 5.  A NaN that a division
    makes (inf / inf) has the sign of the hardware's default NaN,
    negative on x86 and positive on CUDA, so an fp8 NaN code matches a
    NaN code of either sign."""
    import torch

    out = []
    for part, (c, g) in enumerate(zip(enc_cpu, enc_card)):
        a = c.contiguous().view(torch.uint8)
        b = g.cpu().contiguous().view(torch.uint8)
        diff = a != b
        if c.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            low = 0x7F if c.dtype == torch.float8_e4m3fn else 0x7C
            nan_a = ((a & 0x7F) > low) if low == 0x7C else ((a & 0x7F) == low)
            nan_b = ((b & 0x7F) > low) if low == 0x7C else ((b & 0x7F) == low)
            diff &= ~(nan_a & nan_b)
        for i in torch.nonzero(diff).reshape(-1)[:5].tolist():
            out.append((part, i, int(a[i]), int(b[i])))
    return out


def _codec_input():
    """The seeded flat f32 input of the codec checks: ResNet-50's
    gradient size padded to a block, with an all-zero block, a NaN
    block, a +-inf block, blocks of values at the int8 and int4 clip
    and halfway points, and a NaN block of values past e4m3's range."""
    import torch

    g = torch.Generator().manual_seed(16)
    n = MAIN_N + (-MAIN_N) % 128
    scale = torch.tensor([1e-3, 1.0, 30.0])[
        torch.randint(0, 3, (n,), generator=g)]
    v = torch.randn(n, generator=g) * scale
    v[MAIN_N:] = 0.0
    v[0:128] = 0.0
    v[128 + 5] = float("nan")
    v[256 + 7], v[256 + 9] = float("inf"), float("-inf")
    v[384:512] = torch.arange(-127.0, 1.0)
    v[512:640] = torch.arange(128.0) - 63.5
    v[512] = 127.0
    v[640:768] = torch.arange(-7.0, 8.0, 0.5).repeat(9)[:128]
    # A NaN block keeps the scale 1: its values past e4m3's 464 and an
    # inf reach the fp8 cast unnormalised, and e4m3 writes NaN there, as
    # XLA's convert does.
    v[768:896] = torch.linspace(-600.0, 600.0, 128)
    v[769], v[770] = float("nan"), float("inf")
    return v


def check_codecs() -> dict:
    """Phase 16 (a): each cooperative codec on the card against its CPU
    run on the same input, and its encode and decode times."""
    import torch
    from horovod_tpu_torch.ops import quantized as Q
    from horovod_tpu_torch.ops import wire as W

    v = _codec_input()
    vg = v.cuda()
    n = v.numel()
    out = {}
    for name in COOPERATIVE:
        codec = W.get_codec(name)
        enc_c, enc_g = codec.encode(v), codec.encode(vg)
        bad = wire_mismatch(enc_c, enc_g)
        require(not bad, f"{name}: the card's payload or scales differ "
                f"from the CPU encode: {bad}")
        dec_c, dec_g = codec.decode(enc_c), codec.decode(enc_g).cpu()
        nan_c, nan_g = torch.isnan(dec_c), torch.isnan(dec_g)
        require(torch.equal(nan_c, nan_g) and torch.equal(
            dec_c[~nan_c].view(torch.int32), dec_g[~nan_g].view(torch.int32)),
            f"{name}: the card's decode differs from the CPU decode")
        if name == "fp8_e4m3":
            past = v[768:896].abs() > 464.0
            require(bool(past.any()) and bool(
                torch.isnan(dec_g[768:896][past]).all()),
                "fp8_e4m3: a NaN block's values past 464 must decode as "
                "NaN, as XLA writes them")
        wire_bytes = codec.wire_nbytes(n)
        enc_ms = cuda_time_ms(lambda: codec.encode(vg))
        dec_ms = cuda_time_ms(lambda: codec.decode(enc_g))
        enc_bound = bound_ms(4 * n + wire_bytes, 0)[0]
        dec_bound = bound_ms(wire_bytes + 4 * n, 0)[0]
        out[name] = {"encode_ms": enc_ms, "decode_ms": dec_ms,
                     "encode_bound_ms": enc_bound,
                     "decode_bound_ms": dec_bound, "wire_bytes": wire_bytes,
                     "nan_blocks_decoded": int(nan_g.sum())}
        log("train_wire", f"codec {name}: {n} elements, payload and scales "
            f"bitwise the CPU encode, decode bitwise the CPU decode; encode "
            f"ms={enc_ms:.4f} (bound {enc_bound:.4f}, bytes), decode "
            f"ms={dec_ms:.4f} (bound {dec_bound:.4f}, bytes), {wire_bytes} "
            "wire bytes")
    del vg
    torch.cuda.empty_cache()
    return out


def _policy_plan(spec: str, sizes):
    """`wire_policy_plan` of ResNet-50's f32 gradients of `sizes` bytes
    in hook order at the default threshold: [[codec, raw bytes, wire
    bytes], ...]."""
    import torch
    from horovod_tpu_torch.ops import wire as W
    from horovod_tpu_torch.parallel.data_parallel import wire_policy_plan

    leaves = [torch.empty(b // 4, device="meta") for b in sizes]
    return [[name, raw, wb] for _, name, raw, wb in wire_policy_plan(
        leaves, policy=W.parse_wire_policy(spec),
        fusion_threshold_bytes=FUSION_THRESHOLD, bucket_order="forward")]


def _wire_run(phase: str, args, env=None):
    """Two ranks of the ResNet-50 benchmark on a wire; every bucket of
    every step on the ring.  Returns the summaries."""
    summaries = launch(phase, 2, [
        "--model", "resnet50", "--num-classes", "1000", "--image-size", "224",
        "--batch-size", "32", "--num-warmup-batches", "0",
        "--num-batches-per-iter", "1", "--num-iters", "3", "--log-steps",
        *args], env=env, timeout=600)
    steps = [_records(open(os.path.join(LOG_DIR, f"{phase}_rank{r}.log"))
                      .read().splitlines(), "STEP") for r in (0, 1)]
    for r, recs in enumerate(steps):
        before = (0, 0)
        for rec in recs:
            flushed = rec["flushes"] - before[0]
            ring = rec["ring_buckets"] - before[1]
            before = (rec["flushes"], rec["ring_buckets"])
            require(flushed > 0 and ring == flushed,
                    f"{phase} rank {r} step {rec['step']}: {ring} of "
                    f"{flushed} buckets on the ring")
    return summaries, steps


def train_wire(zero3_summaries):
    """Phase 16 (b)-(d); `zero3_summaries`: phase 8's, the same
    stage-3 run on the exact wire."""
    import torch

    results = {}
    sizes = hook_order()
    # Under an explicit int8 every bucket rides the ring: the policy plan
    # with an int8 big codec and no threshold is its partition and wire.
    int8_plan = _policy_plan("big=int8,threshold=0", sizes)
    summaries, steps = _wire_run("train_wire_int8", [
        "--compression", "int8", "--check-wire-step", "1", "--profile",
        "3"])
    check = next(rec["wire_check"] for rec in steps[0]
                 if "wire_check" in rec)
    require(check["bitwise"] and check["bound_ok"] and
            check["buckets"] == len(int8_plan),
            f"train_wire_int8: ring vs its plain model {check}")
    for s in summaries:
        require(s["buckets"] == int8_plan, f"int8 buckets {s['buckets']} "
                f"(want {int8_plan})")
    profiled = [rec for rec in _records(open(os.path.join(
        LOG_DIR, "train_wire_int8_rank0.log")).read().splitlines(),
        "PROFILE")]
    ring_ms = profiled[0]["ranges_ms_per_step"].get("hvd.ring")
    results["int8"] = {"img_sec": [s["img_sec_per_rank"] for s in summaries],
                       "ring_ms": ring_ms, "check": check,
                       "profile": profiled[0]}
    log("train_wire", f"ResNet-50 int8 ring, 2 ranks over gloo: "
        f"{[round(s['img_sec_per_rank'], 2) for s in summaries]} img/sec "
        f"per rank (3 steps and 3 profiled, checks included); buckets "
        f"{summaries[0]['buckets']}; step 1 rank 0: ring bitwise the plain "
        f"model over both ranks' inputs in {check['buckets']} buckets, "
        f"largest distance from the exact mean "
        f"{check['exact_max_abs_diff']:.4g} (within the model's bound); "
        f"profiled: wall {profiled[0]['wall_ms_per_step']:.1f} ms a step, "
        f"hvd.ring host {ring_ms} ms, hvd.synchronize "
        f"{profiled[0]['ranges_ms_per_step'].get('hvd.synchronize')} ms, "
        f"idle share {profiled[0]['device_idle_share']}")

    want = _policy_plan(WIRE_POLICY_INT4, sizes)
    summaries, _ = _wire_run("train_wire_int4", [],
                             env={"HOROVOD_WIRE_POLICY": WIRE_POLICY_INT4})
    for s in summaries:
        require(s["buckets"] == want, f"int4 policy buckets {s['buckets']} "
                f"(wire_policy_plan: {want})")
    results["int4"] = {"img_sec": [s["img_sec_per_rank"] for s in summaries],
                       "buckets": summaries[0]["buckets"]}
    log("train_wire", f"ResNet-50 under HOROVOD_WIRE_POLICY="
        f"{WIRE_POLICY_INT4}: buckets {summaries[0]['buckets']} (those of "
        f"wire_policy_plan), "
        f"{[round(s['img_sec_per_rank'], 2) for s in summaries]} img/sec")
    summaries, _ = _wire_run("train_wire_fp8", ["--compression",
                                                "fp8_e4m3"])
    results["fp8_e4m3"] = {"img_sec": [s["img_sec_per_rank"]
                                       for s in summaries]}
    log("train_wire", f"ResNet-50 fp8_e4m3 ring: "
        f"{[round(s['img_sec_per_rank'], 2) for s in summaries]} img/sec, "
        f"last losses {[round(s['last_loss'], 4) for s in summaries]}")

    # (c) Main path 7: the stage-3 head over an int8 gather.
    zsum = launch("train_wire_zero3", 2, [
        "--zero-stage", "3", "--num-warmup-batches", "0",
        "--num-batches-per-iter", "1", "--num-iters", "3", "--log-steps",
        "--eval-every", "3", "--check-plain-step", "2"],
        module=TRANSFORMER, timeout=600, env=dict(ZERO3_ENV, **WIRE_ENV),
        grow=FLASH_GROW)
    tol = K3_RTOL["torch.float32"]
    for s, s0 in zip(zsum, zero3_summaries):
        r = s["rank"]
        diffs = [abs(a - b) for a, b in zip(s["step_losses"],
                                            s0["step_losses"])]
        require(s["n_layers"] == 8 and len(diffs) == 3 and
                max(diffs) <= WIRE_LOSS_TOL,
                f"rank {r}: int8-wire losses {s['step_losses']} vs the exact "
                f"wire's {s0['step_losses']} (tol {WIRE_LOSS_TOL})")
        (ev,) = s["evals"]
        (ev0,) = s0["evals"]
        require(ev["k3_launches"] == ev0["k3_launches"] == 64 and
                ev["k3_strided_launches"] == 0 and ev["k3_plain_calls"] == 0,
                f"rank {r}: eval forward launched K3 {ev['k3_launches']} "
                f"times (phase 8: {ev0['k3_launches']}), "
                f"{ev['k3_strided_launches']} strided")
        require(ev["eval_logits_rel"] <= tol and
                ev["eval_exact_rel"] <= WIRE_LOGITS_RTOL and
                math.isfinite(ev["eval_loss"]),
                f"rank {r}: eval logits vs the plain head on the decoded "
                f"weights {ev['eval_logits_rel']} (tol {tol}), vs the exact "
                f"head {ev['eval_exact_rel']} (tol {WIRE_LOGITS_RTOL})")
        log("train_wire", f"stage 3, int8 head gather and auto policy, rank "
            f"{r}: {s['tok_sec_per_rank']:.1f} tok/sec (phase 8 "
            f"{s0['tok_sec_per_rank']:.1f}); losses {s['step_losses']} vs "
            f"exact wire {s0['step_losses']} (max diff {max(diffs):.3g}, tol "
            f"{WIRE_LOSS_TOL}); eval forward K3 launches "
            f"{ev['k3_launches']} (strided {ev['k3_strided_launches']}), "
            f"logits vs plain head on the decoded weights "
            f"{ev['eval_logits_rel']:.3g} (tol {tol}), vs the exactly "
            f"gathered head {ev['eval_exact_rel']:.3g} (tol "
            f"{WIRE_LOGITS_RTOL}), eval loss {ev['eval_loss']:.4f} (exact "
            f"{ev0['eval_loss']:.4f}); peak memory {s['peak_mem_gb']:.2f} GB")
    results["zero3"] = zsum

    # (d) ZeRO-1 with the parameter allgather on int8.
    grow2 = {k: 2 for k in FLASH_GROW}
    z1 = launch("train_wire_zero1", 2, [
        "--zero-stage", "1", "--n-layers", "2", "--num-warmup-batches", "0",
        "--num-batches-per-iter", "1", "--num-iters", "3", "--log-steps"],
        module=TRANSFORMER, timeout=600, grow=grow2, env={
            "HOROVOD_SHARD_AG_WIRE": "int8", "HOROVOD_WIRE_POLICY": "auto"})
    for r in (0, 1):
        recs = _records(open(os.path.join(
            LOG_DIR, f"train_wire_zero1_rank{r}.log")).read().splitlines(),
            "STEP")
        diffs = [rec["master_wire_diff"] for rec in recs]
        require(len(diffs) == 3 and all(d > 0 for d in diffs),
                f"rank {r}: f32 master vs decoded parameter {diffs}")
        log("train_wire", f"stage 1, int8 allgather, rank {r}: largest "
            f"|f32 master - decoded parameter| by step {diffs}; digests "
            f"equal across ranks each step; "
            f"{z1[r]['tok_sec_per_rank']:.1f} tok/sec")
    torch.cuda.empty_cache()
    return results



# ---------------------------------------------------------------------------
# Phase 17: the transformer over a mesh (main path 8)
# ---------------------------------------------------------------------------

MESH_ENV = {"HOROVOD_FLASH_ATTENTION": "1"}  # flash at T_local = 8192 too
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# name, mesh flags, other flags, layers
# Depth 4 (of the config's 8): every layer kind and every mesh hop runs
# at full width, in half the script's time for this phase.
# Checked steps of each train_mesh run (then one profiled): two, so that
# phase 20 fits the script's time limit (a checked step at 4 layers
# takes about 2.5 s on the H100, and the phase runs five such runs).
MESH_CHECKED_STEPS = 2
MESH_RUNS = [
    ("ring", ["--sp", "2"], [], 4),
    ("ulysses", ["--sp", "2", "--attn", "ulysses"], [], 4),
    ("tp", ["--tp", "2"], [], 4),
    ("ep", ["--ep", "2", "--moe-every", "2", "--n-experts", "8"], [], 4),
    ("pp", ["--pp", "2"], ["--batch-size", "2"], 4),
]


def expected_flash(name: str, s: dict) -> int:
    """K4 (and K5, K6) launches per step on one rank of a mesh run: a
    layer's attention once per layer; on the causal ring, rank i runs
    the pairs with blocks i, ..., 0 (the future pairs are skipped); under
    GPipe each stage runs its layers on every tick (M + pp - 1 of them,
    M = pp microbatches), bubbles included."""
    layers = s["n_layers"]
    if name == "ring":
        return layers * (s["coords"]["sp"] + 1)
    if name == "pp":
        pp = s["mesh"]["pp"]
        return layers // pp * (2 * pp - 1)
    return layers


def train_mesh():
    """Phase 17 (b)-(f): the default TransformerConfig at T = 16384 over
    two gloo ranks on one card, through `make_train_step`: finite losses,
    one digest of the full parameters per step, step 0's loss within
    LOSS_TOL of rank 0's one-rank `reference_loss` on the same weights
    and tokens, every K4-K6 launch on the tensor cores and as many per
    rank and step as `expected_flash` says (the reference's launches
    left out); tok/sec per rank, with and without the checks' wall time,
    idle share and the mesh ranges' host ms from one profiled step
    (whose `bench.check.digest` range gives the digest's share)."""
    common = ["--num-warmup-batches", "0", "--num-batches-per-iter", "1",
              "--num-iters", str(MESH_CHECKED_STEPS), "--log-steps",
              "--check-dense-step", "0", "--profile", "1"]
    out = {}
    for name, mesh, extra, layers in MESH_RUNS:
        t0 = time.perf_counter()
        summaries = launch(f"mesh_{name}", 2, mesh + extra + common + [
            "--n-layers", str(layers)], module=TRANSFORMER, env=MESH_ENV,
            timeout=400, grow={n: None for n in FLASH_NAMES})
        for s in summaries:
            want = expected_flash(name, s)
            per_step = []
            before = dict.fromkeys(s["launches"], 0)
            for i, cum in enumerate(s["step_launches"]):
                got = {k: cum[k] - before[k] for k in cum}
                if i == 0:
                    got = {k: n - s["check_launches"].get(k, 0)
                           for k, n in got.items()}
                before = cum
                per_step.append(got["flash_fwd"])
                for n in FLASH_NAMES:
                    require(got[n] == want and got[n + "_sm90"] == want,
                            f"mesh_{name} rank {s['rank']} step {i}: {n} "
                            f"{got[n]} launches, {got[n + '_sm90']} on the "
                            f"tensor cores (want {want})")
            log(f"mesh_{name}", f"rank {s['rank']} {s['coords']}: "
                f"{s['tok_sec_per_rank']:.1f} tok/sec per rank "
                f"({MESH_CHECKED_STEPS} checked steps), "
                f"{s['tok_sec_per_rank_net']:.1f} without the "
                f"checks (their ms per step {s['check_ms_per_step']}), "
                f"idle {s['device_idle_share']}, K4-K6 launches "
                f"per step {per_step} (all tensor cores), host ms per step "
                f"{s['ranges_ms_per_step']}, peak {s['peak_mem_gb']:.2f} "
                f"GB, {layers} layers")
        log(f"mesh_{name}", f"{time.perf_counter() - t0:.1f} s")
        out[name] = summaries
    return out


# ---------------------------------------------------------------------------
# The flash threshold, and phase 18: decode and the server (main path 9)
# ---------------------------------------------------------------------------

MIN_T_SWEEP = (512, 1024, 2048, 4096, 8192, 16384)
SERVE_BUDGET_S = 240  # phase 18's share of the script's time limit
SERVE_NEW = 32        # new tokens per decode check
SERVE_WINDOW = 512    # attn_window of the windowed decode check
# A near-tie of greedy decoding: the reference chain's top-2 logits less
# than this apart (logit units).  The full-width model's logits reach
# ~4; its prefill logits through flash and through dense attention part
# by up to 1.4-1.9% of the largest (H100, PERF.md §6), ~0.07, and a bf16
# rounding of the last hidden state (2^-9 of its size) moves a logit by
# ~0.01.  Tokens are compared exactly up to the first near-tie of each
# row; after it each must stay within SERVE_TIE of the reference's best
# (`teacher_forced`).
SERVE_TIE = 0.1
# Phase 18's logits, relative to the largest: the flash prefill against
# the dense one, and make_decode_step at tp=2 against one rank.  Each
# run also reads a fault the tolerance must tell apart: the prefill
# with head 0 of every layer's attention zeroed (a kernel that skips a
# head), and the tp=2 chain with layer 0's attention sum over tp
# dropped.  On an H100 80GB HBM3 at 700 W (PERF.md §6) the sound
# readings were 0.0139-0.0196 and the faults 0.734-1.11: the tolerance
# sits 2.5x above the one and 14x below the other.
SERVE_RTOL = 5e-2


def min_t_table(FA) -> dict:
    """Dense attention (`dense_attention_oracle`, the path `full_attention`
    takes below HOROVOD_FLASH_ATTENTION_MIN_T) against the flash kernels
    at (1, T, 8, 64) bf16 causal, for each T of MIN_T_SWEEP: the forward
    alone (prefill: K4) and forward plus backward (training: K4, K5,
    K6).  The threshold the rule picks is the smallest T at which flash
    is no slower in both.  A dense run that does not fit in the card's
    memory is recorded as such (flash then wins)."""
    import torch
    from horovod_tpu_torch.parallel import sequence as S

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(77)
    rows = []
    for T in MIN_T_SWEEP:
        q, k, v, do = (torch.randn((1, T, 8, 64), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        iters = 10 if T <= 4096 else 3

        def flash_fwd():
            with torch.no_grad():
                FA.flash_attention(q, k, v, causal=True)

        def flash_both():
            o = FA.flash_attention(*leaves, causal=True)
            torch.autograd.backward(o, do)

        def dense_fwd():
            with torch.no_grad():
                S.dense_attention_oracle(q, k, v, causal=True)

        def dense_both():
            o = S.dense_attention_oracle(*leaves, causal=True)
            torch.autograd.backward(o, do)

        row = {"T": T, "flash_fwd_ms": cuda_time_ms(flash_fwd, iters=iters),
               "flash_fwd_bwd_ms": cuda_time_ms(flash_both, iters=iters)}
        for key, fn in (("dense_fwd_ms", dense_fwd),
                        ("dense_fwd_bwd_ms", dense_both)):
            try:
                row[key] = cuda_time_ms(fn, iters=iters, warmup=1)
            except torch.cuda.OutOfMemoryError:
                row[key] = None        # does not fit: flash wins
            torch.cuda.empty_cache()
        row["flash_no_slower"] = all(
            row[d] is None or row[f] <= row[d]
            for f, d in (("flash_fwd_ms", "dense_fwd_ms"),
                         ("flash_fwd_bwd_ms", "dense_fwd_bwd_ms")))
        log("kernels", "MIN_T (1, {T}, 8, 64) bf16 causal: forward flash "
            "{flash_fwd_ms:.4f} dense {dense_fwd_ms} ms; forward+backward "
            "flash {flash_fwd_bwd_ms:.4f} dense {dense_fwd_bwd_ms} ms; "
            "flash no slower in both: {flash_no_slower}".format(**row))
        rows.append(row)
        del q, k, v, do, leaves
        torch.cuda.empty_cache()
    pick = next((r["T"] for r in rows if r["flash_no_slower"]), None)
    log("kernels", f"MIN_T: the smallest T at which flash is no slower in "
        f"both: {pick}; the port's default HOROVOD_FLASH_ATTENTION_MIN_T "
        f"is {FA.MIN_T_DEFAULT}")
    return {"rows": rows, "pick": pick, "default": FA.MIN_T_DEFAULT}


def serve_prompt_len(FA) -> int:
    """T0 of the prompts that take K4: a multiple of 128, at least the
    MIN_T in force (HOROVOD_FLASH_ATTENTION_MIN_T, else the port's
    default) and at least 2048."""
    from horovod_tpu_torch.common import util

    min_t = util.env_int("FLASH_ATTENTION_MIN_T", FA.MIN_T_DEFAULT)
    return max(2048, -(-min_t // 128) * 128)


def prefill_logits(D, params, cfg, prompt, quantize=None):
    """The last position's logits of `transformer_prefill` on a fresh
    cache."""
    cache = D.init_decode_cache(cfg, prompt.shape[0], prompt.shape[1],
                                quantize=quantize, device=prompt.device)
    return D.transformer_prefill(params, cache, prompt, cfg)[0]


def teacher_forced(D, params, cfg, prompt, served, quantize=None):
    """Every served token against the reference chain fed the served
    tokens themselves (prefill, then a decode step per token): at each
    position the token's reference logit must be within SERVE_TIE of
    the largest, and where no other logit is that close it must be the
    argmax.  So the served tokens equal the reference's greedy chain up
    to its first near-tie, and after one each is still a greedy choice
    of the reference model given the served prefix.  Returns (positions
    held, positions that were a near-tie, positions before each row's
    first near-tie)."""
    import torch

    served = torch.as_tensor(served).reshape(prompt.shape[0], -1)
    B, n = served.shape
    cache = D.init_decode_cache(cfg, B, prompt.shape[1] + n,
                                quantize=quantize, device=prompt.device)
    lg, cache = D.transformer_prefill(params, cache, prompt, cfg)
    ties = 0
    untied = torch.ones(B, dtype=torch.bool)
    before_tie = 0
    for i in range(n):
        tok = served[:, i].to(prompt.device)
        top2 = torch.topk(lg, 2, dim=-1).values
        picked = torch.gather(lg, -1, tok[:, None])[:, 0]
        gap = (top2[:, 0] - picked).cpu()
        tie = (top2[:, 0] - top2[:, 1]).cpu() < SERVE_TIE
        require(bool((gap <= SERVE_TIE).all()) and bool(
            (gap[~tie] == 0).all()), f"position {i}: served tokens "
            f"{tok.tolist()} are {gap.tolist()} below the reference's "
            f"largest logit (near-ties {tie.tolist()}, tol {SERVE_TIE})")
        ties += int(tie.sum())
        untied &= ~tie
        before_tie += int(untied.sum())
        if i + 1 < n:
            lg, cache = D.transformer_decode_step(params, cache, tok, cfg)
    return B * n, ties, before_tie


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


DENSE = {"HOROVOD_FLASH_ATTENTION": "0"}


def _with_attr(obj, name, value, fn):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        return fn()
    finally:
        setattr(obj, name, old)


def _head0_dropped(attn):
    """`attn` with head 0 of its output zeroed: phase 18 (a)'s fault."""
    def faulted(*args, **kwargs):
        o = attn(*args, **kwargs).clone()
        o[:, :, 0] = 0
        return o
    return faulted


def serve_decode(FA, D, T, launches) -> dict:
    """Phase 18 (a): `transformer_generate` greedy on 2 prompts of T0
    tokens at full width (main path 9, its K4 launches counted into
    `launches`), against the same chain with dense prefill attention."""
    import torch
    from horovod_tpu_torch.parallel import sequence as S

    dev = torch.device("cuda", 0)
    T0 = serve_prompt_len(FA)
    variants = [("mha", {}, None), ("int8", {}, "int8"),
                ("gqa", {"n_kv_heads": 2}, None),
                ("window", {"attn_window": SERVE_WINDOW}, None)]
    out = {}
    for name, fields, quantize in variants:
        cfg = T.TransformerConfig(**fields)
        params = D.decode_params(T.tree_map(
            lambda a: a.to(dev), T.transformer_init(0, cfg)), cfg)
        g = torch.Generator().manual_seed(18)
        prompt = torch.randint(0, cfg.vocab_size, (2, T0), generator=g).to(dev)
        FA.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = D.transformer_generate(params, cfg, prompt, SERVE_NEW,
                                         quantize=quantize)
        toks = toks.cpu()
        gen_s = time.perf_counter() - t0
        counts, sm90 = FA.launch_counts(), FA.sm90_launch_counts()
        require(counts == {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}
                and sm90["flash_fwd"] == cfg.n_layers,
                f"serve {name}: K4 launches {counts} ({sm90} on the tensor "
                f"cores); want {cfg.n_layers} (one per layer, in the "
                "prefill only)")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
            launches[k + "_sm90"] = launches.get(k + "_sm90", 0) + sm90[k]
        # Against the same model with dense prefill attention.
        flash_lg = prefill_logits(D, params, cfg, prompt, quantize)
        dense_lg = _with_env(DENSE, lambda: prefill_logits(
            D, params, cfg, prompt, quantize))
        rel = _rel_err(flash_lg, dense_lg)
        bad = _rel_err(_with_attr(S, "full_attention", _head0_dropped(
            S.full_attention), lambda: prefill_logits(
                D, params, cfg, prompt, quantize)), dense_lg)
        log("serve", f"decode {name}: prefill logits flash vs dense {rel:.4g}"
            f", with head 0 dropped {bad:.4g} (tol {SERVE_RTOL})")
        require(rel <= SERVE_RTOL, f"serve {name}: prefill logits flash vs "
                f"dense {rel} > {SERVE_RTOL}")
        require(bad > SERVE_RTOL, f"serve {name}: the prefill with head 0 "
                f"dropped reads {bad}, within {SERVE_RTOL}")
        held, ties, compared = _with_env(DENSE, lambda: teacher_forced(
            D, params, cfg, prompt, toks, quantize))
        out[name] = {"T0": T0, "prefill_logits_rel": rel,
                     "fault_logits_rel": bad,
                     "tokens_to_first_tie": compared,
                     "tokens_held": held, "near_ties": ties,
                     "tokens": 2 * SERVE_NEW, "generate_s": gen_s,
                     "k4_launches": counts["flash_fwd"]}
        log("serve", f"decode {name} (2 x {T0} prompt, {SERVE_NEW} new, "
            f"{cfg.n_layers} layers, quantize={quantize}, {fields}): K4 "
            f"launches {counts['flash_fwd']} (all tensor cores, prefill "
            f"only); prefill logits flash vs dense {rel:.3g} (tol "
            f"{SERVE_RTOL}; the fault {bad:.3g}); greedy tokens equal the dense-prefill chain's "
            f"on {compared} of {held} (to the first near-tie, margin < "
            f"{SERVE_TIE}), every one held to that chain fed them ({ties} "
            f"near-ties); generate {gen_s:.3f} s")
        del params
        torch.cuda.empty_cache()
    return out


def serve_server(FA, D, T, launches, smi: str) -> dict:
    """Phase 18 (b): InferenceServer at max_batch 8 over a seeded
    make_trace of 24 requests plus one whose prompt takes K4, under fifo
    then static, and the speculative server (a 2-layer draft at full
    width, gamma from the knob): every request's tokens held to its own
    batch-1 greedy chain (`teacher_forced`: equal up to the first
    near-tie), no page leaks."""
    import numpy as np
    import torch
    from horovod_tpu_torch.serve import InferenceServer
    from horovod_tpu_torch.serve.loadgen import make_trace, run_trace
    from horovod_tpu_torch.serve_benchmark import FULL_TRACE
    from horovod_tpu_torch.utils import autotune

    dev = torch.device("cuda", 0)
    cfg = T.TransformerConfig()
    params = T.tree_map(lambda a: a.to(dev), T.transformer_init(0, cfg))
    dp = D.decode_params(params, cfg)
    T0 = serve_prompt_len(FA)
    trace = make_trace(18, 24, cfg.vocab_size, **FULL_TRACE)
    long_prompt = np.random.RandomState(18).randint(
        0, cfg.vocab_size, T0).astype(np.int32)
    trace.append((4, long_prompt, SERVE_NEW))
    max_seq = max(T0 + SERVE_NEW, max(len(p) + mn for _, p, mn in trace))
    prompts = [torch.from_numpy(p[None].astype(np.int64)).to(dev)
               for _, p, _ in trace]
    draft_cfg = T.TransformerConfig(n_layers=2)
    draft = T.tree_map(lambda a: a.to(dev), T.transformer_init(1, draft_cfg))
    gamma = autotune.current_serve_spec_gamma()
    out, checked = {}, {}
    for run, kw in (("fifo", dict(policy="fifo")),
                    ("static", dict(policy="static")),
                    ("spec", dict(policy="fifo", draft_params=draft,
                                  draft_cfg=draft_cfg, force_spec=True))):
        srv = InferenceServer(params, cfg, max_seq_tokens=max_seq,
                              max_batch=8, device=dev, **kw)
        finished, step = [], srv.step

        def record(step=step, finished=finished):
            out = step()
            finished.extend(out)
            return out

        srv.step = record
        FA.reset_launch_counts()
        stats = run_trace(srv, trace)
        counts, sm90 = FA.launch_counts(), FA.sm90_launch_counts()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
            launches[k + "_sm90"] = launches.get(k + "_sm90", 0) + sm90[k]
        # One launch a layer for each prompt whose prefill routes to
        # flash (`full_attention`: T0 >= MIN_T and a multiple of 128):
        # the target's layers, and under speculation the draft's too.
        flash_prompts = sum(FA.flash_routed(len(p), dev) and len(p) % 128 == 0
                            for _, p, _ in trace)
        want_k4 = flash_prompts * (cfg.n_layers + (
            draft_cfg.n_layers if run == "spec" else 0))
        require(flash_prompts >= 1 and counts["flash_fwd"] == want_k4
                == sm90["flash_fwd"]
                and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 0,
                f"serve {run}: K4 launches {counts} ({sm90} on the tensor "
                f"cores); want {want_k4}: {flash_prompts} prompts take K4")
        require(srv.pool.pages_free() == srv.pool.total_pages,
                f"serve {run}: {srv.pool.total_pages - srv.pool.pages_free()}"
                " pages leaked")
        if srv.dpool is not None:
            require(srv.dpool.pages_free() == srv.dpool.total_pages,
                    f"serve {run}: draft pages leaked")
        # run_trace submits in arrival order (a stable sort of the
        # trace): request id j is trace entry order[j].
        order = sorted(range(len(trace)), key=lambda i: trace[i][0])
        by_id = {seq.req.req_id: seq.generated for seq in finished}
        require(sorted(by_id) == list(range(len(trace))),
                f"serve {run}: finished {sorted(by_id)}")
        compared = held = ties = 0
        for j, i in enumerate(order):
            # A sequence another run served identically is held once.
            key = (i, tuple(by_id[j]))
            if key not in checked:
                checked[key] = teacher_forced(D, dp, cfg, prompts[i],
                                              by_id[j])
            h, t, c = checked[key]
            held, ties, compared = held + h, ties + t, compared + c
        require(held == stats["tokens_out"], f"serve {run}: held {held} of "
                f"{stats['tokens_out']} tokens")
        stats.pop("slo_decisions")
        stats.update(tokens_to_first_tie=compared, tokens_held=held,
                     near_ties=ties,
                     gamma=gamma if run == "spec" else None,
                     k4_launches=counts["flash_fwd"],
                     k4_prompts=flash_prompts)
        out[run] = stats
        log("serve", f"server {run} ({smi}): {stats['tokens_out']} tokens, "
            f"{stats['tokens_per_sec_per_chip']:.1f} tok/sec, request "
            f"p50/p99 {stats['request_p50_ms']:.1f}/"
            f"{stats['request_p99_ms']:.1f} ms, TTFT p50/p99 "
            f"{stats['ttft_list_p50_ms']:.1f}/{stats['ttft_list_p99_ms']:.1f}"
            f" ms, per-token p50/p99 {stats['token_p50_ms']:.2f}/"
            f"{stats['token_p99_ms']:.2f} ms, occupancy "
            f"{stats['batch_occupancy_mean']:.3f}, pool peak "
            f"{stats['kv_pool_peak_utilization']:.3f}, {stats['device_steps']}"
            f" steps ({stats['spec_steps']} speculative, gamma {gamma}); "
            f"tokens equal their chains on {compared} of "
            f"{stats['tokens_out']} (to the first near-tie), all held to "
            f"their chains fed them ({ties} near-ties); K4 launches "
            f"{counts['flash_fwd']} ({flash_prompts} prompts of {len(trace)} "
            f"take it); no page leaked")
        del srv
        torch.cuda.empty_cache()
    return out



def time_prefill_k4(FA) -> dict:
    """K4 at the decode prefill's shape (2, T0, 8, 64) bf16 causal: held
    to its plain version (with K5 and K6 at that shape), then timed
    beside F.scaled_dot_product_attention's forward and the plain
    version, with its bound."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2024)
    shape = (2, serve_prompt_len(FA), 8, 64)
    B, T0, H, D = shape
    errs = _check_flash_case(FA, (B, T0, H, H, D, torch.bfloat16, True,
                                  None, 0), gen, dev)
    q, k, v, _, _ = _flash_case_inputs((B, T0, H, H, D, torch.bfloat16,
                                        True, None, 0), gen, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound = bound_ms(*_flash_work(shape, 2)["flash_fwd"], peak=HALF_FLOPS)
    r = {"shape": list(shape), "max_abs_err": errs["flash_fwd"],
         "ms": cuda_time_ms(lambda: FA.flash_fwd(q, k, v, True), iters=10),
         "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True), iters=10),
         "plain_ms": cuda_time_ms(lambda: FA.flash_fwd_plain(q, k, v, True),
                                  iters=3, warmup=1),
         "bound_ms": bound[0], "bound_by": bound[1]}
    log("kernels", f"flash_fwd at the prefill shape {tuple(shape)} bf16 "
        f"causal: ms={r['ms']:.4f} library_ms={r['library_ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} bound_ms={bound[0]:.4f} ({bound[1]}, "
        f"{bound[0] / r['ms']:.1%} of it), max_abs_err "
        f"{r['max_abs_err']:.3g}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return r


SERVE_TP_STEPS = 8


def decode_rank() -> int:
    """One rank of phase 18 (c) (run by `serve_tp2` through run_ranks):
    the one-rank greedy chain (prefill and SERVE_TP_STEPS steps) on the
    full parameters, then `make_decode_step` at tp=2 fed the same tokens;
    each call's logits relative to the one-rank chain's largest.  Saved
    to LOG_DIR/decode_rank<r>.pt."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import decode as D
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

    hvd.init()
    r, dev = hvd.rank(), hvd.device()
    require(dev.type == "cuda", f"rank {r} runs on {dev}")
    cfg = T.TransformerConfig()
    full = T.transformer_init(0, cfg)
    T0 = serve_prompt_len(FA)
    prompt = torch.randint(0, cfg.vocab_size, (2, T0),
                           generator=torch.Generator().manual_seed(19))
    params = D.decode_params(T.tree_map(lambda a: a.to(dev), full), cfg)
    cache = D.init_decode_cache(cfg, 2, T0 + SERVE_TP_STEPS, device=dev)
    lg, cache = D.transformer_prefill(params, cache, prompt.to(dev), cfg)
    ref, feed = [lg], []
    for _ in range(SERVE_TP_STEPS):
        feed.append(torch.argmax(lg, -1))
        lg, cache = D.transformer_decode_step(params, cache, feed[-1], cfg)
        ref.append(lg)
    del params, cache
    mesh = create_hybrid_mesh(tp=2)
    b = D.make_decode_step(mesh, cfg)
    sp = D.decode_params(b.shard_params(full), cfg)
    sc = b.shard_cache(D.init_decode_cache(cfg, 2, T0 + SERVE_TP_STEPS,
                                           device="cpu"))
    FA.reset_launch_counts()
    t0 = time.perf_counter()
    lg, sc = b.prefill(sp, sc, b.shard_tokens(prompt))
    got = [lg]
    for tok in feed:
        lg, sc = b.step(sp, sc, b.shard_tokens(tok.cpu()))
        got.append(lg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rels = [_rel_err(g, w) for g, w in zip(got, ref)]
    res = {"rank": r, "backend": hvd.backend(), "rels": rels,
           "launches": FA.launch_counts(), "sm90": FA.sm90_launch_counts(),
           "wall_s": wall, "heads": int(sp["blocks"]["wq"].shape[2])}
    # The fault: the same chain with layer 0's attention sum over tp
    # dropped (each rank keeps its own heads' share of wo's product).
    # Both ranks drop the same call, so the collectives still pair.
    calls, reduce_from = [0], D.pc.reduce_from

    def dropped(x, ps, *args, **kwargs):
        calls[0] += 1
        if (calls[0] - 1) % (2 * cfg.n_layers) == 0:   # the first a pass
            return x
        return reduce_from(x, ps, *args, **kwargs)

    def faulted_chain():
        c = b.shard_cache(D.init_decode_cache(cfg, 2, T0 + SERVE_TP_STEPS,
                                              device="cpu"))
        lg, c = b.prefill(sp, c, b.shard_tokens(prompt))
        out = [lg]
        for tok in feed:
            lg, c = b.step(sp, c, b.shard_tokens(tok.cpu()))
            out.append(lg)
        return out

    bad = _with_attr(D.pc, "reduce_from", dropped, faulted_chain)
    res["fault_rels"] = [_rel_err(g, w) for g, w in zip(bad, ref)]
    torch.save(res, os.path.join(LOG_DIR, f"decode_rank{r}.pt"))
    print("DECODE " + json.dumps(res), flush=True)
    hvd.shutdown()
    return 0


def serve_tp2(launches) -> dict:
    """Phase 18 (c): two ranks share the card over gloo and run
    `make_decode_step` at tp=2 (`python -m chip_smoke --decode-rank`):
    the prefill (K4 on each rank's 4 heads, n_layers launches a rank)
    and SERVE_TP_STEPS decode steps, each within SERVE_RTOL of the
    one-rank chain's largest logit."""
    import torch

    n = 2
    run_ranks("serve_tp2", n, "chip_smoke", ["--decode-rank"], 400)
    res = [torch.load(os.path.join(LOG_DIR, f"decode_rank{r}.pt"),
                      weights_only=False) for r in range(n)]
    layers = 8
    for d in res:
        require(d["backend"] == "gloo" and d["heads"] == 4,
                f"serve_tp2 rank {d['rank']}: {d['backend']}, "
                f"{d['heads']} heads")
        log("serve", f"tp2 rank {d['rank']}: logits off the one-rank chain "
            f"{max(d['rels']):.4g}, with layer 0's sum dropped "
            f"{min(d['fault_rels']):.4g}..{max(d['fault_rels']):.4g} (tol "
            f"{SERVE_RTOL})")
        require(max(d["rels"]) <= SERVE_RTOL, f"serve_tp2 rank "
                f"{d['rank']}: logits off the one-rank chain {d['rels']}")
        require(min(d["fault_rels"]) > SERVE_RTOL, f"serve_tp2 rank "
                f"{d['rank']}: the chain with layer 0's sum dropped reads "
                f"{d['fault_rels']}, within {SERVE_RTOL}")
        require(d["launches"]["flash_fwd"] == layers == d["sm90"]["flash_fwd"]
                and d["launches"]["flash_bwd_dq"] == 0,
                f"serve_tp2 rank {d['rank']}: K4 launches {d['launches']}")
        for k, c in d["launches"].items():
            launches[k] = launches.get(k, 0) + c
            launches[k + "_sm90"] = launches.get(k + "_sm90", 0) + \
                d["sm90"][k]
        log("serve", f"tp2 rank {d['rank']} ({d['backend']}, {d['heads']} "
            f"heads): prefill and {SERVE_TP_STEPS} steps, logits off the "
            f"one-rank chain by {max(d['rels']):.3g} of the largest at most "
            f"(tol {SERVE_RTOL}; the fault {min(d['fault_rels']):.3g} at "
            f"least); K4 launches {d['launches']['flash_fwd']} "
            f"(tensor cores); {d['wall_s']:.3f} s")
    return {"max_rel": max(max(d["rels"]) for d in res),
            "fault_min_rel": min(min(d["fault_rels"]) for d in res),
            "wall_s": [d["wall_s"] for d in res]}


def serve_phase(FA, smi: str) -> dict:
    """Phase 18 (main path 9): (a) decode, (b) the server, (c) the
    sharded decode.  Returns the results and K4's launches on the path."""
    from horovod_tpu_torch.models import decode as D
    from horovod_tpu_torch.models import transformer as T

    launches = {}
    out = {"decode": serve_decode(FA, D, T, launches),
           "server": serve_server(FA, D, T, launches, smi),
           "tp2": serve_tp2(launches)}
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 19: the training-health guard and the checkpoint manager
# ---------------------------------------------------------------------------

GUARD_BUDGET_S = 150   # phase 19's share of the script's time limit
GUARD_STEPS = 12       # tests/data/guard_main.py's recipe: 12 steps,
GUARD_NAN_STEP = 3     # rank 1 alone poisons its batch at step 3,
GUARD_FLIP_STEP = 6    # flips a parameter bit at step 6,
GUARD_CKPT_STEP = 4    # the digest-verified checkpoint is step 4's,
GUARD_DIGEST = 4       # and the digest check runs every 4 steps
GUARD_SCALE = 1024.0
GUARD_TEETH_STEPS = 5  # steps 0-4 of the run without the cross-rank OR
GUARD_Z3_STEPS = 3     # stage 3: rank 1's NaN at step 2
GUARD_Z3_NAN = 2
GUARD_RESNET_ARGS = ["--model", "resnet50", "--batch-size", "32",
                     "--num-warmup-batches", "2", "--num-batches-per-iter",
                     "5", "--num-iters", "3",
                     "--profile", "2"]


def _sha(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def guard_rank(cfg=None, seq_len: int = 16384, device=None,
               zero3_env=None) -> int:
    """The ranks of phase 19 (b) and (c) (run by `train_guard` through
    run_ranks as `python -m chip_smoke --guard-rank`; `cfg`, `seq_len`,
    `device` and `zero3_env` shrink it for a rehearsal on the CPU).  Each step's
    batch is {"tokens", "weight"}: the token ids and a per-token f32 loss
    weight of ones (a batch of ids alone has no float leaf for
    `guard.nan_grad` to poison), the loss their weighted mean.

    (b) The ladder: DistributedOptimizer(AdamW, guard=DynamicLossScale(
    1024)) at stage 0, TrainingGuard(digest_interval=4), the checkpoint at
    step 4, rank 1 alone armed with `guard.nan_grad` at step 3 and
    `guard.param_bitflip` at step 6, 12 steps.  Then steps 0-4 again on
    the int8 ring with rank 1's NaN at step 3 and `crossrank_or` made the
    identity: the check's teeth.  (On the exact wire every rank's reduced
    gradient carries the NaN, so each rank flags on its own scan; the
    ring's integer cast launders it, and only rank 1's input flag sees
    it.)  (c) Stage 3 under ZERO3_ENV with rank 1's NaN at step 2, then
    one held-out forward through `gather_matmul` (K3).  Saved to
    LOG_DIR/guard_rank<r>.pt."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.guard import sentinel
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops import matmul_kernels as MK
    from horovod_tpu_torch.synthetic_benchmark import param_digest
    from horovod_tpu_torch.transformer_benchmark import (
        embed_group, launch_counts, reset_launch_counts)

    hvd.init(device=device)
    r, dev = hvd.rank(), hvd.device()
    cfg = cfg or TransformerConfig(compute_dtype=torch.bfloat16)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(r)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (1, seq_len + 1))).to(dev)
    x, y = tokens[:, :-1], tokens[:, 1:]
    clean = {"tokens": x,
             "weight": torch.ones((1, seq_len), dtype=torch.float32,
                                  device=dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def build(scaler, zero_stage=0, compression=None):
        model = Transformer(cfg, seed=r).to(dev)
        inner = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(),
            zero_stage=zero_stage, guard=scaler,
            compression=compression or hvd.Compression.none)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        return model, opt

    def weighted_loss(model, batch):
        logits = model(batch["tokens"])
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, y[..., None])[..., 0]
        w = batch["weight"]
        return ((lse - picked) * w).sum() / w.sum()

    def backward(model, opt, scaler, batch):
        opt.zero_grad(set_to_none=True)
        loss = weighted_loss(model, batch)
        scaler.scale_loss(opt.guard_state, loss).backward()
        return loss.detach()

    def injected(guard, t, nan_step, flip_step=None, params=None):
        """This step's batch (and parameters), rank 1 alone armed."""
        if r == 1 and t == nan_step:
            faults.install("guard.nan_grad@1:err")
        if r == 1 and t == flip_step:
            faults.install("guard.param_bitflip@1:err")
        batch, _ = guard.maybe_inject(clean, params)
        faults.clear()
        return batch

    def adam_state(opt):
        st = [opt.state[p] for p in opt.param_groups[0]["params"]]
        return {"step": [float(s["step"]) for s in st],
                "exp_avg": _sha(s["exp_avg"] for s in st)}

    res = {"rank": r, "backend": hvd.backend(), "device": str(dev)}
    t_phase = time.perf_counter()
    ckpt_dir = hvd.broadcast_object(
        tempfile.mkdtemp(prefix="chip_smoke_guard_") if r == 0 else None)

    # (b) the ladder at stage 0 on the exact wire.
    scaler = hvd.DynamicLossScale(init_scale=GUARD_SCALE,
                                  growth_interval=1000)
    model, opt = build(scaler)
    guard = hvd.TrainingGuard(scaler=scaler, checkpoint_dir=ckpt_dir,
                              digest_interval=GUARD_DIGEST, max_nonfinite=3)
    trace, adam, times = [], {}, {}
    res["rollback"] = None
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    for t in range(1, GUARD_STEPS + 1):
        batch = injected(guard, t, GUARD_NAN_STEP, GUARD_FLIP_STEP, model)
        loss = backward(model, opt, scaler, batch)
        opt.step()
        if t in (GUARD_NAN_STEP - 1, GUARD_NAN_STEP):
            adam[t] = adam_state(opt)
        v = guard.observe(opt, model, t)
        trace.append({"step": t, "flagged": v.flagged,
                      "scale": v.loss_scale, "nonfinite": v.nonfinite_steps,
                      "loss": float(loss)})
        if v.rollback:
            sync()
            tr = time.perf_counter()
            restored = guard.rollback({"model": model.state_dict(),
                                       "opt": opt.state_dict()})
            sync()
            times["restore_s"] = time.perf_counter() - tr
            require(restored is not None, f"rank {r}: nothing restored")
            model.load_state_dict(restored["model"])
            opt.load_state_dict(restored["opt"])
            guard.reset_guard_state(opt, scaler)
            res["rollback"] = {"step": t, "bucket": v.mismatch_bucket}
            res["restored_on"] = sorted({str(v_.device) for v_ in
                                         restored["model"].values()})
            del restored
        elif t == GUARD_CKPT_STEP:
            sync()
            ts = time.perf_counter()
            res["checkpointed"] = guard.checkpoint(
                t, {"model": model.state_dict(), "opt": opt.state_dict()})
            times["save_s"] = time.perf_counter() - ts
    sync()
    times["drill_s"] = time.perf_counter() - t0
    res.update(trace=trace, adam=adam, generation=guard.generation,
               last_verified_step=guard.last_verified_step,
               launches=launch_counts(), digest=param_digest(model),
               finite=all(bool(torch.isfinite(p).all())
                          for p in model.parameters()),
               state_bytes=sum(t_.numel() * t_.element_size() for t_ in
                               list(model.state_dict().values()) + [
                                   v_ for s_ in opt.state.values()
                                   for v_ in s_.values()
                                   if isinstance(v_, torch.Tensor)]))
    del model, opt, guard
    if r == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # The teeth: the same NaN without the cross-rank OR, on the int8 ring.
    scaler = hvd.DynamicLossScale(init_scale=GUARD_SCALE,
                                  growth_interval=1000)
    model, opt = build(scaler, compression=hvd.Compression.int8)
    guard = hvd.TrainingGuard(scaler=scaler, digest_interval=0)

    def teeth():
        flags = []
        for t in range(GUARD_TEETH_STEPS):
            batch = injected(guard, t, GUARD_NAN_STEP)
            backward(model, opt, scaler, batch)
            opt.step()
            flags.append(float(opt.guard_state.bucket_flags.max()))
        return flags

    sync()
    t0 = time.perf_counter()
    res["teeth_flags"] = _with_attr(sentinel, "crossrank_or",
                                    lambda flags, process_set=None: flags,
                                    teeth)
    res["teeth_digest"] = param_digest(model)
    times["teeth_s"] = time.perf_counter() - t0
    del model, opt, guard
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) stage 3: the skip in lockstep, then the held-out forward on K3.
    def zero3():
        scaler = hvd.DynamicLossScale(init_scale=GUARD_SCALE,
                                      growth_interval=1000)
        model, opt = build(scaler, zero_stage=3)
        guard = hvd.TrainingGuard(scaler=scaler, digest_interval=0)
        params = list(model.parameters())
        placement = hvd.zero3_placement(params)
        gi = embed_group(placement, model)
        rows = placement.shard(params)
        placement.bind(params)
        steps = []
        for t in range(GUARD_Z3_STEPS):
            batch = injected(guard, t, GUARD_Z3_NAN)
            local = opt._local
            before = (_sha(v_ for s_ in local.state.values()
                           for v_ in s_.values()), [rw.clone() for rw in rows])
            with torch.no_grad():
                placement.gather(rows)
            backward(model, opt, scaler, batch)
            updates = opt.step()
            rows_new = placement.apply_updates(rows, updates)
            placement.release()
            rec = {"step": t,
                   "flagged": float(opt.guard_state.bucket_flags.max()) > 0,
                   "scale": float(opt.guard_state.loss_scale),
                   "zero_updates": all(float(u.abs().max()) == 0
                                       for u in updates),
                   "state_unchanged": _sha(
                       v_ for s_ in local.state.values()
                       for v_ in s_.values()) == before[0],
                   "rows_unchanged": all(torch.equal(a, b) for a, b in
                                         zip(rows_new, before[1]))}
            rows = rows_new
            steps.append(rec)
            del updates, before
        ev = np.random.RandomState(12345).randint(
            0, cfg.vocab_size, (1, seq_len))
        k3 = MK.tiled_matmul
        n0 = (k3.launches, k3.strided_launches, k3.plain_calls)
        with torch.no_grad():
            placement.gather(rows)
            h = model.hidden(torch.from_numpy(ev).to(dev))
            logits = placement.gather_matmul(
                h.reshape(-1, cfg.d_model).float(), rows, gi)
            placement.release()
        return {"steps": steps,
                "k3_launches": k3.launches - n0[0],
                "k3_strided_launches": k3.strided_launches - n0[1],
                "k3_plain_calls": k3.plain_calls - n0[2],
                "logits_finite": bool(torch.isfinite(logits).all()),
                "logits_sha": _sha([logits]),
                "logits_shape": list(logits.shape)}

    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res["zero3"] = _with_env(zero3_env or ZERO3_ENV, zero3)
    res["zero3"]["launches"] = launch_counts()
    sync()
    times["zero3_s"] = time.perf_counter() - t0
    times["rank_s"] = time.perf_counter() - t_phase
    res["times"] = times
    os.makedirs(LOG_DIR, exist_ok=True)
    torch.save(res, os.path.join(LOG_DIR, f"guard_rank{r}.pt"))
    print("GUARD " + json.dumps(res), flush=True)
    hvd.shutdown()
    return 0


def train_guard() -> dict:
    """Phase 19 (main path 10): (a) the guard's cost on ResNet-50 at one
    rank, (b) the ladder and its teeth, (c) stage 3; see the module
    docstring."""
    import torch

    t_start = time.perf_counter()
    resnet = {}
    for name, env in (("off", {}), ("on", {"HOROVOD_GUARD": "1"})):
        (s,) = launch(f"guard_resnet_{name}", 1, GUARD_RESNET_ARGS, env=env,
                      timeout=300)
        require(s["backend"] == "nccl" and s["device"].startswith("cuda")
                and s["guarded"] == (name == "on"),
                f"guard_resnet_{name}: {s}")
        resnet[name] = s
    require(resnet["on"]["digest"] == resnet["off"]["digest"],
            "ResNet-50 under HOROVOD_GUARD=1 (static scale) ends in other "
            f"parameters: {resnet['on']['digest'][:16]} vs "
            f"{resnet['off']['digest'][:16]}")
    log("train_guard", "(a) ResNet-50, one rank, batch 32, bf16: unguarded "
        f"{resnet['off']['img_sec_per_rank']:.2f} +- "
        f"{resnet['off']['img_sec_std']:.2f} img/sec, HOROVOD_GUARD=1 "
        f"{resnet['on']['img_sec_per_rank']:.2f} +- "
        f"{resnet['on']['img_sec_std']:.2f} img/sec; final parameters' "
        f"SHA-256 equal ({resnet['on']['digest'][:16]})")

    n = 2
    run_ranks("train_guard", n, "chip_smoke", ["--guard-rank"], 400)
    res = [torch.load(os.path.join(LOG_DIR, f"guard_rank{r}.pt"),
                      weights_only=False) for r in range(n)]
    out = check_guard(res, on_card=True)
    out["resnet"] = {k: {f: s[f] for f in ("img_sec_per_rank", "img_sec_std",
                                           "digest", "steps")}
                     for k, s in resnet.items()}
    out["phase_s"] = time.perf_counter() - t_start
    log("train_guard", f"{out['phase_s']:.1f} s (budget {GUARD_BUDGET_S} s)")
    require(out["phase_s"] <= GUARD_BUDGET_S,
            f"train_guard: over its budget of {GUARD_BUDGET_S} s")
    return out


def check_guard(res, on_card: bool) -> dict:
    """Phase 19 (b) and (c)'s checks over the ranks' results."""
    for d in res:
        require(d["backend"] == "gloo" and (d["device"].startswith("cuda")
                                             or not on_card),
                f"guard rank {d['rank']}: {d['backend']} on {d['device']}")
    key = [[{k: t[k] for k in ("step", "flagged", "scale", "nonfinite")}
            for t in d["trace"]] for d in res]
    require(all(k == key[0] for k in key), f"guard: the per-step traces "
            f"differ across ranks {key}")
    by_step = {t["step"]: t for t in key[0]}
    flagged = [t["step"] for t in key[0] if t["flagged"]]
    require(flagged == [GUARD_NAN_STEP], f"guard: flagged steps {flagged}")
    require(by_step[GUARD_NAN_STEP - 1]["scale"] == GUARD_SCALE and
            by_step[GUARD_NAN_STEP]["scale"] == GUARD_SCALE / 2 and
            by_step[GUARD_NAN_STEP]["nonfinite"] == 1,
            f"guard: scale {by_step[GUARD_NAN_STEP - 1]} -> "
            f"{by_step[GUARD_NAN_STEP]}")
    buckets = {d["rollback"]["bucket"] if d["rollback"] else None
               for d in res}
    for d in res:
        a = d["adam"]
        require(a[GUARD_NAN_STEP] == a[GUARD_NAN_STEP - 1],
                f"guard rank {d['rank']}: AdamW's state moved on the "
                f"flagged step {a}")
        require(d["rollback"] is not None and d["rollback"]["step"] == 8
                and d["generation"] == 1 and d["last_verified_step"] ==
                GUARD_CKPT_STEP, f"guard rank {d['rank']}: rollback "
                f"{d['rollback']}, generation {d['generation']}, last "
                f"verified {d['last_verified_step']}")
        require(d["finite"], f"guard rank {d['rank']}: non-finite params")
        require(not on_card or d["restored_on"] == ["cuda:0"],
                f"guard rank {d['rank']}: restored onto {d['restored_on']}")
        if on_card:
            for k in FLASH_NAMES:
                require(d["launches"][k] > 0 and d["launches"][k] ==
                        d["launches"][k + "_sm90"],
                        f"guard rank {d['rank']}: {k} launches "
                        f"{d['launches']}")
    require(len(buckets) == 1 and None not in buckets,
            f"guard: mismatch buckets {buckets}")
    digests = {d["digest"] for d in res}
    require(len(digests) == 1, f"guard: final parameters differ {digests}")
    teeth = {d["teeth_digest"] for d in res}
    require(len(teeth) == len(res) and
            res[1]["teeth_flags"][GUARD_NAN_STEP] == 1 and
            res[0]["teeth_flags"][GUARD_NAN_STEP] == 0,
            f"guard: without the cross-rank OR the ranks still agree "
            f"({teeth}, flags {[d['teeth_flags'] for d in res]})")
    z3 = [d["zero3"] for d in res]
    for d, z in zip(res, z3):
        st = z["steps"][GUARD_Z3_NAN]
        require(st["flagged"] and st["zero_updates"] and
                st["state_unchanged"] and st["rows_unchanged"],
                f"guard rank {d['rank']}: stage 3 step {st}")
        require(not any(s["flagged"] for s in z["steps"]
                        if s["step"] != GUARD_Z3_NAN),
                f"guard rank {d['rank']}: stage 3 flags {z['steps']}")
        require(z["logits_finite"], f"guard rank {d['rank']}: stage 3 "
                "eval logits not finite")
        if on_card:
            require(z["k3_launches"] == 64 and z["k3_strided_launches"] == 0
                    and z["k3_plain_calls"] == 0,
                    f"guard rank {d['rank']}: K3 launches {z}")
    require(len({z["logits_sha"] for z in z3}) == 1,
            f"guard: stage-3 eval logits differ across ranks")
    times = [d["times"] for d in res]
    for d in res:
        log("train_guard", f"(b) rank {d['rank']}: trace "
            + ", ".join(f"{t['step']}:{'F' if t['flagged'] else '.'}"
                        f"{t['scale']:g}/{t['nonfinite']}" for t in d["trace"])
            + f"; AdamW after step {GUARD_NAN_STEP} = after step "
            f"{GUARD_NAN_STEP - 1} (steps {d['adam'][GUARD_NAN_STEP]['step'][0]:g}, "
            f"exp_avg {d['adam'][GUARD_NAN_STEP]['exp_avg'][:16]}); rollback "
            f"at step {d['rollback']['step']} (bucket "
            f"{d['rollback']['bucket']}) to step {d['last_verified_step']}, "
            f"generation {d['generation']}; final SHA-256 "
            f"{d['digest'][:16]}; K4-K6 launches "
            f"{[d['launches'][k] for k in FLASH_NAMES]} (tensor cores "
            f"{[d['launches'][k + '_sm90'] for k in FLASH_NAMES]}); "
            f"checkpoint of {d['state_bytes']} bytes: save "
            f"{d['times'].get('save_s', 0):.3f} s (rank 0 writes), restore "
            f"and broadcast {d['times']['restore_s']:.3f} s; drill "
            f"{d['times']['drill_s']:.1f} s")
        log("train_guard", f"(b) teeth, rank {d['rank']}: int8 ring, "
            f"crossrank_or the identity: flags {d['teeth_flags']}, final "
            f"SHA-256 {d['teeth_digest'][:16]} ({d['times']['teeth_s']:.1f} "
            "s)")
        z = d["zero3"]
        log("train_guard", f"(c) rank {d['rank']}: stage 3 steps "
            f"{z['steps']}; eval: K3 launches {z['k3_launches']} (strided "
            f"{z['k3_strided_launches']}), logits {z['logits_shape']} finite, "
            f"SHA-256 {z['logits_sha'][:16]}; K4-K6 "
            f"{[z['launches'][k] for k in FLASH_NAMES]} "
            f"({d['times']['zero3_s']:.1f} s)")
    log("train_guard", "teeth: the ranks' SHA-256 differ without the "
        f"cross-rank OR ({sorted(x[:16] for x in teeth)})")
    return {"launches": [d["launches"] for d in res],
            "zero3_launches": [d["zero3"]["launches"] for d in res],
            "k3_launches": [z["k3_launches"] for z in z3],
            "times": times, "state_bytes": res[0]["state_bytes"],
            "trace": key[0]}



# ---------------------------------------------------------------------------
# Phase 20: the hierarchical data plane (main path 11)
# ---------------------------------------------------------------------------

HIER_BUDGET_S = 150   # phase 20's share of the script's time limit
HIER_RANKS = 4        # create_hierarchical_mesh(dcn=2, ici=2)
HIER_PASSES = 2       # backward_passes_per_step
HIER_ENV = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}
# The hierarchical reduction against the flat allreduce of the same
# local gradients: f32 sums of the four ranks' values in another order
# ((a + b) + (c + d) against gloo's), a few ulps of the largest value
# (the CPU tests' tolerance: tests/test_torch_port_hierarchical.py).
HIER_RTOL = 1e-6
HIER_ARGS = ["--dcn", "2", "--backward-passes-per-step", str(HIER_PASSES),
             "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
             "--log-steps"]
HIER_GROW = {k: n * HIER_PASSES for k, n in FLASH_GROW.items()}


def train_hier() -> dict:
    """Phase 20 (main path 11): four ranks share the card over gloo as
    `create_hierarchical_mesh(dcn=2, ici=2)`; (a) stage 0 under
    HOROVOD_HIERARCHICAL_ALLREDUCE with fused_apply, early_reduction, K =
    2 and the guard, (b) ZeRO-3 over the pair with the fused parameter
    allgather; see the module docstring."""
    import torch

    t_start = time.perf_counter()
    phase = "train_hier"
    a = launch(f"{phase}_stage0", HIER_RANKS, HIER_ARGS + [
        "--num-iters", "3", "--fused-apply", "--early-reduction", "--guard",
        "--check-hier-step", "1", "--profile", "1"], module=TRANSFORMER,
        grow=HIER_GROW, timeout=HIER_BUDGET_S, env=HIER_ENV)
    profiles = []
    for r in range(HIER_RANKS):
        with open(os.path.join(LOG_DIR, f"{phase}_stage0_rank{r}.log")) as f:
            profiles.append(_records(f.read().splitlines(), "PROFILE")[-1])
    steps = []
    with open(os.path.join(LOG_DIR, f"{phase}_stage0_rank0.log")) as f:
        steps = _records(f.read().splitlines(), "STEP")
    for s in a:
        require(s["passes_per_step"] == HIER_PASSES and s["dcn"] == 2
                and s["size"] == HIER_RANKS, f"{phase}: {s}")
    for r in range(HIER_RANKS):
        with open(os.path.join(LOG_DIR, f"{phase}_stage0_rank{r}.log")) as f:
            recs = _records(f.read().splitlines(), "STEP")
        require(all(rec["guard_flag"] == 0.0 for rec in recs),
                f"{phase}: rank {r} flagged a step: "
                f"{[rec['guard_flag'] for rec in recs]}")
    chk = [rec for rec in steps if "hier_rel" in rec]
    require(len(chk) == 1, f"{phase}: {len(chk)} checked steps")
    chk = chk[0]
    require(chk["hier_rel"] <= HIER_RTOL,
            f"{phase}: hierarchical vs flat allreduce {chk['hier_rel']} "
            f"> {HIER_RTOL}")
    require(0 < chk["int8_err"] <= chk["int8_bound"],
            f"{phase}: the int8 dcn leg {chk['int8_err']} off the exact one "
            f"(bound {chk['int8_bound']}; 0 means the wire did not engage)")
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for s, p in zip(a, profiles):
        ranges = {k: round(v, 1) for k, v in p["ranges_ms_per_step"].items()
                  if k.startswith(("hvd.synchronize", "hvd.hier."))}
        log(phase, f"(a) rank {s['rank']}: {s['tok_sec_per_rank']:.1f} "
            f"tok/sec per rank ({HIER_PASSES} passes a step, the checks "
            f"included; four ranks share one card over gloo: correctness, "
            f"not scaling), peak {s['peak_mem_gb']:.2f} GB of the card's "
            f"{total_gb:.1f}, host ms per step {ranges}, idle "
            f"{p['device_idle_share']}")
    log(phase, f"(a) step 1, rank 0: hierarchical vs flat allreduce "
        f"{chk['hier_rel']:.3g} of the largest gradient "
        f"{chk['grad_top']:.3g} (tol {HIER_RTOL}); int8 dcn wire "
        f"{chk['int8_err']:.3g} off the exact leg (bound "
        f"{chk['int8_bound']:.3g})")

    env = dict(ZERO3_ENV, HOROVOD_SHARD_AG_FUSION="1")
    b = launch(f"{phase}_zero3", HIER_RANKS, HIER_ARGS + [
        "--num-iters", "2", "--zero-stage", "3", "--eval-every", "2"],
        module=TRANSFORMER, grow=HIER_GROW, timeout=HIER_BUDGET_S, env=env)
    for sa, sb in zip(a, b):
        require(sb["zero_stage"] == 3, f"{phase}: {sb}")
        diff = abs(sb["step_losses"][0] - sa["step_losses"][0])
        require(diff <= LOSS_TOL, f"{phase}: stage 3 step 0 loss "
                f"{sb['step_losses'][0]} vs stage 0's {sa['step_losses'][0]}")
        ev = sb["evals"]
        require(len(ev) == 1 and math.isfinite(ev[0]["eval_loss"])
                and ev[0]["k3_launches"] == 0,
                f"{phase}: rank {sb['rank']} eval {ev}")
        log(phase, f"(b) rank {sb['rank']}: stage 3 over the pair, "
            f"{sb['tok_sec_per_rank']:.1f} tok/sec per rank, step 0 loss "
            f"{sb['step_losses'][0]:.6f} vs (a)'s {sa['step_losses'][0]:.6f} "
            f"(diff {diff:.3g}, tol {LOSS_TOL}), eval loss "
            f"{ev[0]['eval_loss']:.4f} (the head gathers its group: K3 "
            f"launches 0), peak {sb['peak_mem_gb']:.2f} GB")
    out = {"launches": [s["launches"] for s in a],
           "zero3_launches": [s["launches"] for s in b],
           "check": chk, "phase_s": time.perf_counter() - t_start}
    log(phase, f"{out['phase_s']:.1f} s (budget {HIER_BUDGET_S} s)")
    require(out["phase_s"] <= HIER_BUDGET_S,
            f"{phase}: over its budget of {HIER_BUDGET_S} s")
    return out


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
    if sys.argv[1:2] == ["--decode-rank"]:
        return decode_rank()
    if sys.argv[1:2] == ["--guard-rank"]:
        return guard_rank()
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
    if sys.argv[1:2] == ["--guard"]:
        # Phase 19 alone (with the builds of the sources it runs).
        _build.build(["flash_attention_sm90", "flash_attention",
                      "tiled_matmul"])
        guard = train_guard()
        print(json.dumps({"guard": guard}), flush=True)
        return 0
    if sys.argv[1:2] == ["--hier"]:
        # Phase 20 alone (with the builds of the sources it runs).
        _build.build(["flash_attention_sm90", "flash_attention"])
        hier = train_hier()
        print(json.dumps({"hier": hier}), flush=True)
        return 0
    if sys.argv[1:2] == ["--serve"]:
        # The flash threshold's table and phase 18 alone.
        _build.build(["flash_attention_sm90", "flash_attention"])
        torch.backends.cuda.matmul.allow_tf32 = False
        table = min_t_table(FA)
        prefill = time_prefill_k4(FA)
        t0 = time.perf_counter()
        serve = serve_phase(FA, smi)
        log("serve", f"{time.perf_counter() - t0:.1f} s")
        print(json.dumps({"min_t": table, "prefill": prefill,
                          "serve": serve}), flush=True)
        return 0
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
    min_t = min_t_table(FA)
    prefill = time_prefill_k4(FA)
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
    t0 = time.perf_counter()
    zoo_summaries, _ = train_zoo()
    log("train_zoo", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mnist_np2()
    log("mnist", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bench = bench_rows()
    log("bench", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    codecs = check_codecs()
    wire = train_wire(zero3_summaries)
    log("train_wire", f"int8 ring {wire['int8']['img_sec']} img/sec per "
        f"rank beside this call's exact gloo bench_np2 hvd row "
        f"{bench['bench_np2']['value']:.2f}; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = train_mesh()
    log("train_mesh", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve = serve_phase(FA, smi)
    log("serve", f"{time.perf_counter() - t0:.1f} s (budget {SERVE_BUDGET_S}"
        " s)")
    require(time.perf_counter() - t0 <= SERVE_BUDGET_S,
            f"serve: over its budget of {SERVE_BUDGET_S} s")
    guard = train_guard()
    hier = train_hier()

    # K1 and K2 on main path 1 (the ladder), net of the check's tree.
    ladder = {n: c - adasum_summaries[0]["check_launches"].get(n, 0)
              for n, c in adasum_summaries[0]["launches"].items()}
    rows = [(fn.__name__, measured[str(torch.float32)][fn.__name__],
             ladder, "adasum_kernels.cu") for fn in K.KERNELS]
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
        if src == "adasum_kernels.cu":
            # K1 and K2 at the other zoo models' fused deltas (f32), and
            # their launches on main path 5 (VGG-16 Adasum at np=2).
            row.update(zoo={m: measured[m][name] for m in ZOO_N},
                       zoo_launches=zoo_summaries[0]["launches"][name])
            require(row["zoo_launches"] > 0, f"{name}: no launch on "
                    "train_zoo")
        if "cuda_core_ms" in m:
            # K4-K6: the tensor-core kernel's launches on the main path
            # (all of them), the CUDA-core kernel's time at this shape,
            # and both routes' times at WIDE_ATTN.
            # Main path 8: each mesh run's launches per rank (net of the
            # one-rank reference), the kernels at the ring's pair shape,
            # non-causal, and their errors at the path's other shapes.
            row.update(cores="tensor (wgmma, sm90)",
                       sm90_launches=launches[name + "_sm90"],
                       cuda_core_ms=m["cuda_core_ms"], d128=m["d128"],
                       ring_pair=m["ring_pair"],
                       ring_diag_max_abs_err=m["ring_diag_max_abs_err"],
                       half_heads_max_abs_err=m["half_heads_max_abs_err"],
                       mesh_launches={
                           run: [s["launches"][name]
                                 - s["check_launches"].get(name, 0)
                                 for s in sums]
                           for run, sums in mesh.items()},
                       serve_launches=serve["launches"][name],
                       serve_sm90_launches=serve["launches"][name + "_sm90"])
            if name == "flash_fwd":
                # Main path 9: K4 at the decode prefill's shape, and the
                # dense-against-flash table that sets MIN_T.
                row.update(prefill=prefill, min_t=min_t)
                require(row["serve_launches"] > 0 and row[
                    "serve_sm90_launches"] == row["serve_launches"],
                    "flash_fwd: no launch on main path 9, or one off the "
                    "tensor cores")
            require(launches[name + "_sm90"] == launches[name],
                    f"{name}: {launches[name + '_sm90']} of "
                    f"{launches[name]} launches on the tensor cores")
            # Main path 10: the guard's ladder (b) and stage 3 (c), per
            # rank.
            row.update(guard_launches=[g[name] for g in guard["launches"]],
                       guard_zero3_launches=[
                           g[name] for g in guard["zero3_launches"]])
            # Main path 11: the hierarchical data plane, (a) stage 0 and
            # (b) stage 3 over the pair, per rank (all on the tensor
            # cores: `launch` requires each step's K4-K6 there).
            row.update(hier_launches=[h[name] for h in hier["launches"]],
                       hier_zero3_launches=[
                           h[name] for h in hier["zero3_launches"]])
            require(all(h[name + "_sm90"] == h[name] > 0
                        for h in hier["launches"] + hier["zero3_launches"]),
                    f"{name}: main path 11 off the tensor cores or not "
                    "launched")
        if name == "tiled_matmul":
            # The launches of the main path's eval forward that took the
            # strided load path (train_zero3 and zero3_nccl require 0),
            # and that path's time at the head chunk.
            row.update(strided_launches=zero3_summaries[0]["evals"][0][
                "k3_strided_launches"], strided_ms=m["strided_ms"],
                wire_launches=wire["zero3"][0]["evals"][0]["k3_launches"],
                guard_launches=guard["k3_launches"])
        kernels.append(row)
        require(launches[name] > 0, f"{name}: no launch on its main path")
    log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    log("train_wire", "codecs " + json.dumps(codecs))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
