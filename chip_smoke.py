#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`horovod_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. env           the card's name and power limit (nvidia-smi), torch and
                 CUDA versions;
2. build         builds every CUDA source of the port (csrc/*.cu) with
                 nvcc, one process per source, all started together,
                 and the native control plane (_native/) with g++
                 beside them;
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
                 run, started by the port's launcher (`python -m
                 horovod_tpu_torch.runner -np 2 --output-filename
                 chiprun_out/train_transformer`, which sets each rank's
                 topology env; every eager collective under
                 HOROVOD_COLLECTIVE_CONSISTENCY_CHECK=1, held over the
                 launcher's rendezvous KV),
                 `python -m horovod_tpu_torch.transformer_benchmark`
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
                 combine within COMBINE_RTOL); beside it on the card one
                 rank on NCCL runs `--model inception3` (299x299,
                 23,834,568 params) and `--model vgg16` (224x224) under
                 Average, 2 warm-up steps, 2 x 3 steps and `--profile
                 2` (the profiler's path): peak memory and, for VGG-16,
                 the buckets it flushed, which must be in
                 every step the count of the JAX package's greedy
                 partition of its gradients (in the order the backward
                 makes them final, from a VGG-16 of its own on the card)
                 at the 64 MiB threshold;
14. mnist        beside phase 10, side by side on the card: BASELINE
                 config 1: two ranks share the card over gloo and run
                 `python -m horovod_tpu_torch.torch_mnist` for 2
                 epochs: finite losses and one digest per step, each
                 rank's mean loss lower in the second epoch, the
                 held-out accuracy above MNIST_MIN_ACC;
15. bench        `python -m horovod_tpu_torch.bench` at one rank on NCCL
                 (ResNet-50, batch 64) and at two ranks sharing the card
                 over gloo (batch 32, DDP on gloo), each row 2 warm-up
                 steps and 3 x 5 timed: the hvd, plain and
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
                 fp8_e4m3` (these two runs share the card at once, as do
                 (c) and (d)); the int8 run's img/sec and host ms in
                 `hvd.ring`.
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
                 AdamW, under HOROVOD_FLASH_ATTENTION=1, 1 step (the
                 checked one) and one profiled:
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
                 says.  Two runs share the card at a time, so they print
                 no rate, time or idle share.
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
                 max_batch 8 over a seeded make_trace of 10 requests
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

21. train_runtime  main path 12: the runtime utilities (utils/megastep.py,
                 profiler.py, prefetch.py, stall_inspector.py; the
                 collective bracket and the step hooks).  (a) One rank
                 (`python -m chip_smoke --runtime-rank`) runs the
                 default TransformerConfig at T = 16384, batch 1, bf16,
                 DistributedOptimizer(AdamW(capturable=True)): from one
                 seed, RUNTIME_CALLS·RUNTIME_K eager steps, then the same
                 model afresh through RUNTIME_CALLS calls of
                 `repeat_steps(k = RUNTIME_K)` (an eager warm-up, the
                 capture of one CUDA graph and its replay, a pure
                 replay): the losses and the final SHA-256 bitwise the
                 eager loop's (else within LOSS_TOL, with the largest
                 difference printed); the step's wall ms and the host's
                 idle share, eager against replayed.  (b) One more
                 replay under `start_device_trace`, with HOROVOD_TIMELINE
                 and HOROVOD_TIMELINE_MARK_CYCLES=1: the merged trace
                 aligned, K4-K6 (`fwd_sm90`, `bwd_dq_sm90`,
                 `bwd_dkv_sm90`) k x n_layers times each in the replay's
                 device events, one cycle and one `step` span for the
                 call.  (c) Seeded token batches [k, 1, T + 1] from a host
                 generator through `prefetch_to_device(size = 2)` into
                 `scan_steps(k)`: every batch bitwise its host source,
                 and in the third call's trace the H2D copies on another
                 stream than K4's.  (d) Two ranks share the card over
                 gloo (`python -m chip_smoke --stall-rank`) with
                 HOROVOD_STALL_CHECK_TIME_SECONDS=1; rank 1 enters an
                 allreduce of a CUDA tensor STALL_LATE_S (plus
                 STALL_SKEW_S) late: rank 0 warns once, naming
                 `ALLREDUCE:drill` and rank 1 (the store reporter),
                 `hvd_stall_warnings_total` reads 1, rank 0's timeline
                 span of the allreduce lasts at least STALL_LATE_S, both
                 ranks finish.  The phase must end within
                 RUNTIME_BUDGET_S.  `hvd.init` starts the stall
                 inspector in every rank of every phase, and every
                 collective records its metrics.

22. train_trace  main path 13: the telemetry plane and the fleet tracer
                 closed-loop (metrics/exposition.py, fleet.py,
                 history.py, anomaly.py; trace/core.py, measure.py,
                 reaction.py; the bucket cap in data_parallel.py).  Two
                 gloo ranks share the card (`python -m chip_smoke
                 --trace-rank`) and train the default TransformerConfig
                 at T = 16384, bf16, AdamW, from one seed, the gradients
                 reduced by the eager `allreduce_gradients` (its
                 partition read live) at a HOROVOD_FUSION_THRESHOLD of
                 TRACE_BUCKETS buckets, one cycle a step, under
                 TRACE_ENV (every rank's timeline with its cycle marks,
                 HOROVOD_METRICS_PORT=0, the history every 0.5 s, the
                 stall inspector on, patience 2, cooldown 1).  Rank 1's
                 own env arms `chaos.straggler_delay` (TRACE_DELAY a
                 collective) from the first collective of the first
                 straggling window.  A warm-up step, then windows of
                 TRACE_WINDOW steps: one clean, straggling ones until
                 the policy fires (at most TRACE_STRAGGLE_MAX), the
                 cooldown, one settled.  At each window's end every rank
                 allgathers its own window events, analyzes the merged
                 trace (`trace.core.analyze`, `TraceMeasurements`) and
                 feeds its own `StragglerReactionPolicy`; an
                 `AnomalyMonitor` (TRACE_MONITOR) sees each step's ms.
                 Required: finite losses and one parameter SHA-256 on
                 both ranks at every step; K4-K6 n_layers a step on
                 each rank, all on the tensor cores; rank 1 blamed in
                 every straggling window; the same decisions on both
                 ranks; a rebalance against rank 1, then one bucket a
                 step on both ranks and the settled window's wait ms a
                 step below every straggling window's; rank 0's
                 /metrics showing one rebalance, `hvd_reaction_max_
                 buckets` 1 and collective calls, rank 1's showing the
                 injections; /healthz 200 on both; `read_fleet` on rank
                 0 (after the firing window, from the watchdogs'
                 publishes) giving both ranks and naming rank 1 in the
                 trace section; `hvd_critical_path_ms` points in each
                 history; a monitor trip at the first straggling step on
                 both ranks (trips on clean steps printed, not gated);
                 the merged trace under chiprun_out/ with flow events on
                 both ranks.  The phase must end within TRACE_BUDGET_S.
23. launcher     the port's launcher and its rendezvous KV, five jobs
                 started at once: (a) `python -m horovod_tpu_torch.runner
                 --check-build` exits 0 showing [X] for NCCL, CUDA and
                 the CUDA kernels (read without touching the card); (b)
                 `runner.run(launcher_allreduce, np=2)`: each rank calls
                 hvd.init() on the card and allreduces a seeded
                 LAUNCHER_N-float tensor, the results come back in rank
                 order, on cuda:0, bitwise the numpy sum; (f) while that
                 job runs, rank 0 reads both ranks' metrics snapshots
                 from the KV with `python -m horovod_tpu_torch.metrics
                 --kv ADDR:PORT --secret S`; (c) under the consistency
                 check, rank 1 allreduces another shape than rank 0: the
                 launcher exits nonzero within CC_TIMEOUT_S + 30 s with
                 the per-rank dump; (d) a rank that exits 3 brings the
                 launcher down with exit 3 and the other rank's process
                 tree (it and its child) gone; (e) the static
                 `runner.executor.Executor` at np=2 runs two functions in
                 turn (the rank and card, then the slot's topology env),
                 results in rank order.  (a) also shows [X] for the
                 elastic launcher and the native control plane.  One
                 JSON line `{"launcher": ...}` of what it found; the
                 phase must end within LAUNCHER_BUDGET_S.
24. elastic_driver  after phase 23: full-width `elastic_resnet`
                 (ResNet-50, 224x224, 1000 classes, batch 32 a rank,
                 bf16, sync batch norm, DistributedOptimizer(SGD
                 momentum), TorchState with an ElasticSampler) under
                 the port's elastic driver, `python -m
                 horovod_tpu_torch.runner --host-discovery-script D
                 --min-np 1 --max-np 2`, D printing a hosts file the
                 phase rewrites; the fake hosts hostA and hostB
                 (HVD_TPU_FAKE_LOCAL_HOSTS) share the card over gloo.
                 (a) Scale up: after hostA's first COMMIT hostB is
                 added; rank 0 resets without a rollback, the joiner
                 enters generation >= 1 as a joiner with rank 0's last
                 commit's parameters and rank 0's whole state after the
                 sync (parameters, batch-norm buffers and momentum:
                 `state_digest`), and the two ranks' parameters agree
                 at every step at size 2.  (b) Failure: at hostB's first
                 COMMIT after ELASTIC_DRIVER_B_STEPS steps its worker
                 is SIGKILLed; the driver blacklists hostB and
                 publishes a degraded generation, the survivor restores
                 its last commit and finishes alone, the driver exits
                 0, every loss finite, the driver served with the
                 native engine.  Prints the reset seconds, the seconds
                 from the hosts file's growth and from the kill to the
                 next generation's first step, and img/sec a rank at
                 sizes 1, 2 and 1, beside the card's name and power
                 limit; one JSON line `{"elastic_driver": ...}`; the
                 phase must end within ELASTIC_DRIVER_BUDGET_S.
25. reshard_chaos  main path 15, after phase 24: live resharding
                 (parallel/reshard.py), elastic ZeRO
                 (`hvd.elastic.ShardedTorchState`) and the chaos soak
                 (faults/chaos.py), in one launch of two ranks sharing
                 the card over gloo under the port's launcher, whose KV
                 is the reshard transport (`reshard_rank`): the default
                 TransformerConfig at T = 16384, AdamW at stage 3 under
                 ZERO3_ENV, RESHARD_STEPS steps, then (a) a shrink 2->1
                 of every stream (parameter rows, exp_avg, exp_avg_sq,
                 the scalars) in chunks under HOROVOD_RESHARD_PEAK_BYTES,
                 bitwise the local restack, the measured staging peak
                 under the ceiling (a host in both worlds keeps its own
                 rows: only the others' travel); (b)
                 a grow 1->2, bitwise the original streams, and one more
                 step from the round-tripped state in a rebuilt optimizer
                 bitwise (loss and SHA-256) the same step from the
                 original; (d) `reshard.peer_die` on rank 1: both
                 ranks' sync takes the restore path (every rank's
                 committed shards), digest gate clean;
                 a corrupt chunk refused; (e) the chaos soak at np=2,
                 seed 7, 5 generations x 4 steps, its tensors on the
                 card, at JAX's settings (its reactions the policy's on
                 its windows' skew shares) and again with the degrade
                 branch off (JAX's rebalance), held to the JAX soak's
                 invariants; (f) rank 0 alone: a crash shrink to one
                 rank through the restore path (the checkpoint) into an
                 optimizer and placement built at n=1, bitwise (a)'s
                 streams, and a step there; (c) ShardedTorchState's
                 publish at that world of one and both ranks' sync in a
                 new world of two on the live path (bytes moved, the
                 optimizer and placement rebuilt at n=2, the digest
                 gate), bitwise the original streams; (g) the
                 train-to-serve handoff: both ranks publish their
                 stage-3 parameter rows (`serve/handoff.py`), rank 0
                 fetches the decode parameters at tp = 1 and both ranks
                 theirs at tp = 2, every slice bitwise the gathered
                 parameters', and rank 0's `InferenceServer` gives the
                 same SERVE_NEW tokens from a serve_prompt_len prompt
                 (K4 at its prefill) on the fetched parameters as on
                 the gathered ones.  K4-K6 launched on
                 the tensor cores on every rank.  Prints the shrink, grow, sync and restore
                 times, bytes, chunks and peaks, each soak event's
                 outcome and MTTR; the phase must end within
                 RESHARD_BUDGET_S.
26. serve_replicas  main path 16, after phase 25: elastic serving
                 (`replicas_phase`): replicas of the full-width default
                 TransformerConfig in bf16, one process each on the card
                 under `serve.replica.ReplicaManager`, every prompt
                 serve_prompt_len tokens (K4 at each prefill).  (a) Two
                 replicas, `serve.replica_die` killing replica1's first
                 incarnation mid-stream: all REPLICA_REQUESTS results,
                 a respawn, the dead incarnation's flight-recorder dump,
                 a reassigned request's lane blamed on replica 1
                 (`trace.core.analyze_serve`), the digests agreeing.
                 (b) On the same fleet `serve.autoscale.
                 AutoscaleController` through `ReplicaFleetActuator`
                 grows it 2 -> 3 under a queued burst while the joiner
                 is killed, then shrinks it 3 -> 2 once the queue
                 drains: each event committed at its planned size, the
                 digests agreeing.  Every served chain held to the
                 phase's own reference (`teacher_forced`), each replica
                 that served with K4 launches all on the tensor cores;
                 prints each replica's first beat, peak memory and K4
                 launches, the KV's get latency at three replicas and
                 the card's free memory before and after the fleet; the
                 phase must end within REPLICA_BUDGET_S.
27. frontends    main path 17: the other frontends (`frontends_rank`,
                 its two ranks folded into phase 4's pair, sharing the
                 card over gloo). (a) Full-width ResNet-50 (25,557,032
                 params, 224x224, batch 32 a rank, bf16 compute) from a
                 seed a rank: `callbacks.BroadcastGlobalVariablesCallback
                 (0).on_train_begin` gives every rank rank 0's initial
                 tree (one SHA-256), and a second call changes nothing;
                 then FRONTENDS_STEPS steps of `DistributedGradientTape(
                 op=Adasum).gradient` with SGD at `LearningRateWarmup
                 Callback.lr`: every loss finite, one SHA-256 across the
                 ranks after each step, K1 and K2 launched on both ranks,
                 `MetricAverageCallback`'s loss bitwise the mean of the
                 allgathered losses (two f32 values).  (b) The MXNet
                 frontend over host numpy arrays of ResNet-50's parameter
                 shapes, drawn per rank: `broadcast_parameters` makes
                 every rank's arrays rank 0's bitwise, and
                 `DistributedOptimizer` around an engine-level SGD
                 (`update(index, weight, grad, state)`, the grouped and
                 the single-index form) gives gradients bitwise the port's
                 `grouped_allreduce(op=Average)` of the same tensors on
                 the card.  It runs on the card (hvd.device() cuda), imports
                 no tensorflow, keras or mxnet, prints its times beside
                 the card's name and power limit and must end within
                 FRONTENDS_BUDGET_S.
28. cluster      main path 18: the spark integration (`spark/`: the
                 barrier mapper, the store, `prepare_data`, the shard
                 loader and the torch estimator's worker loop), its two
                 ranks folded into phase 4's pair after phase 27's,
                 sharing the card over gloo.  This process is the
                 driver (`cluster_prepare`, in a thread beside the
                 pair's earlier runs; the ranks wait for its payload):
                 the shards of seeded numpy
                 rows (2 x CLUSTER_STEPS x CLUSTER_BATCH training rows
                 of 3 x 224 x 224 floats, integer labels in [0, 1000),
                 CLUSTER_VAL_ROWS validation rows marked by a column) go
                 into a store through `prepare_data` on a DataFrame
                 where pandas imports, else through the store's numpy
                 shard writer (it prints which); the spec of
                 `TorchEstimator`'s remote trainer serializes
                 `Sequential(Unflatten(1, (3, 224, 224)), ResNet(50))`
                 (25,557,032 params, seeded, bf16 compute, f32
                 parameters), SGD and `F.cross_entropy`.  Each rank
                 (`cluster_rank`) runs `make_barrier_mapper` on that
                 payload under a fake BarrierTaskContext whose barrier
                 is a rendezvous KV's; the mapper's env bootstraps
                 `hvd.init()` on the card and `_torch_remote_trainer`
                 trains one epoch, batch 32 a rank, CLUSTER_STEPS
                 steps, validation on rank 0.  Required: finite epoch and
                 validation losses, one parameter SHA-256 across the
                 ranks after the broadcast and after every step (global
                 optimizer hooks), no kernel launched, rank 1 shipping
                 nothing, and rank 0's returned module and the store's
                 checkpoint loading in its own process with CPU tensors
                 and the last step's parameters (the model never crosses
                 the KV).  Prints its times beside the card's name and
                 power limit; must end within CLUSTER_BUDGET_S.  Ray
                 (`ray/`) has no card check: Ray is not installed there,
                 and its elastic workers run phase 24's driver.
29. multicard    main path 19, outside the whole run (`--phases
                 multicard`, on a host with four cards): the
                 sharded paths over NCCL, one rank a card (`launch`
                 gives local rank r card r, and NCCL when every rank has
                 a card of its own).  With fewer than MULTICARD_RANKS
                 cards it raises before any build, naming the cards it
                 found.  (a) Full-width ResNet-50 (batch 32 a rank, 3
                 steps) under Adasum at 3 ranks (cards 0-2) and at 4:
                 the XOR ladder with its fold and last hop at 3; every
                 loss finite, one SHA-256 a step, each rank's K1 and K2
                 launches a step the ladder's combines on that rank
                 (`adasum_levels`: [2, 1, 0] at 3, 2 each at 4), the
                 ladder bitwise the tree on the gathered stack; then
                 Average on the int8 ring at 4 ranks, step 1's ring
                 bitwise its plain model.  (b) The default
                 TransformerConfig at T = 16384, 4 of its 8 layers,
                 through `make_train_step` as phase 17 runs it, on dp2 x
                 sp2 ring, dp2 x sp2 Ulysses, dp2 x tp2, dp2 x ep2 MoE (8
                 experts, moe_every 2), dp2 x pp2 (batch 2) and ep2 x sp2
                 ring MoE: step 0 within LOSS_TOL of rank 0's
                 `reference_loss` (under sp the MoE layers route each
                 sequence chunk on its own), K4-K6 as `expected_flash`
                 says on the tensor cores; each rank's host ms in the
                 mesh's ranges.  (c) Phase 6's stage-0 run and phase 8's
                 ZeRO-3 run (ZERO3_ENV, the fused chunked pipeline) at 4
                 ranks, held to phase 8's checks: losses within LOSS_TOL
                 of stage 0's, resident bytes at most a quarter plus
                 the pads, peak memory below stage 0's, and
                 `head_k3_launches(4)` (64) K3 launches a rank in the
                 eval forward.  (d) ResNet-50 over
                 `create_hierarchical_mesh(2, 2)` (`--dcn 2`, ici {0,1}
                 {2,3}, dcn {0,2} {1,3}) under
                 HOROVOD_HIERARCHICAL_ALLREDUCE=1: step 1's gradients
                 within HIER_RTOL of the flat allreduce, the int8 dcn
                 wire within its bound.  (e) `make_decode_step` over dp2
                 x tp2 (`python -m chip_smoke --decode-mesh-rank`): a
                 serve_prompt_len-token prefill (K4 n_layers times a
                 rank on the tensor cores), SERVE_NEW greedy tokens from
                 the mesh's logits, every one held to the one-rank chain
                 (`teacher_forced`), the tp pair's tokens equal.  (a)'s
                 4-rank runs, (b)-(e) run in turn in one set of four
                 processes, each run under its own MULTICARD_RUN_S
                 limit (`fold_rank`); prints one JSON line
                 `{"multicard": ...}` and the group's seconds against
                 MULTICARD_BUDGET_S.

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
sources it runs); `--hier` only phase 20; `--runtime` only phase 21;
`--trace` only phase 22; `--launcher` only phase 23; `--elastic` only
phase 24. `python3 chip_smoke.py --phases GROUP...` runs the named groups
of the whole run (PHASE_GROUPS; `--phases reshard` is phase 25,
`--phases replicas` phase 26, `--phases frontends` phase 27 and
`--phases cluster` phase 28, each in a pair of processes of its own;
`--phases multicard` phase 29, which the whole run leaves out) after
every build, and the whole run and it print `PHASE_TIME <group> <s>`
after each group; it ends with the same last line as the whole run.
`python3 chip_smoke.py --ranks N [--transformer] ARGS` instead runs N
ranks of the ResNet benchmark (or, with --transformer, the transformer
trainer) with ARGS (rank r on card r mod the card count), holds them to
the same checks as the training phases, and prints each rank's SUMMARY
and, with `--profile K`, its PROFILE line (a torch.profiler breakdown
of K steps: device time, idle share, host time in each `hvd.*` and
`bench.*` range).

Jobs that run side by side on the card (`concurrently`: phases 10 and
14, phase 13's runs, phase 16's int4 / fp8 and (c) / (d) runs, phase
17's runs) check results and count launches; they print no rate, time
or idle share (`launch(shared=True)`), since each shares the card and
the host with another.

Process starts, not steps, take most of a short run's time, so runs of
the same rank count share their processes (`launch_folded`: each run in
turn, `module.main(args)` with its own environment and its own process
group): phases 4, 12, 27 and 28 in one pair; the one-rank runs of phases 5, 7,
9, 19 (a) and bench_np1 in one process; phases 6 and 8 in one pair under
the launcher; phase 11's two runs in one pair; phase 13's one-rank runs
in one process; bench_np2 and phase 16's int8 run in one pair; phase
16's int4 run and (c), and its fp8 run and (d), in two pairs side by
side; phase 17's ring and tp runs, and its Ulysses and ep runs, in two
pairs side by side, then pp; phase 20's (a) and (b) in one set of four.
Each phase checks and prints its runs where it did; a folded run's
memory figures include what its process still held when it began (its
log says how much).

Then one JSON line with every kernel's numbers (K1 and K2 also at the
zoo deltas, with their launches on main path 5, and their launches on
main path 1 net of the ladder check's tree, and on main path 17 per
rank as `frontends_launches`; every kernel with its launches on main
path 18 per rank, none, as `cluster_launches`; K3 with its launches on
main path 7 as `wire_launches`; K4-K6 with their times at the ring's
pair shape as `ring_pair`, their errors at the ring's causal diagonal
pair and at the 4 heads a rank of Ulysses and tp=2, and their launches
per rank on each run of main path 8 as `mesh_launches`, and K4-K6's
launches on main path 9 as `serve_launches` and on main path 10 per
rank as `guard_launches` (the ladder) and `guard_zero3_launches`, and on
main path 11 per rank as `hier_launches` and `hier_zero3_launches`, and
on main path 12 as `runtime_launches` (the rank's eager steps, warm-ups
and captures) and `runtime_replay_launches` (one replay's, read from its
trace), and on main path 13 per rank as `trace_launches`, and on main
path 15 per rank as `reshard_launches`, K4's on main path 16 (every
replica's together) as `replicas_launches`, K3's
on main path 10 as `guard_launches`, K4 with its prefill-shape
times as `prefill` and the MIN_T table as `min_t`), and as the last
line
`{"ok": true, "device": {...}}`.  Any failure raises and exits non-zero
with no result line; so does a host without CUDA.  Full logs of the
training ranks go to chiprun_out/.

Every process the script starts, and every process those start, carries
RUN_MARK in its environment; when the script ends, however it ends, it
kills whichever of them is still running and names each on stderr
(`stop_leftovers`).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
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


# Set by the script's top process and inherited by every process under
# it (ranks, launchers, the elastic driver and its workers, builds).
RUN_MARK = "HVD_SMOKE_RUN"


def marked_processes(mark: str) -> dict:
    """pid -> (seconds since it started, command line) of every process
    but this one whose environment holds RUN_MARK=mark (zombies have no
    environment: they are gone)."""
    needle = f"\0{RUN_MARK}={mark}\0".encode()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    hz = os.sysconf("SC_CLK_TCK")
    found = {}
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if needle not in b"\0" + f.read() + b"\0":
                    continue
            with open(f"/proc/{name}/stat") as f:
                # field 22, the start time in ticks since boot (the
                # command in field 2 may hold spaces: split after it)
                started = int(f.read().rsplit(")", 1)[1].split()[19]) / hz
            with open(f"/proc/{name}/cmdline", "rb") as f:
                found[int(name)] = (round(uptime - started, 1), f.read(
                    ).replace(b"\0", b" ").decode(errors="replace").strip())
        except OSError:  # exited meanwhile, or not ours
            continue
    return found


def stop_leftovers(mark: str, timeout: float = 10.0) -> dict:
    """SIGKILL every process still running under RUN_MARK=mark (looking
    again until none is left or `timeout` passes), reap this process's
    own exited children, and return what was found (pid -> (age in
    seconds, command))."""
    import signal

    left = {}
    deadline = time.monotonic() + timeout
    while True:
        now = marked_processes(mark)
        if not now or time.monotonic() > deadline:
            break
        left.update(now)
        for pid in now:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        time.sleep(0.1)
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                break
        except ChildProcessError:
            break
    for pid, (age, cmd) in sorted(left.items()):
        print(f"[cleanup] killed pid {pid}, started {age} s before the "
              f"end, left running: {cmd[:300]}", file=sys.stderr, flush=True)
    return left


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


def _port_env(env=None) -> dict:
    """This process's environment with `env` added and the checkout on
    PYTHONPATH (the ranks import the port from it)."""
    return dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def run_launcher(args, timeout: float, env=None):
    """Run `python -m horovod_tpu_torch.runner args` (the port's launcher)
    with `env` added; return (exit code, its output).  At the time limit
    the launcher gets SIGINT, which makes it terminate its ranks' process
    trees before it exits, then SIGKILL."""
    import signal

    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *args], cwd=HERE,
        env=_port_env(env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        text, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(timeout=15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        raise RuntimeError(f"launcher {args[:6]}: no exit in {timeout} s")
    return p.returncode, text


_RANK_PREFIX = re.compile(r"^\[\d+\]<\d\d:\d\d:\d\d> ")


def run_ranks(phase: str, nranks: int, module: str, args, timeout: float,
              env=None, rank_env=None, launcher: bool = False):
    """Run `python -m module args` as `nranks` processes, rank r on card
    r mod the card count (all on card 0 when there is one), with `env`
    (and `rank_env(r)`) added to the environment; return each rank's
    stdout lines.  Raises if a rank fails or times out.

    `launcher=True` starts the ranks through the port's launcher
    (`python -m horovod_tpu_torch.runner -np nranks --output-filename
    chiprun_out/<phase>`), which sets each rank's topology env, and reads
    each rank's `rank.N.log` (without the launcher's `[r]<time> `
    prefix)."""
    if launcher:
        require(rank_env is None, "the launcher gives every rank one env")
        logs = os.path.join(LOG_DIR, phase)
        shutil.rmtree(logs, ignore_errors=True)
        rc, text = run_launcher(
            ["-np", str(nranks), "--output-filename", logs, sys.executable,
             "-m", module, *args], timeout, env=env)
        ranks = []
        for r in range(nranks):
            with open(os.path.join(logs, f"rank.{r}.log")) as f:
                ranks.append([_RANK_PREFIX.sub("", l)
                              for l in f.read().splitlines()])
        if rc != 0:
            raise RuntimeError(f"{phase}: the launcher exited {rc}:\n"
                               + text[-2000:] + "".join(
                                   f"\nrank {r}:\n" + "\n".join(l[-40:])
                                   for r, l in enumerate(ranks)))
        return ranks
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


def concurrently(fns, workers: int = 2) -> list:
    """Call `fns` (each starting its own rank processes), `workers` at a
    time; return their results in order, raising the first failure.
    Jobs that only check results share the card this way, to keep the
    script within its time limit (process starts, not steps, take most
    of such a job's wall); they print no rate or time
    (`launch(shared=True)`)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result() for f in futures]


FOLD_ENV = "HVD_SMOKE_FOLD"


def fold_rank() -> int:
    """A rank that runs several trainer runs in turn in one process (`python
    -m chip_smoke --fold-rank`): FOLD_ENV holds a JSON list of [module,
    args, env]; each runs as `module.main(args)` (chip_smoke's own `main`
    with `args` as its argv) with `env` added ("{rank}" in a value is this
    rank) and optionally a time limit in seconds, after a `FOLD <i>`
    line, the card's cache emptied and its peak-memory count reset
    before it.  A run past its limit ends the process with every
    thread's stack on stderr (`faulthandler`): a rank waiting in a
    collective its peers never reach fails in bounded time.  Each
    `main` initializes the runtime and shuts it down, so every run gets a
    process group of its own on the same coordinator (its next
    generation), as a new process would."""
    import faulthandler
    import importlib

    import torch

    from horovod_tpu_torch import faults

    rank = os.environ.get("HOROVOD_PROCESS_ID",
                          os.environ.get("HOROVOD_RANK", "0"))
    argv = sys.argv
    for i, (module, args, env, limit) in enumerate(
            json.loads(os.environ[FOLD_ENV])):
        env = {k: v.replace("{rank}", rank) for k, v in env.items()}
        print(f"FOLD {i}", flush=True)
        gc.collect()  # the last run's tensors, before the cache is emptied
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            # cuBLAS's workspaces live in the caching allocator too.
            getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # What the process still holds from the runs before: the
            # run's memory figures include it (`launch_folded` logs it).
            print(f"FOLD_HELD {torch.cuda.memory_allocated()}", flush=True)
        # A run reads HOROVOD_FAULT_SPEC at its first fault point, as a
        # new process would.
        faults._env_loaded = False
        sys.argv = [module, *args]
        main = importlib.import_module(module).main
        if limit:
            faulthandler.dump_traceback_later(limit, exit=True)
        try:  # chip_smoke's own main reads its mode from sys.argv
            rc = _with_env(env, lambda: main(list(args))
                           if main.__code__.co_argcount else main())
        finally:
            faulthandler.cancel_dump_traceback_later()
            sys.argv = argv
        if rc:
            return rc
    faults.clear()
    return 0


def launch_folded(phase: str, nranks: int, runs, timeout: float = 900,
                  env=None, launcher: bool = False) -> list:
    """Run several trainer runs in turn in the same `nranks` rank processes
    (`fold_rank`), each process started once: `runs` is a list of dicts
    with `phase`, `args` and optionally `module` (RESNET), `env`, `grow`,
    `shared`, `raw` and `limit` (the run's own time limit, s).  Each
    run's lines are held to `launch`'s checks under its own phase name
    (a `raw` run's are not: it prints no SUMMARY), its SUMMARY's memory
    figures (`*_mem_gb`) as the process read them, with what it still held from the runs before (`fold_rank`'s
    FOLD_HELD) logged; returns (summaries or None, each rank's lines) a
    run.
    `launcher=True` starts the processes through the port's launcher
    (run_ranks)."""
    spec = [[r.get("module", RESNET), list(r["args"]), r.get("env", {}),
             r.get("limit")] for r in runs]
    outs = run_ranks(phase, nranks, "chip_smoke", ["--fold-rank"], timeout,
                     env=dict(env or {}, **{FOLD_ENV: json.dumps(spec)}),
                     launcher=launcher)
    parts = [[[] for _ in runs] for _ in outs]
    for r, lines in enumerate(outs):
        i = -1
        for line in lines:
            if line.startswith("FOLD "):
                i = int(line.split()[1])
            elif line.startswith("FOLD_HELD "):
                if i > 0:
                    log(runs[i]["phase"], f"rank {r}: "
                        f"{int(line.split()[1]) / 1e9:.3f} GB held from the "
                        "runs before it in its process")
            elif i >= 0:
                parts[r][i].append(line)
    out = []
    for i, run in enumerate(runs):
        lines = [parts[r][i] for r in range(nranks)]
        out.append((None if run.get("raw") else check_launch(
            run["phase"], lines, run["args"], module=run.get("module", RESNET),
            grow=run.get("grow"), shared=run.get("shared", False)), lines))
    return out


# A key of a SUMMARY that holds a rate, a time or an idle share.
_TIMED = ("_sec", "_ms", "idle")


def _untimed(rec: dict) -> dict:
    """`rec` without its rates, times and idle shares."""
    return {k: v for k, v in rec.items()
            if not any(t in k for t in _TIMED)}


def launch(phase: str, nranks: int, args, module: str = RESNET,
           grow=None, timeout: float = 900, env=None,
           launcher: bool = False, shared: bool = False):
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
    after a step's STEP line) do not count toward the next step's.
    `launcher=True` starts the ranks through the port's launcher
    (run_ranks).  `shared=True` (a job beside another on the card)
    prints each SUMMARY without its rates and times (`_untimed`) and no
    PROFILE."""
    outs = run_ranks(phase, nranks, module, args, timeout, env=env,
                     launcher=launcher)
    return check_launch(phase, outs, args, module=module, grow=grow,
                        shared=shared)


def check_launch(phase: str, outs, args, module: str = RESNET, grow=None,
                 shared: bool = False):
    """`launch`'s checks on each rank's stdout lines `outs` of one run."""
    nranks = len(outs)
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
            if shared and tag == "PROFILE":
                continue
            for rec in _records(lines, tag):
                shown = _untimed(rec) if shared else rec
                log(phase, f"{tag} {json.dumps(shown)}")
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


AUTOTUNE_ARGS = ["--model", "resnet50", "--num-classes", "1000",
                 "--image-size", "224", "--batch-size", "32",
                 "--num-warmup-batches", "1", "--num-batches-per-iter", "4",
                 "--num-iters", "3", "--log-steps"]


def adasum_and_autotune(cluster: dict):
    """Phase 4's ranks, then phase 12's, phase 27's and phase 28's (its
    driver side `cluster` prepared), in turn in one pair of processes
    (`launch_folded`); returns (phase 4's summaries, phase 12's
    summaries and lines, phase 27's lines, phase 28's lines)."""
    for r in (0, 1):
        path = os.path.join(LOG_DIR, f"autotune_rank{r}.csv")
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    (adasum, _), autotune, frontends, cluster = launch_folded(
        "adasum_autotune", 2, [
        dict(phase="train_adasum", args=[
            "--use-adasum", "--model", "resnet50", "--num-classes", "1000",
            "--image-size", "224", "--batch-size", "32",
            "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
            "--num-iters", "3", "--log-steps", "--check-plain-step", "1"],
            grow=ADASUM_GROW),
        dict(phase="autotune_np2", args=AUTOTUNE_ARGS, env=dict(
            AUTOTUNE_ENV, HOROVOD_AUTOTUNE_LOG=os.path.join(
                LOG_DIR, "autotune_rank{rank}.csv"))),
        FRONTENDS_RUN, dict(CLUSTER_RUN, env=cluster["env"])], timeout=900)
    log("adasum_autotune", f"{time.perf_counter() - t0:.1f} s for phases 4, "
        "12, 27 and 28 in one pair of processes")
    return adasum, autotune, frontends[1], cluster[1]


def train_adasum(summaries):
    """Phase 4's checks on its summaries (`adasum_and_autotune`)."""
    require(all(s["steps"] == 3 for s in summaries),
            f"steps per rank: {[s['steps'] for s in summaries]}")
    for s in summaries:
        log("train_adasum", f"rank {s['rank']}: {s['img_sec_per_rank']:.2f} "
            f"img/sec (3 steps, checks included), backend {s['backend']}, "
            f"launches {s['launches']}")
    return summaries


AVERAGE_ARGS = ["--model", "resnet50", "--num-classes", "1000",
                "--image-size", "224", "--batch-size", "64",
                "--num-warmup-batches", "3", "--num-batches-per-iter", "5",
                "--num-iters", "3"]
TRANSFORMER_NCCL_ARGS = ["--num-warmup-batches", "2",
                         "--num-batches-per-iter", "3", "--num-iters", "3"]
ZERO3_NCCL_ARGS = ["--zero-stage", "3", "--num-warmup-batches", "2",
                   "--num-batches-per-iter", "3", "--num-iters", "3",
                   "--eval-every", "11"]
BENCH_NP1_ARGS = ["--num-warmup-batches", "2", "--num-batches-per-iter", "5",
                  "--num-iters", "3"]


def single_rank_runs() -> dict:
    """The one-rank runs on NCCL of phases 5, 7, 9, 19 (a) and 15
    (bench_np1), in turn in one process (`launch_folded`): one process
    start instead of six.  Each run still has the card to itself and its
    own process group; each phase checks and prints its run's summary
    where it did."""
    runs = [dict(phase="train_average", args=AVERAGE_ARGS),
            dict(phase="transformer_nccl", args=TRANSFORMER_NCCL_ARGS,
                 module=TRANSFORMER),
            dict(phase="zero3_nccl", args=ZERO3_NCCL_ARGS,
                 module=TRANSFORMER, env=ZERO3_ENV),
            dict(phase="guard_resnet_off", args=GUARD_RESNET_ARGS),
            dict(phase="guard_resnet_on", args=GUARD_RESNET_ARGS,
                 env={"HOROVOD_GUARD": "1"}),
            dict(phase="bench_np1", args=BENCH_NP1_ARGS, module=BENCH,
                 raw=True)]
    t0 = time.perf_counter()
    out = launch_folded("single_rank", 1, runs, timeout=1200)
    log("single_rank", f"{time.perf_counter() - t0:.1f} s for "
        f"{[r['phase'] for r in runs]} in one process")
    return {r["phase"]: o for r, o in zip(runs, out)}


def train_average(s):
    """Phase 5; `s`: its summary (`single_rank_runs`)."""
    require(s["backend"] == "nccl", s)
    log("train_average", f"{s['img_sec_per_rank']:.2f} img/sec "
        f"(+- {1.96 * s['img_sec_std']:.2f}), batch 64, backend "
        f"{s['backend']}, buckets flushed {s['flushes']} over "
        f"{s['steps']} steps, last loss {s['last_loss']:.4f}")
    return s


ZERO3_ARGS = ["--zero-stage", "3", "--num-warmup-batches", "0",
              "--num-batches-per-iter", "1", "--num-iters", "3", "--log-steps",
              "--eval-every", "3", "--check-plain-step", "2"]


def transformer_and_zero3():
    """Main paths 2 and 3: phase 6's run then phase 8's, in turn in one
    pair of processes started by the port's launcher (`launch_folded`),
    phase 6's with every eager collective under the consistency check;
    returns each run's summaries."""
    t0 = time.perf_counter()
    (stage0, _), (zero3, _) = launch_folded("train_transformer", 2, [
        dict(phase="train_transformer", args=[
            "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
            "--num-iters", "3", "--log-steps", "--check-plain-step", "1"],
            module=TRANSFORMER, grow=FLASH_GROW, env=LAUNCHED_ENV),
        dict(phase="train_zero3", args=ZERO3_ARGS, module=TRANSFORMER,
             env=ZERO3_ENV, grow=FLASH_GROW)], timeout=900, launcher=True)
    log("train_transformer", f"{time.perf_counter() - t0:.1f} s for phases "
        "6 and 8 in one pair of processes")
    return stage0, zero3


def train_transformer(summaries):
    """Main path 2's checks on its summaries (`transformer_and_zero3`)."""
    require(all(s["steps"] == 3 and s["n_layers"] == 8 for s in summaries),
            f"steps per rank: {[s['steps'] for s in summaries]}")
    # The check ran on the ranks: every flushed gradient bucket's
    # allreduce (3 steps of at least one each) and the other eager
    # collectives, as many on each rank.
    checks = [(s["consistency_checks"], s["flushes"]) for s in summaries]
    require(all(n >= f >= 3 for n, f in checks)
            and len({n for n, _ in checks}) == 1,
            f"consistency checks, buckets flushed per rank: {checks}")
    for s in summaries:
        log("train_transformer", f"rank {s['rank']}: "
            f"{s['tok_sec_per_rank']:.1f} tok/sec (3 steps, checks "
            f"included), backend {s['backend']}, peak memory "
            f"{s['peak_mem_gb']:.2f} GB, launches {s['launches']}, "
            f"{s['consistency_checks']} consistency checks "
            f"({s['flushes']} buckets flushed)")
    return summaries


# Phase 6's ranks run every eager collective under the consistency check
# (utils/consistency.py, over the launcher's rendezvous KV).
LAUNCHED_ENV = {"HOROVOD_COLLECTIVE_CONSISTENCY_CHECK": "1"}


def transformer_nccl(s):
    """Phase 7; `s`: its summary (`single_rank_runs`)."""
    require(s["backend"] is None or s["backend"] == "nccl", s)
    log("transformer_nccl", f"{s['tok_sec_per_rank']:.1f} tok/sec "
        f"(+- {1.96 * s['tok_sec_std']:.1f}), T 16384, batch 1, one rank "
        f"on the card, peak memory {s['peak_mem_gb']:.2f} GB, last loss "
        f"{s['last_loss']:.4f}")
    return s


def head_k3_launches(n: int, vocab: int = 32000, d_model: int = 512,
                     chunk_bytes: int = 1 << 20) -> int:
    """K3 launches a rank in one held-out forward at stage 3 over n
    ranks: the tied head's (vocab / n, d_model) f32 shard gathers in row
    chunks of chunk_bytes (HOROVOD_FUSED_CHUNK_BYTES' default;
    `plan_chunks`), and each gathered chunk's n row bands are one K3
    product each (`fused_allgather_matmul`): 63 at one rank, 64 at two
    and at four."""
    rows = chunk_bytes // (d_model * 4)
    return n * -(-(vocab // n) // rows)


def train_zero3(summaries, stage0, phase: str = "train_zero3"):
    """Main path 3 (see the module docstring): the checks on its
    summaries (`transformer_and_zero3`); `stage0`: phase 6's, the same
    seeds and data at stage 0."""
    tol = K3_RTOL["torch.float32"]
    n = len(summaries)
    k3 = head_k3_launches(n)
    for s, s0 in zip(summaries, stage0):
        r = s["rank"]
        require(s["steps"] == 3 and s["n_layers"] == 8 and
                s["zero_stage"] == 3, f"rank {r}: {s}")
        diffs = [abs(a - b) for a, b in zip(s["step_losses"],
                                            s0["step_losses"])]
        require(len(diffs) == 3 and max(diffs) <= LOSS_TOL,
                f"rank {r}: stage-3 losses {s['step_losses']} vs stage 0 "
                f"{s0['step_losses']}")
        cap = s["param_full_bytes"] // n + 4 * s["shard_groups"]
        require(s["param_resident_bytes"] <= cap,
                f"rank {r}: resident {s['param_resident_bytes']} > {cap}")
        require(s["param_storage_bytes"] == 0,
                f"rank {r}: parameters hold {s['param_storage_bytes']} "
                "bytes between steps (want 0)")
        require(s["peak_mem_gb"] <= s0["peak_mem_gb"],
                f"rank {r}: stage 3 peaks at {s['peak_mem_gb']:.3f} GB, "
                f"stage 0 at {s0['peak_mem_gb']:.3f}")
        (ev,) = s["evals"]
        require(ev["k3_launches"] == k3 and ev["k3_plain_calls"] == 0
                and ev["k3_strided_launches"] == 0,
                f"rank {r}: eval forward launched K3 {ev['k3_launches']} "
                f"times (want {k3}), {ev['k3_strided_launches']} on the "
                "strided path (want 0)")
        require(ev["eval_logits_rel"] <= tol and
                math.isfinite(ev["eval_loss"]),
                f"rank {r}: eval logits vs the plain head "
                f"{ev['eval_logits_rel']} (tol {tol}), loss {ev['eval_loss']}")
        log(phase, f"rank {r}: {s['tok_sec_per_rank']:.1f} tok/sec "
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


def zero3_nccl(s, stage0):
    """One rank on NCCL at stage 3; `s`: its summary (`single_rank_runs`),
    `stage0`: phase 7's."""
    require(s["backend"] == "nccl", s)
    cap = s["param_full_bytes"] + 4 * s["shard_groups"]
    require(s["param_storage_bytes"] == 0 and
            s["param_resident_bytes"] <= cap,
            f"parameters hold {s['param_storage_bytes']} bytes between "
            f"steps (want 0), resident {s['param_resident_bytes']} (cap "
            f"{cap})")
    (ev,) = s["evals"]
    k3 = head_k3_launches(1)
    require(ev["k3_launches"] == k3 and ev["k3_strided_launches"] == 0
            and math.isfinite(ev["eval_loss"]),
            f"eval forward launched K3 {ev['k3_launches']} times (want {k3}), "
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
            + f" (tol {SYNC_BN_TOL:.3g}, statistics {SYNC_BN_STAT_TOL})")


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


def _elastic_run(name: str, outs):
    """One elastic run's checks on each rank's lines `outs`."""
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
    """Main path 4: the fault-free run then the faulted one, in turn in one
    pair of processes (`launch_folded`)."""
    steps = 2 * 4
    spec, seed, first = elastic_fault_spec(steps)
    (_, clean), (_, faulted) = launch_folded("train_elastic", 2, [
        dict(phase="train_elastic_clean", args=ELASTIC_ARGS, module=ELASTIC,
             raw=True),
        dict(phase="train_elastic_fault", args=ELASTIC_ARGS, module=ELASTIC,
             env={"HOROVOD_FAULT_SPEC": spec,
                  "HOROVOD_FAULT_SEED": str(seed)}, raw=True)], timeout=900)
    clean = _elastic_run("train_elastic_clean", clean)
    faulted = _elastic_run("train_elastic_fault", faulted)
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


def autotune_np2(run):
    """Phase 12's checks on its (summaries, lines) (`adasum_and_autotune`)."""
    sizes = hook_order()
    logs = [os.path.join(LOG_DIR, f"autotune_rank{r}.csv") for r in (0, 1)]
    summaries, lines = run
    steps = [_records(lines[r], "STEP") for r in (0, 1)]
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
    """Main path 5 (see the module docstring).  The Adasum pair and the
    one-rank runs go side by side on the card: their checks are counts,
    launches and losses, and they print no rate."""
    phase = "train_zoo"

    def adasum_pair():
        return launch(phase, 2, [
            "--model", "vgg16", "--use-adasum", "--num-classes", "1000",
            "--image-size", "224", "--batch-size", "32",
            "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
            "--num-iters", "3", "--log-steps", "--check-plain-step", "1"],
            grow=ADASUM_GROW, timeout=900, shared=True)

    def one_rank_runs():
        models = ("inception3", "vgg16")
        out = launch_folded(f"{phase}_singles", 1, [
            dict(phase=f"{phase}_{model}", args=[
                "--model", model, "--num-classes", "1000", "--batch-size",
                "32", "--num-warmup-batches", "2", "--num-batches-per-iter",
                "3", "--num-iters", "2", "--profile", "2"], shared=True)
            for model in models], timeout=900)
        return {model: summaries[0]
                for model, (summaries, _) in zip(models, out)}

    summaries, singles = concurrently([adasum_pair, one_rank_runs])
    require(all(s["steps"] == 3 and s["params"] == ZOO_N["vgg16"]
                for s in summaries), f"vgg16 Adasum: {summaries}")
    for s in summaries:
        log(phase, f"vgg16 Adasum rank {s['rank']}: 3 steps, backend "
            f"{s['backend']}, peak memory "
            f"{s['peak_mem_gb']:.2f} GB, launches {s['launches']}")
    vgg_sizes = hook_order("vgg16", 224)
    buckets = expected_buckets(vgg_sizes, FUSION_THRESHOLD)
    require(sum(vgg_sizes) == 4 * ZOO_N["vgg16"], "vgg16 gradient bytes")
    for model, s in singles.items():
        require(s["backend"] == "nccl" and s["params"] == ZOO_N[model], s)
        if model == "vgg16":
            require(s["flushes"] == buckets * s["steps"],
                    f"vgg16: {s['flushes']} buckets over {s['steps']} steps, "
                    f"want {buckets} a step (the JAX partition of its "
                    f"gradients in hook order at {FUSION_THRESHOLD} bytes)")
        log(phase, f"{model} at {s['image_size']}x{s['image_size']}, one "
            f"rank on NCCL: batch 32, buckets flushed "
            f"{s['flushes']} over {s['steps']} steps "
            f"({s['flushes'] / s['steps']:g} a step), peak memory "
            f"{s['peak_mem_gb']:.2f} GB, last loss {s['last_loss']:.4f}")
    log(phase, f"vgg16 buckets a step at {FUSION_THRESHOLD} bytes: "
        f"{buckets} (gradient bytes in hook order: {vgg_sizes[:6]} ...)")
    return summaries, singles


def mnist_np2():
    """BASELINE config 1's trainer at two ranks on the card over gloo."""
    summaries = launch("mnist", 2, ["--epochs", "2", "--log-steps"],
                       module=MNIST, timeout=300, shared=True)
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
            f"{s['steps']} steps, backend {s['backend']}")
    return summaries


BENCH_NP2_ARGS = ["--batch-size", "32", "--num-warmup-batches", "2",
                  "--num-batches-per-iter", "5", "--num-iters", "3"]
WIRE_INT8_ARGS = ["--compression", "int8", "--check-wire-step", "1",
                  "--profile", "3"]


def bench_and_int8():
    """bench_np2 then phase 16's int8 run, in turn in one pair of
    processes (`launch_folded`), each alone on the card; returns
    (bench_np2's lines, the int8 run's (summaries, lines))."""
    t0 = time.perf_counter()
    (_, bench), int8 = launch_folded("bench_np2", 2, [
        dict(phase="bench_np2", args=BENCH_NP2_ARGS, module=BENCH, raw=True),
        dict(phase="train_wire_int8",
             args=WIRE_RESNET_ARGS + WIRE_INT8_ARGS)], timeout=900)
    log("bench_np2", f"{time.perf_counter() - t0:.1f} s for bench_np2 and "
        "train_wire's int8 run in one pair of processes")
    return bench, int8


def bench_rows(np1_outs, np2_outs):
    """`python -m horovod_tpu_torch.bench` at one rank on NCCL (its
    defaults: ResNet-50, batch 64) and at two ranks sharing the card over
    gloo (batch 32); each's lines from `single_rank_runs` and
    `bench_and_int8`."""
    results = {}
    for name, nranks, outs in (("bench_np1", 1, np1_outs),
                               ("bench_np2", 2, np2_outs)):
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


WIRE_RESNET_ARGS = ["--model", "resnet50", "--num-classes", "1000",
                    "--image-size", "224", "--batch-size", "32",
                    "--num-warmup-batches", "0", "--num-batches-per-iter",
                    "1", "--num-iters", "3", "--log-steps"]


def _check_ring_steps(phase: str, steps) -> None:
    """Every bucket of every step of each rank's STEP records on the
    ring."""
    for r, recs in enumerate(steps):
        before = (0, 0)
        for rec in recs:
            flushed = rec["flushes"] - before[0]
            ring = rec["ring_buckets"] - before[1]
            before = (rec["flushes"], rec["ring_buckets"])
            require(flushed > 0 and ring == flushed,
                    f"{phase} rank {r} step {rec['step']}: {ring} of "
                    f"{flushed} buckets on the ring")


def train_wire(zero3_summaries, int8):
    """Phase 16 (b)-(d); `zero3_summaries`: phase 8's, the same
    stage-3 run on the exact wire; `int8`: the int8 run's (summaries,
    lines) (`bench_and_int8`)."""
    import torch

    results = {}
    sizes = hook_order()
    # Under an explicit int8 every bucket rides the ring: the policy plan
    # with an int8 big codec and no threshold is its partition and wire.
    int8_plan = _policy_plan("big=int8,threshold=0", sizes)
    summaries, int8_lines = int8
    steps = [_records(lines, "STEP") for lines in int8_lines]
    _check_ring_steps("train_wire_int8", steps)
    check = next(rec["wire_check"] for rec in steps[0]
                 if "wire_check" in rec)
    require(check["bitwise"] and check["bound_ok"] and
            check["buckets"] == len(int8_plan),
            f"train_wire_int8: ring vs its plain model {check}")
    for s in summaries:
        require(s["buckets"] == int8_plan, f"int8 buckets {s['buckets']} "
                f"(want {int8_plan})")
    profiled = _records(int8_lines[0], "PROFILE")
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

    # Two pairs of processes share the card: the int4 policy run then (c)
    # in one, the fp8 run then (d) in the other.
    want = _policy_plan(WIRE_POLICY_INT4, sizes)
    grow2 = {k: 2 for k in FLASH_GROW}
    (summaries, int4_lines), (zsum, _), (fp8, fp8_lines), (_, z1_lines) = [
        run for chain in concurrently([
            lambda: launch_folded("train_wire_chain0", 2, [
                dict(phase="train_wire_int4", args=WIRE_RESNET_ARGS,
                     env={"HOROVOD_WIRE_POLICY": WIRE_POLICY_INT4},
                     shared=True),
                dict(phase="train_wire_zero3", args=[
                    "--zero-stage", "3", "--num-warmup-batches", "0",
                    "--num-batches-per-iter", "1", "--num-iters", "3",
                    "--log-steps", "--eval-every", "3",
                    "--check-plain-step", "2"], module=TRANSFORMER,
                    env=dict(ZERO3_ENV, **WIRE_ENV), grow=FLASH_GROW,
                    shared=True)], timeout=900),
            lambda: launch_folded("train_wire_chain1", 2, [
                dict(phase="train_wire_fp8",
                     args=WIRE_RESNET_ARGS + ["--compression", "fp8_e4m3"],
                     shared=True),
                dict(phase="train_wire_zero1", args=[
                    "--zero-stage", "1", "--n-layers", "2",
                    "--num-warmup-batches", "0", "--num-batches-per-iter",
                    "1", "--num-iters", "3", "--log-steps"],
                    module=TRANSFORMER, grow=grow2,
                    env={"HOROVOD_SHARD_AG_WIRE": "int8",
                         "HOROVOD_WIRE_POLICY": "auto"}, shared=True)],
                timeout=900)]) for run in chain]
    for phase, lines in (("train_wire_int4", int4_lines),
                         ("train_wire_fp8", fp8_lines)):
        _check_ring_steps(phase, [_records(l, "STEP") for l in lines])
    for s in summaries:
        require(s["buckets"] == want, f"int4 policy buckets {s['buckets']} "
                f"(wire_policy_plan: {want})")
    results["int4"] = {"buckets": summaries[0]["buckets"]}
    log("train_wire", f"ResNet-50 under HOROVOD_WIRE_POLICY="
        f"{WIRE_POLICY_INT4}: buckets {summaries[0]['buckets']} (those of "
        f"wire_policy_plan)")
    results["fp8_e4m3"] = {"last_loss": [s["last_loss"] for s in fp8]}
    log("train_wire", f"ResNet-50 fp8_e4m3 ring: "
        f"last losses {[round(s['last_loss'], 4) for s in fp8]}")

    # (c) Main path 7: the stage-3 head over an int8 gather; (d) ZeRO-1
    # with the parameter allgather on int8.
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
            f"{r}: losses {s['step_losses']} vs "
            f"exact wire {s0['step_losses']} (max diff {max(diffs):.3g}, tol "
            f"{WIRE_LOSS_TOL}); eval forward K3 launches "
            f"{ev['k3_launches']} (strided {ev['k3_strided_launches']}), "
            f"logits vs plain head on the decoded weights "
            f"{ev['eval_logits_rel']:.3g} (tol {tol}), vs the exactly "
            f"gathered head {ev['eval_exact_rel']:.3g} (tol "
            f"{WIRE_LOGITS_RTOL}), eval loss {ev['eval_loss']:.4f} (exact "
            f"{ev0['eval_loss']:.4f}); peak memory {s['peak_mem_gb']:.2f} GB")
    results["zero3"] = zsum

    # (d) ZeRO-1's int8 allgather.
    for r in (0, 1):
        recs = _records(z1_lines[r], "STEP")
        diffs = [rec["master_wire_diff"] for rec in recs]
        require(len(diffs) == 3 and all(d > 0 for d in diffs),
                f"rank {r}: f32 master vs decoded parameter {diffs}")
        log("train_wire", f"stage 1, int8 allgather, rank {r}: largest "
            f"|f32 master - decoded parameter| by step {diffs}; digests "
            f"equal across ranks each step")
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
# Checked steps of each train_mesh run (then one profiled): one, so that
# the script with phase 23 keeps to its 1,060 s target (a checked step at
# 4 layers takes about 2.5 s on the H100, and the phase runs five such
# runs; step 0 carries the one-rank reference check either way).
MESH_CHECKED_STEPS = 1
MESH_RUNS = [
    ("ring", ["--sp", "2"], [], 4),
    ("ulysses", ["--sp", "2", "--attn", "ulysses"], [], 4),
    ("tp", ["--tp", "2"], [], 4),
    ("ep", ["--ep", "2", "--moe-every", "2", "--n-experts", "8"], [], 4),
    ("pp", ["--pp", "2"], ["--batch-size", "2"], 4),
]


# The runs whose attention is the causal ring over sp.
RING_RUNS = ("ring", "ep_sp")


def expected_flash(name: str, s: dict) -> int:
    """K4 (and K5, K6) launches per step on one rank of a mesh run: a
    layer's attention once per layer; on the causal ring, rank i runs
    the pairs with blocks i, ..., 0 (the future pairs are skipped); under
    GPipe each stage runs its layers on every tick (M + pp - 1 of them,
    M = pp microbatches), bubbles included."""
    layers = s["n_layers"]
    if name in RING_RUNS:
        return layers * (s["coords"]["sp"] + 1)
    if name == "pp":
        pp = s["mesh"]["pp"]
        return layers // pp * (2 * pp - 1)
    return layers


MESH_ARGS = ["--num-warmup-batches", "0", "--num-batches-per-iter", "1",
             "--num-iters", str(MESH_CHECKED_STEPS), "--log-steps",
             "--check-dense-step", "0", "--profile", "1"]


def check_mesh_run(phase: str, name: str, summaries):
    """A mesh run's launch checks on its summaries (`launch`'s done):
    every step's K4-K6 launches on every rank as many as
    `expected_flash` says, all on the tensor cores, the one-rank
    reference's left out."""
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
                        f"{phase} rank {s['rank']} step {i}: {n} "
                        f"{got[n]} launches, {got[n + '_sm90']} on the "
                        f"tensor cores (want {want})")
        log(phase, f"rank {s['rank']} {s['coords']}: {len(per_step)} "
            f"checked steps, K4-K6 launches per step {per_step} (all "
            f"tensor cores), peak {s['peak_mem_gb']:.2f} GB, "
            f"{s['n_layers']} layers")
    return summaries


def train_mesh():
    """Phase 17 (b)-(f): the default TransformerConfig at T = 16384 over
    two gloo ranks on one card, through `make_train_step`: finite losses,
    one digest of the full parameters per step, step 0's loss within
    LOSS_TOL of rank 0's one-rank `reference_loss` on the same weights
    and tokens, every K4-K6 launch on the tensor cores and as many per
    rank and step as `expected_flash` says (the reference's launches
    left out), and one profiled step (the profiler's path).  Two runs
    share the card at a time, so they print no rate or time."""
    def chain(k, runs):
        """`runs`, in turn in one pair of processes."""
        t0 = time.perf_counter()
        out = launch_folded(f"mesh_chain{k}", 2, [
            dict(phase=f"mesh_{name}", args=mesh + extra + MESH_ARGS + [
                "--n-layers", str(layers)], module=TRANSFORMER,
                grow={n: None for n in FLASH_NAMES}, shared=True)
            for name, mesh, extra, layers in runs], timeout=900,
            env=MESH_ENV)
        log(f"mesh_chain{k}", f"{[r[0] for r in runs]}: "
            f"{time.perf_counter() - t0:.1f} s")
        return {name: check_mesh_run(f"mesh_{name}", name, summaries)
                for (name, _, _, _), (summaries, _) in zip(runs, out)}

    # Two pairs of processes share the card, each running its runs in turn
    # (ring then tp, Ulysses then ep: the parent's pairs), then pp alone.
    out = {}
    for done in concurrently([functools.partial(chain, 0, MESH_RUNS[0:4:2]),
                              functools.partial(chain, 1, MESH_RUNS[1:4:2])]):
        out.update(done)
    out.update(chain(2, MESH_RUNS[4:]))
    return {name: out[name] for name, *_ in MESH_RUNS}


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
    make_trace of 10 requests plus one whose prompt takes K4, under fifo
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
    # 10 requests (more than max_batch, so the batch still turns over):
    # the script's depth, which keeps it to its time target.
    trace = make_trace(18, 10, cfg.vocab_size, **FULL_TRACE)
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


def train_guard(singles) -> dict:
    """Phase 19 (main path 10): (a) the guard's cost on ResNet-50 at one
    rank (its two runs from `single_rank_runs`), (b) the ladder and its
    teeth, (c) stage 3; see the module docstring."""
    import torch

    t_start = time.perf_counter()
    resnet = {}
    for name in ("off", "on"):
        (s,) = singles[f"guard_resnet_{name}"][0]
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
    # (a) and (b) in turn in the same four processes.
    (a, a_lines), (b, _) = launch_folded(phase, HIER_RANKS, [
        dict(phase=f"{phase}_stage0", args=HIER_ARGS + [
            "--num-iters", "3", "--fused-apply", "--early-reduction",
            "--guard", "--check-hier-step", "1", "--profile", "1"],
            module=TRANSFORMER, grow=HIER_GROW, env=HIER_ENV),
        dict(phase=f"{phase}_zero3", args=HIER_ARGS + [
            "--num-iters", "2", "--zero-stage", "3", "--eval-every", "2"],
            module=TRANSFORMER, grow=HIER_GROW,
            env=dict(ZERO3_ENV, HOROVOD_SHARD_AG_FUSION="1"))],
        timeout=HIER_BUDGET_S)
    profiles = [_records(lines, "PROFILE")[-1] for lines in a_lines]
    steps = _records(a_lines[0], "STEP")
    for s in a:
        require(s["passes_per_step"] == HIER_PASSES and s["dcn"] == 2
                and s["size"] == HIER_RANKS, f"{phase}: {s}")
    for r in range(HIER_RANKS):
        recs = _records(a_lines[r], "STEP")
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


RUNTIME_BUDGET_S = 60  # phase 21's share of the script's time limit
RUNTIME_K = 2          # steps a megastep call
RUNTIME_CALLS = 3      # megastep calls: eager warm-up, capture + replay, replay
STALL_LATE_S = 3.0     # rank 1 enters the drill's allreduce this late
STALL_SKEW_S = 0.25    # its sleep's margin over the barrier's skew
STALL_ENV = {"HOROVOD_STALL_CHECK_TIME_SECONDS": "1"}
SM90_NAMES = {"flash_fwd": "fwd_sm90", "flash_bwd_dq": "bwd_dq_sm90",
              "flash_bwd_dkv": "bwd_dkv_sm90"}  # K4-K6's CUDA kernels


def _trace_events(path: str) -> list:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _kernel_counts(events) -> dict:
    """K4-K6 kernel launches in a torch.profiler trace, by wrapper name."""
    out = {n: 0 for n in SM90_NAMES}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for n, sym in SM90_NAMES.items():
            if sym in e.get("name", ""):
                out[n] += 1
    return out


def runtime_rank(cfg=None, seq_len: int = 16384, device=None,
                 k: int = RUNTIME_K, calls: int = RUNTIME_CALLS) -> int:
    """Phase 21 (a)-(c) in one process (`python -m chip_smoke
    --runtime-rank`, run by `train_runtime` under HOROVOD_TIMELINE and
    HOROVOD_TIMELINE_MARK_CYCLES=1; `cfg`, `seq_len` and `device` shrink
    it for a rehearsal on the CPU).

    (a) One rank, DistributedOptimizer(AdamW(capturable=True)) on the
    transformer from one seed: calls·k eager steps, then the same model
    afresh through `calls` calls of `repeat_steps(k)` (warm-up, capture
    and replay, replay): losses and the final parameters' SHA-256, and
    per step the wall time (to a sync) and the host's share of it.
    (b) One more replay under `start_device_trace`: the trace, the
    merged view and the timeline's cycles and step spans of the call.
    (c) Seeded token batches [k, 1, T+1] from a host generator through
    `prefetch_to_device(size=2)` into `scan_steps(k)`; the third call
    profiled.  Saved to LOG_DIR/runtime_rank0.pt."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.utils import megastep, profiler, timeline

    hvd.init(device=device)
    dev = hvd.device()
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or TransformerConfig(compute_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, seq_len + 1))).to(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def build():
        model = Transformer(cfg, seed=0).to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4, capturable=on_card),
            named_parameters=model.named_parameters())
        return model, opt

    def step(carry, batch):
        model, opt = carry
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(batch[:, :-1]), batch[:, 1:])
        loss.backward()
        opt.step()
        return carry, loss.detach()

    def timed(fn):
        """(fn's result, wall s to a sync, host s until fn returned)."""
        sync()
        t0 = time.perf_counter()
        out = fn()
        t_host = time.perf_counter() - t0
        sync()
        return out, time.perf_counter() - t0, t_host

    FA.reset_launch_counts()
    res = {"k": k, "calls": calls, "n_layers": cfg.n_layers,
           "device": str(dev)}
    # (a) eager, then megastep from the same seed.
    model, opt = build()
    eager = []
    for _ in range(calls * k):
        (_, loss), wall, host = timed(lambda: step((model, opt), tokens))
        eager.append((loss.clone(), wall, host))
    res["eager_losses"] = torch.stack([e[0] for e in eager]).float().cpu()
    res["eager_digest"] = _sha(model.parameters())
    res["eager_wall_s"] = [e[1] for e in eager]
    res["eager_host_s"] = [e[2] for e in eager]
    del model, opt, eager
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    model, opt = build()
    mstep = megastep.repeat_steps(step, k, out_mode="all")
    mega = []
    for _ in range(calls):
        (_, losses), wall, host = timed(lambda: mstep((model, opt), tokens))
        mega.append((losses.clone(), wall, host))
    res["mega_losses"] = torch.cat([m[0] for m in mega]).float().cpu()
    res["mega_digest"] = _sha(model.parameters())
    res["mega_wall_s"] = [m[1] for m in mega]
    res["mega_host_s"] = [m[2] for m in mega]
    res["graph"] = mstep.graph is not None
    res["launches"] = {**FA.launch_counts(), **{
        f"{n}_sm90": c for n, c in FA.sm90_launch_counts().items()}}

    # (b) one replay under the profiler, with the timeline's marker.
    tl = timeline.get_timeline()
    logdir = os.path.join(LOG_DIR, "runtime_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    profiler.start_device_trace(logdir)
    mstep((model, opt), tokens)
    sync()
    trace = profiler.stop_device_trace()
    res["replay_launches"] = _kernel_counts(_trace_events(trace))
    if tl is not None:
        path = tl._writer.filename
        timeline.stop_timeline()  # flush and close the file
        res["merge"] = profiler.merge_traces(
            path, trace, os.path.join(LOG_DIR, "runtime_merged.json"))
        host = _trace_events_host(path)
        after = host[next(i for i, e in enumerate(host)
                          if e["name"] == profiler.TRACE_START_MARKER):]
        res["replay_cycles"] = sum(e["cat"] == "cycle" for e in after)
        res["replay_spans"] = sum(e["cat"] == "step" and e["ph"] == "X"
                                  for e in after)
        res["cycles"] = sum(e["cat"] == "cycle" for e in host)
    os.remove(trace)

    # (c) prefetch into scan_steps; the third call profiled.
    rng = np.random.RandomState(1)
    sources = [torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (k, 1, seq_len + 1))) for _ in range(calls + 1)]
    feed = hvd.prefetch_to_device(iter(sources), size=2)
    sstep = megastep.scan_steps(step, k, out_mode="all")
    same = []
    scan_losses = []
    trace = None
    for c in range(calls):
        if c == calls - 1 and on_card:
            profiler.start_device_trace(logdir)
        batch = next(feed)
        _, losses = sstep((model, opt), batch)
        scan_losses.append(losses.clone())
        same.append(torch.equal(batch.cpu(), sources[c]))
    sync()
    if on_card:
        trace = profiler.stop_device_trace()
    same.append(torch.equal(next(feed).cpu(), sources[calls]))
    res["prefetch_bitwise"] = same
    res["scan_losses"] = torch.cat(scan_losses).float().cpu()
    res["scan_graph"] = sstep.graph is not None
    if trace is not None:
        ev = _trace_events(trace)
        copies = [e for e in ev if e.get("cat") == "gpu_memcpy"
                  and "HtoD" in e.get("name", "")]
        compute = {e.get("args", {}).get("stream") for e in ev
                   if e.get("cat") == "kernel"
                   and SM90_NAMES["flash_fwd"] in e.get("name", "")}
        res["h2d_streams"] = sorted({e.get("args", {}).get("stream")
                                     for e in copies}, key=str)
        res["compute_streams"] = sorted(compute, key=str)
        res["scan_replay_launches"] = _kernel_counts(ev)
        os.remove(trace)

    # The bracket's host cost: one-element allreduces at one rank (no
    # exchange), the inspector and the metrics on and off in turns; and
    # one watchdog check.
    from horovod_tpu_torch.metrics import catalog as MET
    from horovod_tpu_torch.utils import stall_inspector

    x = torch.ones(1, device=dev)
    si = stall_inspector.get_inspector()

    def burst(on: bool, n: int = 2000) -> float:
        stall_inspector._inspector = si if on else None
        MET.set_enabled(on)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            hvd.allreduce(x)
        sync()
        return (time.perf_counter() - t0) / n * 1e6

    turns = [(on, burst(on)) for on in (True, False, False, True)]
    stall_inspector._inspector = si
    MET.set_enabled(True)
    res["bracket_us"] = {k: [t for on, t in turns if on == (k == "on")]
                         for k in ("on", "off")}
    t0 = time.perf_counter()
    for _ in range(1000):
        si.check()
    res["watchdog_check_us"] = (time.perf_counter() - t0) / 1000 * 1e6
    torch.save(res, os.path.join(LOG_DIR, "runtime_rank0.pt"))
    hvd.shutdown()
    return 0


def _trace_events_host(path: str) -> list:
    from horovod_tpu_torch.utils.profiler import _load_timeline_events

    return _load_timeline_events(path)


def stall_rank(device=None) -> int:
    """Phase 21 (d)'s ranks (`python -m chip_smoke --stall-rank` under
    run_ranks' env and STALL_ENV): rank 1 enters an allreduce of a CUDA
    tensor STALL_LATE_S late; each rank saves the warnings its stall
    inspector issued, the metric and its wait to
    LOG_DIR/stall_rank<r>.pt."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.metrics import catalog as MET
    from horovod_tpu_torch.utils import stall_inspector

    hvd.init(device=device)
    r = hvd.rank()
    si = stall_inspector.get_inspector()
    warned = []
    log_warning = si._warn_fn
    si._warn_fn = lambda m: (warned.append(m), log_warning(m))
    hvd.barrier()
    if r == 1:
        time.sleep(STALL_LATE_S + STALL_SKEW_S)
    t0 = time.perf_counter()
    out = hvd.allreduce(torch.full((1024,), float(r + 1),
                                   device=hvd.device()), name="drill")
    wait = time.perf_counter() - t0
    res = {"rank": r, "wait_s": wait, "warned": warned,
           "warnings": MET.stall_warnings._solo().get(),
           "reporter": si._reporter is not None,
           "out_ok": bool((out == 1.5).all()), "device": str(out.device),
           "backend": hvd.backend()}
    hvd.shutdown()  # closes rank 0's timeline
    torch.save(res, os.path.join(LOG_DIR, f"stall_rank{r}.pt"))
    return 0


def check_runtime(res: dict, on_card: bool) -> dict:
    """Phase 21 (a)-(c)'s checks on `runtime_rank`'s record."""
    import torch

    k, calls, n_layers = res["k"], res["calls"], res["n_layers"]
    eager, mega = res["eager_losses"], res["mega_losses"]
    require(eager.shape == mega.shape == (calls * k,)
            and torch.isfinite(eager).all() and torch.isfinite(mega).all(),
            f"runtime: losses {eager} {mega}")
    bitwise = (torch.equal(eager, mega)
               and res["eager_digest"] == res["mega_digest"])
    diff = float((eager - mega).abs().max())
    require(bitwise or diff <= LOSS_TOL,
            f"runtime: megastep's losses {diff} off the eager loop's "
            f"(tol {LOSS_TOL})")
    require(res["graph"] == on_card and res["scan_graph"] == on_card,
            f"runtime: graph {res['graph']}, scan graph {res['scan_graph']}")
    require(all(res["prefetch_bitwise"]),
            f"runtime: prefetched batches vs host {res['prefetch_bitwise']}")
    require(torch.isfinite(res["scan_losses"]).all(),
            f"runtime: scan losses {res['scan_losses']}")
    out = {"bitwise": bitwise, "max_loss_diff": diff}
    if "merge" in res:
        require(res["merge"]["aligned"] and res["replay_cycles"] == 1
                and res["replay_spans"] == 1,
                f"runtime: merge {res['merge']}, the replay's cycles "
                f"{res['replay_cycles']} and step spans "
                f"{res['replay_spans']} (want 1 each)")
    if on_card:
        want = k * n_layers
        for name in ("replay_launches", "scan_replay_launches"):
            require(all(c == want for c in res[name].values()),
                    f"runtime: {name} {res[name]}, want {want} of each")
        require(res["h2d_streams"] and not set(res["h2d_streams"])
                & set(res["compute_streams"]),
                f"runtime: H2D copies on streams {res['h2d_streams']}, "
                f"compute on {res['compute_streams']}")
        for n in SM90_NAMES:
            require(res["launches"][n] > 0 and res["launches"][
                n + "_sm90"] == res["launches"][n],
                f"runtime: {n} launches {res['launches']}")
    # The eager steps after the first and the pure replays (calls from
    # the third on), per step: wall ms and the host's idle share.
    e_wall = res["eager_wall_s"][1:]
    e_host = res["eager_host_s"][1:]
    m_wall = [w / k for w in res["mega_wall_s"][2:]]
    m_host = [h / k for h in res["mega_host_s"][2:]]
    out.update(
        eager_step_ms=1e3 * sum(e_wall) / len(e_wall),
        eager_host_idle=1 - sum(e_host) / sum(e_wall),
        replay_step_ms=1e3 * sum(m_wall) / len(m_wall),
        replay_host_idle=1 - sum(m_host) / sum(m_wall),
        bracket_us=res["bracket_us"],
        watchdog_check_us=res["watchdog_check_us"],
        launches=res["launches"], replay_launches=res.get("replay_launches"),
        h2d_streams=res.get("h2d_streams"),
        compute_streams=res.get("compute_streams"))
    return out


def check_stall(res, tl_path: str, on_card: bool = True) -> dict:
    """Phase 21 (d)'s checks: rank 0 warned once, naming the drill's
    allreduce and rank 1; its metric reads 1; its timeline span of the
    allreduce lasted at least STALL_LATE_S; both ranks finished."""
    from horovod_tpu_torch.utils.profiler import _load_timeline_events

    r0, r1 = res
    require(r0["out_ok"] and r1["out_ok"] and r0["reporter"]
            and r0["device"].startswith("cuda") == on_card
            and r0["backend"] == "gloo",
            f"stall drill: {r0} {r1}")
    require(len(r0["warned"]) == 1 and "[ALLREDUCE:drill]" in r0["warned"][0]
            and "rank 1 (at op" in r0["warned"][0],
            f"stall drill: rank 0 warned {r0['warned']}")
    require(r0["warnings"] == 1 and r1["warned"] == [],
            f"stall drill: hvd_stall_warnings_total {r0['warnings']}, rank "
            f"1 warned {r1['warned']}")
    span = [e for e in _load_timeline_events(tl_path)
            if e.get("tid") == "ALLREDUCE:drill"]
    require(len(span) == 1 and span[0]["dur"] >= STALL_LATE_S * 1e6,
            f"stall drill: rank 0's span {span}")
    return {"warning": r0["warned"][0], "span_s": span[0]["dur"] / 1e6,
            "wait_s": [r0["wait_s"], r1["wait_s"]]}


def train_runtime() -> dict:
    """Phase 21 (main path 12): the runtime utilities; see the module
    docstring."""
    import torch

    t_start = time.perf_counter()
    phase = "train_runtime"
    tl = os.path.join(LOG_DIR, "runtime_timeline.json")
    run_ranks(phase, 1, "chip_smoke", ["--runtime-rank"], 120, env={
        "HOROVOD_TIMELINE": tl, "HOROVOD_TIMELINE_MARK_CYCLES": "1"})
    res = torch.load(os.path.join(LOG_DIR, "runtime_rank0.pt"),
                     weights_only=False)
    out = check_runtime(res, on_card=True)
    log(phase, f"(a) {res['calls']} megastep calls of repeat_steps(k="
        f"{res['k']}) against {res['calls'] * res['k']} eager steps: "
        + ("losses and final SHA-256 bitwise equal" if out["bitwise"] else
           f"largest loss difference {out['max_loss_diff']:.3g} (tol "
           f"{LOSS_TOL})")
        + f"; per step eager {out['eager_step_ms']:.2f} ms (host idle "
        f"{out['eager_host_idle']:.3f}), replayed "
        f"{out['replay_step_ms']:.2f} ms (host idle "
        f"{out['replay_host_idle']:.3f})")
    log(phase, f"(b) one replay's trace: K4-K6 {out['replay_launches']} "
        f"(want {res['k'] * res['n_layers']} each); merged "
        f"{res['merge']}; timeline cycles {res['replay_cycles']} and step "
        f"spans {res['replay_spans']} for the call ({res['cycles']} in all)")
    log(phase, f"(c) prefetch: {len(res['prefetch_bitwise'])} batches "
        f"bitwise their host sources; H2D copies on streams "
        f"{out['h2d_streams']}, K4 on {out['compute_streams']}")
    log(phase, f"host us a one-element allreduce at one rank, the "
        f"inspector and metrics on / off in turns (on, off, off, on): "
        f"{out['bracket_us']}; one watchdog check "
        f"{out['watchdog_check_us']:.2f} us")
    stall_tl = os.path.join(LOG_DIR, "stall_timeline.json")
    run_ranks(f"{phase}_stall", 2, "chip_smoke", ["--stall-rank"], 60,
              env=dict(STALL_ENV, HOROVOD_TIMELINE=stall_tl))
    stall = check_stall([torch.load(os.path.join(
        LOG_DIR, f"stall_rank{r}.pt"), weights_only=False)
        for r in range(2)], stall_tl)
    log(phase, f"(d) rank 0 warned once: {stall['warning']!r}; its span "
        f"{stall['span_s']:.3f} s, waits {stall['wait_s']}")
    out.update(stall=stall, phase_s=time.perf_counter() - t_start)
    log(phase, f"{out['phase_s']:.1f} s (budget {RUNTIME_BUDGET_S} s)")
    require(out["phase_s"] <= RUNTIME_BUDGET_S,
            f"{phase}: over its budget of {RUNTIME_BUDGET_S} s")
    return out



# ---------------------------------------------------------------------------
# Phase 22: the telemetry plane and the fleet tracer (main path 13)
# ---------------------------------------------------------------------------

TRACE_BUDGET_S = 90      # phase 22's share of the script's time limit
TRACE_WINDOW = 3         # steps an analysis window
TRACE_STRAGGLE_MAX = 3   # straggling windows the policy has to fire in
TRACE_BUCKETS = 8        # buckets a step before the rebalance
TRACE_DELAY = "50ms"     # rank 1's delay at every collective dispatch
# Collectives of one window's analysis (allgather_object: two allgathers,
# each with its size exchange) and of the steps before the first window
# (none): with the
# buckets they give the hit of the fault point where rank 1's delay
# starts, the first collective of the first straggling window.
TRACE_ANALYSIS_HITS = 4
TRACE_PRE_HITS = 0
TRACE_ENV = {"HOROVOD_TIMELINE_ALL_RANKS": "1",
             "HOROVOD_TIMELINE_MARK_CYCLES": "1",
             "HOROVOD_METRICS_PORT": "0",
             "HOROVOD_METRICS_HISTORY_INTERVAL": "0.5",
             "HOROVOD_STRAGGLER_PATIENCE": "2",
             "HOROVOD_STRAGGLER_COOLDOWN": "1",
             "HOROVOD_ANOMALY_Z": "3"}
# The monitor's EWMA: a zero-initialised mean needs a fast alpha to learn
# the clean level in TRACE_WINDOW steps; the floor of its std is 5% of
# the mean (the one-card step varies by a few percent within a call).
TRACE_MONITOR = {"alpha": 0.9, "warmup": TRACE_WINDOW, "rel_floor": 0.05}


def trace_buckets(cfg, nbuckets: int = TRACE_BUCKETS):
    """(HOROVOD_FUSION_THRESHOLD that gives `nbuckets` buckets of the
    model's gradients, the bucket count it gives), from the parameters'
    metadata (the model built on the meta device)."""
    import torch
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.parallel import data_parallel as dp

    with torch.device("meta"):
        params = list(Transformer(cfg, seed=0).parameters())
    total = sum(p.numel() * p.element_size() for p in params)
    threshold = -(-total // nbuckets)
    return threshold, len(dp.gradient_bucket_partition(
        params, fusion_threshold_bytes=threshold))


def trace_first_hit(buckets: int, window: int = TRACE_WINDOW) -> int:
    """The hit of `chaos.straggler_delay` where rank 1's delay starts:
    after the warm-up step and the clean window (buckets a step) and the
    clean window's analysis."""
    return 1 + TRACE_PRE_HITS + (1 + window) * buckets + TRACE_ANALYSIS_HITS


def _window_events(events, lo: int, hi: int) -> list:
    """One rank's events of steps lo..hi (JAX faults/chaos.py
    `_window_events`): the CYCLE instants lo-1..hi and the collective
    spans stamped lo-1..hi-1 (a span carries the cycles completed when
    it was issued)."""
    out = []
    for ev in events:
        name = str(ev.get("name", ""))
        if ev.get("ph") == "i" and name.startswith("CYCLE_"):
            if name[6:].isdigit() and lo - 1 <= int(name[6:]) <= hi:
                out.append(ev)
        elif ev.get("ph") == "X" and ev.get("cat") == "collective":
            st = ev.get("step")
            if st is not None and lo - 1 <= int(st) <= hi - 1:
                out.append(ev)
    return out


def _http(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def trace_rank(cfg=None, seq_len: int = 16384, device=None,
               window: int = TRACE_WINDOW) -> int:
    """Phase 22's ranks (`python -m chip_smoke --trace-rank`, run by
    `train_trace` through run_ranks under TRACE_ENV; rank 1 alone armed
    with `chaos.straggler_delay` from the first straggling window on;
    `cfg`, `seq_len` and `device` shrink it for a rehearsal on the CPU).

    The transformer from one seed with AdamW, its gradients reduced by
    the eager `allreduce_gradients` (the partition read live), one cycle
    a step (`step_clock` / `record_step`).  A warm-up step, then windows
    of `window` steps: one clean, straggling ones until the policy
    fires, the cooldown, one settled.  At each window's end every rank
    loads its own events of the window, allgathers them, analyzes the
    merged trace, publishes the measurements and feeds its own
    `StragglerReactionPolicy`; an `AnomalyMonitor` sees each step's
    milliseconds.  Saved to LOG_DIR/trace_rank<r>.pt."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.metrics import anomaly, exposition, fleet, history
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel import data_parallel as dp
    from horovod_tpu_torch.trace import core as tcore
    from horovod_tpu_torch.trace.measure import TraceMeasurements
    from horovod_tpu_torch.trace.reaction import StragglerReactionPolicy
    from horovod_tpu_torch.utils import timeline

    t_phase = time.perf_counter()
    hvd.init(device=device)
    r, dev = hvd.rank(), hvd.device()
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or TransformerConfig(compute_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.RandomState(r).randint(
        0, cfg.vocab_size, (1, seq_len + 1))).to(dev)
    x, y = tokens[:, :-1], tokens[:, 1:]
    model = Transformer(cfg, seed=0).to(dev)
    params = list(model.parameters())
    opt = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    policy = StragglerReactionPolicy()
    monitor = anomaly.AnomalyMonitor(**TRACE_MONITOR)
    path = timeline.get_timeline()._writer.filename

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    res = {"rank": r, "device": str(dev), "backend": hvd.backend(),
           "n_layers": cfg.n_layers, "losses": [], "digests": [],
           "step_ms": [], "buckets": [], "windows": [], "trips": [],
           "patience": policy.patience, "cooldown": policy.cooldown}
    t = 0

    def step():
        nonlocal t
        t += 1
        clock = dp.step_clock()
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(x), y)
        loss.backward()
        grads = [p.grad for p in params]
        res["buckets"].append(len(dp.gradient_bucket_partition(grads)))
        for p, g in zip(params, dp.allreduce_gradients(grads)):
            p.grad = g
        opt.step()
        res["losses"].append(float(loss))
        sync()
        ms = (time.perf_counter() - clock[0]) * 1e3
        dp.record_step(clock)
        res["step_ms"].append(ms)
        res["digests"].append(_sha(params))
        if t > 1:  # the warm-up step builds and allocates
            a = monitor.observe("hvd_critical_path_ms", ms, step=t)
            if a is not None:
                res["trips"].append({"step": t, "value": a.value,
                                     "score": a.score})

    def window_(kind: str) -> dict:
        lo = t + 1
        if kind == "straggle" and not any(
                w["kind"] == "straggle" for w in res["windows"]):
            # The first straggling window: rank 1's delay starts at its
            # first collective.
            res["hits_before"] = faults.points_hit("chaos.straggler_delay")
            res["injected_before"] = faults.injections()
        for _ in range(window):
            step()
        time.sleep(0.05)  # let the timeline's writer drain its queue
        mine = _window_events(tcore.load_events(path), lo, t)
        traces = dict(enumerate(hvd.allgather_object(mine)))
        report = tcore.analyze(traces)
        m = TraceMeasurements.from_report(report)
        m.apply_to_metrics()
        d = policy.observe(m)
        w = {"kind": kind, "steps": [lo, t],
             "straggler_rank": m.straggler_rank, "skew_share": m.skew_share,
             "wait_ms_per_step": m.wait_ms_per_step,
             "critical_path_ms": m.critical_path_ms,
             "step_skew_ms": m.step_skew_ms,
             "decision": dataclasses.asdict(d),
             "buckets_after": len(dp.gradient_bucket_partition(params)),
             "ranks_seen": sorted(traces),
             "events": [len(v) for _, v in sorted(traces.items())]}
        res["windows"].append(w)
        return w

    FA.reset_launch_counts()
    step()  # warm-up
    window_("clean")
    for _ in range(TRACE_STRAGGLE_MAX):
        if window_("straggle")["decision"]["action"] == "rebalance":
            break
    # The fleet view: the watchdog publishes each rank's snapshot (the
    # firing window's trace gauges) at its cadence; rank 0 reads both.
    time.sleep(1.2)
    hvd.barrier()
    if r == 0:
        snaps = fleet.read_fleet(basics.kv_store())
        res["fleet_ranks"] = [s["rank"] for s in snaps]
        res["fleet_view"] = fleet.render_fleet(snaps)
    hvd.barrier()
    window_("cooldown")
    window_("settled")
    res["launches"] = {**FA.launch_counts(), **{
        f"{n}_sm90": c for n, c in FA.sm90_launch_counts().items()}}
    res["injections"] = {f"{p}:{m}": n
                         for (p, m), n in faults.injections().items()}
    res["reaction"] = dp.reaction_rebalance()

    # The endpoints: rank 0 scrapes both ranks' /metrics and /healthz.
    ports = hvd.allgather_object(exposition.server_port())
    res["ports"] = ports
    res["healthz"] = {str(q): _http(f"http://127.0.0.1:{port}/healthz")
                      for q, port in enumerate(ports) if r == 0 or q == r}
    if r == 0:
        res["metrics"] = {str(q): _http(f"http://127.0.0.1:{port}/metrics")
                          for q, port in enumerate(ports)}
    hist = history.get_history()
    res["history_points"] = len(hist.points("hvd_critical_path_ms")) \
        if hist is not None else 0
    res["history_samples"] = hist.samples_taken if hist is not None else 0
    hvd.barrier()
    hvd.shutdown()  # closes the timeline, stops the endpoint and sampler
    res["released"] = exposition.server_port() is None
    res["rank_s"] = time.perf_counter() - t_phase
    torch.save(res, os.path.join(LOG_DIR, f"trace_rank{r}.pt"))
    return 0


def _metric(text: str, name: str, **labels) -> list:
    """The values of `name`'s samples in a Prometheus text whose labels
    include `labels`."""
    out = []
    for line in text.splitlines():
        if not line.startswith(name) or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        if head != name and not head.startswith(name + "{"):
            continue
        if all(f'{k}="{v}"' in head for k, v in labels.items()):
            out.append(float(value))
    return out


def check_trace(res, first_hit: int, on_card: bool = True) -> dict:
    """Phase 22's checks on the two ranks' records (see the module
    docstring)."""
    r0, r1 = res
    n = len(r0["losses"])
    require(n == len(r1["losses"]) and all(
        math.isfinite(v) for v in r0["losses"] + r1["losses"]),
        f"trace: losses {r0['losses']} {r1['losses']}")
    require(r0["digests"] == r1["digests"],
            "trace: the ranks' parameter SHA-256 differ at steps "
            f"{[i + 1 for i, (a, b) in enumerate(zip(r0['digests'], r1['digests'])) if a != b]}")
    require(r0["backend"] == "gloo" and r0["device"].startswith("cuda")
            == on_card, f"trace: {r0['backend']} on {r0['device']}")
    # Rank 1's delay starts at the first straggling window's first
    # collective, and only there.
    require(r1["hits_before"] == first_hit - 1
            and r1["injected_before"] == {} and r0["injections"] == {}
            and r1["injections"].get("chaos.straggler_delay:delay", 0) > 0,
            f"trace: rank 1 hit the point {r1['hits_before']} times "
            f"before the straggling windows (want {first_hit - 1}), "
            f"injected {r1['injected_before']} then {r1['injections']}; "
            f"rank 0 {r0['injections']}")
    wins = r0["windows"]
    require([w["decision"] for w in wins] == [w["decision"] for w in
                                               r1["windows"]],
            "trace: the ranks' decisions differ")
    kinds = [w["kind"] for w in wins]
    strag = [w for w in wins if w["kind"] == "straggle"]
    fired = strag[-1] if strag else None
    require(kinds[0] == "clean" and kinds[-2:] == ["cooldown", "settled"]
            and fired is not None
            and fired["decision"]["action"] == "rebalance"
            and fired["decision"]["rank"] == 1,
            f"trace: windows {[(w['kind'], w['decision']) for w in wins]}")
    require(all(w["straggler_rank"] == 1 for w in strag),
            f"trace: straggling windows blamed "
            f"{[w['straggler_rank'] for w in strag]}")
    require(all(w["ranks_seen"] == [0, 1] and min(w["events"]) > 0
                for w in wins), f"trace: window events "
            f"{[(w['ranks_seen'], w['events']) for w in wins]}")
    settled = wins[-1]
    require(wins[-2]["decision"]["reason"] == "cooldown",
            f"trace: cooldown window {wins[-2]['decision']}")
    before = r0["buckets"][0]
    require(before > 1 and all(
        rec["windows"][-1]["buckets_after"] == 1
        and rec["buckets"][-1] == 1 and rec["reaction"] == (1, 1)
        for rec in res), f"trace: buckets {r0['buckets']} / "
        f"{r1['buckets']}, reaction {r0['reaction']} {r1['reaction']}")
    require(all(settled["wait_ms_per_step"] < w["wait_ms_per_step"]
                for w in strag), f"trace: wait ms a step settled "
            f"{settled['wait_ms_per_step']} vs straggling "
            f"{[w['wait_ms_per_step'] for w in strag]}")
    if on_card:
        for name in SM90_NAMES:
            for rec in res:
                want = n * rec["n_layers"]
                require(rec["launches"][name] == rec["launches"][
                    name + "_sm90"] == want,
                    f"trace: rank {rec['rank']} {name} launches "
                    f"{rec['launches']}, want {want} on the tensor cores")
    # The endpoints and the fleet view.
    m0, m1 = r0["metrics"]["0"], r0["metrics"]["1"]
    require(m0[0] == 200 and m1[0] == 200, "trace: /metrics "
            f"{m0[0]} {m1[0]}")
    reactions = _metric(m0[1], "hvd_straggler_reactions_total",
                        action="rebalance")
    max_b = _metric(m0[1], "hvd_reaction_max_buckets")
    calls = sum(_metric(m0[1], "hvd_collective_calls_total"))
    inj = sum(_metric(m1[1], "hvd_fault_injections_total",
                      point="chaos.straggler_delay"))
    require(reactions == [1.0] and max_b == [1.0] and calls > 0 and inj > 0,
            f"trace: rank 0's /metrics reactions {reactions}, max buckets "
            f"{max_b}, collective calls {calls}; rank 1's injections {inj}")
    health = [r0["healthz"]["0"], r0["healthz"]["1"], r1["healthz"]["1"]]
    require(all(h[0] == 200 for h in health), f"trace: /healthz {health}")
    require(r0["fleet_ranks"] == [0, 1]
            and "blamed straggler (rank 0's analysis): rank 1"
            in r0["fleet_view"], f"trace: fleet {r0['fleet_ranks']}\n"
            f"{r0['fleet_view']}")
    require(all(rec["history_points"] > 0 and rec["released"]
                for rec in res), "trace: history points "
            f"{[rec['history_points'] for rec in res]}, endpoints released "
            f"{[rec['released'] for rec in res]}")
    onset = strag[0]["steps"][0]
    require(all(any(a["step"] == onset for a in rec["trips"])
                for rec in res), f"trace: the monitor did not trip at the "
            f"straggler's onset (step {onset}): "
            f"{[rec['trips'] for rec in res]}")
    clean_trips = [a for rec in res for a in rec["trips"]
                   if a["step"] < onset]
    return {"windows": [{k: w[k] for k in (
        "kind", "steps", "straggler_rank", "skew_share", "wait_ms_per_step",
        "critical_path_ms")} | {"action": w["decision"]["action"],
                                 "reason": w["decision"]["reason"]}
        for w in wins],
        "buckets": [before, 1], "steps": n,
        "step_ms": [r0["step_ms"], r1["step_ms"]],
        "trips": [rec["trips"] for rec in res], "clean_trips": clean_trips,
        "launches": [rec["launches"] for rec in res],
        "injections": r1["injections"], "fleet_view": r0["fleet_view"],
        "history_points": [rec["history_points"] for rec in res],
        "rank_s": [rec["rank_s"] for rec in res]}


def train_trace() -> dict:
    """Phase 22 (main path 13): the telemetry plane and the fleet tracer
    closed-loop; see the module docstring."""
    import torch
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.trace import core as tcore

    t_start = time.perf_counter()
    phase = "train_trace"
    threshold, buckets = trace_buckets(
        TransformerConfig(compute_dtype=torch.bfloat16))
    first = trace_first_hit(buckets)
    tl = os.path.join(LOG_DIR, "trace_timeline.json")
    for f in (tl, os.path.join(LOG_DIR, "trace_timeline.rank1.json")):
        if os.path.exists(f):
            os.remove(f)
    run_ranks(phase, 2, "chip_smoke", ["--trace-rank"], 180, env=dict(
        TRACE_ENV, HOROVOD_TIMELINE=tl,
        HOROVOD_FUSION_THRESHOLD=str(threshold)),
        rank_env=lambda r: {"HOROVOD_FAULT_SPEC": (
            f"chaos.straggler_delay@{first}:delay:{TRACE_DELAY}")}
        if r == 1 else {})
    res = [torch.load(os.path.join(LOG_DIR, f"trace_rank{r}.pt"),
                      weights_only=False) for r in range(2)]
    out = check_trace(res, first, on_card=True)
    paths = [tl, os.path.join(LOG_DIR, "trace_timeline.rank1.json")]
    merged = tcore.merge(paths)
    tcore.write_merged(merged, os.path.join(LOG_DIR, "trace_fleet.json"))
    flows = {e["pid"] for e in merged["traceEvents"] if e.get("cat") == "xrank"}
    require(merged["metadata"]["ranks"] == [0, 1] and flows == {0, 1},
            f"trace: merged {merged['metadata']}, flow pids {flows}")
    for w in out["windows"]:
        log(phase, f"{w['kind']} steps {w['steps']}: blamed rank "
            f"{w['straggler_rank']}, skew share {w['skew_share']}, wait "
            f"{w['wait_ms_per_step']} ms a step, critical path "
            f"{w['critical_path_ms']} ms -> {w['action']} ({w['reason']})")
    log(phase, f"buckets {out['buckets'][0]} -> 1 at threshold {threshold} "
        f"(rank 1's delay {TRACE_DELAY} from hit {first}; injections "
        f"{out['injections']}); K4-K6 {out['launches'][0]} on rank 0")
    log(phase, f"step ms rank 0 {[round(v, 1) for v in out['step_ms'][0]]}")
    log(phase, f"monitor trips {out['trips']} (on clean steps: "
        f"{out['clean_trips']}); history points {out['history_points']}")
    log(phase, "fleet view read on rank 0:\n" + out["fleet_view"].rstrip())
    log(phase, f"merged {merged['metadata']['flow_events']} flow events, "
        f"offsets {merged['metadata']['clock_offsets_us']} -> "
        "chiprun_out/trace_fleet.json")
    out.update(threshold=threshold, first_hit=first,
               flow_events=merged["metadata"]["flow_events"],
               phase_s=time.perf_counter() - t_start)
    log(phase, f"{out['phase_s']:.1f} s (budget {TRACE_BUDGET_S} s; "
        f"ranks {[round(s, 1) for s in out['rank_s']]})")
    require(out["phase_s"] <= TRACE_BUDGET_S,
            f"{phase}: over its budget of {TRACE_BUDGET_S} s")
    return out

# ---------------------------------------------------------------------------
# Phase 23: the launcher, its rendezvous KV, run(), the Executor, the
# consistency check and the metrics fleet over the KV
# ---------------------------------------------------------------------------

LAUNCHER_BUDGET_S = 45   # phase 23's share of the script's time limit
LAUNCHER_N = 1 << 20     # floats each rank allreduces in (b)
CC_TIMEOUT_S = 10        # HOROVOD_CONSISTENCY_TIMEOUT in (c)
TOPOLOGY_KEYS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                 "HOROVOD_LOCAL_SIZE")  # (e)'s second function reads them

# (d)'s ranks: rank 0 starts a child and sleeps, rank 1 exits 3 once the
# pids are written; the launcher must return 3 with both gone.
EXIT3_RANK = """
import os, subprocess, sys, time
d = sys.argv[1]
if os.environ["HOROVOD_RANK"] == "0":
    child = subprocess.Popen(["sleep", "300"])
    with open(os.path.join(d, "pids.tmp"), "w") as f:
        f.write(f"{os.getpid()} {child.pid}")
    os.replace(os.path.join(d, "pids.tmp"), os.path.join(d, "pids"))
    time.sleep(300)
while not os.path.exists(os.path.join(d, "pids")):
    time.sleep(0.05)
sys.exit(3)
"""


def _digest(a) -> str:
    import hashlib

    return hashlib.sha256(a.tobytes()).hexdigest()


def launcher_allreduce(seed: int):
    """(b): on each rank `hvd.init()` on the card, a Sum allreduce of a
    seeded LAUNCHER_N-float tensor; returns (rank, device, the SHA-256 of
    the result, rank 0's fleet reading).  Rank 0 waits until every
    rank's watchdog has published its snapshot to the rendezvous KV and
    runs (f), `python -m horovod_tpu_torch.metrics --kv ADDR:PORT
    --secret S --raw`, while the job runs."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner.elastic_worker import client_from_env

    hvd.init()
    r = hvd.rank()
    x = np.random.RandomState(seed + r).randn(LAUNCHER_N).astype(np.float32)
    y = hvd.allreduce(torch.from_numpy(x).to(hvd.device()), op=hvd.Sum)
    fleet = None
    if r == 0:
        kv = client_from_env()
        deadline = time.monotonic() + 20
        while (len(kv.keys("metrics/rank/")) < hvd.size()
               and time.monotonic() < deadline):
            time.sleep(0.1)
        env = os.environ
        p = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.metrics", "--raw",
             "--kv", f"{env['HOROVOD_RENDEZVOUS_ADDR']}:"
             f"{env['HOROVOD_RENDEZVOUS_PORT']}",
             "--secret", env["HOROVOD_SECRET_KEY"]],
            capture_output=True, text=True, timeout=60, env=_port_env())
        snaps = json.loads(p.stdout) if p.returncode == 0 else []
        fleet = {"rc": p.returncode, "ranks": [s["rank"] for s in snaps],
                 "allreduce_calls": [sum(
                     v for labels, v in s["metrics"].get(
                         "hvd_collective_calls_total", {}).get(
                         "samples", []) if labels[0] == "ALLREDUCE")
                     for s in snaps], "stderr": p.stderr[-500:]}
    hvd.barrier()
    dev = str(hvd.device())
    out = (r, dev, _digest(y.cpu().numpy()), fleet)
    hvd.shutdown()
    return out


def executor_whoami():
    """(e)'s first function: this worker's rank and card."""
    import torch

    return int(os.environ["HOROVOD_RANK"]), torch.cuda.get_device_name(0)


def executor_topology(keys):
    """(e)'s second function: this worker's values of the topology env
    variables `keys`, as the launcher's slot env set them."""
    return tuple(int(os.environ[k]) for k in keys)


def cc_rank() -> int:
    """(c)'s ranks: one matching allreduce, then rank 1 allreduces
    another shape than rank 0 under the consistency check."""
    import torch
    import horovod_tpu_torch as hvd

    hvd.init()
    r = hvd.rank()
    hvd.allreduce(torch.ones(4, device=hvd.device()), op=hvd.Sum)
    hvd.allreduce(torch.ones(2 + r, device=hvd.device()), op=hvd.Sum)
    hvd.shutdown()
    return 0


def launcher_phase() -> dict:
    """Phase 23: (a)-(f) of the module docstring, all five launches at
    once in threads; every check raises on failure."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs  # pickled by reference for the workers
    from horovod_tpu_torch.runner import run
    from horovod_tpu_torch.runner.executor import Executor

    t_start = time.perf_counter()
    phase = "launcher"
    d = os.path.join(LOG_DIR, "launcher_exit")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    want = _digest(sum(np.random.RandomState(23 + r).randn(
        LAUNCHER_N).astype(np.float32) for r in range(2)))
    card = torch.cuda.get_device_name(0)
    timed = {}

    def timed_call(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        timed[name] = round(time.perf_counter() - t0, 2)
        return out

    with ThreadPoolExecutor(4) as pool:
        a = pool.submit(timed_call, "a", run_launcher, ["--check-build"], 60)
        c = pool.submit(timed_call, "c", run_launcher, [
            "-np", "2", sys.executable, "-c",
            "import sys, chip_smoke; sys.exit(chip_smoke.cc_rank())"],
            CC_TIMEOUT_S + 60, env={
                "HOROVOD_COLLECTIVE_CONSISTENCY_CHECK": "1",
                "HOROVOD_CONSISTENCY_TIMEOUT": str(CC_TIMEOUT_S)})
        dd = pool.submit(timed_call, "d", run_launcher, [
            "-np", "2", sys.executable, "-c", EXIT3_RANK, d], 60)
        b = pool.submit(timed_call, "b", run, cs.launcher_allreduce,
                        args=(23,), np=2,
                        extra_env={"PYTHONPATH": _port_env()["PYTHONPATH"]})

        def executor():
            with Executor(np=2, extra_env={
                    "PYTHONPATH": _port_env()["PYTHONPATH"]}) as ex:
                return ex.run(cs.executor_whoami), ex.run(
                    cs.executor_topology, args=(TOPOLOGY_KEYS,))

        e = pool.submit(timed_call, "e", executor)
        (rc_a, out_a), (rc_c, out_c), (rc_d, out_d) = \
            a.result(), c.result(), dd.result()
        res_b, (who, res_e) = b.result(), e.result()

    # (a) --check-build: NCCL, CUDA and the CUDA kernels built or
    # buildable, read without touching the card.
    marks = {ln[8:]: ln[5] for ln in out_a.splitlines()
             if ln.startswith("    [")}
    card_marks = ("NCCL", "CUDA", "CUDA kernels (adasum, flash attention, "
                  "tiled matmul)", "elastic", "native control plane (C++)")
    require(rc_a == 0 and "gloo (CPU, ranks sharing a card)" in marks
            and all(marks.get(k) == "X" for k in card_marks),
            f"(a) --check-build exited {rc_a}:\n{out_a}")
    # (b) run(): results in rank order, on the card, the numpy sum.
    dev0 = "cuda:0"
    require([(r, dv) for r, dv, _, _ in res_b] == [(0, dev0), (1, dev0)]
            and all(h == want for _, _, h, _ in res_b),
            f"(b) run(): {[(r, dv, h[:12]) for r, dv, h, _ in res_b]} "
            f"(want the numpy sum {want[:12]})")
    # (c) the consistency check: nonzero within its timeout plus 30 s,
    # with the per-rank dump.
    dump = ["collective consistency check FAILED at collective #1",
            'process 0: {"dtypes": ["float32"], "kind": "allreduce", '
            '"op": "Sum", "shapes": [[2]]}',
            'process 1: {"dtypes": ["float32"], "kind": "allreduce", '
            '"op": "Sum", "shapes": [[3]]}']
    require(rc_c != 0 and timed["c"] <= CC_TIMEOUT_S + 30
            and all(line in out_c for line in dump),
            f"(c) consistency: exit {rc_c} in {timed['c']} s:\n"
            f"{out_c[-3000:]}")
    # (d) a rank's exit 3 is the launcher's, and the other rank's tree
    # is gone.
    with open(os.path.join(d, "pids")) as f:
        pids = [int(v) for v in f.read().split()]
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    require(rc_d == 3 and not alive, f"(d) exit {rc_d}, alive {alive}:\n"
            f"{out_d[-2000:]}")
    # (e) the Executor: two functions in turn, results in rank order.
    require(who == [(0, card), (1, card)]
            and res_e == [(r, 2, r, 2) for r in (0, 1)],
            f"(e) Executor: {who}, {res_e}")
    # (f) the fleet over the KV, read while (b)'s job ran.
    fleet = res_b[0][3]
    require(fleet["rc"] == 0 and fleet["ranks"] == [0, 1]
            and all(n >= 1 for n in fleet["allreduce_calls"]),
            f"(f) metrics --kv: {fleet}")
    out = {"seconds": timed,
           "cc_exit": rc_c, "exit3": rc_d, "fleet": fleet,
           "phase_s": round(time.perf_counter() - t_start, 2)}
    log(phase, f"(a) --check-build [X] NCCL, CUDA, CUDA kernels, elastic, "
        f"native control plane; (b) run() "
        f"np=2 on {dev0}, bitwise the numpy sum; (c) mismatch exit {rc_c} "
        f"in {timed['c']} s with the dump; (d) exit 3 returned, tree gone; "
        f"(e) Executor two functions in rank order; (f) metrics --kv ranks "
        f"{fleet['ranks']}, allreduce calls {fleet['allreduce_calls']}; "
        f"seconds {timed}; {out['phase_s']} s (budget {LAUNCHER_BUDGET_S})")
    require(out["phase_s"] <= LAUNCHER_BUDGET_S,
            f"{phase}: over its budget of {LAUNCHER_BUDGET_S} s")
    print(json.dumps({"launcher": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 24: full-width elastic ResNet-50 under the elastic driver, 1 -> 2
# -> 1 ranks
# ---------------------------------------------------------------------------

ELASTIC_DRIVER_BUDGET_S = 90  # phase 24's share of the script's time limit
# Two epochs of eight batches at one rank: rank 0 is still training when
# the joiner arrives (it trains on until it sees the new generation at a
# commit, at most two steps later, then waits in the bootstrap for the
# joiner), both ranks take at least three steps at size 2 before the
# failure, and the survivor four alone after it.
ELASTIC_DRIVER_ARGS = ["--epochs", "2", "--batches-per-epoch", "8",
                       "--commit-every", "2", "--log-steps"]
# hostB's worker is killed at its first commit after this many steps
# (a rate at size 2 leaves the first step out).
ELASTIC_DRIVER_B_STEPS = 3
_DRIVER_PREFIX = re.compile(r"^\[(\d+)\]<\d\d:\d\d:\d\d> ([A-Z]+) (\{.*\})$")


def _segments(steps):
    """Split one rank's STEP records into runs of one world size: a list
    of `{"size": n, "ms": [train_ms of each step]}`, in order."""
    runs = []
    for s in steps:
        if not runs or runs[-1]["size"] != s["size"]:
            runs.append({"size": s["size"], "ms": []})
        runs[-1]["ms"].append(s["train_ms"])
    return runs


def elastic_driver_phase(smi: str, trainer_args=(), budget: float =
                         ELASTIC_DRIVER_BUDGET_S) -> dict:
    """Phase 24: (a) scale up from hostA to hostA + hostB, (b) SIGKILL
    hostB's worker, under `python -m horovod_tpu_torch.runner
    --host-discovery-script`; every check raises on failure.
    `trainer_args` go to the trainer after ELASTIC_DRIVER_ARGS (the CPU
    rehearsal passes `--device cpu` and a small model)."""
    import signal
    import threading

    from horovod_tpu_torch import _native

    phase = "elastic_driver"
    t_start = time.perf_counter()
    require(_native.load() is not None,
            f"{phase}: the native control plane did not build")
    d = os.path.join(LOG_DIR, phase)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    hosts = os.path.join(d, "hosts.txt")

    def set_hosts(text):
        with open(hosts + ".tmp", "w") as f:
            f.write(text)
        os.replace(hosts + ".tmp", hosts)

    set_hosts("hostA:1\n")
    script = os.path.join(d, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts}\n")
    os.chmod(script, 0o755)
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner",
         "--host-discovery-script", script, "--min-np", "1", "--max-np",
         "2", "--log-level", "INFO", sys.executable, "-m", ELASTIC,
         *ELASTIC_DRIVER_ARGS, *trainer_args], cwd=HERE,
        env=_port_env({"HVD_TPU_FAKE_LOCAL_HOSTS": "hostA,hostB"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    lines, recs = [], {0: [], 1: []}  # the worker spawned as rank r
    cond = threading.Condition()

    def pump():
        with open(os.path.join(d, "driver.log"), "w") as out:
            for line in p.stdout:
                out.write(line)
                m = _DRIVER_PREFIX.match(line.rstrip("\n"))
                with cond:
                    lines.append(line)
                    if m and int(m.group(1)) in recs:
                        recs[int(m.group(1))].append(
                            (m.group(2), json.loads(m.group(3))))
                    cond.notify_all()

    def wait_for(who, tag, what, after_steps=0):
        deadline = t_start + budget
        with cond:
            while True:
                got, steps = None, 0
                for t, r in recs[who]:
                    steps += t == "STEP"
                    if t == tag and steps >= after_steps:
                        got = r
                        break
                if got is not None:
                    return got
                require(p.poll() is None or pumper.is_alive(),
                        f"{phase}: the driver exited {p.poll()} before "
                        f"{what}:\n" + "".join(lines[-60:]))
                require(time.perf_counter() < deadline,
                        f"{phase}: no {what} within {budget} s:\n"
                        + "".join(lines[-60:]))
                cond.wait(0.2)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        # (a) after rank 0's first commit, hostB joins
        wait_for(0, "COMMIT", "COMMIT of hostA's worker")
        t_grow = time.time()
        set_hosts("hostA:1\nhostB:1\n")
        # (b) at the joiner's first commit after ELASTIC_DRIVER_B_STEPS
        # steps, its worker is killed
        wait_for(1, "COMMIT", "COMMIT of hostB's worker",
                 after_steps=ELASTIC_DRIVER_B_STEPS)
        enter_b = wait_for(1, "ENTER", "ENTER of hostB's worker")
        os.kill(enter_b["pid"], signal.SIGKILL)
        t_kill = time.time()
        rc = p.wait(timeout=max(1.0, t_start + budget
                                - time.perf_counter()))
        pumper.join(30)
    finally:
        if p.poll() is None:  # the driver tears its workers down
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    text = "".join(lines)
    require(rc == 0, f"{phase}: the driver exited {rc}:\n{text[-6000:]}")
    require("native rendezvous server on port" in text,
            f"{phase}: the driver did not serve with the native engine")
    require("blacklisting host hostB" in text and "DEGRADED" in text,
            f"{phase}: hostB was not blacklisted, or no degraded "
            f"generation:\n{text[-4000:]}")
    a = recs[0]
    b = recs[1]

    def tagged(rs, tag):
        return [r for t, r in rs if t == tag]

    enters_a, commits_a = tagged(a, "ENTER"), tagged(a, "COMMIT")
    steps_a, steps_b = tagged(a, "STEP"), tagged(b, "STEP")
    (summary,) = tagged(a, "SUMMARY")
    require([e["resets"] for e in enters_a] == [0, 1, 2]
            and summary["resets"] == 2 and summary["size"] == 1,
            f"{phase}: hostA's entries {enters_a}, summary {summary}")
    # (a) the joiner: a later generation, joining, rank 0's last commit
    # (the parameters, the batch-norm buffers and the momentum); rank 0
    # entered it with the same state.
    pos = [i for i, (t, r) in enumerate(a) if t == "ENTER"]
    last_commit = [r for t, r in a[:pos[1]] if t == "COMMIT"][-1]
    require(enter_b["gen"] >= 1 and enter_b["joining"]
            and enter_b["rank"] == 1 and enters_a[1]["gen"] == enter_b["gen"],
            f"{phase}: the joiner's entry {enter_b}")
    reset1 = [r for r in tagged(a, "RESET") if r["resets"] == 1]
    require(reset1 and reset1[0]["digest"] == last_commit["digest"],
            f"{phase}: rank 0's reset on the new generation rolled back")
    require(enter_b["digest"] == enters_a[1]["digest"]
            == last_commit["digest"]
            and enter_b["state_digest"] == enters_a[1]["state_digest"],
            f"{phase}: the joiner's state is not rank 0's last commit")
    both = {(s["epoch"], s["batch"]): s["digest"] for s in steps_b}
    pairs = [(s["digest"], both[(s["epoch"], s["batch"])]) for s in steps_a
             if s["size"] == 2 and (s["epoch"], s["batch"]) in both]
    require(pairs and all(x == y for x, y in pairs)
            and all(s["size"] == 2 for s in steps_b),
            f"{phase}: the ranks' parameters differ at size 2 ({pairs})")
    # (b) the survivor's restore is its last commit before the failure,
    # and it finishes alone
    reset2 = [r for r in tagged(a, "RESET") if r["resets"] == 2]
    commit_before = [r for t, r in a[:pos[2]] if t == "COMMIT"][-1]
    require(reset2 and reset2[0]["digest"] == commit_before["digest"]
            and enters_a[2]["digest"] == commit_before["digest"],
            f"{phase}: after the failure the parameters are not the last "
            "commit's")
    require(all(math.isfinite(s["loss"]) for s in steps_a + steps_b),
            f"{phase}: a non-finite loss")
    runs = _segments(steps_a)
    require([r["size"] for r in runs] == [1, 2, 1]
            and steps_a[-1]["size"] == 1,
            f"{phase}: hostA's sizes {[r['size'] for r in runs]}")
    args = [*ELASTIC_DRIVER_ARGS, *trainer_args]
    bs = int(args[args.index("--batch-size") + 1]) \
        if "--batch-size" in args else 32  # elastic_resnet's default
    img_sec = [[round(bs * 1e3 * (len(r["ms"]) - 1) / sum(r["ms"][1:]), 2)
                if len(r["ms"]) > 1 else None for r in runs]]
    runs_b = _segments(steps_b)
    img_sec.append([round(bs * 1e3 * (len(r["ms"]) - 1) / sum(r["ms"][1:]),
                          2) if len(r["ms"]) > 1 else None for r in runs_b])
    grow_s = min(s["wall"] for s in steps_a + steps_b
                 if s["size"] == 2) - t_grow
    shrink_s = min(s["wall"] for s in steps_a[len(steps_a) - len(
        runs[2]["ms"]):]) - t_kill
    out = {"card": smi, "engine": "native",
           "reset_seconds": [round(x, 3) for x in summary["reset_seconds"]],
           "grow_to_first_step_s": round(grow_s, 3),
           "kill_to_first_step_s": round(shrink_s, 3),
           "img_sec_per_rank": {"hostA (1, 2, 1)": img_sec[0],
                                "hostB (2)": img_sec[1]},
           "steps": {"hostA": len(steps_a), "hostB": len(steps_b)},
           "joiner_gen": enter_b["gen"],
           "phase_s": round(time.perf_counter() - t_start, 2)}
    log(phase, f"{smi}: native control plane; (a) hostB joined generation "
        f"{enter_b['gen']} with rank 0's last commit and, after the sync, "
        f"rank 0's whole state (parameters, buffers, momentum), "
        f"{len(pairs)} steps equal at size 2, first step at size "
        f"2 {grow_s:.3f} s after the hosts file grew; (b) hostB killed, "
        f"blacklisted, the survivor restored its last commit and took its "
        f"first step alone {shrink_s:.3f} s after the kill; resets "
        f"{out['reset_seconds']} s; img/sec a rank (train time, sizes 1, "
        f"2, 1) {img_sec[0]}, the joiner at 2 {img_sec[1]}; "
        f"{out['phase_s']} s (budget {budget})")
    require(out["phase_s"] <= budget,
            f"{phase}: over its budget of {budget} s")
    print(json.dumps({"elastic_driver": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 25: live resharding, elastic ZeRO state and the chaos soak
# ---------------------------------------------------------------------------

RESHARD_BUDGET_S = 200   # phase 25's share of the script's time limit
RESHARD_STEPS = 2        # stage-3 steps before the reshards
RESHARD_DIE_TIMEOUT = 5.0  # (d): how long a fetch waits for the dead peer
RESHARD_ENV = {"HOROVOD_RESHARD_TIMEOUT": "60"}
# (e): the soak's environment (tests/test_torch_port_chaos.py's, JAX's
# soak's settings).
SOAK_ENV = {"HOROVOD_TIMELINE_ALL_RANKS": "1",
            "HOROVOD_TIMELINE_MARK_CYCLES": "1",
            "HOROVOD_TIMELINE_DISABLE_NATIVE": "1",
            "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
            "HOROVOD_STRAGGLER_PATIENCE": "2",
            "HOROVOD_STRAGGLER_COOLDOWN": "1",
            "HOROVOD_CHAOS_GENERATIONS": "5",
            "HOROVOD_CHAOS_STEPS_PER_GEN": "4"}
SOAK_SEED = 7
# (e) again with the reaction's degrade branch off (no skew share reaches
# it): JAX's rebalance, its loud re-init and the anomaly it leaves.
SOAK_DEGRADE_OFF = {"HOROVOD_STRAGGLER_SKEW_THRESHOLD": "inf"}


def _streams_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        for k in a)


def model_tree(model, leaves) -> dict:
    """`leaves` (one tensor for each of `model`'s parameters, in their
    order) as the JAX-layout tree `transformer_params` gives: the
    blocks' leaves stacked over the layers."""
    import torch

    named = dict(zip([n for n, _ in model.named_parameters()], leaves))
    stack = {k: torch.stack([named[f"blocks.{i}.{k}"]
                             for i in range(len(model.blocks))])
             for k in ("ln1", "ln2", "wq", "wk", "wv", "wo", "wi", "wg",
                       "wd")}
    return {"embed": named["embed"], "final_norm": {"scale": named[
        "final_norm"]}, "blocks": {k: {"scale": v} if k in ("ln1", "ln2")
                                   else v for k, v in stack.items()}}


def param_specs(model, cfg) -> list:
    """Each of `model`'s parameters' tp spec: `transformer_pspecs`'
    without the stacked layer axis."""
    from horovod_tpu_torch.models import transformer_pspecs

    specs = transformer_pspecs(cfg)
    out = []
    for name, _ in model.named_parameters():
        if name == "embed":
            out.append(specs["embed"])
        elif name == "final_norm":
            out.append(specs["final_norm"]["scale"])
        else:
            leaf = name.split(".")[-1]
            spec = specs["blocks"][leaf]
            out.append((spec["scale"] if leaf in ("ln1", "ln2")
                        else spec)[1:])
    return out


def serve_handoff(model, placement, rows, cfg, dev, seq_len: int,
                  chunk: int, peak: int, progress=lambda what: None) -> dict:
    """Phase 25 (g), on both ranks of the stage-3 world: each publishes
    its placed parameter rows for serving (`serve.handoff.
    publish_for_serve`, through the launcher's KV); rank 0 fetches the
    decode parameters at tp = 1 and both ranks their halves at tp = 2
    (`fetch_decode_params`), every leaf slice held bitwise to the same
    slice of the gathered parameters; rank 0 then serves one prompt of
    `serve_prompt_len` (at most seq_len) for SERVE_NEW tokens through
    `InferenceServer` on the fetched parameters and on the gathered
    ones: the same tokens.  Returns the seconds, bytes, staging peaks
    and checks."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel import reshard as rs
    from horovod_tpu_torch.serve import InferenceServer
    from horovod_tpu_torch.serve import handoff as ho

    r, n = hvd.rank(), hvd.size()
    params = list(model.parameters())
    specs = param_specs(model, cfg)
    ge = tuple(sum(g.sizes) for g in placement.groups)
    _, groups = ho.handoff_meta(params, specs)
    out = {"groups_match": [list(g.idxs) for g in placement.groups]
           == [idxs for idxs, _ in groups]}
    t = rs.KVTransport.from_env("phase25serve")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rep = ho.publish_for_serve(rows, ge, n, r, t, chunk_bytes=chunk,
                               peak_bytes=peak)
    out["publish_s"] = time.perf_counter() - t0
    out["publish_bytes"], out["publish_peak"] = rep.bytes_moved, rep.peak_bytes
    progress("handoff publish")
    with torch.no_grad():
        placement.gather(rows)
        full = [p.detach().cpu().clone() for p in params]
    placement.release()

    class Memo:
        """Rank 0's transport: a payload its tp = 1 fetch read serves
        its tp = 2 fetch from memory (rank 1's tp = 2 fetch reads every
        payload over the KV)."""

        def __init__(self):
            self.seen = {}

        def wait(self, key, timeout=30.0):
            if key not in self.seen:
                self.seen[key] = t.wait(key, timeout=timeout)
            return self.seen[key]

    memo = Memo() if r == 0 else t

    def fetch(tp: int) -> list:
        stats = {}
        t0 = time.perf_counter()
        got = ho.fetch_decode_params(params, specs, memo, tp=tp,
                                     tp_rank=r % tp, chunk_bytes=chunk,
                                     peak_bytes=peak, stats=stats)
        out[f"fetch_tp{tp}_s"] = time.perf_counter() - t0
        out[f"fetch_tp{tp}_bytes"] = sum(x.numel() * x.element_size()
                                         for x in got)
        out[f"fetch_tp{tp}_peak"] = stats["peak_bytes"]
        bitwise = True
        for x, f, spec in zip(got, full, specs):
            ax = next((i for i, a in enumerate(spec) if a == "tp"), None)
            want = f if ax is None else f.chunk(tp, dim=ax)[r % tp]
            bitwise &= x.shape == want.shape and torch.equal(
                x.contiguous().view(torch.uint8),
                want.contiguous().view(torch.uint8))
        out[f"tp{tp}_bitwise"] = bitwise
        return got

    got1 = fetch(1) if r == 0 else None
    fetch(2)
    del memo
    progress("handoff fetch")
    if r == 0:
        T0 = min(serve_prompt_len(FA), seq_len)
        prompt = np.random.RandomState(25).randint(0, cfg.vocab_size, T0)
        FA.reset_launch_counts()

        def tokens(leaves) -> list:
            srv = InferenceServer(model_tree(model, leaves), cfg,
                                  max_seq_tokens=T0 + SERVE_NEW,
                                  max_batch=1, device=dev)
            srv.submit(prompt, SERVE_NEW)
            (seq,) = srv.run()
            return list(seq.generated)

        t0 = time.perf_counter()
        out["tokens_fetched"] = tokens(got1)
        out["tokens_gathered"] = tokens(full)
        out["serve_s"] = time.perf_counter() - t0
        out["serve_k4"] = FA.launch_counts()["flash_fwd"]
        out["serve_k4_sm90"] = FA.sm90_launch_counts()["flash_fwd"]
        out["prompt_len"] = T0
        del got1
    del full
    hvd.barrier()
    if r == 0:
        rs.cleanup(t, "serve")
    return out


def reshard_rank(cfg=None, seq_len: int = 16384, device=None,
                 zero3_env=None, peak=None, chunk=None,
                 out_dir: str = LOG_DIR, keep_streams: bool = False) -> int:
    """The ranks of phase 25 (run by `reshard_phase` through the port's
    launcher as `python -m chip_smoke --reshard-rank`, whose KV is the
    transport; `cfg`, `seq_len`, `device`, `zero3_env`, `peak` and
    `chunk` shrink it for the CPU, tests/test_torch_port_sharded_state.py,
    which also keeps the streams, `keep_streams`).
    The transformer at stage 3 (AdamW, ZERO3_ENV) takes RESHARD_STEPS
    steps, its state held by a `ShardedTorchState` that checkpoints it,
    then:

    (a) a shrink 2->1: both ranks publish their streams, rank 0 fetches;
        held bitwise to the local restack (every rank's streams
        allgathered, then cut), the staging peak to its ceiling, and in
        (f) to the restore path (the checkpoint restored, then cut);
    (b) a grow 1->2 from rank 0's world-1 streams: bitwise the original
        streams; a fresh optimizer filled with them takes one more step,
        bitwise the loss and the parameters' SHA-256 of the same step
        from the original state;
    (d) `reshard.peer_die` armed on rank 1 at the publish: both ranks'
        sync degrades to the restore path (without a checkpoint: the
        committed shards) and the digest gate passes;
        `reshard.chunk_corrupt` on rank 1: rank 0's fetch refuses it;
    (e) the chaos soak at np=2 on the card (seed SOAK_SEED, SOAK_ENV)
        in a second process group, then again with SOAK_DEGRADE_OFF;
    (f) rank 0 alone: a crash shrink (no publish) to a world of one,
        whose sync takes the restore path into an optimizer and a
        placement built at n=1, bitwise (a)'s live streams; one step
        there;
    (c) the state's own live path across a world change, 1->2: rank 0
        publishes its world-1 state at `on_hosts_updated`, both ranks
        join a new world of two and `sync` fetches each one's shards,
        rebuilds its optimizer and placement, gates on the digest and
        broadcasts the scalars: bitwise the original 2-rank streams;
    (g) between (b) and (d), the train-to-serve handoff of the stage-3
        parameter rows (`serve_handoff`).
    Saved to out_dir/reshard_rank<r>.pt."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.faults.chaos import ChaosSoak
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.parallel import data_parallel
    from horovod_tpu_torch.parallel import reshard as rs
    from horovod_tpu_torch.synthetic_benchmark import param_digest
    from horovod_tpu_torch.transformer_benchmark import (
        launch_counts, reset_launch_counts)
    from horovod_tpu_torch.utils.checkpoint import CheckpointManager

    hvd.init(device=device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    require(n == 2, f"phase 25 runs at np=2, got {n}")
    init_args = basics.init_arguments()
    cfg = cfg or TransformerConfig(compute_dtype=torch.bfloat16)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    peak = peak or rs.default_peak_bytes()
    chunk = chunk or rs.default_chunk_bytes(peak)
    res = {"rank": r, "device": str(dev), "peak_ceiling": peak,
           "chunk_bytes": chunk, "workers": rs.parallel_workers(peak, chunk)}
    times = {}
    t_phase = time.perf_counter()
    tmp = hvd.broadcast_object(
        tempfile.mkdtemp(prefix="chip_smoke_reshard_") if r == 0 else None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def progress(what: str) -> None:
        print(f"RESHARD_PROGRESS {what} at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    rng = np.random.RandomState(r)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (1, seq_len + 1))).to(dev)
        for _ in range(RESHARD_STEPS + 1)]

    def stage3():
        model = Transformer(cfg, seed=0).to(dev)
        inner = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(), zero_stage=3)
        params = list(model.parameters())
        placement = hvd.zero3_placement(params)
        rows = placement.shard(params)
        placement.bind(params)
        return model, opt, placement, rows

    def step(model, opt, placement, rows, tokens):
        with torch.no_grad():
            placement.gather(rows)
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(tokens[:, :-1]), tokens[:, 1:])
        loss.backward()
        updates = opt.step()
        rows = placement.apply_updates(rows, updates)
        placement.release()
        del updates
        return loss.detach(), rows

    def digest(model, placement, rows) -> str:
        with torch.no_grad():
            placement.gather(rows)
        d = param_digest(model)
        placement.release()
        return d

    def host(streams):
        return {k: np.asarray(v).copy() for k, v in streams.items()}

    shrunk = {}  # rank 0: the shrink's world-1 streams, for (f)

    def run_stage3():
        model, opt, placement, rows = stage3()
        reset_launch_counts()
        losses = []
        for t in range(RESHARD_STEPS):
            loss, rows = step(model, opt, placement, rows, batches[t])
            losses.append(float(loss))
        res["losses"] = losses
        progress("steps")
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        state = hvd.elastic.ShardedTorchState(
            model, opt, placement=placement, rows=rows,
            checkpoint_manager=mgr,
            transport=rs.KVTransport.from_env("phase25"), chunk_bytes=chunk,
            peak_bytes=peak, reshard_timeout=60, step=RESHARD_STEPS)
        z = state._saved["__zero__"]
        specs, data = z["specs"], z["data"]
        res["streams"] = len(specs)
        if keep_streams:
            res["specs"], res["data"] = [tuple(x) for x in specs], data
        res["state_bytes"] = int(sum(v.nbytes for v in data.values()))
        sync()
        t0 = time.perf_counter()
        state.checkpoint(RESHARD_STEPS)
        times["checkpoint_s"] = time.perf_counter() - t0
        progress("checkpoint")
        t = rs.KVTransport.from_env("phase25raw")

        # (a) shrink 2 -> 1: rank 0 fetches.
        t0 = time.perf_counter()
        got, rep = rs.reshard_streams(
            specs, data, 2, 1, r, 0 if r == 0 else None, t, tag="shrink",
            chunk_bytes=chunk, peak_bytes=peak)
        times["shrink_s"] = time.perf_counter() - t0
        res["shrink"] = {"bytes": rep.bytes_moved, "chunks": rep.chunks,
                         "peak": rep.peak_bytes, "ms": rep.wall_ms}
        t0 = time.perf_counter()
        per_old = hvd.allgather_object(data)
        local = rs.reshard_rank_streams(specs, per_old, 1)[0]
        times["local_restack_s"] = time.perf_counter() - t0
        del per_old
        if r == 0:
            # (f) holds the restore path's world-1 state to these.
            res["shrink_live_eq_local"] = _streams_equal(got, local)
            shrunk.update(got)
            if keep_streams:
                res["shrunk"] = got
        del local
        hvd.barrier()
        if r == 0:
            rs.cleanup(t, "shrink")
        progress("shrink")

        # (b) grow 1 -> 2 from rank 0's world-1 streams, then one step.
        t0 = time.perf_counter()
        grown, rep = rs.reshard_streams(
            specs, got if r == 0 else None, 1, 2, 0 if r == 0 else None, r,
            t, tag="grow", chunk_bytes=chunk, peak_bytes=peak)
        times["grow_s"] = time.perf_counter() - t0
        res["grow"] = {"bytes": rep.bytes_moved, "chunks": rep.chunks,
                       "peak": rep.peak_bytes, "ms": rep.wall_ms}
        del got
        res["grow_roundtrip"] = _streams_equal(grown, data)
        opt_rt = opt.rebuilt()
        rows_rt = rs.streams_to_opt_state(opt_rt, specs, grown)
        res["rebuilt_roundtrip"] = _streams_equal(
            host(rs.opt_state_streams(opt_rt, rows_rt)[1]), data)
        del grown
        loss_rt, rows_rt = step(model, opt_rt, placement, rows_rt,
                                batches[-1])
        res["step_rt"] = {"loss": float(loss_rt),
                          "digest": digest(model, placement, rows_rt)}
        del opt_rt, rows_rt
        loss_0, rows_0 = step(model, opt, placement, rows, batches[-1])
        res["step_orig"] = {"loss": float(loss_0),
                            "digest": digest(model, placement, rows_0)}
        del rows_0
        res["launches"] = launch_counts()
        hvd.barrier()
        if r == 0:
            rs.cleanup(t, "grow")
        progress("grow")

        # (g) the train-to-serve handoff of the stage-3 rows.
        res["handoff"] = serve_handoff(model, placement, rows, cfg, dev,
                                       seq_len, chunk, peak, progress)
        progress("handoff")

        # (d) a dead peer at the publish, then a corrupt chunk.  The
        # restore path here is the one without a checkpoint (every rank's
        # committed shards); (f) takes the checkpoint's.
        if r == 1:
            faults.install("reshard.peer_die:err")
        state._reshard_timeout = RESHARD_DIE_TIMEOUT
        state.on_hosts_updated()
        res["die_points_hit"] = faults.points_hit("reshard.peer_die")
        faults.clear()
        state.checkpoint_manager = None
        t0 = time.perf_counter()
        state.sync()
        times["die_sync_s"] = time.perf_counter() - t0
        state.checkpoint_manager = mgr
        res["die_path"] = state.last_sync_path
        res["die_state_bitwise"] = _streams_equal(
            host(rs.opt_state_streams(state.optimizer, state.rows)[1]), data)
        small = specs[:2]
        if r == 1:
            faults.install("reshard.chunk_corrupt:err")
        try:
            out, _ = rs.reshard_streams(
                small, data, 2, 1, r, 0 if r == 0 else None, t,
                tag="corrupt", chunk_bytes=chunk, peak_bytes=peak,
                timeout=RESHARD_DIE_TIMEOUT)
            res["corrupt_assembled"] = out is not None
        except rs.ReshardError as e:
            res["corrupt_error"] = str(e)[:120]
            res["corrupt_assembled"] = False
        res["corrupt_points_hit"] = faults.points_hit("reshard.chunk_corrupt")
        faults.clear()
        hvd.barrier()
        if r == 0:
            for tag in ("corrupt", "die"):
                rs.cleanup(t, tag)
        return model, state, specs, data

    model, state, specs, data = _with_env(dict(zero3_env or ZERO3_ENV,
                                               **RESHARD_ENV), run_stage3)
    progress("peer_die and corrupt")
    sync()
    times["stage3_s"] = time.perf_counter() - t_phase

    # (e) the soak in a process group of its own, with its environment.
    t0 = time.perf_counter()
    hvd.shutdown()
    soak_env = dict(SOAK_ENV, HOROVOD_TIMELINE=os.path.join(
        out_dir, "reshard_soak_tl.json"))

    def soak():
        hvd.init(**init_args)
        out = ChaosSoak(seed=SOAK_SEED).run()
        hvd.shutdown()
        # The soak's rebalance caps the bucket partition for the process
        # (`set_reaction_rebalance`); (f) rebuilds the stage-3 partition.
        data_parallel.clear_reaction_rebalance()
        return out

    res["soak"] = _with_env(soak_env, soak)
    res["soak_rebalance"] = _with_env(dict(
        soak_env, **SOAK_DEGRADE_OFF, HOROVOD_TIMELINE=os.path.join(
            out_dir, "reshard_soak_rebalance_tl.json")), soak)
    times["soak_s"] = time.perf_counter() - t0
    progress("soak")

    # (f) rank 0 alone: a crash shrink (no publish) to a world of one.
    if r == 0:
        t0 = time.perf_counter()

        def crash():
            hvd.init(coordinator_address=f"file://{tmp}/solo",
                     num_processes=1, process_id=0, device=dev)
            state.sync()
            return state.last_sync_path

        res["crash_path"] = _with_env(dict(zero3_env or ZERO3_ENV,
                                           **RESHARD_ENV), crash)
        times["crash_sync_s"] = time.perf_counter() - t0
        res["crash_state_bitwise"] = _streams_equal(
            host(rs.opt_state_streams(state.optimizer, state.rows)[1]),
            shrunk)
        res["crash_n"] = state.optimizer.n
        loss, _ = _with_env(dict(zero3_env or ZERO3_ENV), lambda: step(
            model, state.optimizer, state.placement, state.rows,
            batches[-1]))
        res["crash_step_loss"] = float(loss)
        # (c) begins: the world of one publishes before its teardown.
        sync()
        t0 = time.perf_counter()
        state.on_hosts_updated()
        times["publish_s"] = time.perf_counter() - t0
        hvd.shutdown()
        progress("crash shrink")

    # (c) a world of two again; the state syncs 1->2 on the live path.
    def grow():
        hvd.init(**init_args)
        t0 = time.perf_counter()
        state.sync()
        times["sync_s"] = time.perf_counter() - t0
        rep = state.last_reshard
        res["class_path"] = state.last_sync_path
        res["class_n"] = state.optimizer.n
        res["class_sync"] = (None if rep is None else {
            "bytes": rep.bytes_moved, "chunks": rep.chunks,
            "peak": rep.peak_bytes, "ms": rep.wall_ms})
        res["class_state_bitwise"] = _streams_equal(
            host(rs.opt_state_streams(state.optimizer, state.rows)[1]), data)
        res["class_step"] = state.step
        hvd.barrier()
        hvd.shutdown()

    _with_env(dict(zero3_env or ZERO3_ENV, **RESHARD_ENV), grow)
    progress("class")
    if r == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    times["rank_s"] = time.perf_counter() - t_phase
    res["times"] = times
    os.makedirs(out_dir, exist_ok=True)
    torch.save(res, os.path.join(out_dir, f"reshard_rank{r}.pt"))
    print("RESHARD " + json.dumps(
        {k: v for k, v in res.items()
         if k not in ("soak", "soak_rebalance", "specs", "data", "shrunk")}),
        flush=True)
    return 0


def policy_reactions(windows, degrade: bool = True) -> list:
    """(gen, action, rank) of each reaction the port's straggler policy
    fires on a soak's windows (SOAK_ENV's patience and cooldown; the
    default threshold, or none with `degrade` off)."""
    import types

    from horovod_tpu_torch.trace.reaction import StragglerReactionPolicy

    policy = StragglerReactionPolicy(
        patience=int(SOAK_ENV["HOROVOD_STRAGGLER_PATIENCE"]),
        cooldown=int(SOAK_ENV["HOROVOD_STRAGGLER_COOLDOWN"]),
        skew_threshold=None if degrade else math.inf,
        on_rebalance=lambda rank: None, on_degrade=lambda rank: None)
    out = []
    for w in windows:
        if w["skew_share"] is None:
            continue
        d = policy.observe(types.SimpleNamespace(
            straggler_rank=w["straggler_rank"], skew_share=w["skew_share"]))
        if d.fired:
            out.append((w["gen"], d.action, d.rank))
    return out


def check_soak(res, name: str, rebalance: bool = False) -> dict:
    """The chaos soak's checks on both ranks' results (JAX's
    `_assert_soak_invariants` and `test_two_process_soak`): the fleet
    agrees, every event recovered or degraded, the tuner sampled, the
    stall and the NaN recovered, a reaction against the straggler that
    is the policy's on the windows' skew shares (shares of the critical
    path), loud re-inits, no false anomaly.  At JAX's settings the port
    degrades its straggler (its step is short, so the straggler takes
    most of it); `rebalance` (the degrade branch off) also asks for
    JAX's rebalance and a detected anomaly.  Returns rank 0's."""
    s0, s1 = res
    for s in res:
        require(not s["split_brain"] and s["final_digest_mismatch"] is None
                and all(e["outcome"] in ("recovered", "degraded")
                        and e["mttr_ms"] >= 0 for e in s["events"]),
                f"rank {s['rank']}: {name} {s['events']}")
    require(s0["final_w"] == s1["final_w"] and
            [(e["kind"], e["gen"], e["step"]) for e in s0["events"]] ==
            [(e["kind"], e["gen"], e["step"]) for e in s1["events"]]
            and s0["reactions"] == s1["reactions"],
            f"{name}: the ranks' parameters, events or reactions differ")
    require(s0["autotune_enabled"], f"{name}: the tuner is off")
    bests = [w["autotune_best"] for w in s0["windows"]
             if w["autotune_best"] is not None]
    samples = [w["autotune_samples"] for w in s0["windows"]]
    require(bests and all(b2 >= b1 for b1, b2 in zip(bests, bests[1:]))
            and samples[-1] >= 1 and samples == sorted(samples),
            f"{name}: tuner bests {bests}, samples {samples}")
    kinds = {e["kind"]: e for e in s0["events"]}
    shares = [w["skew_share"] for w in s0["windows"]
              if w["skew_share"] is not None]
    actions = [x["action"] for x in s0["reactions"]]
    require(s0["straggler_target"] >= 0
            and any(x["rank"] == s0["straggler_target"]
                    for x in s0["reactions"])
            and [(x["gen"], x["action"], x["rank"]) for x in s0["reactions"]]
            == policy_reactions(s0["windows"],
                                degrade=not rebalance)
            and all(0.0 <= v <= 1.0 for v in shares)
            and (not rebalance or actions[:1] == ["rebalance"])
            and s0["straggler_target"] in [
                w["straggler_rank"] for w in s0["windows"]
                if w["straggler_armed"]] and s0["loud_reinits"] >= 1,
            f"{name}: straggler {s0['straggler_target']}, reactions "
            f"{s0['reactions']}, skew shares {shares}, loud re-inits "
            f"{s0['loud_reinits']}")
    require("worker_stall" in kinds and kinds.get("nan_grad", {}).get(
        "outcome") == "recovered" and kinds["nan_grad"]["steps_lost"] >= 1,
            f"{name}: events {s0['events']}")
    anom = s0["anomaly"]
    require(anom["false_positives"] == 0
            and set(anom["detected_kinds"]) <= set(anom["injected_kinds"])
            and (not rebalance or anom["detected_kinds"]),
            f"{name}: anomaly monitor {anom}")
    return s0


def check_reshard(res, on_card: bool = True) -> dict:
    """Phase 25's checks on both ranks' saved results (`reshard_rank`);
    every failure raises.  Returns what the phase prints."""
    r0, r1 = res
    for s in res:
        r = s["rank"]
        require(all(math.isfinite(v) for v in s["losses"]),
                f"rank {r}: losses {s['losses']}")
        require(s["shrink"]["peak"] <= s["peak_ceiling"]
                and s["grow"]["peak"] <= s["peak_ceiling"],
                f"rank {r}: staging peak {s['shrink']['peak']} / "
                f"{s['grow']['peak']} over {s['peak_ceiling']}")
        require(s["shrink"]["chunks"] > 1,
                f"rank {r}: the shrink moved {s['shrink']['chunks']} chunk")
        require(s["grow_roundtrip"] and s["rebuilt_roundtrip"],
                f"rank {r}: the grow 1->2 did not give back the 2-rank "
                "streams bitwise (or a rebuilt optimizer did not hold them)")
        require(s["step_rt"] == s["step_orig"],
                f"rank {r}: the step after the round trip {s['step_rt']} is "
                f"not bitwise the step without it {s['step_orig']}")
        require(s["class_path"] == "reshard" and s["class_state_bitwise"]
                and s["class_n"] == 2 and (s["class_sync"] or {}).get("bytes", 0) > 0
                and s["class_step"] == RESHARD_STEPS,
                f"rank {r}: ShardedTorchState's sync 1->2 took "
                f"{s['class_path']} at n {s['class_n']}, moved "
                f"{s['class_sync']}, bitwise {s['class_state_bitwise']}, "
                f"step {s['class_step']}")
        require(s["die_path"] == "restore" and s["die_state_bitwise"],
                f"rank {r}: with rank 1 dead at the publish the sync took "
                f"{s['die_path']}, bitwise {s['die_state_bitwise']}")
        require(s["die_points_hit"] == (1 if r == 1 else 0),
                f"rank {r}: reshard.peer_die hit {s['die_points_hit']}")
        if on_card:
            l = s["launches"]
            require(all(l[k] > 0 and l[k + "_sm90"] == l[k]
                        for k in FLASH_NAMES),
                    f"rank {r}: K4-K6 {l} off the tensor cores or not "
                    "launched")
    for s in res:
        h = s["handoff"]
        require(h["groups_match"] and h["tp2_bitwise"]
                and h["publish_bytes"] > 0
                and h["publish_peak"] <= s["peak_ceiling"]
                and h["fetch_tp2_peak"] <= s["peak_ceiling"],
                f"rank {s['rank']}: serve handoff {h}")
    h = r0["handoff"]
    require(h["tp1_bitwise"] and h["fetch_tp1_peak"] <= r0["peak_ceiling"],
            f"serve handoff at tp=1: bitwise {h['tp1_bitwise']}, peak "
            f"{h['fetch_tp1_peak']}")
    require(h["tokens_fetched"] == h["tokens_gathered"]
            and len(h["tokens_fetched"]) == SERVE_NEW,
            f"serve handoff: tokens from the fetched parameters "
            f"{h['tokens_fetched']} are not those from the gathered ones "
            f"{h['tokens_gathered']}")
    if on_card:
        require(h["serve_k4"] > 0 and h["serve_k4_sm90"] == h["serve_k4"],
                f"serve handoff: K4 {h['serve_k4']} launches "
                f"({h['serve_k4_sm90']} on the tensor cores) at the prefill")
    require(r0["shrink_live_eq_local"],
            "shrink 2->1: the live streams are not bitwise the local "
            "restack's")
    require(not r0["corrupt_assembled"] and "sha256" in r0.get(
        "corrupt_error", "") and r1["corrupt_points_hit"] >= 1,
            f"corrupt chunk: assembled {r0['corrupt_assembled']}, "
            f"{r0.get('corrupt_error')}, hits {r1['corrupt_points_hit']}")
    require(r0["crash_path"] == "restore" and r0["crash_state_bitwise"]
            and r0["crash_n"] == 1 and math.isfinite(r0["crash_step_loss"]),
            f"crash shrink (the restore path at one rank, held to the live "
            f"shrink's streams): path {r0['crash_path']}, bitwise "
            f"{r0['crash_state_bitwise']}, n {r0['crash_n']}, loss "
            f"{r0['crash_step_loss']}")
    soak = check_soak([r0["soak"], r1["soak"]], "soak")
    check_soak([r0["soak_rebalance"], r1["soak_rebalance"]],
               "soak (degrade off)", rebalance=True)
    return {"launches": [s["launches"] for s in res],
            "times": [s["times"] for s in res],
            "shrink": [s["shrink"] for s in res],
            "grow": [s["grow"] for s in res],
            "class_sync": [s["class_sync"] for s in res],
            "state_bytes": [s["state_bytes"] for s in res],
            "streams": r0["streams"], "peak_ceiling": r0["peak_ceiling"],
            "chunk_bytes": r0["chunk_bytes"], "step": r0["step_rt"],
            "soak_events": [(e["kind"], e["outcome"], e["mttr_ms"])
                            for e in r0["soak"]["events"]],
            "soak_reactions": r0["soak"]["reactions"],
            "soak_shares": [w["skew_share"] for w in r0["soak"]["windows"]],
            "soak_anomaly": soak["anomaly"],
            "rebalance_reactions": r0["soak_rebalance"]["reactions"],
            "rebalance_anomaly": r0["soak_rebalance"]["anomaly"],
            "handoff": [s["handoff"] for s in res]}


def reshard_phase() -> dict:
    """Phase 25 (main path 15): the ranks of `reshard_rank`, two on the
    card over gloo under the port's launcher; see the module docstring."""
    import torch

    t_start = time.perf_counter()
    phase = "reshard_chaos"
    for f in ("reshard_soak_tl.json", "reshard_soak_tl.rank1.json",
              "reshard_soak_rebalance_tl.json",
              "reshard_soak_rebalance_tl.rank1.json"):
        if os.path.exists(os.path.join(LOG_DIR, f)):
            os.remove(os.path.join(LOG_DIR, f))
    run_ranks(phase, 2, "chip_smoke", ["--reshard-rank"], RESHARD_BUDGET_S,
              env=ZERO3_ENV, launcher=True)
    res = [torch.load(os.path.join(LOG_DIR, f"reshard_rank{r}.pt"),
                      weights_only=False) for r in range(2)]
    out = check_reshard(res, on_card=True)
    mib = 1 << 20
    for r, (sh, gr, cs, tm) in enumerate(zip(
            out["shrink"], out["grow"], out["class_sync"], out["times"])):
        log(phase, f"rank {r}: state {out['state_bytes'][r] / mib:.1f} MiB "
            f"in {out['streams']} streams; shrink 2->1 {tm['shrink_s']:.3f} "
            f"s ({sh['bytes'] / mib:.1f} MiB, {sh['chunks']} chunks, peak "
            f"{sh['peak'] / mib:.2f} of {out['peak_ceiling'] / mib:.0f} "
            f"MiB); grow 1->2 {tm['grow_s']:.3f} s ({gr['bytes'] / mib:.1f} "
            f"MiB, {gr['chunks']} chunks, peak {gr['peak'] / mib:.2f} MiB); "
            f"checkpoint {tm['checkpoint_s']:.3f} s, local restack "
            f"{tm['local_restack_s']:.3f} s; ShardedTorchState sync 1->2 "
            f"{tm['sync_s']:.3f} s ({cs['bytes'] / mib:.1f} MiB, peak "
            f"{cs['peak'] / mib:.2f} MiB); peer_die sync "
            f"{tm['die_sync_s']:.3f} s (restore path); "
            f"soak {tm['soak_s']:.1f} s; rank {tm['rank_s']:.1f} s")
    log(phase, f"crash shrink to one rank: restore path (checkpoint "
        f"restored and cut, bitwise the live shrink) in "
        f"{out['times'][0]['crash_sync_s']:.3f} s; its ShardedTorchState "
        f"publish at world 1 {out['times'][0]['publish_s']:.3f} s; step "
        f"after the round "
        f"trip bitwise: loss {out['step']['loss']:.6f}, SHA-256 "
        f"{out['step']['digest'][:16]}")
    for kind, outcome, mttr in out["soak_events"]:
        log(phase, f"soak event {kind}: {outcome}, MTTR {mttr} ms")
    log(phase, f"soak reactions {out['soak_reactions']} on skew shares "
        f"{out['soak_shares']}; anomaly detected "
        f"{out['soak_anomaly']['detected_kinds']} of "
        f"{out['soak_anomaly']['injected_kinds']}")
    log(phase, f"soak with the degrade branch off: reactions "
        f"{out['rebalance_reactions']}; anomaly detected "
        f"{out['rebalance_anomaly']['detected_kinds']}")
    h0, h1 = out["handoff"]
    log(phase, f"(g) serve handoff: publish {h0['publish_s']:.3f} / "
        f"{h1['publish_s']:.3f} s ({h0['publish_bytes'] / mib:.1f} / "
        f"{h1['publish_bytes'] / mib:.1f} MiB, peak "
        f"{h0['publish_peak'] / mib:.2f} / {h1['publish_peak'] / mib:.2f} "
        f"MiB); fetch at tp=1 on rank 0 {h0['fetch_tp1_s']:.3f} s "
        f"({h0['fetch_tp1_bytes'] / mib:.1f} MiB, staging peak "
        f"{h0['fetch_tp1_peak'] / mib:.2f} MiB); at tp=2 "
        f"{h0['fetch_tp2_s']:.3f} / {h1['fetch_tp2_s']:.3f} s "
        f"({h0['fetch_tp2_bytes'] / mib:.1f} MiB a rank, peak "
        f"{h0['fetch_tp2_peak'] / mib:.2f} / {h1['fetch_tp2_peak'] / mib:.2f}"
        f" MiB); every slice bitwise the gathered parameters'; "
        f"{SERVE_NEW} tokens served from a {h0['prompt_len']}-token prompt "
        f"on the fetched parameters equal those on the gathered ones "
        f"({h0['serve_s']:.3f} s for both, K4 {h0['serve_k4']} launches, "
        f"{h0['serve_k4_sm90']} on the tensor cores)")
    log(phase, "K4-K6 launches per rank (reshard_launches): " + ", ".join(
        f"{n} {[l[n] for l in out['launches']]}" for n in FLASH_NAMES))
    out["phase_s"] = time.perf_counter() - t_start
    log(phase, f"{out['phase_s']:.1f} s (budget {RESHARD_BUDGET_S} s)")
    require(out["phase_s"] <= RESHARD_BUDGET_S,
            f"{phase}: over its budget of {RESHARD_BUDGET_S} s")
    return out


# ---------------------------------------------------------------------------
# Phase 26: elastic serving replicas, healed and scaled
# ---------------------------------------------------------------------------

REPLICA_BUDGET_S = 90     # phase 26's share of the script's time limit
# The lease: a replica's first beat comes after its process start (8-11
# s on the card's host), the full-width model's init, its move to the
# card and the digest; the start grace is two TTLs.
REPLICA_LEASE_TTL = 30.0
REPLICA_DIE_BEAT = 3      # the dying incarnation's last loop iteration
REPLICA_BATCH = 2         # each replica's decode rows
REPLICA_REQUESTS = 6      # (a)
REPLICA_BURST = 8         # (b): queued beyond the fleet's 2 x 2 rows
REPLICA_AROUND = (3, 2)   # (b): submitted after the grow, after the shrink
# (b): a controller that fires within the phase: grow after two
# observations of pressure (the burst), shrink after two of relief once
# the reversal's cooldown (2 x 2 observations) is past.
REPLICA_AUTOSCALE_ENV = {
    "HOROVOD_AUTOSCALE_MIN_REPLICAS": "2",
    "HOROVOD_AUTOSCALE_MAX_REPLICAS": "3",
    "HOROVOD_AUTOSCALE_DWELL": "2", "HOROVOD_AUTOSCALE_COOLDOWN": "2",
    "HOROVOD_AUTOSCALE_OCC_HIGH": "0.85", "HOROVOD_AUTOSCALE_OCC_LOW": "0.30",
    "HOROVOD_AUTOSCALE_QUEUE_MS": "0"}


def _die(host: str) -> dict:
    return {"HOROVOD_FAULT_SPEC":
            f"serve.replica_die@{REPLICA_DIE_BEAT}:exit:1",
            "HOROVOD_FAULT_HOSTS": host}


def _fire(ctrl, mgr, step: int, verdict: str, limit: int = 32):
    """Observe the fleet until the controller fires; returns (the next
    step, the decision, its event)."""
    from horovod_tpu_torch.serve.autoscale import snapshot_from_manager

    for step in range(step, step + limit):
        mgr.poll_results()
        d, ev = ctrl.step(snapshot_from_manager(mgr, step,
                                                max_batch=REPLICA_BATCH))
        if ev is not None:
            require(d.verdict == verdict, f"serve_replicas: the controller "
                    f"fired {d.verdict} ({d.reason}), want {verdict}")
            return step + 1, d, ev
    raise RuntimeError(f"serve_replicas: no {verdict} in {limit} "
                       f"observations: {[d.reason for d in ctrl.decisions]}")


def replicas_phase(FA, smi: str, cfg_kw=None, device=None,
                   prompt_len=None, budget: float = REPLICA_BUDGET_S) -> dict:
    """Phase 26 (main path 16): a fleet of the full-width default
    TransformerConfig in bf16 (`serve/replica.py`, one process a replica
    on the card), prompts of serve_prompt_len tokens so that every
    prefill runs K4.

    (a) The die drill: ReplicaManager(2) with `serve.replica_die` on
        replica1's first incarnation, timelines and flight-recorder
        dumps on; REPLICA_REQUESTS requests of SERVE_NEW tokens: every
        result arrives, a respawn, the dead incarnation's dump
        (`fault_exit:serve.replica_die`), a reassigned request's lane
        blamed on replica 1 (`trace.core.analyze_serve`), the digests
        agreeing.
    (b) On the same fleet, `AutoscaleController` through
        `ReplicaFleetActuator` (REPLICA_AUTOSCALE_ENV): a queued burst
        grows it 2 -> 3 while `serve.replica_die` kills the joiner, then
        it shrinks 3 -> 2 once the queue drains; each event committed
        at its planned size, the digests agreeing after each.
    Every request's tokens held to the phase's own reference chain
    (`teacher_forced`: equal up to the first near-tie, within SERVE_TIE
    after it); each replica that served reports K4 launches, all on the
    tensor cores, and its peak memory; the card's free memory comes
    back once the fleet stops.  `cfg_kw`, `device` ("cpu": the card's
    checks off) and `prompt_len` shrink it for a rehearsal on the
    CPU."""
    import glob

    import numpy as np
    import torch
    from horovod_tpu_torch.models import decode as D
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serve import flightrec
    from horovod_tpu_torch.serve.autoscale import (
        AutoscaleConfig, AutoscaleController, ReplicaFleetActuator)
    from horovod_tpu_torch.serve.replica import ReplicaManager
    from horovod_tpu_torch.trace import core as tcore

    phase = "serve_replicas"
    t_start = time.perf_counter()
    on_card = device is None
    dev = torch.device("cuda", 0) if on_card else torch.device(device)
    cfg_kw = dict(cfg_kw or {}, compute_dtype="bfloat16" if on_card
                  else "float32")
    cfg = T.TransformerConfig(**dict(cfg_kw, compute_dtype=getattr(
        torch, cfg_kw["compute_dtype"])))
    T0 = prompt_len or serve_prompt_len(FA)
    config = {"cfg": cfg_kw, "seed": 0,
              "serve": dict({"max_seq_tokens": T0 + SERVE_NEW,
                             "max_batch": REPLICA_BATCH},
                            **({} if on_card else {"device": device}))}
    out_dir = os.path.join(LOG_DIR, "serve_replicas")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    tl = os.path.join(out_dir, "tl.json")
    rng = np.random.RandomState(26)
    prompts = {}

    def submit(mgr, n):
        for _ in range(n):
            p = rng.randint(0, cfg.vocab_size, T0)
            prompts[mgr.submit(p.tolist(), SERVE_NEW)] = p

    def free_gb():
        if not on_card:
            return 0.0
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info(dev)[0] / 1e9

    free_before = free_gb()
    out, times = {}, {}
    with ReplicaManager(2, config, lease_ttl=REPLICA_LEASE_TTL,
                        respawn_backoff=0.2, child_env=dict(
                            _die("replica1"), HOROVOD_TIMELINE=tl,
                            HOROVOD_SERVE_FLIGHTREC_DIR=out_dir)) as mgr:
        # Only replica1's first incarnation is armed.
        for k in _die(""):
            mgr.child_env.pop(k)
        # (a) the die drill.
        t0 = time.perf_counter()
        submit(mgr, REPLICA_REQUESTS)
        res = mgr.wait_all(timeout=120)
        out["a"] = {"results": len(res), "respawns": mgr._respawns,
                    "digest_agreement": mgr.digest_agreement(timeout=60)}
        times["a_s"] = time.perf_counter() - t0
        require(len(res) == REPLICA_REQUESTS and out["a"]["respawns"] >= 1
                and out["a"]["digest_agreement"],
                f"{phase} (a): {out['a']}")
        # (b) scale events on the same fleet.
        t0 = time.perf_counter()
        ctrl = _with_env(REPLICA_AUTOSCALE_ENV, lambda: AutoscaleController(
            AutoscaleConfig(), actuator=ReplicaFleetActuator(mgr)))
        submit(mgr, REPLICA_BURST)
        mgr.child_env.update(_die("replica2"))     # the joiner
        step, d, grow = _fire(ctrl, mgr, 0, "grow")
        for k in _die(""):
            mgr.child_env.pop(k)
        t1 = time.perf_counter()
        for _ in range(20):
            mgr.kv.get("serve/stop")
        out["kv_get_ms"] = (time.perf_counter() - t1) / 20 * 1e3
        submit(mgr, REPLICA_AROUND[0])
        respawns = mgr._respawns
        mgr.wait_all(timeout=120)
        out["grow"] = {"state": grow.state, "planned": d.to_size,
                       "converged": grow.converged_size,
                       "wall_ms": grow.wall_ms,
                       "respawns": mgr._respawns - respawns,
                       "digest_agreement": mgr.digest_agreement(timeout=60)}
        times["grow_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, d, shrink = _fire(ctrl, mgr, step, "shrink")
        submit(mgr, REPLICA_AROUND[1])
        mgr.wait_all(timeout=120)
        out["shrink"] = {"state": shrink.state, "planned": d.to_size,
                         "converged": shrink.converged_size,
                         "wall_ms": shrink.wall_ms,
                         "digest_agreement": mgr.digest_agreement(timeout=60)}
        times["shrink_s"] = time.perf_counter() - t0
        for ev, size in (("grow", 3), ("shrink", 2)):
            e = out[ev]
            require(e["state"] == "committed" and e["planned"] == size
                    == e["converged"] and e["digest_agreement"],
                    f"{phase} (b): the {ev} event {e}")
        require(out["grow"]["respawns"] >= 1,
                f"{phase} (b): the joiner did not die and respawn")
        results = dict(mgr.results)
        out["first_beats"] = [(r, round(s, 3)) for r, s in mgr.first_beats]
        out["fleet"] = mgr.fleet_size()
    times["fleet_s"] = time.perf_counter() - t_start
    out["free_gb"] = (free_before, free_gb())
    require(out["free_gb"][1] >= free_before - 1.0,
            f"{phase}: {free_before - out['free_gb'][1]:.2f} GB of the card "
            "still held after the fleet stopped")

    # What the replicas left: the dead incarnation's dump, the lanes.
    dumps = [flightrec.load_dump(f) for f in sorted(glob.glob(
        os.path.join(out_dir, "serve_flightrec.replica1.*.json")))]
    require(any(dp["reason"] == "fault_exit:serve.replica_die"
                for dp in dumps), f"{phase}: replica1 left no dump "
            f"(reasons {[dp['reason'] for dp in dumps]})")
    files = sorted(glob.glob(tl + ".rank*"))
    report = tcore.analyze_serve(files, align="wall")
    stitched = [row for row in report["requests"] if row["reassigned"]]
    require(any(row["blamed_replica"] == 1 for row in stitched),
            f"{phase}: no reassigned request blamed on replica 1: "
            f"{stitched}")
    stats = [dict(e["args"], file=os.path.basename(f))
             for f in files for evs in tcore.load_rank_traces([f]).values()
             for e in evs if e.get("name") == "replica_stats"]
    served = [st for st in stats if st["served"]]
    require(len(served) >= 2 and (not on_card or all(
        st["launches"]["flash_fwd"] > 0
        and st["sm90"]["flash_fwd"] == st["launches"]["flash_fwd"]
        for st in served)), f"{phase}: K4 launches of the replicas {stats}")
    out["replicas"] = [{k: st[k] for k in ("file", "served", "peak_mem_gb")}
                       | {"k4": st["launches"]["flash_fwd"],
                          "k4_sm90": st["sm90"]["flash_fwd"]}
                       for st in stats]
    out["launches"] = sum(st["launches"]["flash_fwd"] for st in stats)

    # Every chain against the phase's own reference.
    require(sorted(results) == sorted(prompts), f"{phase}: results for "
            f"{sorted(results)} of {sorted(prompts)}")
    t0 = time.perf_counter()
    params = D.decode_params(T.tree_map(lambda a: a.to(dev),
                                        T.transformer_init(0, cfg)), cfg)
    ids = sorted(results)
    held = ties = before = 0
    for i in range(0, len(ids), 8):
        chunk = ids[i:i + 8]
        h, t, b = teacher_forced(
            D, params, cfg,
            torch.from_numpy(np.stack([prompts[j] for j in chunk])).to(dev),
            [results[j] for j in chunk])
        held, ties, before = held + h, ties + t, before + b
    require(held == len(ids) * SERVE_NEW, f"{phase}: held {held} tokens")
    out["tokens"] = {"held": held, "near_ties": ties,
                     "before_first_tie": before}
    times["reference_s"] = time.perf_counter() - t0
    del params
    out["times"] = times
    log(phase, f"({smi}) (a) {REPLICA_REQUESTS} requests of {SERVE_NEW} "
        f"tokens from {T0}-token prompts on 2 replicas, replica1 killed at "
        f"its beat {REPLICA_DIE_BEAT}: all {out['a']['results']} results, "
        f"{out['a']['respawns']} respawn, digests agree, its dump "
        f"fault_exit:serve.replica_die, {len(stitched)} reassigned lanes; "
        f"{times['a_s']:.1f} s")
    log(phase, f"(b) grow 2->3 under a burst of {REPLICA_BURST} "
        f"({out['grow']['wall_ms']:.0f} ms to converge, the joiner killed "
        f"and respawned) {times['grow_s']:.1f} s, shrink 3->2 "
        f"({out['shrink']['wall_ms']:.0f} ms) {times['shrink_s']:.1f} s; "
        f"both committed, digests agree; KV get at 3 replicas "
        f"{out['kv_get_ms']:.3f} ms")
    log(phase, f"first beats (replica, s from spawn) {out['first_beats']}; "
        f"replicas (file, served, peak GB, K4, on sm90) {out['replicas']}; "
        f"card free {out['free_gb'][0]:.2f} GB before, "
        f"{out['free_gb'][1]:.2f} GB after the fleet")
    log(phase, f"{held} tokens of {len(ids)} requests held to the "
        f"reference chains ({before} before a row's first near-tie, "
        f"{ties} near-ties); {times['reference_s']:.1f} s")
    out["phase_s"] = time.perf_counter() - t_start
    log(phase, f"{out['phase_s']:.1f} s (budget {budget} s)")
    require(out["phase_s"] <= budget,
            f"{phase}: over its budget of {budget} s")
    return out


# ---------------------------------------------------------------------------
# Phase 27: the framework-neutral frontend and the MXNet frontend
# ---------------------------------------------------------------------------

FRONTENDS_BUDGET_S = 60  # phase 27's share of the script's time limit
FRONTENDS_STEPS = 3
FRONTENDS_LR = 0.0125    # the benchmark's SGD rate (LearningRateWarmupCallback's target)
FRONTENDS_RUN = dict(phase="frontends", module="chip_smoke",
                     args=["--frontends-rank"], raw=True)


def _tree_sha(tree) -> str:
    """`_sha` of a dict of tensors or numpy arrays, in sorted name
    order."""
    import torch

    return _sha(torch.as_tensor(tree[k]) for k in sorted(tree))


def frontends_rank(model_name: str = "resnet50", image_size: int = 224,
                   batch: int = 32, device=None) -> int:
    """One rank of phase 27 (a folded run of the adasum pair, or of a pair
    of its own): (a) the callbacks and the tape on the zoo model at full
    width from a seed a rank, (b) the MXNet frontend over host numpy
    arrays of the model's parameter shapes.  Prints one `FRONTENDS` line
    of results for `check_frontends`."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.mxnet as hmx
    from horovod_tpu_torch.models import zoo_build
    from horovod_tpu_torch.ops import adasum_kernels

    t_start = time.perf_counter()
    hvd.init(device=device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    out = {"rank": r, "size": n, "device": str(dev),
           "backend": hvd.backend()}
    # (a) The callbacks and the tape.
    model = zoo_build(model_name, 1000, compute_dtype=torch.bfloat16,
                      seed=r, image_size=image_size).to(dev)
    model.train()
    params = {k: v.detach() for k, v in model.named_parameters()}
    out["params"] = sum(v.numel() for v in params.values())
    out["initial_sha"] = _tree_sha(params)
    bcast = hvd.callbacks.BroadcastGlobalVariablesCallback(0)
    sync()
    t0 = time.perf_counter()
    synced = bcast.on_train_begin(params)
    sync()
    out["broadcast_ms"] = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        for k, v in synced.items():
            model.get_parameter(k).copy_(v)
    out["broadcast_sha"] = _tree_sha(synced)
    again = {k: v.detach() for k, v in model.named_parameters()}
    out["second_call_same"] = (bcast.on_train_begin(again) is again
                               and _tree_sha(again) == out["broadcast_sha"])
    g = torch.Generator().manual_seed(r)
    x = torch.rand((batch, 3, image_size, image_size), generator=g).to(dev)
    y = torch.randint(0, 1000, (batch,), generator=g).to(dev)
    tape = hvd.DistributedGradientTape(op=hvd.Adasum)
    warmup = hvd.callbacks.LearningRateWarmupCallback(
        warmup_epochs=1, initial_lr=FRONTENDS_LR)

    def loss_fn(p, x, y):
        return F.cross_entropy(functional_call(model, p, (x,)), y)

    adasum_kernels.reset_launch_counts()
    steps = []
    for b in range(FRONTENDS_STEPS):
        lr = warmup.lr(0, FRONTENDS_STEPS, b)
        sync()
        t0 = time.perf_counter()
        loss, grads = tape.gradient(loss_fn, dict(model.named_parameters()),
                                    x, y)
        with torch.no_grad():
            for k, grad in grads.items():
                model.get_parameter(k).sub_(grad, alpha=lr)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({"loss": float(loss), "lr": lr, "ms": ms,
                      "sha": _tree_sha(dict(model.named_parameters()))})
    out["steps"] = steps
    out["launches"] = adasum_kernels.launch_counts()
    last = loss.float()
    out["metric_avg"] = float(hvd.callbacks.MetricAverageCallback()
                              .on_epoch_end({"loss": last})["loss"])
    gathered = hvd.allgather(last.reshape(1))
    out["allgather_mean"] = float((gathered[0] + gathered[1]) / 2)
    out["a_s"] = time.perf_counter() - t_start
    del model, params, synced, again, grads, x, y
    # (b) The MXNet frontend over host arrays of the model's shapes.
    t0 = time.perf_counter()
    shapes = {k: tuple(v.shape) for k, v in zoo_build(
        model_name, 1000, compute_dtype=None, seed=0,
        image_size=image_size).named_parameters()}
    rng = np.random.RandomState(100 + r)
    arrays = {k: rng.standard_normal(sh).astype(np.float32)
              for k, sh in shapes.items()}
    out["mx_initial_sha"] = _tree_sha(arrays)
    out["mx_on_card"] = hmx._to_torch(arrays[next(iter(arrays))]).device.type
    hmx.broadcast_parameters(arrays, root_rank=0)
    out["mx_broadcast_sha"] = _tree_sha(arrays)
    names = sorted(arrays)
    grads = [rng.standard_normal(shapes[k]).astype(np.float32)
             for k in names]
    want = hvd.grouped_allreduce([torch.from_numpy(g_).to(dev)
                                  for g_ in grads], op=hvd.Average)

    class EngineSGD:
        """The engine-level optimizer surface (`update(index, weight,
        grad, state)`) of mx.optimizer.SGD, on numpy arrays."""

        learning_rate = 0.1

        def update(self, index, weight, grad, state):
            if isinstance(index, (list, tuple)):
                for w, g_ in zip(weight, grad):
                    w[:] = w - self.learning_rate * g_
            else:
                weight[:] = weight - self.learning_rate * grad

    opt = hmx.DistributedOptimizer(EngineSGD())
    weights = [arrays[k] for k in names]
    before = [w.copy() for w in weights]
    opt.update(list(range(1, len(names))), weights[1:], grads[1:],
               [None] * (len(names) - 1))
    opt.update(0, weights[0], grads[0], None)
    out["mx_grads_bitwise"] = all(
        np.array_equal(g_, w_.cpu().numpy()) for g_, w_ in zip(grads, want))
    out["mx_applied"] = all(
        np.array_equal(w, b_ - np.float32(0.1) * g_)
        for w, b_, g_ in zip(weights, before, grads))
    out["mx_arrays"] = len(names)
    out["b_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_start
    print("FRONTENDS " + json.dumps(out), flush=True)
    hvd.shutdown()
    return 0


def check_frontends(lines, smi: str, on_card: bool = True) -> dict:
    """Phase 27's checks on each rank's lines (`frontends_rank`)."""
    phase = "frontends"
    recs = [_records(ls, "FRONTENDS")[-1] for ls in lines]
    r0 = recs[0]
    for rec in recs:
        r = rec["rank"]
        require(rec["size"] == 2 and rec["backend"] == "gloo",
                f"rank {r}: size {rec['size']}, backend {rec['backend']}")
        require(not on_card or rec["device"].startswith("cuda"),
                f"rank {r} ran on {rec['device']}")
        require(rec["params"] == MAIN_N or not on_card,
                f"rank {r}: {rec['params']} parameters, not {MAIN_N}")
        require(rec["broadcast_sha"] == r0["initial_sha"],
                f"rank {r}: the broadcast tree is not rank 0's initial one")
        require(rec["second_call_same"], f"rank {r}: the second "
                "on_train_begin changed the parameters")
        require(len(rec["steps"]) == FRONTENDS_STEPS and all(
            math.isfinite(s["loss"]) for s in rec["steps"]),
            f"rank {r}: steps {rec['steps']}")
        require(not on_card or all(c > 0 for c in rec["launches"].values()),
                f"rank {r}: K1/K2 launches {rec['launches']}")
        require(rec["metric_avg"] == rec["allgather_mean"],
                f"rank {r}: MetricAverageCallback {rec['metric_avg']} is not "
                f"the allgathered mean {rec['allgather_mean']}")
        require(rec["mx_broadcast_sha"] == r0["mx_initial_sha"],
                f"rank {r}: the MXNet arrays are not rank 0's")
        require(rec["mx_grads_bitwise"] and rec["mx_applied"],
                f"rank {r}: MXNet DistributedOptimizer's gradients are not "
                "the grouped Average's bitwise, or its update did not apply")
        require(not on_card or rec["mx_on_card"] == "cuda",
                f"rank {r}: the MXNet frontend's tensors on "
                f"{rec['mx_on_card']}")
    for i in range(FRONTENDS_STEPS):
        shas = {rec["steps"][i]["sha"] for rec in recs}
        require(len(shas) == 1, f"step {i}: parameters differ {shas}")
    require(r0["initial_sha"] != recs[1]["initial_sha"],
            "the ranks started from the same parameters")
    for rec in recs:
        log(phase, f"rank {rec['rank']}: ({smi}) callbacks broadcast "
            f"{rec['broadcast_ms']:.1f} ms, one SHA-256 {rec['broadcast_sha'][:16]}"
            " = rank 0's initial tree; tape(Adasum) steps "
            + ", ".join(f"loss {s['loss']:.4f} lr {s['lr']:.6f} "
                        f"{s['ms']:.1f} ms" for s in rec["steps"])
            + f"; K1/K2 launches {rec['launches']}; metric average "
            f"{rec['metric_avg']!r} = allgathered mean; (a) {rec['a_s']:.1f} s"
            f"; MXNet: {rec['mx_arrays']} arrays broadcast bitwise, "
            f"DistributedOptimizer's gradients bitwise the grouped Average; "
            f"(b) {rec['b_s']:.1f} s; {rec['phase_s']:.1f} s in all")
    phase_s = max(rec["phase_s"] for rec in recs)
    log(phase, f"{phase_s:.1f} s (budget {FRONTENDS_BUDGET_S} s), {smi}")
    require(phase_s <= FRONTENDS_BUDGET_S,
            f"{phase}: over its budget of {FRONTENDS_BUDGET_S} s")
    return {"launches": [rec["launches"] for rec in recs],
            "phase_s": phase_s,
            "step_ms": [[s["ms"] for s in rec["steps"]] for rec in recs]}


def frontends_phase(ctx) -> dict:
    """Phase 27: checks the folded run of the adasum pair, or runs it in
    a pair of its own (`--phases frontends`)."""
    lines = ctx.get("frontends_lines")
    if lines is None:
        lines = launch_folded("frontends", 2, [FRONTENDS_RUN],
                              timeout=300)[0][1]
    return check_frontends(lines, ctx["smi"])


# ---------------------------------------------------------------------------
# Phase 28: the cluster integrations (spark: the barrier mapper and the
# torch estimator's worker loop)
# ---------------------------------------------------------------------------

CLUSTER_BUDGET_S = 60  # phase 28's share of the script's time limit
CLUSTER_BATCH = 32     # rows a rank a step
CLUSTER_STEPS = 3      # steps a rank in its one epoch
CLUSTER_VAL_ROWS = 32  # the validation split, evaluated on rank 0
CLUSTER_LR = 0.0125    # SGD, the benchmark's rate
CLUSTER_PAYLOAD_WAIT_S = 180  # a rank's wait for the driver's payload


class _BarrierCtx:
    """The BarrierTaskContext surface a barrier task's mapper reads
    (`partitionId`, `getTaskInfos`, `barrier`), its barrier on the
    rendezvous KV, as tests/data/spark_task_main.py's."""

    class _Info:
        address = "127.0.0.1:0"

    def __init__(self, rank: int, size: int, client):
        self._rank, self._size, self._client = rank, size, client

    def partitionId(self):  # noqa: N802 — pyspark's name
        return self._rank

    def getTaskInfos(self):  # noqa: N802
        return [self._Info() for _ in range(self._size)]

    def barrier(self):
        self._client.barrier("cluster_stage", self._size, timeout=120)


def cluster_setup() -> dict:
    """Phase 28's store and the rendezvous server whose KV is the barrier
    tasks' barrier, and the env of their run (`cluster_rank` reads it):
    what a run needs before `cluster_prepare` has written its payload
    (the whole run starts the ranks' pair meanwhile)."""
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    from horovod_tpu_torch.spark.common.store import Store

    store = Store.create(None)
    server = RendezvousServer()
    port = server.start()
    run_id = "cluster"
    return {"env": {"CLUSTER_PAYLOAD": os.path.join(store.prefix_path,
                                                    "payload.b64"),
                    "CLUSTER_RDV_PORT": str(port),
                    "CLUSTER_RDV_SECRET": server.secret,
                    "CLUSTER_COORD_PORT": str(_free_port()),
                    "CLUSTER_CKPT": store.get_checkpoint_path(run_id)},
            "server": server, "store": store, "run_id": run_id}


def cluster_prepare(setup: dict, depth: int = 50, image_size: int = 224,
                    batch: int = CLUSTER_BATCH, device=None) -> dict:
    """Phase 28's driver side, as `TorchEstimator.fit` does it before its
    backend runs: the shards in `setup`'s store (`prepare_data` on a
    frame of seeded numpy rows where pandas imports, else the store's
    own numpy shard writer), the spec of the estimator's remote trainer
    (the seeded model `Sequential(Unflatten, ResNet(depth))` serialized,
    SGD, `F.cross_entropy`), and its payload for `make_barrier_mapper`,
    written whole at CLUSTER_PAYLOAD (or, where this fails, the error at
    CLUSTER_PAYLOAD.failed, which the ranks raise).  Returns `setup`
    with what it did."""
    import traceback

    try:
        return _cluster_prepare(setup, depth, image_size, batch, device)
    except BaseException:
        with open(setup["env"]["CLUSTER_PAYLOAD"] + ".failed", "w") as f:
            f.write(traceback.format_exc())
        raise


def _cluster_prepare(setup, depth, image_size, batch, device) -> dict:
    import base64
    import pickle

    import numpy as np
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models.resnet import ResNet
    from horovod_tpu_torch.spark.common import util
    from horovod_tpu_torch.spark.common.store import part_name
    from horovod_tpu_torch.spark.torch import (TorchEstimator,
                                               _torch_remote_trainer)

    t0 = mark = time.perf_counter()
    spans = {}

    def span(name):
        nonlocal mark
        now = time.perf_counter()
        spans[name] = now - mark
        mark = now

    try:
        import pandas as pd
    except ImportError:
        pd = None
    branch = "numpy" if pd is None else "pandas"
    span("probe")
    n_train = 2 * batch * CLUSTER_STEPS
    rows = n_train + CLUSTER_VAL_ROWS
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, 3 * image_size * image_size),
                            dtype=np.float32)
    y = rng.integers(0, 1000, size=rows)
    is_val = np.zeros(rows, bool)
    is_val[rng.permutation(rows)[:CLUSTER_VAL_ROWS]] = True
    store, run_id = setup["store"], setup["run_id"]
    span("rows")
    if pd is not None:
        meta = util.prepare_data(
            pd.DataFrame({"features": list(x), "label": y,
                          "is_val": is_val}),
            store, run_id, 2, ["features"], ["label"], validation="is_val",
            seed=0)
    else:
        train_dir = store.get_train_data_path(run_id)
        val_dir = store.get_val_data_path(run_id)
        store.mkdirs(train_dir)
        store.mkdirs(val_dir)
        tr = np.flatnonzero(~is_val)
        per_rank = batch * CLUSTER_STEPS
        for r in range(2):
            shard = tr[r * per_rank:(r + 1) * per_rank]
            util._write_shard(store, os.path.join(train_dir, part_name(r)),
                              x[shard], y[shard, None])
        util._write_shard(store, os.path.join(val_dir, util.VAL_BASE),
                          x[is_val], y[is_val, None])
        meta = {"train_rows": n_train, "val_rows": CLUSTER_VAL_ROWS,
                "features_dim": x.shape[1], "labels_dim": 1}
    span("shards")
    model = torch.nn.Sequential(
        torch.nn.Unflatten(1, (3, image_size, image_size)),
        ResNet(depth, 1000, seed=0))
    span("model")
    est = TorchEstimator(
        model=model, optimizer=torch.optim.SGD(model.parameters(),
                                               lr=CLUSTER_LR),
        loss=F.cross_entropy, feature_cols=["features"],
        label_cols=["label"], validation="is_val", batch_size=batch,
        epochs=1, random_seed=0, store=store, run_id=run_id, device=device)
    est._validate_params()
    spec = est._build_spec(store, run_id, meta)
    span("spec")
    payload = setup["env"]["CLUSTER_PAYLOAD"]
    with open(payload + ".tmp", "w") as f:
        f.write(base64.b64encode(pickle.dumps(
            (_torch_remote_trainer, (spec,), {}))).decode())
    os.replace(payload + ".tmp", payload)
    span("payload")
    setup.update(branch=branch, meta=meta, spans=spans,
                 model_mb=len(spec["model_bytes"]) / 1e6,
                 prep_s=time.perf_counter() - t0)
    how = ("prepare_data on a DataFrame" if branch == "pandas"
           else "the store's numpy writer")
    log("cluster", f"driver: the shards from the {branch} branch ({how}), "
        f"{meta}; the spec's model {setup['model_mb']:.1f} MB; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in spans.items())
        + f"; {setup['prep_s']:.1f} s in all")
    return setup


def cluster_finish(setup: dict) -> None:
    setup["server"].stop()
    setup["store"].cleanup()


def cluster_rank() -> int:
    """One barrier task of phase 28 (a folded run of the adasum pair, or of
    a pair of its own): the port's `make_barrier_mapper` under a fake
    `BarrierTaskContext` runs the payload `cluster_prepare` wrote (the
    torch estimator's remote trainer); the mapper's env bootstraps the
    trainer's `hvd.init()`.  Global optimizer hooks record the
    parameters' SHA-256 before the first step (after the broadcast) and
    after each step; rank 0 loads the module it returns and the
    checkpoint, in its own process.  Prints one `CLUSTER` line."""
    import base64
    import io
    import pickle

    import torch
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.spark as hs
    from horovod_tpu_torch.ops import adasum_kernels, flash_attention
    from horovod_tpu_torch.ops import matmul_kernels
    from horovod_tpu_torch.runner.rendezvous import RendezvousClient

    t_start = time.perf_counter()
    env = os.environ
    rank, size = int(env["HOROVOD_PROCESS_ID"]), int(env["HOROVOD_NUM_PROCESSES"])
    port, secret = int(env["CLUSTER_RDV_PORT"]), env["CLUSTER_RDV_SECRET"]
    path = env["CLUSTER_PAYLOAD"]
    deadline = time.monotonic() + CLUSTER_PAYLOAD_WAIT_S
    while not os.path.exists(path):  # `cluster_prepare` still writing
        if os.path.exists(path + ".failed"):
            with open(path + ".failed") as f:
                raise RuntimeError("the driver's side failed:\n" + f.read())
        require(time.monotonic() < deadline, f"no payload at {path} within "
                f"{CLUSTER_PAYLOAD_WAIT_S} s")
        time.sleep(0.05)
    wait_s = time.perf_counter() - t_start
    with open(path) as f:
        payload = f.read()
    hs.COORDINATOR_PORT = int(env["CLUSTER_COORD_PORT"])
    mapper = hs.make_barrier_mapper(payload, "127.0.0.1", port, secret)
    ctx = _BarrierCtx(rank, size, RendezvousClient("127.0.0.1", port, secret))
    digests, marks = [], []

    def params(opt):
        return [p for g in opt.param_groups for p in g["params"]]

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def pre(opt, args, kwargs):
        if not digests:  # the first step's: what the broadcast left
            digests.append(_sha(params(opt)))

    def post(opt, args, kwargs):
        sync()
        t = time.perf_counter()
        digests.append(_sha(params(opt)))
        marks.append((t, time.perf_counter()))

    for k in (adasum_kernels, flash_attention, matmul_kernels):
        k.reset_launch_counts()
    saved = dict(os.environ)
    hooks = [register_optimizer_step_pre_hook(pre),
             register_optimizer_step_post_hook(post)]
    t0 = time.perf_counter()
    try:
        (out_rank, data), = list(mapper(rank, iter([]), ctx=ctx))
    finally:
        for h in hooks:
            h.remove()
        os.environ.clear()
        os.environ.update(saved)
    mapper_s = time.perf_counter() - t0
    launches = {**adasum_kernels.launch_counts(),
                **flash_attention.launch_counts(),
                **matmul_kernels.launch_counts()}
    out = {"rank": out_rank, "size": hvd.size(), "backend": hvd.backend(),
           "device": str(hvd.device()), "digests": digests,
           "first_step_end_s": marks[0][0] - t0 if marks else None,
           "step_ms": [(b[0] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])],
           "launches": launches, "mapper_s": mapper_s, "wait_s": wait_s}
    hvd.shutdown()
    result = pickle.loads(base64.b64decode(data))
    if out_rank == 0:
        t1 = time.perf_counter()
        module = torch.load(io.BytesIO(result["model"]), weights_only=False)
        tensors = list(module.state_dict().values())
        out.update(history=result["history"],
                   returned_cpu=all(t.device.type == "cpu" for t in tensors),
                   returned_params=sum(p.numel() for p in module.parameters()),
                   returned_sha=_sha(module.parameters()),
                   returned_mb=len(result["model"]) / 1e6)
        with open(env["CLUSTER_CKPT"], "rb") as f:
            state = pickle.load(f)["state_dict"]
        module.load_state_dict(state)
        out.update(ckpt_cpu=all(t.device.type == "cpu"
                                for t in state.values()),
                   ckpt_sha=_sha(module.parameters()),
                   load_s=time.perf_counter() - t1)
    else:
        out["result"] = result
    out["phase_s"] = time.perf_counter() - t_start
    print("CLUSTER " + json.dumps(out), flush=True)
    return 0


CLUSTER_RUN = dict(phase="cluster", module="chip_smoke",
                   args=["--cluster-rank"], raw=True)


def check_cluster(lines, prep: dict, smi: str, on_card: bool = True) -> dict:
    """Phase 28's checks on each rank's lines (`cluster_rank`)."""
    phase = "cluster"
    recs = [_records(ls, "CLUSTER")[-1] for ls in lines]
    r0 = recs[0]
    for rec in recs:
        r = rec["rank"]
        require(rec["size"] == 2 and rec["backend"] == "gloo",
                f"rank {r}: size {rec['size']}, backend {rec['backend']}")
        require(not on_card or rec["device"].startswith("cuda"),
                f"rank {r} ran on {rec['device']}")
        require(len(rec["digests"]) == CLUSTER_STEPS + 1,
                f"rank {r}: {len(rec['digests'])} digests, want the "
                f"broadcast's and {CLUSTER_STEPS} steps'")
        require(not any(rec["launches"].values()),
                f"rank {r}: path 18 launched a kernel {rec['launches']}")
    for i in range(CLUSTER_STEPS + 1):
        shas = {rec["digests"][i] for rec in recs}
        require(len(shas) == 1, f"{'broadcast' if i == 0 else f'step {i}'}"
                f": parameters differ {shas}")
    require(recs[1]["result"] is None, "rank 1 shipped a result")
    hist = r0["history"]
    require(len(hist["loss"]) == len(hist["val_loss"]) == 1 and all(
        math.isfinite(v) for v in hist["loss"] + hist["val_loss"]),
        f"history {hist}")
    require(r0["returned_cpu"] and r0["ckpt_cpu"],
            "the returned module or the checkpoint holds non-CPU tensors")
    require(r0["returned_params"] == MAIN_N or not on_card,
            f"{r0['returned_params']} parameters returned, not {MAIN_N}")
    require(r0["returned_sha"] == r0["ckpt_sha"] == r0["digests"][-1],
            "the returned module or the checkpoint is not the last step's "
            "parameters")
    for rec in recs:
        log(phase, f"rank {rec['rank']}: ({smi}) {rec['backend']} on "
            f"{rec['device']}, one SHA-256 after the broadcast "
            f"{rec['digests'][0][:16]} and after each of {CLUSTER_STEPS} "
            f"steps, the last {rec['digests'][-1][:16]}; the first step "
            f"ended {rec['first_step_end_s']:.1f} s into the mapper, then "
            "steps " + ", ".join(f"{ms:.1f}" for ms in rec["step_ms"])
            + f" ms (a SHA-256 of each step left out); launches "
            f"{rec['launches']}; the mapper {rec['mapper_s']:.1f} s, "
            f"{rec['phase_s']:.1f} s in all ({rec['wait_s']:.1f} s of it "
            "waiting for the driver's payload)")
    log(phase, f"rank 0: history {hist}, the module shipped back "
        f"{r0['returned_mb']:.1f} MB with CPU tensors "
        f"({r0['returned_params']} parameters), the store's checkpoint "
        f"the same parameters; loaded in {r0['load_s']:.1f} s")
    phase_s = prep["prep_s"] + max(rec["phase_s"] - rec["wait_s"]
                                   for rec in recs)
    log(phase, f"{phase_s:.1f} s (the driver's {prep['prep_s']:.1f} s and "
        f"the ranks' after it; budget {CLUSTER_BUDGET_S} s), {smi}")
    require(phase_s <= CLUSTER_BUDGET_S,
            f"{phase}: over its budget of {CLUSTER_BUDGET_S} s")
    return {"phase_s": phase_s, "branch": prep["branch"],
            "step_ms": [rec["step_ms"] for rec in recs],
            "history": hist, "launches": [rec["launches"] for rec in recs]}


def cluster_phase(ctx) -> dict:
    """Phase 28: checks the folded run of the adasum pair, or prepares and
    runs it in a pair of its own (`--phases cluster`)."""
    if ctx.get("cluster_lines") is None:
        prep = cluster_setup()
        try:
            cluster_prepare(prep)
            lines = launch_folded("cluster", 2, [dict(
                CLUSTER_RUN, env=prep["env"])], timeout=300)[0][1]
        finally:
            cluster_finish(prep)
        return check_cluster(lines, prep, ctx["smi"])
    return check_cluster(ctx["cluster_lines"], ctx["cluster_prep"],
                         ctx["smi"])


# ---------------------------------------------------------------------------
# Phase 29: the sharded paths over NCCL, one rank a card (main path 19)
# ---------------------------------------------------------------------------

MULTICARD_RANKS = 4
MULTICARD_BUDGET_S = 600  # the group's aim by its own count (logged)
MULTICARD_RUN_S = 240     # each run's own time limit (`fold_rank`)
MULTICARD_RESNET = ["--model", "resnet50", "--num-classes", "1000",
                    "--image-size", "224", "--batch-size", "32",
                    "--num-warmup-batches", "0", "--num-batches-per-iter",
                    "1", "--num-iters", "3", "--log-steps"]
MULTICARD_ADASUM = MULTICARD_RESNET + ["--use-adasum", "--check-plain-step",
                                       "1"]
# name, mesh flags, other flags: dp fills the four ranks where no flag
# names it (`--dp -1`); ep_sp is ep=2 x sp=2 with the ring, dp=1.
MULTICARD_MESHES = [
    ("ring", ["--sp", "2"], []),
    ("ulysses", ["--sp", "2", "--attn", "ulysses"], []),
    ("tp", ["--tp", "2"], []),
    ("ep", ["--ep", "2", "--moe-every", "2", "--n-experts", "8"], []),
    ("pp", ["--pp", "2"], ["--batch-size", "2"]),
    ("ep_sp", ["--ep", "2", "--sp", "2", "--moe-every", "2",
               "--n-experts", "8"], []),
]
MULTICARD_MESH_LAYERS = 4  # train_mesh's depth
MULTICARD_STAGE0 = ["--num-warmup-batches", "0", "--num-batches-per-iter",
                    "1", "--num-iters", "3", "--log-steps",
                    "--check-plain-step", "1"]
MULTICARD_DECODE_RUN = dict(phase="multicard_decode", module="chip_smoke",
                            args=["--decode-mesh-rank"], raw=True)


def multicard_cards() -> list:
    """The visible cards' names; raises unless there are
    MULTICARD_RANKS of them (no fallback to ranks sharing a card)."""
    import torch

    names = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    if len(names) < MULTICARD_RANKS:
        raise RuntimeError(
            f"multicard: one rank a card needs {MULTICARD_RANKS} cards; "
            f"found {len(names)}: {names}")
    return names


def adasum_levels(n: int, idx: int) -> int:
    """The pair combines (one K1 and one K2 launch each) set rank idx of
    n runs in one XOR ladder (`adasum_in_axis`): the fold on ranks below
    n - 2^k, one a level below 2^k; a rank at or above 2^k sends its
    vector and gets the result."""
    k = 1 << (n.bit_length() - 1)
    return int(idx < n - k) + (k.bit_length() - 1) * int(idx < k)


def _own_card(phase: str, s: dict, r: int, on_card: bool = True) -> None:
    """Rank r ran on NCCL on card r (over gloo on the CPU, rehearsing)."""
    want = ("nccl", f"cuda:{r}") if on_card else ("gloo", "cpu")
    require((s["backend"], s["device"]) == want,
            f"{phase} rank {r}: {s['backend']} on {s['device']} (want "
            f"{want})")


def check_ladder(phase: str, summaries, lines, on_card: bool = True) -> list:
    """Each rank's K1 and K2 launches every step: `adasum_levels` (the
    fused delta is one ladder a step), the check's tree left out (on the
    CPU the plain versions launch nothing); the ranks on NCCL, each on
    its own card."""
    n = len(summaries)
    per_rank = []
    for r, (s, rank_lines) in enumerate(zip(summaries, lines)):
        _own_card(phase, s, r, on_card)
        want = adasum_levels(n, r) if on_card else 0
        before = dict.fromkeys(s["launches"], 0)
        for rec in _records(rank_lines, "STEP"):
            for name in ADASUM_GROW:
                got = (rec["launches"][name] - before[name]
                       - rec.get("check_launches", {}).get(name, 0))
                require(got == want, f"{phase} rank {r} step "
                        f"{rec['step']}: {name} launched {got} times (want "
                        f"{want}, the ladder's combines on this rank)")
            before = rec["launches"]
        per_rank.append(want)
    log(phase, f"K1 and K2 launches a step per rank {per_rank} (the "
        f"ladder's combines at {n} ranks), every rank on NCCL on its own "
        "card")
    return per_rank


def decode_mesh_rank(cfg=None, device=None, prompt_len=None) -> int:
    """One rank of phase 29 (e) (`python -m chip_smoke
    --decode-mesh-rank`, one a card): `make_decode_step` over dp=2 x
    tp=2 on the default TransformerConfig in bf16, two prompts of
    serve_prompt_len tokens (K4 at the prefill, on each rank's 4 heads),
    SERVE_NEW greedy tokens of this rank's row from the mesh's own
    logits; then every token held to the one-rank reference chain on the
    full parameters (`teacher_forced`), and the tp pair's tokens equal.
    Prints one DECODE_MESH line.  `cfg`, `device` and `prompt_len`
    rehearse it on the CPU at a small size."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import decode as D
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

    hvd.init(device=device)
    r, dev = hvd.rank(), hvd.device()
    cfg = cfg or T.TransformerConfig()
    full = T.transformer_init(0, cfg)
    mesh = create_hybrid_mesh(dp=2, tp=2)
    B, T0, new = 2, prompt_len or serve_prompt_len(FA), SERVE_NEW

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    prompt = torch.randint(0, cfg.vocab_size, (B, T0),
                           generator=torch.Generator().manual_seed(19))
    b = D.make_decode_step(mesh, cfg)
    sp = D.decode_params(b.shard_params(full), cfg)
    sc = b.shard_cache(D.init_decode_cache(cfg, B, T0 + new, device="cpu"))
    FA.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    lg, sc = b.prefill(sp, sc, b.shard_tokens(prompt))
    served = []
    for i in range(new):
        served.append(torch.argmax(lg, -1))
        if i + 1 < new:
            lg, sc = b.step(sp, sc, served[-1])
    sync()
    wall = time.perf_counter() - t0
    launches, sm90 = FA.launch_counts(), FA.sm90_launch_counts()
    served = torch.stack(served, 1)
    pair = hvd.allgather(served[None], process_set=mesh.sets["tp"])
    heads = int(sp["blocks"]["wq"].shape[2])
    del sp, sc, lg
    rows = B // mesh.size("dp")
    mine = prompt[mesh.index("dp") * rows:(mesh.index("dp") + 1) * rows]
    params = D.decode_params(T.tree_map(lambda a: a.to(dev), full), cfg)
    held, ties, before_tie = teacher_forced(D, params, cfg, mine.to(dev),
                                            served)
    res = {"rank": r, "backend": hvd.backend(), "device": str(dev),
           "prompt_len": T0,
           "coords": {a: mesh.index(a) for a in ("dp", "tp")},
           "heads": heads, "n_layers": cfg.n_layers,
           "tokens": served.cpu().tolist(),
           "tp_pair_equal": bool(torch.equal(pair[0], pair[1])),
           "held": held, "ties": ties, "before_tie": before_tie,
           "launches": launches, "sm90": sm90, "wall_s": wall}
    print("DECODE_MESH " + json.dumps(res), flush=True)
    hvd.shutdown()
    return 0


def check_decode_mesh(lines, on_card: bool = True) -> list:
    """Phase 29 (e)'s checks on its ranks' DECODE_MESH lines (the
    launches and the cards only `on_card`)."""
    res = [_records(rank_lines, "DECODE_MESH")[-1] for rank_lines in lines]
    for r, d in enumerate(res):
        _own_card("multicard_decode", d, r, on_card)
        require(d["tp_pair_equal"], f"multicard_decode rank {r}: the tp "
                "pair generated different tokens")
        require(d["held"] == SERVE_NEW * len(d["tokens"]),
                f"multicard_decode rank {r}: {d['held']} tokens held")
        require(not on_card or d["launches"]["flash_fwd"] == d["n_layers"]
                == d["sm90"]["flash_fwd"]
                and d["launches"]["flash_bwd_dq"] == 0,
                f"multicard_decode rank {r}: K4 launches {d['launches']} "
                f"(tensor cores {d['sm90']})")
        log("multicard_decode", f"rank {r} {d['coords']}: a prefill of "
            f"{d['prompt_len']} tokens and {SERVE_NEW} generated tokens, "
            f"every one held to the one-rank chain ({d['ties']} at a "
            f"near-tie, {d['before_tie']} before the row's first), the tp "
            f"pair's equal; K4 {d['launches']['flash_fwd']} launches on "
            f"the tensor cores; {d['wall_s']:.3f} s")
    return res


def multicard_phase(smi_lines, on_card: bool = True) -> dict:
    """Phase 29 (main path 19): the sharded paths over NCCL, one rank a
    card (`--phases multicard`, outside the whole run); see the module
    docstring.  `on_card=False` rehearses it on the CPU (the argument
    lists extended with the trainers' CPU flags): the same runs and
    checks but for the launch counts, the cards and memory."""
    cards = multicard_cards() if on_card else []
    for line in smi_lines:
        log("multicard", f"card: {line}")
    t_start = time.perf_counter()
    # (a) at three ranks: the ladder's fold and its last hop.
    ((np3, np3_lines),) = launch_folded("multicard_np3", 3, [dict(
        phase="multicard_adasum_np3", args=MULTICARD_ADASUM,
        limit=MULTICARD_RUN_S)], timeout=MULTICARD_RUN_S)
    out = {"adasum_np3": check_ladder("multicard_adasum_np3", np3,
                                      np3_lines, on_card)}
    meshes = [dict(phase=f"multicard_mesh_{name}",
                   args=mesh + extra + MESH_ARGS + [
                       "--n-layers", str(MULTICARD_MESH_LAYERS)],
                   module=TRANSFORMER, env=MESH_ENV,
                   grow={n: None for n in FLASH_NAMES} if on_card else {})
              for name, mesh, extra in MULTICARD_MESHES]
    flash = FLASH_GROW if on_card else {}
    runs = [dict(phase="multicard_adasum_np4", args=MULTICARD_ADASUM),
            dict(phase="multicard_int8", args=MULTICARD_RESNET + [
                "--compression", "int8", "--check-wire-step", "1"]),
            dict(phase="multicard_hier", args=MULTICARD_RESNET + [
                "--dcn", "2", "--check-hier-step", "1"], env=HIER_ENV),
            *meshes,
            dict(phase="multicard_stage0", args=MULTICARD_STAGE0,
                 module=TRANSFORMER, grow=flash),
            dict(phase="multicard_zero3", args=ZERO3_ARGS,
                 module=TRANSFORMER, env=ZERO3_ENV, grow=flash),
            dict(MULTICARD_DECODE_RUN)]
    for run in runs:
        run["limit"] = MULTICARD_RUN_S
    t0 = time.perf_counter()
    done = dict(zip([r["phase"] for r in runs], launch_folded(
        "multicard_np4", MULTICARD_RANKS, runs,
        timeout=MULTICARD_RUN_S * len(runs))))
    log("multicard", f"{time.perf_counter() - t0:.1f} s for {len(runs)} "
        f"runs in one set of {MULTICARD_RANKS} processes")
    for phase, (summaries, _) in done.items():
        for r, s in enumerate(summaries or []):
            _own_card(phase, s, r, on_card)
    # (a) at four ranks, then Average on the int8 ring.
    out["adasum_np4"] = check_ladder(
        "multicard_adasum_np4", *done["multicard_adasum_np4"], on_card)
    steps = [_records(lines, "STEP") for lines in done["multicard_int8"][1]]
    _check_ring_steps("multicard_int8", steps)
    (check,) = [rec["wire_check"] for rec in steps[0] if "wire_check" in rec]
    flushed = steps[0][1]["flushes"] - steps[0][0]["flushes"]
    require(check["bitwise"] and check["bound_ok"]
            and check["buckets"] == flushed,
            f"multicard_int8: ring vs its plain model {check} ({flushed} "
            "buckets flushed)")
    log("multicard_int8", f"step 1, rank 0: {check['buckets']} buckets on "
        f"the int8 ring bitwise the plain ring model over the four ranks' "
        f"inputs, within its bound of the exact mean (largest distance "
        f"{check['exact_max_abs_diff']:.3g})")
    out["int8"] = check
    # (d) the hierarchical legs.
    summ, hier_lines = done["multicard_hier"]
    (chk,) = [rec for rec in _records(hier_lines[0], "STEP")
              if "hier_rel" in rec]
    require(chk["hier_rel"] <= HIER_RTOL,
            f"multicard_hier: hierarchical vs flat allreduce "
            f"{chk['hier_rel']} > {HIER_RTOL}")
    require(0 < chk["int8_err"] <= chk["int8_bound"],
            f"multicard_hier: the int8 dcn leg {chk['int8_err']} off the "
            f"exact one (bound {chk['int8_bound']})")
    require(all(s["dcn"] == 2 for s in summ), f"multicard_hier: {summ}")
    log("multicard_hier", f"step 1, rank 0: ResNet-50's gradients over "
        f"ici {{0,1}} {{2,3}} and dcn {{0,2}} {{1,3}} vs the flat allreduce "
        f"{chk['hier_rel']:.3g} of the largest {chk['grad_top']:.3g} (tol "
        f"{HIER_RTOL}); int8 dcn wire {chk['int8_err']:.3g} off the exact "
        f"leg (bound {chk['int8_bound']:.3g})")
    out["hier"] = chk
    # (b) the meshes.
    out["mesh_launches"] = {}
    for name, _, _ in MULTICARD_MESHES:
        phase = f"multicard_mesh_{name}"
        summaries, lines = done[phase]
        if on_card:
            check_mesh_run(phase, name, summaries)
        out["mesh_launches"][name] = [
            {k: s["launches"][k] - s["check_launches"].get(k, 0)
             for k in FLASH_NAMES} for s in summaries]
        for s, p in zip(summaries, [_records(rank_lines, "PROFILE")[-1]
                                    for rank_lines in lines]):
            ranges = {k: round(v, 1)
                      for k, v in p["ranges_ms_per_step"].items()
                      if k.startswith(("hvd.", "bench.check"))}
            log(phase, f"rank {s['rank']} {s['coords']}: "
                f"{s['tok_sec_per_rank_net']:.1f} tok/sec per rank without "
                f"the checks, profiled step {p['wall_ms_per_step']:.1f} ms, "
                f"idle {p['device_idle_share']}, host ms {ranges}")
    # (c) ZeRO-3 against stage 0 at four ranks.
    stage0 = done["multicard_stage0"][0]
    zero3 = done["multicard_zero3"][0]
    require(all(s["steps"] == 3 for s in stage0 + zero3),
            f"multicard: steps {[s['steps'] for s in stage0 + zero3]}")
    if on_card:
        train_zero3(zero3, stage0, phase="multicard_zero3")
    out["stage0_launches"] = [s["launches"] for s in stage0]
    out["zero3_launches"] = [s["launches"] for s in zero3]
    out["k3_launches"] = [s["evals"][0]["k3_launches"] for s in zero3]
    for s0, s3 in zip(stage0, zero3):
        log("multicard_zero3", f"rank {s3['rank']}: stage 0 "
            f"{s0['tok_sec_per_rank']:.1f}, stage 3 "
            f"{s3['tok_sec_per_rank']:.1f} tok/sec per rank (3 steps, "
            f"checks included), peak {s0['peak_mem_gb']} and "
            f"{s3['peak_mem_gb']} GB, losses {s0['step_losses']} and "
            f"{s3['step_losses']}")
    # (e) decode over dp x tp.
    out["decode"] = check_decode_mesh(done["multicard_decode"][1], on_card)
    out["cards"] = cards
    out["phase_s"] = time.perf_counter() - t_start
    log("multicard", f"{out['phase_s']:.1f} s (aim {MULTICARD_BUDGET_S} s)")
    return out


# ---------------------------------------------------------------------------
# The whole run's phases, in groups
# ---------------------------------------------------------------------------

def _group_adasum(ctx) -> None:
    """Phases 4 and 12 (one pair of processes, `launch_folded`, which
    runs phase 27's and phase 28's ranks too; the `frontends` and
    `cluster` groups check them)."""
    from concurrent.futures import ThreadPoolExecutor

    prep = ctx["cluster_prep"] = cluster_setup()
    try:
        # Phase 28's driver side runs beside the pair's earlier runs (the
        # ranks wait for its payload): it is host work while they keep
        # the card busy.
        with ThreadPoolExecutor(1) as pool:
            prepared = pool.submit(cluster_prepare, prep)
            (ctx["adasum"], autotune_run, ctx["frontends_lines"],
             ctx["cluster_lines"]) = adasum_and_autotune(prep)
            prepared.result()
    finally:
        cluster_finish(prep)
    train_adasum(ctx["adasum"])
    autotune_np2(autotune_run)


def _group_singles(ctx) -> None:
    """The one-rank runs of phases 5, 7, 9, 19 (a) and bench_np1 (one
    process); phases 5, 7 and 9 checked."""
    singles = ctx["singles"] = single_rank_runs()
    train_average(singles["train_average"][0][0])
    nccl_summary = transformer_nccl(singles["transformer_nccl"][0][0])
    zero3_nccl(singles["zero3_nccl"][0][0], nccl_summary)


def _group_transformer(ctx) -> None:
    """Phases 6 and 8 (one pair of processes under the launcher)."""
    stage0, zero3_run = transformer_and_zero3()
    ctx["transformer"] = train_transformer(stage0)
    ctx["zero3"] = train_zero3(zero3_run, stage0)


def _group_surface_mnist(ctx) -> None:
    """Phases 10 and 14 side by side on the card: both check results and
    print no rate."""
    concurrently([surface_np2, mnist_np2])


def _group_wire(ctx) -> None:
    """bench_np2 and phase 16's int8 run (one pair), phase 15's rows and
    phase 16."""
    bench_np2, int8 = bench_and_int8()
    bench = bench_rows(ctx["singles"]["bench_np1"][1], bench_np2)
    ctx["codecs"] = check_codecs()
    wire = ctx["wire"] = train_wire(ctx["zero3"], int8)
    log("train_wire", f"int8 ring {wire['int8']['img_sec']} img/sec per "
        f"rank beside this call's exact gloo bench_np2 hvd row "
        f"{bench['bench_np2']['value']:.2f}")


def _group_serve(ctx) -> None:
    """Phase 18, within its budget."""
    from horovod_tpu_torch.ops import flash_attention as FA

    t0 = time.perf_counter()
    ctx["serve"] = serve_phase(FA, ctx["smi"])
    log("serve", f"{time.perf_counter() - t0:.1f} s (budget {SERVE_BUDGET_S}"
        " s)")
    require(time.perf_counter() - t0 <= SERVE_BUDGET_S,
            f"serve: over its budget of {SERVE_BUDGET_S} s")


def _group_replicas(ctx) -> None:
    """Phase 26."""
    from horovod_tpu_torch.ops import flash_attention as FA

    ctx["replicas"] = replicas_phase(FA, ctx["smi"])


def _group_frontends(ctx) -> None:
    """Phase 27 (its ranks folded into the adasum pair in the whole
    run)."""
    ctx["frontends"] = frontends_phase(ctx)


def _group_cluster(ctx) -> None:
    """Phase 28 (its ranks folded into the adasum pair in the whole run,
    its driver side prepared there)."""
    ctx["cluster"] = cluster_phase(ctx)


def _group(key: str, fn, *args):
    def run(ctx) -> None:
        ctx[key] = fn(*(ctx[a] for a in args))
    run.__doc__ = fn.__doc__
    return run


# name -> fn(ctx), in the whole run's order (`ctx` carries results from a
# group to the ones after it); `--phases NAME...` runs some of them.
PHASE_GROUPS = {
    "adasum": _group_adasum,
    "singles": _group_singles,
    "transformer": _group_transformer,
    "surface_mnist": _group_surface_mnist,
    "elastic": _group("elastic", train_elastic),
    "zoo": _group("zoo", lambda: train_zoo()[0]),
    "wire": _group_wire,
    "mesh": _group("mesh", train_mesh),
    "serve": _group_serve,
    "guard": _group("guard", train_guard, "singles"),
    "hier": _group("hier", train_hier),
    "runtime": _group("runtime", train_runtime),
    "trace": _group("trace", train_trace),
    "launcher": _group("launcher", launcher_phase),
    "elastic_driver": _group("elastic_driver", elastic_driver_phase, "smi"),
    "reshard": _group("reshard", reshard_phase),
    "replicas": _group_replicas,
    "frontends": _group_frontends,
    "cluster": _group_cluster,
}
# The groups whose results a group reads.
PHASE_NEEDS = {"wire": ("singles", "transformer"), "guard": ("singles",)}


def _group_multicard(ctx) -> None:
    """Phase 29, with its results as one JSON line."""
    ctx["multicard"] = multicard_phase(ctx["smi_lines"])
    print(json.dumps({"multicard": ctx["multicard"]}), flush=True)


# Groups that `--phases NAME...` runs and the whole run does not: phase
# 29 needs four cards, one a rank.
OWN_GROUPS = {"multicard": _group_multicard}


def run_phase_groups(names, ctx: dict) -> None:
    """Run the named groups of PHASE_GROUPS in turn, each after the
    groups it reads (PHASE_NEEDS), printing `PHASE_TIME <name> <seconds>`
    after each."""
    groups = dict(PHASE_GROUPS, **OWN_GROUPS)
    for name in names:
        if name not in groups:
            raise SystemExit(f"unknown phase group {name!r}: "
                             f"{list(groups)}")
        missing = [n for n in PHASE_NEEDS.get(name, ()) if n not in ctx]
        if missing:
            raise SystemExit(f"phase group {name} reads {missing}: name "
                             "them before it")
        t0 = time.perf_counter()
        groups[name](ctx)
        ctx[name] = ctx.get(name)
        print(f"PHASE_TIME {name} {time.perf_counter() - t0:.1f}",
              flush=True)


def build_all() -> None:
    """Every kernel source (nvcc, in parallel) and, beside them, the
    native control plane (g++)."""
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch import _build, _native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(_native.load)
        _build.build(_build.sources())
        require(native.result() is not None,
                "the native control plane did not build with g++")
    log("build", f"native control plane {_native.library_path()} (g++); "
        f"{time.perf_counter() - t0:.2f} s for "
        f"{_build.sources()} (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name in _build.sources():
        with open(_build._library_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("build", line.strip())


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
    if sys.argv[1:2] == ["--decode-mesh-rank"]:
        return decode_mesh_rank()
    if sys.argv[1:2] == ["--guard-rank"]:
        return guard_rank()
    if sys.argv[1:2] == ["--runtime-rank"]:
        return runtime_rank()
    if sys.argv[1:2] == ["--stall-rank"]:
        return stall_rank()
    if sys.argv[1:2] == ["--trace-rank"]:
        return trace_rank()
    if sys.argv[1:2] == ["--reshard-rank"]:
        return reshard_rank()
    if sys.argv[1:2] == ["--fold-rank"]:
        return fold_rank()
    if sys.argv[1:2] == ["--frontends-rank"]:
        return frontends_rank()
    if sys.argv[1:2] == ["--cluster-rank"]:
        return cluster_rank()
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
    smi_lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    smi = smi_lines[0]
    print("\n".join(smi_lines), flush=True)
    if sys.argv[1:2] == ["--phases"]:
        # Some groups of the whole run (PHASE_GROUPS) or of OWN_GROUPS,
        # with every build.
        if "multicard" in sys.argv[2:]:
            multicard_cards()  # before the builds: four cards or no run
        build_all()
        run_phase_groups(sys.argv[2:], {"smi": smi, "smi_lines": smi_lines})
        log("done", f"{time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:2] == ["--guard"]:
        # Phase 19 alone (with the builds of the sources it runs).
        _build.build(["flash_attention_sm90", "flash_attention",
                      "tiled_matmul"])
        runs = [dict(phase="guard_resnet_off", args=GUARD_RESNET_ARGS),
                dict(phase="guard_resnet_on", args=GUARD_RESNET_ARGS,
                     env={"HOROVOD_GUARD": "1"})]
        guard = train_guard(dict(zip(
            [r["phase"] for r in runs],
            launch_folded("guard_resnet", 1, runs, timeout=600))))
        print(json.dumps({"guard": guard}), flush=True)
        return 0
    if sys.argv[1:2] == ["--hier"]:
        # Phase 20 alone (with the builds of the sources it runs).
        _build.build(["flash_attention_sm90", "flash_attention"])
        hier = train_hier()
        print(json.dumps({"hier": hier}), flush=True)
        return 0
    if sys.argv[1:2] == ["--runtime"]:
        # Phase 21 alone (with the builds of the sources it runs).
        _build.build(["flash_attention_sm90", "flash_attention"])
        runtime = train_runtime()
        print(json.dumps({"runtime": runtime}), flush=True)
        return 0
    if sys.argv[1:2] == ["--trace"]:
        # Phase 22 alone (with the builds of the sources it runs).
        _build.build(["flash_attention_sm90", "flash_attention"])
        trace = train_trace()
        print(json.dumps({"trace": {k: v for k, v in trace.items()
                                    if k != "fleet_view"}}), flush=True)
        return 0
    if sys.argv[1:2] == ["--launcher"]:
        # Phase 23 alone (nothing to build: it launches no kernel).
        launcher_phase()
        return 0
    if sys.argv[1:2] == ["--elastic"]:
        # Phase 24 alone (nothing to build with nvcc: the path runs no
        # kernel; the native control plane is built with g++).
        elastic_driver_phase(smi)
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

    build_all()

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
    ctx = {"smi": smi}
    run_phase_groups(list(PHASE_GROUPS), ctx)
    adasum_summaries = ctx["adasum"]
    transformer_summaries = ctx["transformer"]
    zero3_summaries = ctx["zero3"]
    zoo_summaries, wire, mesh, serve = (ctx["zoo"], ctx["wire"], ctx["mesh"],
                                        ctx["serve"])
    guard, hier, runtime, trace, reshard, replicas = (
        ctx["guard"], ctx["hier"], ctx["runtime"], ctx["trace"],
        ctx["reshard"], ctx["replicas"])
    codecs = ctx["codecs"]

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
            # their launches on main path 5 (VGG-16 Adasum at np=2) and
            # on main path 17 per rank (the tape under Adasum).
            row.update(zoo={m: measured[m][name] for m in ZOO_N},
                       zoo_launches=zoo_summaries[0]["launches"][name],
                       frontends_launches=[
                           f[name] for f in ctx["frontends"]["launches"]])
            require(row["zoo_launches"] > 0, f"{name}: no launch on "
                    "train_zoo")
            require(all(c > 0 for c in row["frontends_launches"]),
                    f"{name}: no launch on main path 17")
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
                # Main path 16: the replica fleet's K4 launches, all the
                # replicas' together (each on the tensor cores:
                # replicas_phase).
                row.update(prefill=prefill, min_t=min_t,
                           replicas_launches=replicas["launches"])
                require(row["replicas_launches"] > 0,
                        "flash_fwd: no launch on main path 16")
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
            # Main path 12: the runtime rank's launches (eager steps,
            # warm-ups and the captures: a replay's launches show in its
            # trace only) and one replay's, read from its trace.
            row.update(runtime_launches=runtime["launches"][name],
                       runtime_replay_launches=runtime[
                           "replay_launches"][name])
            # Main path 13: the traced, straggling, rebalanced run's
            # launches per rank (all on the tensor cores: check_trace).
            row.update(trace_launches=[t[name] for t in trace["launches"]])
            # Main path 15: stage 3 around the reshards, per rank (all on
            # the tensor cores: check_reshard).
            row.update(reshard_launches=[
                x[name] for x in reshard["launches"]])
        if name == "tiled_matmul":
            # The launches of the main path's eval forward that took the
            # strided load path (train_zero3 and zero3_nccl require 0),
            # and that path's time at the head chunk.
            row.update(strided_launches=zero3_summaries[0]["evals"][0][
                "k3_strided_launches"], strided_ms=m["strided_ms"],
                wire_launches=wire["zero3"][0]["evals"][0]["k3_launches"],
                guard_launches=guard["k3_launches"])
        # Main path 18 (the spark estimator's worker loop) reaches no
        # kernel: its launches per rank, 0 (check_cluster requires it).
        row["cluster_launches"] = [c.get(name, 0)
                                   for c in ctx["cluster"]["launches"]]
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
    if RUN_MARK in os.environ:  # a rank of a running smoke: its top
        sys.exit(main())        # process stops what is left
    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    import signal

    # A SIGTERM (a time limit) ends the run through the sweep below too.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        rc = main()
    finally:
        stop_leftovers(os.environ[RUN_MARK])
    sys.exit(rc)
