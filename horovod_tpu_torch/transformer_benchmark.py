"""Transformer LM trainer on the port: the flagship dense configuration,
data parallel.

Counterpart of `bench.py` `run_transformer_bench` and
`examples/transformer_lm.py` on the dp axis alone: synthetic tokens made
from a numpy seed per rank, AdamW with optax.adamw's defaults (lr 3e-4,
betas (0.9, 0.999), eps 1e-8, weight decay 1e-4), bf16 compute with f32
parameters, and the horovod.torch loop:

    hvd.init() → DistributedOptimizer(AdamW) → broadcast_parameters /
    broadcast_optimizer_state → forward, backward, step()

Defaults are `TransformerConfig()` (vocab 32000, d_model 512, 8 heads of
64, d_ff 2048, 8 layers, about 50M parameters) at T = 16384, batch 1 per
rank, where attention routes to the flash kernels on the card.  Prints
tok/sec per rank.  `--log-steps` adds one JSON line per step (loss, the
launch counts of every port kernel, SHA-256 of the parameters);
`--check-plain-step S` adds to step S's line rank 0's recomputation with
the plain attention (no kernels); `--profile K` a PROFILE line (as
synthetic_benchmark's).

`--zero-stage K` trains under `DistributedOptimizer(zero_stage=K)`.  At
stage 3 the parameters are bound to a `zero3_placement` (views of one
buffer per shard group) and the step is gather -> forward/backward ->
sharded step -> apply_updates -> release: between steps only the rows
and the optimizer's shards stay on the device (SUMMARY's
`param_resident_bytes` and `param_storage_bytes` read the storages).
`--eval-every N` adds a held-out forward every
N steps (one fixed batch, the same on every rank) and an EVAL line: its
loss, the launches of K3 (`tiled_matmul`) and, on the check step, the
logits' largest difference from the plain head relative to their
largest value (`k3_plain_calls` counts K3's wrapper taking its plain
version, on the CPU; `k3_strided_launches` the launches that took its
strided load path).  At stage 3 the eval head is `placement.gather_matmul`,
which runs K3 under HOROVOD_FUSED_PALLAS=1 (the ZeRO-3 configuration
also sets HOROVOD_FUSED_COLLECTIVES=1 and HOROVOD_FUSION_THRESHOLD=
33554432, where the embedding is a shard group of its own).  The wires
come from the environment (HOROVOD_WIRE_POLICY, HOROVOD_SHARD_AG_WIRE,
HOROVOD_ZERO_GATHER_WIRE): under a gather wire the check step's EVAL line
also gives the logits' largest difference from those of the exactly
gathered head (`eval_exact_rel`), and under an allgather wire each STEP
line gives the largest |f32 master − decoded parameter| of this rank's
shards (`master_wire_diff`).

The optimizer's keywords: `--backward-passes-per-step K` (a step is K
passes, each its own seeded micro-batch, `opt.step()` after each;
launches and STEP lines count steps), `--fused-apply`,
`--early-reduction`, `--guard` (`DistributedOptimizer(guard=True)`, the
schedule from the env; STEP lines add the loss scale and the flag), and
`--dcn N`: the data-parallel ranks as `create_hierarchical_mesh(N)`,
passed as `axis_name=` to the optimizer and the stage-3 placement (the
hierarchical reduction needs HOROVOD_HIERARCHICAL_ALLREDUCE=1 at stage
0; stages 1-3 always take the pair; the stage-3 eval head then gathers
the embedding's group, since `gather_matmul` refuses the pair).
`--check-hier-step S` (with `--dcn`): on step S's last pass, after the
backward, every rank synchronizes the optimizer and rank 0 holds the
reduced gradients (this pass's) to a flat allreduce of the same local
gradients over the global set (`hier_rel`: largest difference over the
largest value), and the same gradients through
`hierarchical_allreduce(dcn_wire="int8")` to the exact result
(`int8_err`, beside `int8_bound`: two int8 encodes on the dcn leg, each
at most half a step of a block whose largest value is at most the sum
over the ranks of their largest |gradient|, over the world size).

The runtime utilities: `--megastep M` runs M steps a call through
`utils/megastep.py` (`repeat_steps` on the fixed batch, `scan_steps`
on M prefetched ones; on the card one CUDA graph of M steps, replayed
from the third call on; AdamW then takes `capturable=True`): a call
counts as one of `--num-batches-per-iter`, tok/sec counts its M steps,
and `--log-steps` prints one STEP line a call, after a sync, with the
call's M losses.  It takes the plain data-parallel step only, so it
refuses `--guard` (its verdict reads the host once a step) and, on the
card, ranks that share a gloo group (their collectives run on the host),
and takes none of `--zero-stage`, `--backward-passes-per-step` > 1,
`--dcn`, `--eval-every` or the check flags.  `--prefetch N` draws a new
seeded token batch a step on the host (or M stacked under megastep)
and feeds it through `prefetch_to_device(size=N)`; without it every
step trains on one fixed batch.  HOROVOD_TIMELINE (and
HOROVOD_TIMELINE_MARK_CYCLES=1) records the collectives, one cycle and
one `step` span a step or megastep call.

The mesh (`--tp --pp --ep --sp`, and `--dp`, by default the rest of
the world size; `--attn ring|ulysses`, `--moe-every`, `--n-experts`,
`--n-kv-heads`, `--attn-window`: examples/transformer_lm.py's flags):
whenever tp, pp, ep or sp is above 1, the step is
`models.transformer.make_train_step` over `create_hybrid_mesh` (GPipe
with pp microbatches): each rank holds its shards of one seeded model
and AdamW over them; the global
batch is `--batch-size` rows per data shard (dp·ep of them) of seeded
tokens, the same on every rank, and each rank takes its block.  STEP
lines carry the loss (the global one, the same on every rank), the
launch counts and the SHA-256 of the full parameters gathered from the
shards (the same on every rank); `--check-dense-step S` adds to step
S's line rank 0's `reference_loss` (the dense layers on one rank, the
MoE layers routing per shard as the mesh does) on the same parameters
and tokens.  SUMMARY adds the mesh, tok/sec per rank (the global
batch's tokens over the world size), the same rate without the checks
(`tok_sec_per_rank_net`: the reference and the digests run in the
ranges `bench.check.reference` and `bench.check.digest`, timed between
syncs, and `check_ms_per_step` gives their wall ms per step of each
iteration) and, with `--profile`, the host ms per step in the mesh's
ranges (`hvd.sp.hop`, `hvd.sp.a2a`, `hvd.tp.psum`, `hvd.ep.a2a`,
`hvd.pp.hop`, ...) and the idle share.

Run:  python -m horovod_tpu_torch.transformer_benchmark --num-iters 3
CPU:  python -m horovod_tpu_torch.transformer_benchmark --device cpu \\
          --vocab-size 256 --d-model 64 --n-heads 2 --d-head 32 \\
          --d-ff 128 --n-layers 2 --seq-len 128 --log-steps
      (add --sp 2 under two ranks for the ring over the sequence)
Multi-process: HOROVOD_COORDINATOR_ADDR, HOROVOD_NUM_PROCESSES,
HOROVOD_PROCESS_ID (and HOROVOD_LOCAL_RANK / HOROVOD_LOCAL_SIZE) per rank.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import Transformer, TransformerConfig, \
    lm_loss, num_params
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.parallel import hierarchical as hier
from horovod_tpu_torch.parallel.mesh import (create_hierarchical_mesh,
                                             create_hybrid_mesh)
from horovod_tpu_torch.ops import adasum_kernels, flash_attention as fa
from horovod_tpu_torch.ops import matmul_kernels as mk
from horovod_tpu_torch.utils import consistency, megastep
from horovod_tpu_torch.synthetic_benchmark import param_digest, \
    profile_summary


def launch_counts() -> dict:
    """Every kernel's launches, and as `<name>_sm90` those of K4-K6 that
    took the tensor-core route."""
    return {**adasum_kernels.launch_counts(), **fa.launch_counts(),
            **{f"{n}_sm90": c for n, c in fa.sm90_launch_counts().items()},
            **mk.launch_counts()}


def reset_launch_counts() -> None:
    adasum_kernels.reset_launch_counts()
    fa.reset_launch_counts()
    mk.reset_launch_counts()


def storage_bytes(tensors) -> int:
    """Bytes the tensors' storages hold now, each storage once."""
    held = {}
    for t in tensors:
        st = t.untyped_storage()
        held[st.data_ptr()] = st.nbytes()
    return sum(held.values())


def embed_group(placement, model) -> int:
    """Index of the shard group that holds the embedding alone (the tied
    head's weight); raises if the partition grouped it with others."""
    idx = [p is model.embed for p in model.parameters()].index(True)
    for gi, g in enumerate(placement.groups):
        if g.idxs == (idx,):
            return gi
    raise ValueError(
        "the embedding shares a shard group with other parameters, so "
        "gather_matmul cannot take it: lower HOROVOD_FUSION_THRESHOLD "
        "(33554432 isolates it at the default widths)")


def _check_plain_attention(model, x, y, logits) -> dict:
    """Rank 0's check of the kernels on one step: the forward again with
    K4's plain version for attention, and once more with that plain
    version made non-causal, a fault the check must tell apart.  For
    each: its loss, and max|its logits - `logits`| / max|`logits`|.
    Also the tied head against the f32 path it replaced (the f32 einsum
    of the compute-dtype operands): `head_logits_rel`, relative to the
    largest logit."""
    def faulted(q, k, v, causal, window):
        return fa.flash_attention_plain(q, k, v, causal=False, window=window)

    top = logits.abs().max()
    rec = {}
    with torch.no_grad():
        for name, attn in (("plain", fa.flash_attention_plain),
                           ("faulted", faulted)):
            h = model.hidden(x, attn=attn)
            other = model.head(h)
            rec[f"{name}_loss"] = float(lm_loss(other, y))
            rec[f"{name}_logits_rel"] = float(
                (other - logits).abs().max() / top)
            if name == "plain":
                dt = model.cfg.compute_dtype
                f32 = torch.einsum("btd,vd->btv", h.to(dt).float(),
                                   model.embed.to(dt).float())
                rec["head_logits_rel"] = float(
                    (other - f32).abs().max() / f32.abs().max())
                del f32
            del h, other
    return rec


def _profiled(one_step, steps: int, dev, sync) -> dict:
    """Profile `steps` calls of `one_step`: profile_summary's record."""
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return profile_summary(trace, wall, steps, on_card=dev.type == "cuda")


def check_megastep(args, dev) -> None:
    """`--megastep`'s refusals (see the module docstring)."""
    if args.guard:
        raise SystemExit(
            "--megastep refuses --guard: the guard's skip-step verdict "
            "reads the host once a step, which a CUDA graph cannot "
            "capture")
    if dev.type == "cuda" and hvd.size() > 1 and hvd.backend() == "gloo":
        raise SystemExit(
            "--megastep refuses ranks that share a gloo group on the card: "
            "gloo's collectives run on the host, which a CUDA graph cannot "
            "capture")
    other = [f for f, on in (
        ("--zero-stage", args.zero_stage),
        ("--backward-passes-per-step", args.backward_passes_per_step > 1),
        ("--dcn", args.dcn > 1), ("--eval-every", args.eval_every),
        ("--check-plain-step", args.check_plain_step >= 0),
        ("--check-hier-step", args.check_hier_step >= 0),
        ("--fused-apply", args.fused_apply),
        ("--early-reduction", args.early_reduction)) if on]
    if other:
        raise SystemExit(f"--megastep takes the plain data-parallel step "
                         f"only, not {', '.join(other)}")


def run_mesh(args, cfg: TransformerConfig, dev) -> int:
    """The trainer over a hybrid mesh (see the module docstring)."""
    mesh = create_hybrid_mesh(dp=args.dp, pp=args.pp, ep=args.ep,
                              tp=args.tp, sp=args.sp, dcn=args.dcn)
    shape = {a: n for a, n in mesh.shape.items() if n > 1}
    opt_fn = functools.partial(torch.optim.AdamW, lr=3e-4,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=1e-4)
    step, shard_state, shard_batch = T.make_train_step(mesh, cfg, opt_fn)
    params = T.transformer_init(0, cfg)
    n_params = sum(a.numel() for _, a in T.tree_leaves(params))
    shards, opt = shard_state(params)
    del params
    rows = args.batch_size * mesh.size("dp") * mesh.size("ep")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (rows, args.seq_len + 1)))
    x, y = tokens[:, :-1], tokens[:, 1:]
    batch = shard_batch((x, y))
    pp = mesh.size("pp")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def full_params():
        full = T.unshard(shards, cfg, mesh)
        return T.unstack_pipeline(full) if pp > 1 else full

    step_no = 0
    last_loss = float("nan")
    check_s = 0.0

    def checked(name, fn):
        """Run a check in its own range, between syncs and followed by a
        barrier (so that a rank waiting for rank 0's reference waits
        here), and add its wall time to `check_s`."""
        nonlocal check_s
        sync()
        t0 = time.perf_counter()
        with record_function(name):
            out = fn()
            sync()
            hvd.barrier()
        check_s += time.perf_counter() - t0
        return out

    def dense_check() -> dict:
        full = full_params()
        if hvd.rank() != 0:
            return {}
        before = launch_counts()
        loss = T.reference_loss(full, x.to(dev), y.to(dev), cfg,
                                dp=mesh.size("dp"), ep=mesh.size("ep"),
                                pp=pp)
        after = launch_counts()
        return {"dense_loss": loss,
                "check_launches": {k: after[k] - before[k] for k in after}}

    def one_step():
        nonlocal step_no, last_loss
        check = {}
        if step_no == args.check_dense_step:
            check = checked("bench.check.reference", dense_check)
        _, _, loss = step(shards, opt, batch)
        last_loss = loss
        if args.log_steps:
            sync()
            rec = {"step": step_no, "rank": hvd.rank(),
                   "loss": float(loss), "launches": launch_counts(),
                   "digest": checked("bench.check.digest", lambda:
                                     T.tree_digest(full_params())),
                   **check}
            print("STEP " + json.dumps(rec), flush=True)
        step_no += 1

    if hvd.rank() == 0:
        print(f"Model: transformer ({n_params} params, {cfg.n_layers} "
              f"layers, d_model {cfg.d_model}, moe_every {cfg.moe_every}), "
              f"seq {args.seq_len}, global batch {rows}, mesh {shape}, "
              f"attn {cfg.attn_impl}, device {dev}, backend "
              f"{hvd.backend()}", flush=True)
    reset_launch_counts()
    for _ in range(args.num_warmup_batches):
        one_step()
    sync()
    tok_secs, net_tok_secs, checks_ms = [], [], []
    tokens_per_iter = rows * args.seq_len * args.num_batches_per_iter
    for i in range(args.num_iters):
        check_s = 0.0
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            one_step()
        sync()
        dt = time.perf_counter() - t0
        tok_sec = tokens_per_iter / dt / hvd.size()
        if hvd.rank() == 0:
            print(f"Iter #{i}: {tok_sec:.1f} tok/sec per rank", flush=True)
        tok_secs.append(tok_sec)
        net_tok_secs.append(tokens_per_iter / (dt - check_s) / hvd.size())
        checks_ms.append(check_s * 1e3 / args.num_batches_per_iter)
    profiled = None
    if args.profile:
        profiled = _profiled(one_step, args.profile, dev, sync)
        print("PROFILE " + json.dumps(dict(profiled, rank=hvd.rank())),
              flush=True)
    summary = {"rank": hvd.rank(), "size": hvd.size(), "mesh": shape,
               "coords": {a: mesh.index(a) for a in shape},
               "attn": cfg.attn_impl, "moe_every": cfg.moe_every,
               "tok_sec_per_rank": float(np.mean(tok_secs)),
               "tok_sec_std": float(np.std(tok_secs)),
               # The same iterations without the checks' wall time (the
               # dense reference, the digests), and that time per step
               # in each iteration.
               "tok_sec_per_rank_net": float(np.mean(net_tok_secs)),
               "check_ms_per_step": checks_ms,
               "steps": step_no, "last_loss": float(last_loss),
               "launches": launch_counts(), "n_layers": cfg.n_layers,
               "ranges_ms_per_step": (profiled or {}).get(
                   "ranges_ms_per_step"),
               "device_idle_share": (profiled or {}).get(
                   "device_idle_share"),
               "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None),
               "device": str(dev), "backend": hvd.backend()}
    print("SUMMARY " + json.dumps(summary), flush=True)
    hvd.shutdown()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--d-head", type=int, default=64)
    p.add_argument("--d-ff", type=int, default=2048)
    p.add_argument("--n-layers", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=16384)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="default: the rank's card; 'cpu' runs on the host")
    p.add_argument("--log-steps", action="store_true",
                   help="one JSON line per step: loss, launches, digest")
    p.add_argument("--profile", type=int, default=0,
                   help="after timing, profile this many steps and print "
                        "a PROFILE line (per-step breakdown)")
    p.add_argument("--check-plain-step", type=int, default=-1,
                   help="on this step, rank 0 recomputes the logits and "
                        "the loss with the plain attention (no kernels), "
                        "and with it made non-causal, under no_grad")
    p.add_argument("--zero-stage", type=int, default=0,
                   choices=(0, 1, 2, 3),
                   help="DistributedOptimizer(zero_stage=K); 3 keeps the "
                        "parameters in a zero3_placement")
    p.add_argument("--eval-every", type=int, default=0,
                   help="a held-out forward every N steps (EVAL line)")
    for axis in ("tp", "pp", "ep", "sp"):
        p.add_argument(f"--{axis}", type=int, default=1,
                       help=f"mesh axis {axis} (make_train_step when > 1)")
    p.add_argument("--dp", type=int, default=-1,
                   help="mesh axis dp (default: the rest of the world)")
    p.add_argument("--attn", default="ring", choices=("ring", "ulysses"),
                   help="sequence parallelism over sp")
    p.add_argument("--moe-every", type=int, default=0)
    p.add_argument("--n-experts", type=int, default=8)
    p.add_argument("--n-kv-heads", type=int, default=0)
    p.add_argument("--attn-window", type=int, default=0)
    p.add_argument("--dcn", type=int, default=1,
                   help="slices: the ranks as create_hierarchical_mesh(N) "
                        "(the optimizer's axis_name), or the mesh's dcn")
    p.add_argument("--backward-passes-per-step", type=int, default=1)
    p.add_argument("--fused-apply", action="store_true")
    p.add_argument("--early-reduction", action="store_true")
    p.add_argument("--guard", action="store_true",
                   help="DistributedOptimizer(guard=True)")
    p.add_argument("--check-hier-step", type=int, default=-1,
                   help="with --dcn: on this step hold the hierarchical "
                        "reduction to the flat one and the int8 dcn wire")
    p.add_argument("--check-dense-step", type=int, default=-1,
                   help="mesh: on this step rank 0 computes the loss on "
                        "one rank (reference_loss)")
    p.add_argument("--megastep", type=int, default=0,
                   help="M steps a call through utils/megastep.py (one "
                        "CUDA graph on the card)")
    p.add_argument("--prefetch", type=int, default=0,
                   help="a new token batch a step through "
                        "prefetch_to_device(size=N)")
    args = p.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_heads=args.n_heads, d_head=args.d_head, d_ff=args.d_ff,
        n_layers=args.n_layers, compute_dtype=torch.bfloat16,
        moe_every=args.moe_every, n_experts=args.n_experts,
        attn_impl=args.attn, n_kv_heads=args.n_kv_heads,
        attn_window=args.attn_window)
    if max(args.tp, args.pp, args.ep, args.sp) > 1:
        return run_mesh(args, cfg, dev)
    if args.megastep:
        check_megastep(args, dev)
    model = Transformer(cfg, seed=hvd.rank()).to(dev)
    hmesh = create_hierarchical_mesh(args.dcn) if args.dcn > 1 else None
    K = args.backward_passes_per_step
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
                            capturable=bool(args.megastep)
                            and dev.type == "cuda")
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   zero_stage=args.zero_stage,
                                   backward_passes_per_step=K,
                                   fused_apply=args.fused_apply,
                                   early_reduction=args.early_reduction,
                                   guard=True if args.guard else None,
                                   axis_name=hmesh)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    params = list(model.parameters())
    placement = rows = None
    if args.zero_stage == 3:
        placement = hvd.zero3_placement(params, axis_name=hmesh)
        gi_embed = embed_group(placement, model)
        rows = placement.shard(params)
        placement.bind(params)

    def gather_params():
        if placement is not None:
            with torch.no_grad(), record_function("bench.gather"):
                placement.gather(rows)

    def release_params():
        if placement is not None:
            with record_function("bench.release"):
                placement.release()

    def digest() -> str:
        """The parameters' SHA-256 after the step (at stage 3 gathered
        for it, then released again)."""
        gather_params()
        d = param_digest(model)
        release_params()
        return d

    ev = np.random.RandomState(12345).randint(
        0, cfg.vocab_size, (args.batch_size, args.seq_len + 1))
    xe = torch.from_numpy(ev[:, :-1]).to(dev)
    ye = torch.from_numpy(ev[:, 1:]).to(dev)

    def evaluate(check: bool) -> dict:
        """The held-out forward; at stage 3 the parameters are gathered
        for it and released after, and the head is gather_matmul."""
        with torch.no_grad(), record_function("bench.eval"):
            gather_params()
            h = model.hidden(xe)
            flat = h.reshape(-1, cfg.d_model).float()
            k3 = mk.tiled_matmul
            before = (k3.launches, k3.plain_calls, k3.strided_launches)
            if placement is not None and hmesh is None:
                logits = placement.gather_matmul(flat, rows, gi_embed)
            else:
                logits = model.head(h).reshape(flat.shape[0], -1)
            rec = {"k3_launches": k3.launches - before[0],
                   "k3_plain_calls": k3.plain_calls - before[1],
                   "k3_strided_launches": k3.strided_launches - before[2],
                   "eval_loss": float(lm_loss(logits, ye.reshape(-1)))}
            if check:
                ref = mk.tiled_matmul_plain(flat, model.embed.detach().t())
                rec["eval_logits_rel"] = float(
                    (logits - ref).abs().max() / ref.abs().max())
                if placement is not None and placement.gather_wire:
                    # The head gathered exactly, from the same rows.
                    w = hvd.allgather(rows[gi_embed].reshape(-1))
                    ref = mk.tiled_matmul_plain(
                        flat, w.reshape(model.embed.shape).t())
                    rec["eval_exact_rel"] = float(
                        (logits - ref).abs().max() / ref.abs().max())
                del ref
            del logits
            release_params()
        return rec

    rng = np.random.RandomState(hvd.rank())
    micro = []  # one (x, y) a pass of the step
    for _ in range(K):
        tokens = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (args.batch_size, args.seq_len + 1))).to(dev)
        micro.append((tokens[:, :-1], tokens[:, 1:]))
    fixed = tokens  # the last pass's [B, T+1]: megastep's fixed batch
    feed = None
    if args.prefetch:
        def host_batches():
            """A new seeded batch of tokens a step on the host: [K, B,
            T+1], or [M, B, T+1] under megastep."""
            lead = args.megastep or K
            while True:
                yield torch.from_numpy(rng.randint(
                    0, cfg.vocab_size,
                    (lead, args.batch_size, args.seq_len + 1)))

        feed = hvd.prefetch_to_device(host_batches(), size=args.prefetch,
                                      device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step_no = 0
    last_loss = float("nan")
    eval_s = 0.0  # held-out forwards' wall time, left out of tok/sec
    peak = 0  # the largest allocation peak of the phases read so far

    def phase_peak():
        """With --log-steps on the card: the allocation peak since the
        last call, in GB (the allocator counts on the host, so no sync
        is needed), and a fresh count for the next phase."""
        nonlocal peak
        if not args.log_steps or dev.type != "cuda":
            return None
        p_ = torch.cuda.max_memory_allocated(dev)
        peak = max(peak, p_)
        torch.cuda.reset_peak_memory_stats(dev)
        return p_ / 1e9

    def check_hier() -> dict:
        """--check-hier-step: this pass's reduced gradients against the
        flat allreduce and the int8 dcn wire (see the module docstring);
        called after the backward of the step's last pass."""
        local = [p.grad.detach().clone() for p in params]
        opt.synchronize()
        with torch.no_grad(), record_function("bench.check.hier"):
            flat = hvd.grouped_allreduce(local, op=hvd.Average)
            int8 = hier.hierarchical_allreduce(local, hmesh,
                                               dcn_wire="int8")
            top = max(float(f.abs().max()) for f in flat)
            rec = {
                "hier_rel": max(float((p.grad - f).abs().max())
                                for p, f in zip(params, flat)) / top,
                "int8_err": max(float((q - p.grad).abs().max())
                                for p, q in zip(params, int8)),
                "int8_bound": 2 * float(hvd.allreduce(
                    torch.stack([g.abs().max() for g in local]).max(),
                    op=hvd.Sum)) / 254 / hvd.size(),
                "grad_top": top}
        del local, flat, int8
        return rec if hvd.rank() == 0 else {}

    def train_step(carry, tokens):
        """One plain step on tokens [B, T+1] (megastep's step_fn)."""
        model_, opt_ = carry
        opt_.zero_grad(set_to_none=True)
        loss = lm_loss(model_(tokens[:, :-1]), tokens[:, 1:])
        loss.backward()
        opt_.step()
        return carry, loss.detach()

    mstep = None
    if args.megastep:
        mstep = (megastep.scan_steps if feed is not None
                 else megastep.repeat_steps)(train_step, args.megastep,
                                             out_mode="all")

    def mega_step():
        """One megastep call: M steps, one STEP line."""
        nonlocal step_no, last_loss
        _, losses = mstep((model, opt), next(feed) if feed is not None
                          else fixed)
        last_loss = losses.mean()
        if args.log_steps:
            sync()
            rec = {"step": step_no, "rank": hvd.rank(),
                   "loss": float(last_loss),
                   "pass_losses": [float(v) for v in losses],
                   "launches": launch_counts(), "digest": digest(),
                   "megastep": args.megastep, "graph": mstep.graph is not None}
            print("STEP " + json.dumps(rec), flush=True)
        step_no += 1

    def one_step():
        nonlocal step_no, last_loss, rows, eval_s
        if mstep is not None:
            return mega_step()
        opt.zero_grad(set_to_none=True)
        mem = {"before": phase_peak()}
        check, losses = {}, []
        steps = micro
        if feed is not None:
            steps = [(t[:, :-1], t[:, 1:]) for t in next(feed)]
        for k, (xk, yk) in enumerate(steps):
            gather_params()
            with record_function("bench.forward"):
                logits = model(xk)
                loss = lm_loss(logits, yk)
            mem["forward"] = phase_peak()
            with record_function("bench.backward"):
                scaler = getattr(opt, "_scaler", None)
                (scaler.scale_loss(opt.guard_state, loss)
                 if scaler is not None else loss).backward()
            mem["backward"] = phase_peak()
            if step_no == args.check_plain_step and hvd.rank() == 0 \
                    and k == 0:
                # Same parameters as the forward above (the step has not
                # run).
                check = _check_plain_attention(model, xk, yk,
                                               logits.detach())
            del logits
            if step_no == args.check_hier_step and k == K - 1:
                sync()
                check.update(check_hier())
            with record_function("bench.optimizer_step"):
                updates = opt.step()
            if placement is not None and updates is not None:
                with record_function("bench.apply_updates"):
                    rows = placement.apply_updates(rows, updates)
            del updates
            release_params()
            losses.append(loss.detach())
        mem["step"] = phase_peak()
        last_loss = torch.stack(losses).mean()
        if args.log_steps:
            sync()
            rec = {"step": step_no, "rank": hvd.rank(),
                   "loss": float(last_loss),
                   "pass_losses": [float(v) for v in losses],
                   "launches": launch_counts(),
                   "digest": digest(), "mem_peak_gb": mem, **check}
            diff = getattr(opt, "master_wire_diff", None)
            if diff is not None:
                rec["master_wire_diff"] = float(diff)
            gs = getattr(opt, "guard_state", None)
            if gs is not None:
                rec["loss_scale"] = float(gs.loss_scale)
                rec["guard_flag"] = float(gs.bucket_flags.max())
            print("STEP " + json.dumps(rec), flush=True)
        if args.eval_every and (step_no + 1) % args.eval_every == 0:
            sync()
            t0 = time.perf_counter()
            rec = {"step": step_no, "rank": hvd.rank(),
                   **evaluate(step_no == args.check_plain_step),
                   "launches": launch_counts()}
            sync()
            eval_s += time.perf_counter() - t0
            print("EVAL " + json.dumps(rec), flush=True)
        step_no += 1

    if hvd.rank() == 0:
        print(f"Model: transformer ({num_params(model)} params, "
              f"{cfg.n_layers} layers, d_model {cfg.d_model}), seq "
              f"{args.seq_len}, batch {args.batch_size}/rank, "
              f"{hvd.size()} rank(s), device {dev}, backend "
              f"{hvd.backend()}, flash attention "
              f"{fa.flash_routed(args.seq_len, dev)}, zero stage "
              f"{args.zero_stage}, {K} pass(es) a step, dcn "
              f"{args.dcn}", flush=True)
    reset_launch_counts()
    for _ in range(args.num_warmup_batches):
        one_step()
    sync()

    tok_secs = []
    for i in range(args.num_iters):
        t0, e0 = time.perf_counter(), eval_s
        for _ in range(args.num_batches_per_iter):
            one_step()
        sync()
        dt = time.perf_counter() - t0 - (eval_s - e0)
        tok_sec = (args.batch_size * args.seq_len * K
                   * (args.megastep or 1) * args.num_batches_per_iter / dt)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {tok_sec:.1f} tok/sec per rank", flush=True)
        tok_secs.append(tok_sec)

    if args.profile:
        profiled = _profiled(one_step, args.profile, dev, sync)
        print("PROFILE " + json.dumps(dict(profiled, rank=hvd.rank())),
              flush=True)

    mean, std = float(np.mean(tok_secs)), float(np.std(tok_secs))
    summary = {"rank": hvd.rank(), "size": hvd.size(),
               "tok_sec_per_rank": mean, "tok_sec_std": std,
               "steps": step_no, "last_loss": float(last_loss),
               "launches": launch_counts(),
               "flushes": getattr(opt, "total_flushes", None),
               # Eager collectives held to every rank's under
               # HOROVOD_COLLECTIVE_CONSISTENCY_CHECK=1 (0 with it off).
               "consistency_checks": sum(consistency._seqs.values()),
               "n_layers": cfg.n_layers, "zero_stage": args.zero_stage,
               "passes_per_step": K, "dcn": args.dcn,
               "megastep": args.megastep, "prefetch": args.prefetch,
               "param_full_bytes": sum(p_.numel() * p_.element_size()
                                       for p_ in params),
               "param_resident_bytes": (
                   placement.resident_bytes() if placement is not None
                   else storage_bytes(params)),
               "param_storage_bytes": storage_bytes(params),
               "opt_state_bytes": hvd.optimizer_state_bytes(opt),
               "shard_groups": (len(placement.groups)
                                if placement is not None else None),
               "peak_mem_gb": (max(peak, torch.cuda.max_memory_allocated(
                   dev)) / 1e9 if dev.type == "cuda" else None),
               # What stays allocated between steps: parameters (or
               # rows), gradients, optimizer state.
               "between_steps_mem_gb": (torch.cuda.memory_allocated(dev) / 1e9
                                        if dev.type == "cuda" else None),
               "device": str(dev), "backend": hvd.backend()}
    if hvd.rank() == 0:
        print(f"Tok/sec per rank: {mean:.1f} +- {1.96 * std:.1f}")
        print(f"Total tok/sec on {hvd.size()} rank(s): "
              f"{mean * hvd.size():.1f} +- {1.96 * std * hvd.size():.1f}")
    print("SUMMARY " + json.dumps(summary), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
