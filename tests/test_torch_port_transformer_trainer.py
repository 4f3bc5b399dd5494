"""Port parity: the transformer's data-parallel training on the CPU.

- One `DistributedOptimizer(AdamW)` step at np=2 (gloo, a `file://`
  rendezvous under tmp), each rank on half the batch, against one
  single-process step on the whole batch; the tied embedding's hook;
  `broadcast_optimizer_state` on AdamW's state.
- `python -m horovod_tpu_torch.transformer_benchmark` on two CPU ranks,
  data parallel and over sp=2.

Tolerances are stated at each test.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port_collectives import no_launcher_env  # noqa: F401 (autouse)
from test_torch_port_trainer import REPO, run_world


WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import Transformer, TransformerConfig

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
torch.use_deterministic_algorithms(True)
cfg = TransformerConfig(vocab_size=256, d_model=64, n_heads=2, d_head=32,
                        d_ff=128, n_layers=2, compute_dtype=torch.float32)
tokens = np.random.RandomState(11).randint(0, 256, (4, 129))
x, y = torch.from_numpy(tokens[:, :-1]), torch.from_numpy(tokens[:, 1:])
res = {}
for world in ("single", "dist"):
    model = Transformer(cfg, seed=r)          # broadcast makes it rank 0's
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    if world == "dist":
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)  # empty state
        half = slice(2 * r, 2 * r + 2)
        xb, yb = x[half], y[half]
    else:
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        xb, yb = x, y
    hooks = []
    if world == "dist":
        orig = opt._enqueue
        opt._enqueue = lambda p: (hooks.append(id(p)), orig(p))
    opt.zero_grad()
    model.loss(xb, yb).backward()
    if world == "dist":
        res["local_grads"] = [p.grad.clone() for p in model.parameters()]
        res["embed_hooks"] = hooks.count(id(model.embed))
        res["hooks"] = len(hooks)
    opt.step()
    res[world + "_grads"] = [p.grad.clone() for p in model.parameters()]
    res[world + "_params"] = [p.detach().clone() for p in model.parameters()]
    if world == "dist":
        # AdamW's state now holds tensors, 'step' among them: broadcast
        # from rank 0 after perturbing rank 1's copy.
        inner = opt._opt
        if r == 1:
            for st in inner.state.values():
                st["exp_avg"].add_(1.0)
                st["step"].add_(5)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        res["state"] = [(float(st["step"]), st["exp_avg"].clone(),
                         st["exp_avg_sq"].clone())
                        for st in inner.state.values()]
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def adamw_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("adamw"), 2, WORKER)


def test_averaged_gradient_equals_the_whole_batch_gradient(adamw_world):
    """Two ranks on half batches each, op=Average: the mean of the two
    half-batch mean losses' gradients is the whole-batch gradient.  f32
    sums in another order: 1e-5 of each gradient's largest value."""
    for d in adamw_world:
        for got, want in zip(d["dist_grads"], d["single_grads"]):
            torch.testing.assert_close(
                got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    local = [d["local_grads"] for d in adamw_world]
    for got, a, b in zip(adamw_world[0]["dist_grads"], *local):
        torch.testing.assert_close(got, (a + b) / 2, rtol=0, atol=0)


def test_one_adamw_step_matches_the_single_process_step(adamw_world):
    """Adam's first step is lr * g / (|g| + eps) ≈ lr·sign(g): a gradient
    element within a rounding of zero may flip it, so parameters are
    held to 2·lr on every element and 1e-7 absolute on all but 0.1% of
    them (f32 rounding of parameters of size ~0.1)."""
    lr = 3e-4
    for d in adamw_world:
        diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in
                           zip(d["dist_params"], d["single_params"])])
        assert float(diffs.max()) <= 2 * lr
        assert float((diffs > 1e-7).float().mean()) <= 1e-3
    a, b = (torch.cat([p.reshape(-1) for p in d["dist_params"]])
            for d in adamw_world)
    assert torch.equal(a, b)  # one parameter set on both ranks


def test_the_tied_embedding_is_reduced_once(adamw_world):
    """The embedding is used twice in the graph (lookup and head); its
    post-accumulate hook fires once, as for every other parameter."""
    n_params = len(adamw_world[0]["dist_grads"])
    for d in adamw_world:
        assert d["embed_hooks"] == 1
        assert d["hooks"] == n_params


def test_broadcast_optimizer_state_carries_adamw_state(adamw_world):
    s0, s1 = (d["state"] for d in adamw_world)
    assert len(s0) == len(s1) == len(adamw_world[0]["dist_grads"])
    for (step0, m0, v0), (step1, m1, v1) in zip(s0, s1):
        assert step0 == step1 == 1.0
        assert torch.equal(m0, m1) and torch.equal(v0, v1)


def _run_trainer(tmp_path, extra):
    """`python -m horovod_tpu_torch.transformer_benchmark` at a small size
    on two gloo ranks, the flash path's plain versions forced on; each
    rank's lines."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1", HOROVOD_FLASH_ATTENTION="1",
        HOROVOD_COORDINATOR_ADDR=f"file://{tmp_path}/rendezvous",
        HOROVOD_NUM_PROCESSES="2")
    args = [sys.executable, "-m", "horovod_tpu_torch.transformer_benchmark",
            "--device", "cpu", "--vocab-size", "256", "--d-model", "64",
            "--n-heads", "2", "--d-head", "32", "--d-ff", "128",
            "--n-layers", "2", "--num-warmup-batches", "0",
            "--num-batches-per-iter", "1", "--num-iters", "2",
            "--log-steps"] + extra
    procs = [subprocess.Popen(args, cwd=REPO, env=dict(
        env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [log.splitlines() for log in logs]


def _records(lines, kind):
    return [json.loads(line[len(kind) + 1:]) for line in lines
            if line.startswith(kind + " ")]


def test_the_trainer_on_two_cpu_ranks(tmp_path):
    """The dp trainer: finite losses, one parameter digest per step, and
    rank 0's logits and loss with K4's plain version equal to the trained
    ones (the same function on the CPU), while the non-causal fault moves
    the logits."""
    logs = _run_trainer(tmp_path, ["--seq-len", "128",
                                   "--check-plain-step", "1"])
    steps = [_records(lines, "STEP") for lines in logs]
    assert [len(s) for s in steps] == [2, 2]
    for r0, r1 in zip(*steps):
        assert np.isfinite(r0["loss"]) and np.isfinite(r1["loss"])
        assert r0["digest"] == r1["digest"]
        assert set(r0["launches"]) == {"fused_dot_norms", "fused_scaled_add",
                                       "flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv", "tiled_matmul",
                                       "flash_fwd_sm90",
                                       "flash_bwd_dq_sm90",
                                       "flash_bwd_dkv_sm90"}
        # The CPU runs the plain versions: no kernel launched.
        assert not any(r0["launches"].values())
    check = steps[0][1]
    assert check["plain_loss"] == check["loss"]
    assert check["plain_logits_rel"] == 0.0
    # The non-causal fault reads 1.32 here (seed 0, this size).
    assert check["faulted_logits_rel"] > 0.5
    assert steps[0][1]["loss"] < steps[0][0]["loss"]


def test_the_mesh_trainer_on_two_cpu_ranks(tmp_path):
    """The trainer over sp=2 (ring attention): one loss and one parameter
    digest across the ranks each step; step 0's loss within 2e-3 of rank
    0's one-rank `reference_loss` (bf16 compute, chip_smoke's LOSS_TOL);
    the checks run in their own ranges and the rate without them is the
    higher one."""
    logs = _run_trainer(tmp_path, ["--seq-len", "256", "--sp", "2",
                                   "--check-dense-step", "0",
                                   "--profile", "1"])
    steps = [_records(lines, "STEP") for lines in logs]
    assert [len(s) for s in steps] == [3, 3]
    for r0, r1 in zip(*steps):
        assert np.isfinite(r0["loss"]) and r0["loss"] == r1["loss"]
        assert r0["digest"] == r1["digest"]
    first = steps[0][0]
    assert abs(first["dense_loss"] - first["loss"]) <= 2e-3 * first["loss"]
    assert "dense_loss" not in steps[1][0]
    assert steps[0][2]["loss"] < first["loss"]
    for lines in logs:
        (s,) = _records(lines, "SUMMARY")
        assert s["mesh"] == {"sp": 2} and s["steps"] == 3
        assert len(s["check_ms_per_step"]) == 2
        assert all(ms > 0 for ms in s["check_ms_per_step"])
        assert s["tok_sec_per_rank_net"] > s["tok_sec_per_rank"]
        assert {"hvd.sp.hop", "bench.check.digest"} <= set(
            s["ranges_ms_per_step"])
