"""Port parity: the autotuner (`horovod_tpu_torch/utils/autotune.py`)
against the JAX package's `horovod_tpu/utils/autotune.py`, and the live
fusion threshold of `DistributedOptimizer` in an np=2 gloo world on the
CPU.

Tolerances: the Gaussian process and the proposals, normalized to
[0, 1], within 1e-12 (the same float64 numpy code on both sides); the
knobs, the log's rows (timestamps aside) and the bucket counts exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.utils import autotune as JA
from horovod_tpu_torch.utils import autotune as TA

from test_torch_port_collectives import REPO


def test_gaussian_process_and_optimizer_as_jax():
    rng = np.random.RandomState(4)
    x, y = rng.rand(7, 3), rng.rand(7) * 100
    cand = rng.rand(50, 3)
    gp_t, gp_j = TA.GaussianProcess(), JA.GaussianProcess()
    gp_t.fit(x, y)
    gp_j.fit(x, y)
    for a, b in zip(gp_t.predict(cand), gp_j.predict(cand)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    bo_t, bo_j = TA.BayesianOptimizer(3, seed=9), JA.BayesianOptimizer(3,
                                                                      seed=9)
    for xi, yi in zip(x, y):
        np.testing.assert_allclose(bo_t.next_sample(), bo_j.next_sample(),
                                   rtol=0, atol=1e-12)
        bo_t.observe(xi, yi)
        bo_j.observe(xi, yi)
    assert bo_t.best[1] == bo_j.best[1]


@pytest.fixture
def tune_env(monkeypatch, tmp_path):
    for k in [k for k in os.environ if k.startswith(("HOROVOD_", "HVD_TPU_"))]:
        monkeypatch.delenv(k)
    env = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "2",
           "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "3",
           "HOROVOD_AUTOTUNE_MAX_SAMPLES": "6",
           "HOROVOD_FUSION_THRESHOLD": str(8 << 20),
           "HOROVOD_MIN_BUCKETS": "2", "HOROVOD_WIRE_BIG_FORMAT": "fp16",
           "HOROVOD_SERVE_MAX_BATCH": "16"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    managers = {}

    def build(name):
        monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(tmp_path / name))
        mod = TA if name == "port" else JA
        mod.shutdown_manager()
        managers[name] = mod.init_from_env()
        return managers[name]

    yield build
    TA.shutdown_manager()
    JA.shutdown_manager()


def _knobs(pm):
    return [(n, t.low, t.high, t.log_scale, t.integer, t.host_only,
             t.current) for n, t in ((n, pm._tunables[n]) for n in pm._order)]


def _norm(pm):
    return [pm._tunables[n].norm(pm._tunables[n].current) for n in pm._order]


def _rows(path):
    with open(path) as f:
        return [line.split(",", 1)[1] for line in f]


def test_same_knobs_order_bounds_and_initial_values(tune_env):
    pt, pj = tune_env("port"), tune_env("jax")
    assert _knobs(pt) == _knobs(pj)
    assert len(pt._order) == 17 and pt.values() == pj.values()
    assert TA.current_fusion_threshold() == JA.current_fusion_threshold() \
        == 8 << 20
    assert TA.current_min_buckets() == JA.current_min_buckets() == 2


def test_same_rates_give_the_jax_proposals(tune_env):
    """Warmup discards 2 samples, 6 samples drive the search, then the
    manager freezes at the best: the same values after every sample
    (normalized within 1e-12), the same log."""
    pt, pj = tune_env("port"), tune_env("jax")
    rates = [50.0, 61.0, 40.0, 75.5, 70.25, 90.0, 66.0, 81.0, 99.0, 12.0]
    for rate in rates:
        pt.record_sample(rate)
        pj.record_sample(rate)
        np.testing.assert_allclose(_norm(pt), _norm(pj), rtol=0, atol=1e-12)
        assert pt.values() == pj.values() and pt.frozen == pj.frozen
    assert pt.frozen
    for name in ("fusion_threshold", "bucket_order", "min_buckets",
                 "zero_stage", "fused_chunk_bytes"):
        assert getattr(TA, f"current_{name}")() == \
            getattr(JA, f"current_{name}")()
    rows_t, rows_j = _rows(pt._log_file), _rows(pj._log_file)
    assert rows_t == rows_j
    kinds = [r.split(",")[0] for r in rows_t]
    assert kinds == ["warmup"] * 2 + ["sample"] * 6 + ["frozen"]


def test_record_step_and_trace_as_jax(tune_env):
    pt, pj = tune_env("port"), tune_env("jax")
    clock = np.cumsum(np.random.RandomState(2).rand(40) + 0.5)
    for k, now in enumerate(clock):
        items = 32 + k % 5
        pt.record_step(items, now=float(now))
        pj.record_step(items, now=float(now))
        if k == 20:
            pt.record_trace(123.0, 64, bucket_ms={"b0": 1.5})
            pj.record_trace(123.0, 64, bucket_ms={"b0": 1.5})
    np.testing.assert_allclose(_norm(pt), _norm(pj), rtol=0, atol=1e-12)
    assert _rows(pt._log_file) == _rows(pj._log_file)


def test_rate_sync_replaces_each_measured_rate():
    seen = []
    pm = TA.ParameterManager(warmup_samples=0, steps_per_sample=1,
                             max_samples=3,
                             rate_sync=lambda r: seen.append(r) or 7.0)
    pm.register("fusion_threshold", 1 << 20, 256 << 20, log_scale=True,
                integer=True, initial=64 << 20)
    for now in (0.0, 1.0, 3.0):
        pm.record_step(10, now=now)
    assert seen == [10.0, 5.0]
    assert pm._bo._ys == [7.0, 7.0]


def test_readers_without_a_tuner_read_the_env(monkeypatch):
    TA.shutdown_manager()
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "12345")
    monkeypatch.setenv("HOROVOD_FUSED_CHUNK_BYTES", "4096")
    monkeypatch.setenv("HOROVOD_BUCKET_ORDER", "forward")
    assert TA.current_fusion_threshold() == 12345
    assert TA.current_fused_chunk_bytes() == 4096
    assert TA.current_bucket_order() == "forward"
    monkeypatch.setenv("HOROVOD_BUCKET_ORDER", "sideways")
    with pytest.raises(ValueError, match="BUCKET_ORDER"):
        TA.current_bucket_order()


# ---------------------------------------------------------------------------
# np=2: the optimizer's buckets follow the live threshold on both ranks
# ---------------------------------------------------------------------------

WIDTHS = [512, 768, 384, 640, 512, 256]

WORKER = r'''
import sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils.autotune import current_fusion_threshold

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
widths = [int(w) for w in sys.argv[5].split(",")]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
g = torch.Generator().manual_seed(r)
layers = []
for a, b in zip(widths[:-1], widths[1:]):
    layers += [torch.nn.Linear(a, b), torch.nn.Tanh()]
model = torch.nn.Sequential(*layers)
order = []
for p in model.parameters():
    # Registered before the optimizer's: records the order in which the
    # gradients become final, independently of the optimizer.
    p.register_post_accumulate_grad_hook(
        lambda p: order.append(p.numel() * p.element_size()))
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.01))
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
steps = []
for k in range(12):
    x = torch.randn(4, widths[0], generator=g)
    order.clear()
    threshold = current_fusion_threshold()
    before = opt.total_flushes
    opt.zero_grad()
    model(x).square().mean().backward()
    opt.step()
    hvd.autotune_record_step(4)
    steps.append({"threshold": threshold, "flushes": opt.total_flushes - before,
                  "sizes": list(order),
                  "params": torch.cat([p.detach().reshape(-1)
                                       for p in model.parameters()])})
torch.save({"steps": steps}, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _buckets(sizes, threshold):
    """The hook path's bucket count: a bucket is dispatched once its
    bytes reach the threshold, and the rest at synchronize."""
    count, filled = 0, 0
    for s in sizes:
        filled += s
        if filled >= threshold:
            count, filled = count + 1, 0
    return count + (1 if filled else 0)


def test_np2_buckets_follow_the_live_threshold(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in [k for k in env if k.startswith(("HOROVOD_", "HVD_TPU_"))]:
        env.pop(k)
    env.update(HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
               HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="2",
               HOROVOD_AUTOTUNE_MAX_SAMPLES="4",
               HOROVOD_FUSION_THRESHOLD=str(2 << 20))
    url = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path), "2", str(r), url,
         ",".join(map(str, WIDTHS))], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    res = [torch.load(tmp_path / f"rank{r}.pt")["steps"] for r in range(2)]
    thresholds = [s["threshold"] for s in res[0]]
    assert thresholds == [s["threshold"] for s in res[1]]
    assert len(set(thresholds)) >= 2, thresholds
    for s0, s1 in zip(*res):
        assert s0["sizes"] == s1["sizes"]
        want = _buckets(s0["sizes"], s0["threshold"])
        assert s0["flushes"] == s1["flushes"] == want, (s0["threshold"],
                                                       s0["sizes"])
        assert torch.equal(s0["params"], s1["params"])
    assert len({s["flushes"] for s in res[0]}) >= 2
