"""The port's headline bench `horovod_tpu_torch.bench` on the CPU at a
tiny size (ResNet-18, 32×32, batch 2, 10 classes, 2 timed steps a row):
it prints exactly one JSON line with every key; at one rank the hvd,
plain and DDP rows leave bitwise the same parameters (a one-rank
allreduce changes no bit, in the port or in DDP's reducer over gloo);
with no card and no `--device cpu` it raises and prints no number."""

import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_port_collectives import REPO

TINY = ["--model", "resnet18", "--image-size", "32", "--batch-size", "2",
        "--num-classes", "10", "--num-warmup-batches", "1",
        "--num-batches-per-iter", "1", "--num-iters", "2"]
ROW_KEYS = {"img_sec", "ci95", "img_secs", "idle_share",
            "device_busy_ms_per_step", "digest"}


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="2")
    for k in [k for k in env if k.startswith(("HOROVOD_", "HVD_TPU_"))]:
        env.pop(k)
    return subprocess.run([sys.executable, "-m", "horovod_tpu_torch.bench",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)


@pytest.fixture(scope="module")
def tiny_line():
    r = _run(["--device", "cpu", "--profile", "1", *TINY])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0])


def test_one_json_line_with_every_key(tiny_line):
    line = tiny_line
    for key in ("metric", "value", "unit", "plain", "ddp", "vs_baseline",
                "vs_ddp", "rows", "model", "batch_size", "image_size",
                "size", "backend", "fusion_threshold", "device"):
        assert key in line, key
    assert line["metric"] == "resnet18_synthetic_img_sec_per_rank"
    assert (line["size"], line["backend"], line["device"]) == (1, "gloo",
                                                                "cpu")
    assert set(line["rows"]) == {"hvd", "plain", "ddp"}
    for name, row in line["rows"].items():
        assert set(row) == ROW_KEYS, name
        assert len(row["img_secs"]) == 2 and row["img_sec"] > 0
        # The CPU has no card whose idle share a trace could read.
        assert row["idle_share"] is None
    assert line["value"] == line["rows"]["hvd"]["img_sec"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / line["plain"])
    assert line["vs_ddp"] == pytest.approx(line["value"] / line["ddp"])


def test_rows_leave_the_same_parameters_at_one_rank(tiny_line):
    digests = {k: r["digest"] for k, r in tiny_line["rows"].items()}
    assert len(set(digests.values())) == 1, digests


def test_without_a_card_it_raises_and_prints_no_number():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the bench would use it")
    r = _run(TINY)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "device='cpu'" in r.stderr


def test_autoscale_extra_prints_one_record():
    """`--autoscale` on the CPU: one JSON line, the A/B's records equal
    `simulate_autoscale`'s in this process, the autoscaled fleet ahead
    on the burst at the same mean size, and two scale events (the grow
    faulted) all recovered."""
    from horovod_tpu_torch.serve.autoscale import (
        AutoscaleConfig, simulate_autoscale)
    from horovod_tpu_torch.serve.loadgen import make_shaped_trace

    r = _run(["--autoscale", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, r.stdout
    rec = json.loads(lines[0])
    assert rec["bench"] == "autoscale"
    assert rec["autoscaled_wins_burst"] and rec["all_recovered"]
    assert (rec["scale_events"], rec["scale_events_faulted"]) == (2, 1)
    cfg = AutoscaleConfig(min_replicas=1, max_replicas=8, cooldown_steps=4,
                          dwell_steps=2, grow_step=2)
    trace = make_shaped_trace("burst", 7, 500, 64, base_every=4.0,
                              burst_every=128, burst_size=80)
    assert rec["ab"]["burst"]["autoscaled"] == simulate_autoscale(trace, cfg)
    assert set(rec["ab"]) == {"burst", "diurnal", "multi_tenant"}
