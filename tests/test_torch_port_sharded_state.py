"""Elastic ZeRO (`hvd.elastic.ShardedTorchState`) and live resharding of
the port's stage-3 state at np=2 on the CPU, against the JAX package's
restack.

One launch of two gloo ranks under `python -m horovod_tpu_torch.runner`
(its rendezvous KV the transport) runs `chip_smoke.reshard_rank`, the
ranks of phase 25, at narrow widths: (a) a shrink 2->1 bitwise the local
restack, its staging peak under the ceiling; (b) a
grow 1->2 bitwise the original streams, then a step bitwise the step
without the round trip; (d) `reshard.peer_die` degrading both ranks to
the restore path with the digest gate clean, and a corrupt chunk
refused; (e) the chaos soak at np=2, at JAX's settings and with the
degrade branch off; (f) a crash shrink with no publish to a world of
one, which must take the restore path, bitwise (a)'s streams; (c) that
world of one publishing at `on_hosts_updated` and both ranks' `sync` in
a new world of two on the live path, bitwise the original streams.
`chip_smoke.check_reshard` holds the
results; the test then holds every shard stream of the shrink to JAX's
`reshard_shard_rows` and the optimizer's streams to JAX's
`reshard_opt_state` on the same flat rows."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.parallel import reshard as jrs
from horovod_tpu.parallel.optimizer import DistributedOptState, _ShardSlot

from test_torch_port_collectives import REPO, no_launcher_env  # noqa: F401

WORKER = r'''
import sys
sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke
from horovod_tpu_torch.models import TransformerConfig

cfg = TransformerConfig(vocab_size=256, d_model=64, n_heads=2, d_head=32,
                        d_ff=128, n_layers=2, compute_dtype=torch.float32)
chip_smoke.reshard_rank(cfg=cfg, seq_len=64, device="cpu",
                        zero3_env={"HOROVOD_FUSION_THRESHOLD": "65536"},
                        peak=1 << 16, chunk=4096, out_dir=sys.argv[1],
                        keep_streams=True)
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_state")
    worker = tmp / "reshard_worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in ("HOROVOD_COORDINATOR_ADDR", "HOROVOD_NUM_PROCESSES",
              "HOROVOD_PROCESS_ID", "HOROVOD_RENDEZVOUS_ADDR"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, str(worker), str(tmp), REPO], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout + r.stderr)[-8000:]
    return [torch.load(tmp / f"reshard_rank{k}.pt", weights_only=False)
            for k in range(2)]


def test_scenarios_hold(results):
    """(a)-(f) as phase 25 checks them on the card (K4-K6 aside: the CPU
    run takes the plain attention)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    out = chip_smoke.check_reshard(results, on_card=False)
    assert out["streams"] == len(results[0]["specs"])
    r0, r1 = results
    assert r0["class_path"] == r1["class_path"] == "reshard"
    assert r0["die_path"] == r1["die_path"] == "restore"
    assert r0["crash_path"] == "restore"


def _compat(results):
    """The two ranks' shard streams stacked into JAX's (2, shard) compat
    rows (zero padded), by stream name."""
    specs = [jrs.StreamSpec(*s) for s in results[0]["specs"]]
    out = {}
    for s in specs:
        if s.kind != "shard":
            continue
        sz = jrs._shard_sz(s.elems, 2)
        rows = np.zeros((2, sz), np.dtype(s.dtype))
        for r in range(2):
            part = results[r]["data"][s.name]
            rows[r, :part.size] = part
        out[s.name] = (s, rows)
    return out


def test_shrink_is_jax_restack(results):
    """Every shard stream rank 0 fetched at world 1 is JAX's
    `reshard_shard_rows` of the two ranks' rows, bitwise."""
    got = results[0]["shrunk"]
    for name, (s, rows) in _compat(results).items():
        want = jrs.reshard_shard_rows(rows, s.elems, 1)[0][:s.elems]
        assert got[name].tobytes() == want.tobytes(), name


def test_adamw_state_restack_is_jax(results):
    """The port's AdamW streams (exp_avg, exp_avg_sq per group, the
    replicated step) through JAX's `reshard_opt_state` at 1 and at 3
    ranks equal the port's local restack of the same streams."""
    from horovod_tpu_torch.parallel import reshard as rs

    specs = [rs.StreamSpec(*s) for s in results[0]["specs"]]
    per_old = [results[r]["data"] for r in range(2)]
    groups = sorted({int(s.name[1:].split(".")[0]) for s in specs
                     if s.name.startswith("o")})
    ge = tuple(next(s.elems for s in specs if s.name == f"o{g}.exp_avg")
               for g in groups)
    slots = []
    for g, elems in zip(groups, ge):
        st = {}
        for key in ("exp_avg", "exp_avg_sq"):
            sz = jrs._shard_sz(elems, 2)
            rows = np.zeros((2, sz), np.float32)
            for r in range(2):
                part = per_old[r][f"o{g}.{key}"]
                rows[r, :part.size] = part
            st[key] = rows
        st["step"] = np.repeat(per_old[0][f"o{g}.step"].astype(np.float32),
                               2)
        slots.append(_ShardSlot(st, None))
    jstate = DistributedOptState(tuple(slots), None, np.asarray(3), None,
                                 None)
    for n_new in (1, 3):
        jout = jrs.reshard_opt_state(jstate, ge, n_new)
        port = rs.reshard_rank_streams(specs, per_old, n_new)
        for j in range(n_new):
            for g, elems in zip(groups, ge):
                lo, hi = rs._owned_range(elems, n_new, j)
                for key in ("exp_avg", "exp_avg_sq"):
                    want = np.asarray(jout.inner[g].state[key])[j][:hi - lo]
                    assert port[j][f"o{g}.{key}"].tobytes() == \
                        want.tobytes(), (n_new, j, g, key)
                assert float(port[j][f"o{g}.step"][0]) == float(
                    np.asarray(jout.inner[g].state["step"])[j])


@pytest.mark.parametrize("fused_apply", [False, True], ids=["hooks", "fused"])
def test_an_optimizer_frees_its_model_after_its_last_use(fused_apply):
    """The gradient hooks hold the `DistributedOptimizer` weakly: once
    the caller drops the model and the optimizer, their parameters,
    gradients and state are freed (a folded run of phase 25's host
    process starts with none of the last run's memory)."""
    import gc
    import weakref

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                    torch.nn.Linear(16, 4))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            fused_apply=fused_apply)
        for _ in range(2):
            opt.zero_grad()
            model(torch.ones(2, 8)).sum().backward()
            opt.step()
        refs = [weakref.ref(p) for p in model.parameters()]
        del model, opt
        gc.collect()
        assert all(r() is None for r in refs)
    finally:
        hvd.shutdown()
