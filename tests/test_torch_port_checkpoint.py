"""Port parity: the checkpoint manager (`horovod_tpu_torch/utils/
checkpoint.py`) on the CPU, against the JAX package's
(`horovod_tpu/utils/checkpoint.py`).

The JAX package's one-process path is orbax, which the port does not
have; the port takes its rank-0 path in both modes.  So the parity is
that path's: the `step_N` / `step_N.corrupt` layout, the pruning and the
quarantine over the same directories (listings equal after the same
calls), rank 0 writing and every rank reading rank 0's view.  One
process: the round trip bitwise (f32, bf16, f16, int, bool tensors,
nested containers, Python values), `.tmp` swept, old steps pruned, a
sha256 mismatch, a garbled payload and a missing one raising
`CheckpointCorruptError`, `restore_latest` rolling back past a corrupt
step (and counting `hvd_checkpoint_rollbacks_total`), the fault points.
A 2-rank gloo world: rank 0 writes into a directory only it names, both
ranks list and restore its steps, a failed read raises on both.
"""

import os

import numpy as np
import pytest
import torch

from horovod_tpu.utils.checkpoint import CheckpointManager as JManager

from horovod_tpu_torch import faults
from horovod_tpu_torch.common.exceptions import CheckpointCorruptError
from horovod_tpu_torch.metrics import catalog as met
from horovod_tpu_torch.utils import checkpoint as ckpt
from horovod_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_port_collectives import (  # noqa: F401
    no_launcher_env, run_world)


def _state(seed=0):
    rng = np.random.RandomState(seed)
    f = torch.from_numpy(rng.randn(5, 7).astype(np.float32))
    return {
        "model": {"w": f, "b16": f.to(torch.bfloat16)[:3],
                  "h": f.half().t(), "i": torch.arange(9).reshape(3, 3),
                  "mask": torch.from_numpy(rng.rand(6) > 0.5)},
        "opt": {"state": {0: {"step": torch.tensor(7.0),
                              "exp_avg": f * 0.5}},
                "param_groups": [{"lr": 3e-4, "betas": (0.9, 0.999),
                                  "params": [0], "foreach": None}]},
        "step": 11, "tag": "run",
    }


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and a.reshape(-1).contiguous().view(
                    torch.uint8).equal(b.reshape(-1).contiguous().view(
                        torch.uint8)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return a == b


def test_round_trip_is_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    assert mgr.save(3, st)
    assert sorted(os.listdir(tmp_path / "step_3")) == ["state.pt",
                                                       "state.sha256"]
    got = mgr.restore(3)
    assert _same(got, st)
    assert all(t.device.type == "cpu" for t in got["model"].values())
    assert _same(mgr.restore_latest(template=st), st)
    assert mgr.latest_step() == 3 and mgr.all_steps() == [3]


def test_a_view_saves_only_itself(tmp_path):
    """A parameter that views a larger buffer (a ZeRO-3 binding) saves
    its own elements, not the buffer's."""
    buf = torch.arange(1 << 16, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"p": buf[10:20]})
    assert os.path.getsize(tmp_path / "step_1" / "state.pt") < 4096
    assert torch.equal(mgr.restore(1)["p"], buf[10:20])


def test_template_places_and_checks_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2), "b": [torch.zeros(3), 4]})
    got = mgr.restore(1, template={"a": torch.empty(2),
                                   "b": [torch.empty(3), 0]})
    assert got["b"][1] == 4 and got["a"].device.type == "cpu"
    with pytest.raises(ValueError, match="template has 1 leaves"):
        mgr.restore(1, template={"a": torch.empty(2)})


def test_tmp_is_swept_and_old_steps_pruned(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    (tmp_path / "step_5.tmp").mkdir(parents=True)
    (tmp_path / "step_5.tmp" / "junk").write_text("x")
    for s in (1, 2, 5, 9):
        mgr.save(s, {"s": torch.tensor(s)})
    assert sorted(os.listdir(tmp_path)) == ["step_5", "step_9"]
    assert int(mgr.restore(5)["s"]) == 5
    # max_to_keep=None keeps every step.
    keep = CheckpointManager(str(tmp_path / "all"), max_to_keep=None)
    for s in range(4):
        keep.save(s, {"s": s})
    assert keep.all_steps() == [0, 1, 2, 3]


@pytest.mark.parametrize("keep", [None, 3])
def test_pruning_matches_jax(tmp_path, keep):
    """The same steps saved into the port's manager and listed for the
    JAX package's rank-0 path: the same step directories stay."""
    port = CheckpointManager(str(tmp_path / "p"), max_to_keep=keep)
    for s in (4, 1, 7, 2, 9):
        port.save(s, {"s": s})
    jm = JManager(str(tmp_path / "j"), max_to_keep=keep)
    os.makedirs(tmp_path / "j")
    for s in (4, 1, 7, 2, 9):
        (tmp_path / "j" / f"step_{s}").mkdir()
        jm._prune()
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))
    assert port._local_steps() == jm._pickle_steps()


def _corrupt_payload(path):
    data = bytearray((path / "state.pt").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (path / "state.pt").write_bytes(bytes(data))


def test_sha256_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    _corrupt_payload(tmp_path / "step_1")
    with pytest.raises(CheckpointCorruptError, match="digest mismatch"):
        mgr.restore(1)


def test_garbled_and_missing_payloads_raise(tmp_path):
    import hashlib

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    garbage = b"not a checkpoint"
    (tmp_path / "step_1" / "state.pt").write_bytes(garbage)
    (tmp_path / "step_1" / "state.sha256").write_text(
        hashlib.sha256(garbage).hexdigest())
    with pytest.raises(CheckpointCorruptError, match="failed to load"):
        mgr.restore(1)
    (tmp_path / "step_2").mkdir()
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        mgr.restore(2)


def test_quarantine_moves_then_prunes_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_CKPT_QUARANTINE_KEEP", "1")
    trees = {}
    for name, cls in (("p", CheckpointManager), ("j", JManager)):
        mgr = cls(str(tmp_path / name))
        for s in (1, 2):
            (tmp_path / name / f"step_{s}").mkdir(parents=True)
            mgr._quarantine(s)
        trees[name] = sorted(os.listdir(tmp_path / name))
    assert trees["p"] == trees["j"] == ["step_2.corrupt"]


@pytest.mark.parametrize("keep", ["0", "2", "5"])
def test_quarantine_prune_matches_jax(tmp_path, monkeypatch, keep):
    monkeypatch.setenv("HOROVOD_CKPT_QUARANTINE_KEEP", keep)
    trees = {}
    for name, cls in (("p", CheckpointManager), ("j", JManager)):
        d = tmp_path / name
        for s in (3, 1, 4, 5, 9):
            (d / f"step_{s}.corrupt").mkdir(parents=True)
        (d / "step_6").mkdir()
        cls(str(d))._prune_quarantine()
        trees[name] = sorted(os.listdir(d))
    assert trees["p"] == trees["j"]


def test_restore_latest_rolls_back_past_a_corrupt_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    for s in (1, 2, 3):
        mgr.save(s, {"s": torch.tensor(s)})
    _corrupt_payload(tmp_path / "step_3")
    (tmp_path / "step_2" / "state.pt").unlink()
    before = met.checkpoint_rollbacks.labels().get()
    got = mgr.restore_latest()
    assert int(got["s"]) == 1
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2.corrupt",
                                            "step_3.corrupt"]
    assert met.checkpoint_rollbacks.labels().get() == before + 2
    assert mgr.latest_step() == 1
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest() is None and empty.latest_step() is None


def test_one_shot_helpers(tmp_path):
    st = _state(1)
    assert ckpt.save_checkpoint(str(tmp_path), st, step=4)
    assert ckpt.save_checkpoint(str(tmp_path), _state(2), step=6)
    assert _same(ckpt.restore_checkpoint(str(tmp_path), step=4), st)
    assert _same(ckpt.restore_checkpoint(str(tmp_path)), _state(2))


@pytest.mark.parametrize("point", ["checkpoint.save", "checkpoint.restore"])
def test_fault_points_fire(tmp_path, point):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(1)})
    try:
        faults.install(f"{point}@1:err")
        with pytest.raises(faults.FaultInjected):
            if point == "checkpoint.save":
                mgr.save(2, {"a": torch.ones(1)})
            else:
                mgr.restore_latest()
        # Counted without acting: both points, every call.
        faults.install("checkpoint.save@1:delay:0s:0.000001,"
                       "checkpoint.restore@1:delay:0s:0.000001")
        mgr.save(3, {"a": torch.ones(1)})
        mgr.restore(3)
        mgr.restore_latest()
        assert faults.points_hit("checkpoint.save") == 1
        assert faults.points_hit("checkpoint.restore") == 2
    finally:
        faults.clear()
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_3"]


WORKER = r'''
import os, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils.checkpoint import CheckpointManager

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
# Only rank 0's directory holds files: rank 1 names one that is empty.
mgr = CheckpointManager(os.path.join(out_dir, "ckpt" if r == 0 else
                                     f"empty{r}"), max_to_keep=2)
res = {"rank": r}
tmpl = {"w": torch.zeros(4), "step": 0}
res["latest_before"] = mgr.latest_step()
res["saved"] = [mgr.save(s, {"w": torch.full((4,), float(s + r)),
                             "step": s}) for s in (1, 2, 3)]
res["latest"] = mgr.latest_step()
res["all"] = mgr.all_steps()
res["restored"] = mgr.restore_latest(template=tmpl)
res["restored_2"] = mgr.restore(2, template=tmpl)
if r == 0:   # corrupt step 3: restore(3) must fail on every rank
    p = os.path.join(out_dir, "ckpt", "step_3", "state.pt")
    data = bytearray(open(p, "rb").read())
    data[-10] ^= 0xFF
    open(p, "wb").write(bytes(data))
try:
    mgr.restore(3)
    res["error"] = None
except RuntimeError as e:
    res["error"] = str(e)
res["rolled_back"] = mgr.restore_latest()
res["listing"] = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("ckpt2"), 2, WORKER)


def test_rank0_writes_and_both_ranks_restore(world):
    r0, r1 = world
    assert r0["saved"] == [True] * 3 and r1["saved"] == [False] * 3
    for d in world:
        assert d["latest_before"] is None
        assert d["latest"] == 3 and d["all"] == [2, 3]
        assert torch.equal(d["restored"]["w"], torch.full((4,), 3.0))
        assert d["restored"]["step"] == 3
        assert torch.equal(d["restored_2"]["w"], torch.full((4,), 2.0))


def test_a_failed_read_raises_on_every_rank_and_rolls_back(world):
    for d in world:
        assert d["error"] is not None and "digest mismatch" in d["error"]
        assert d["error"].startswith("checkpoint restore failed on rank 0")
        assert d["rolled_back"]["step"] == 2
        assert d["listing"] == ["step_2", "step_3.corrupt"]
