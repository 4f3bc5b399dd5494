"""Port parity: the estimator layer (`horovod_tpu_torch.spark.common`,
`.spark.torch`, `.spark.lightning`) against `horovod_tpu.spark`'s.

- The store (routing, path layout, local and remote writes,
  `save_checkpoint`), `Params`, `prepare_data` and `ShardDataLoader`:
  the same files, shards and batches as JAX's for the same frame and
  seed, bitwise.
- The validation errors (driver-side, before any data is written):
  JAX's messages, but for the package's name.
- `LocalBackend` passes the caller's env only (JAX's pins its workers to
  the CPU with JAX_PLATFORMS); the estimators' `device` reaches each
  worker's `hvd.init` and the fitted model's `_predict`.
- `TorchEstimator.fit` at np=2 over `LocalBackend(2)` on the CPU: each
  epoch's loss and validation loss within 1e-6 of a plain one-process
  torch loop over the same batches with the ranks' gradients averaged,
  and the returned (CPU) module's parameters too; the Lightning fit at
  np=2 and its one-process scheduler case held to the same loop.
"""

import io
import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import horovod_tpu.spark.common.data_loader as JDL
import horovod_tpu.spark.common.params as JP
import horovod_tpu.spark.common.store as JS
import horovod_tpu.spark.common.util as JU
import horovod_tpu_torch.spark.common.data_loader as PDL
import horovod_tpu_torch.spark.common.params as PP
import horovod_tpu_torch.spark.common.store as PS
import horovod_tpu_torch.spark.common.util as PU
from horovod_tpu.common.exceptions import HorovodTpuError as JErr
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.spark.common import LocalBackend, Store

from test_torch_port_collectives import (  # noqa: F401  (autouse)
    REPO,
    no_launcher_env,
)

DATA = os.path.join(REPO, "tests", "data")
PKGS = {"jax": (JS, JU, JDL, JP), "port": (PS, PU, PDL, PP)}


def make_df(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = 2.0 * x1 - 1.0 * x2 + 0.5
    return pd.DataFrame({"x1": x1, "x2": x2, "y": y.astype(np.float32)})


def _tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------

class _MockFs:
    """In-memory duck-typed filesystem client with HDFS's rename (it
    refuses to overwrite)."""

    def __init__(self):
        self.files, self.dirs, self.renames = {}, set(), []

    class _Buf:
        def __init__(self, fs, path, mode):
            self._fs, self._path, self._mode = fs, path, mode
            self._io = io.BytesIO(fs.files.get(path, b"")
                                  if "r" in mode else b"")

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if "w" in self._mode:
                self._fs.files[self._path] = self._io.getvalue()

        def read(self):
            return self._io.getvalue()

        def write(self, data):
            self._io.write(data)

    def open(self, path, mode="rb"):
        return self._Buf(self, path, mode)

    def exists(self, path):
        return path in self.files or path in self.dirs or any(
            f.startswith(path + "/") for f in self.files)

    def mkdirs(self, path):
        self.dirs.add(path)

    def ls(self, path):
        out = set()
        for f in list(self.files) + list(self.dirs):
            if f.startswith(path + "/"):
                out.add(f[len(path) + 1:].split("/")[0])
        return sorted(path + "/" + o for o in out)

    def rename(self, src, dst):
        if dst in self.files:
            raise FileExistsError(dst)
        self.renames.append((src, dst))
        self.files[dst] = self.files.pop(src)

    def delete(self, path):
        self.files.pop(path, None)


def _layout(store, run="r1"):
    return (type(store).__name__, store.prefix_path,
            store.get_run_path(run), store.get_train_data_path(run),
            store.get_val_data_path(run), store.get_checkpoint_path(run),
            store.get_logs_path(run))


@pytest.mark.parametrize("url", [
    "{tmp}/store", "file://{tmp}/fs", "dbfs:/ml/store", "DBFS:/x/y",
    "hdfs://nn:8020/warehouse", "hdfs:///wh", "s3://bucket/prefix",
    "abfss://c@a/x", "gs://b/p/"])
def test_store_routing_and_layout_are_jax(tmp_path, url):
    url = url.format(tmp=tmp_path)
    remote = "://" in url and not url.startswith("file://")
    kw = {"filesystem": _MockFs()} if remote else {}
    assert _layout(PS.Store.create(url, **kw)) == \
        _layout(JS.Store.create(url, **kw))


@pytest.mark.parametrize("url,kw", [
    ("s3://b/x", {}), ("abfss://c@a/x", {}), ("hdfs://nn/x", {}),
    ("dbfs:/x", {"filesystem": object()})])
def test_store_refusals_are_jax(url, kw):
    msgs = {}
    for name, (S, _, _, _) in PKGS.items():
        with pytest.raises((JErr, HorovodTpuError)) as e:
            S.Store.create(url, **kw)
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["jax"]


def test_remote_writes_are_jax():
    """The same writes through HDFS-like clients leave the same files
    (the tmp names are random; the renames' destinations are not)."""
    state = {}
    for name, (S, _, _, _) in PKGS.items():
        fs = _MockFs()
        s = S.Store.create("hdfs://nn/wh", filesystem=fs)
        p = s.get_checkpoint_path("r3")
        s.write_bytes(p, b"epoch1")
        s.write_bytes(p, b"epoch2")
        s.write_bytes(s.get_run_path("r3") + "/blob.bin", b"payload")
        state[name] = (fs.files, [d for _, d in fs.renames],
                       s.read_bytes(p), s.list_dir(s.get_run_path("r3")),
                       s.saving_runs())
    assert state["port"] == state["jax"]
    assert state["port"][2] == b"epoch2"


def test_strip_scheme_is_jax():
    for p in ("hdfs://nn:8020/tmp/run/x", "hdfs:///tmp/run/x",
              "hdfs://nn:8020", "/plain/path", "s3://b"):
        assert PS._strip_scheme(p) == JS._strip_scheme(p)


def test_local_store_and_checkpoint_are_jax(tmp_path):
    payload = {"state_dict": {"w": np.arange(6, dtype=np.float32)},
               "epoch": 3}
    trees = {}
    for name, (S, _, _, _) in PKGS.items():
        root = tmp_path / name
        s = S.Store.create(str(root))
        s.write_bytes(s.get_run_path("r") + "/a/b.bin", b"abc")
        assert s.read_bytes(s.get_run_path("r") + "/a/b.bin") == b"abc"
        ckpt = S.save_checkpoint(s.get_run_path("r"), payload)
        assert ckpt == s.get_checkpoint_path("r")
        trees[name] = (_tree(root), s.saving_runs())
    assert trees["port"] == trees["jax"]
    assert PS.CHECKPOINT_FILE == JS.CHECKPOINT_FILE
    assert [PS.part_name(r) for r in (0, 7, 12345)] == \
        [JS.part_name(r) for r in (0, 7, 12345)]


def test_owned_tempdir_cleanup():
    s = Store.create(None)
    prefix = s.prefix_path
    assert os.path.isdir(prefix)
    s.cleanup()
    assert not os.path.exists(prefix)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def test_params_are_jax_plus_device():
    port = PP.EstimatorParams._collect_params()
    assert port == dict(JP.EstimatorParams._collect_params(), device=None)
    p = PP.EstimatorParams(batch_size=16)
    assert p.setEpochs(7) is p and p.getEpochs() == 7
    assert p.setDevice("cpu").getDevice() == "cpu"
    assert (p.setFeatureCols(["x1"]).getFeatureCols() ==
            JP.EstimatorParams().setFeatureCols(["x1"]).getFeatureCols())


@pytest.mark.parametrize("bad", ["unknown", "attribute"])
def test_param_refusals_are_jax(bad):
    msgs = {}
    for name, (_, _, _, P) in PKGS.items():
        with pytest.raises((TypeError, AttributeError)) as e:
            if bad == "unknown":
                P.EstimatorParams(nonsense=1)
            else:
                P.EstimatorParams().setNonsense  # noqa: B018
        msgs[name] = (type(e.value), str(e.value))
    # The port's table has one more valid name, `device`.
    assert msgs["port"] == (msgs["jax"][0], msgs["jax"][1].replace(
        "'custom_objects', ", "'custom_objects', 'device', "))


# ---------------------------------------------------------------------------
# prepare_data and the shard loader, bitwise JAX's
# ---------------------------------------------------------------------------

def _frame(case):
    if case == "arrays":
        rng = np.random.default_rng(3)
        return pd.DataFrame({
            "img": [rng.normal(size=(2, 3)).astype(np.float32)
                    for _ in range(22)],
            "cls": rng.integers(0, 5, size=22),
            "w": rng.normal(size=22)})
    df = make_df(41, seed=5)
    df["is_val"] = np.arange(41) % 5 == 0
    df["cls"] = np.arange(41) % 3
    return df


PREPARE = {
    "no_shuffle": dict(frame="plain", shards=3, feats=["x1", "x2"],
                       labels=["y"], shuffle=False),
    "shuffle_seeded": dict(frame="plain", shards=2, feats=["x2", "x1"],
                           labels=["y"], seed=11),
    "fraction": dict(frame="plain", shards=4, feats=["x1"], labels=["y"],
                     validation=0.25, seed=1),
    "column": dict(frame="plain", shards=2, feats=["x1", "x2"],
                   labels=["y", "cls"], validation="is_val", seed=2),
    "int_labels": dict(frame="plain", shards=3, feats=["x1"],
                       labels=["cls"], validation=0.1, seed=4),
    "array_cells": dict(frame="arrays", shards=2, feats=["img", "w"],
                        labels=["cls"], validation=0.2, seed=7),
}


@pytest.mark.parametrize("case", sorted(PREPARE))
def test_prepare_data_shards_are_jax(tmp_path, case):
    c = PREPARE[case]
    df = _frame(c["frame"])
    got = {}
    for name, (S, U, _, _) in PKGS.items():
        s = S.Store.create(str(tmp_path / name))
        meta = U.prepare_data(
            df, s, "run", c["shards"], feature_cols=c["feats"],
            label_cols=c["labels"], validation=c.get("validation"),
            shuffle=c.get("shuffle", True), seed=c.get("seed"))
        got[name] = (meta, _tree(str(tmp_path / name)))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert len(got["port"][1]) == 2 * (c["shards"]
                                       + bool(got["port"][0]["val_rows"]))


@pytest.mark.parametrize("shuffle,seed,bs,drop_last", [
    (True, 0, 4, True), (True, 9, 5, False), (False, None, 3, False),
    (False, None, 7, True), (True, 3, 64, False)])
def test_shard_loader_batches_are_jax(tmp_path, shuffle, seed, bs,
                                      drop_last):
    s = Store.create(str(tmp_path))
    PU.prepare_data(make_df(61), s, "r", 2, ["x1", "x2"], ["y"], seed=5)
    d = s.get_train_data_path("r")
    for rank in (0, 1):
        p = PDL.ShardDataLoader(d, rank, bs, shuffle=shuffle, seed=seed,
                                drop_last=drop_last)
        j = JDL.ShardDataLoader(d, rank, bs, shuffle=shuffle, seed=seed,
                                drop_last=drop_last)
        assert (len(p), p.rows) == (len(j), j.rows)
        for epoch in range(3):
            pb, jb = list(p.epoch(epoch)), list(j.epoch(epoch))
            assert len(pb) == len(jb) == len(p)
            for (px, py), (jx, jy) in zip(pb, jb):
                assert px.tobytes() == jx.tobytes()
                assert py.tobytes() == jy.tobytes()


def test_loaders_and_output_frame_are_jax(tmp_path):
    s = Store.create(str(tmp_path))
    PU.prepare_data(make_df(30), s, "r", 2, ["x1"], ["y"], validation=0.2,
                    seed=1)
    for rank in (0, 1):
        for a, b in zip(PU.load_shard(s.get_train_data_path("r"), rank),
                        JU.load_shard(s.get_train_data_path("r"), rank)):
            assert a.tobytes() == b.tobytes()
    for a, b in zip(PU.load_val(s.get_val_data_path("r")),
                    JU.load_val(s.get_val_data_path("r"))):
        assert a.tobytes() == b.tobytes()
    assert PU.shard_paths("/d", 3) == JU.shard_paths("/d", 3)
    assert PU.shard_paths("/d", PU.VAL_BASE) == JU.shard_paths("/d", "val")
    for cols, preds in ((["p"], np.zeros((4, 1))), (["p"], np.ones((4, 3))),
                        (["mu", "sd"], np.arange(8.0).reshape(4, 2))):
        pd.testing.assert_frame_equal(
            PU.to_output_frame(make_df(4), cols, preds),
            JU.to_output_frame(make_df(4), cols, preds))
    with pytest.raises(HorovodTpuError, match="outputs per row"):
        PU.to_output_frame(make_df(4), ["mu", "sigma"], np.zeros((4, 3)))


def test_missing_shard_raises(tmp_path):
    with pytest.raises(HorovodTpuError, match="no shard"):
        PDL.ShardDataLoader(str(tmp_path), 7, batch_size=4)


# ---------------------------------------------------------------------------
# Driver-side refusals: JAX's messages
# ---------------------------------------------------------------------------

def _lit():
    if DATA not in sys.path:
        sys.path.insert(0, DATA)
    import lit_module

    return lit_module


def _refusal(pkg, case, tmp_path):
    """Raise the refusal `case` with package `pkg`'s estimators."""
    import importlib

    base = "horovod_tpu" if pkg == "jax" else "horovod_tpu_torch"
    st = importlib.import_module(f"{base}.spark.torch")
    sl = importlib.import_module(f"{base}.spark.lightning")
    common = importlib.import_module(f"{base}.spark.common")
    util = importlib.import_module(f"{base}.spark.common.util")
    net = torch.nn.Linear(2, 1)
    sgd = torch.optim.SGD(net.parameters(), lr=0.1)
    mse = torch.nn.functional.mse_loss
    one = common.LocalBackend(1)
    cols = dict(feature_cols=["x1", "x2"], label_cols=["y"])
    store = common.Store.create(str(tmp_path / pkg))
    lit = _lit()
    df = make_df(8)
    if case == "no_model":
        st.TorchEstimator(**cols).fit(df)
    elif case == "no_cols":
        st.TorchEstimator(model=object()).fit(df)
    elif case == "no_loss":
        st.TorchEstimator(model=net, optimizer=sgd, backend=one,
                          **cols).fit(df)
    elif case == "callbacks":
        st.TorchEstimator(model=net, optimizer=sgd, loss=mse, backend=one,
                          callbacks=[object()], **cols).fit(df)
    elif case == "optimizer":
        st.TorchEstimator(model=net, optimizer="sgd", loss=mse, backend=one,
                          store=store, run_id="leak", **cols).fit(df)
    elif case == "compression":
        st.TorchEstimator(model=net, optimizer=sgd, loss=mse, backend=one,
                          compression="int4", **cols).fit(df)
    elif case == "backward_passes":
        st.TorchEstimator(model=net, optimizer=sgd, loss=mse, backend=one,
                          backward_passes_per_step=0, **cols).fit(df)
    elif case == "group_order":
        seq = torch.nn.Sequential(torch.nn.Linear(2, 4),
                                  torch.nn.Linear(4, 1))
        opt = torch.optim.SGD([{"params": seq[1].parameters(), "lr": 0.001},
                               {"params": seq[0].parameters(), "lr": 0.01}],
                              lr=0.1)
        st._build_optimizer(st._optimizer_recipe(opt), seq)
    elif case == "param_count":
        st._build_optimizer(st._optimizer_recipe(
            torch.optim.SGD([net.weight], lr=0.1)), net)
    elif case == "lit_contract":
        sl.LightningEstimator(model=torch.nn.Linear(2, 1), backend=one,
                              **cols).fit(df)
    elif case == "lit_loss":
        sl.LightningEstimator(model=lit.LitRegression(), loss="mse",
                              backend=one, **cols).fit(df)
    elif case == "lit_multi_opt":
        sl.LightningEstimator(model=lit.LitMultiOpt(), backend=one,
                              store=store, run_id="multi", **cols).fit(df)
    elif case == "lit_callbacks":
        sl.LightningEstimator(model=lit.LitRegression(), backend=one,
                              callbacks=[object()], **cols).fit(df)
    elif case == "lit_step_loss":
        sl._step_loss({"log": {}})
    elif case == "too_few_rows":
        util.prepare_data(make_df(2), store, "r", 4, ["x1"], ["y"])
    elif case == "missing_column":
        util.prepare_data(df, store, "r", 2, ["nope"], ["y"])
    elif case == "validation_column":
        util.prepare_data(df, store, "r", 2, ["x1"], ["y"],
                          validation="is_vall")
    elif case == "validation_fraction":
        util.prepare_data(df, store, "r", 2, ["x1"], ["y"], validation=1.5)
    elif case == "cluster_store":
        from types import ModuleType, SimpleNamespace

        mod = ModuleType("pyspark")
        mod.SparkContext = SimpleNamespace(_active_spark_context=(
            SimpleNamespace(master="spark://cluster:7077")))
        saved = sys.modules.get("pyspark")
        sys.modules["pyspark"] = mod
        try:
            est = importlib.import_module(f"{base}.spark.common.estimator")
            backend = importlib.import_module(f"{base}.spark.common.backend")
            est.HorovodEstimator._check_store_reachable(
                common.Store.create(None), backend.SparkBackend(2))
        finally:
            if saved is None:
                sys.modules.pop("pyspark")
            else:
                sys.modules["pyspark"] = saved
    else:
        raise AssertionError(case)


REFUSALS = ["no_model", "no_cols", "no_loss", "callbacks", "optimizer",
            "compression", "backward_passes", "group_order", "param_count",
            "lit_contract", "lit_loss", "lit_multi_opt", "lit_callbacks",
            "lit_step_loss", "too_few_rows", "missing_column",
            "validation_column", "validation_fraction", "cluster_store"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_are_jax(tmp_path, case):
    msgs = {}
    for pkg in ("jax", "port"):
        with pytest.raises((JErr, HorovodTpuError)) as e:
            _refusal(pkg, case, tmp_path)
        assert isinstance(e.value, JErr if pkg == "jax" else HorovodTpuError)
        msgs[pkg] = str(e.value).replace("horovod_tpu_torch", "horovod_tpu")
    assert msgs["port"] == msgs["jax"]
    # Refused before prepare_data: no shard scratch left in the store.
    for pkg in ("jax", "port"):
        s = Store.create(str(tmp_path / pkg))
        for run in ("leak", "multi"):
            assert not os.path.exists(s.get_train_data_path(run))


def test_optimizer_recipe_keeps_param_groups():
    from horovod_tpu_torch.spark.torch import (
        _build_optimizer, _optimizer_recipe,
    )

    net = torch.nn.Sequential(torch.nn.Linear(2, 4), torch.nn.Linear(4, 1))
    opt = torch.optim.SGD([
        {"params": net[0].parameters(), "lr": 0.01},
        {"params": net[1].parameters(), "lr": 0.001, "momentum": 0.5},
    ], lr=0.1)
    net2 = torch.nn.Sequential(torch.nn.Linear(2, 4), torch.nn.Linear(4, 1))
    rebuilt = _build_optimizer(_optimizer_recipe(opt), net2)
    assert [g["lr"] for g in rebuilt.param_groups] == [0.01, 0.001]
    assert rebuilt.param_groups[1]["momentum"] == 0.5
    assert rebuilt.param_groups[0]["params"] == list(net2[0].parameters())
    factory = _build_optimizer(_optimizer_recipe(
        lambda ps: torch.optim.Adam(ps, lr=0.5)), net2)
    assert isinstance(factory, torch.optim.Adam)


def test_lightning_optimizer_forms():
    from horovod_tpu_torch.spark.lightning import _single_optimizer

    lit = _lit()
    m = lit.LitRegression()
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1)
    assert _single_optimizer(opt) == (opt, [])
    assert _single_optimizer([opt]) == (opt, [])
    assert _single_optimizer(([opt], [sched])) == (opt, [sched])
    assert _single_optimizer([[opt], [sched]]) == (opt, [sched])
    assert _single_optimizer({"optimizer": opt, "lr_scheduler": {
        "scheduler": sched, "interval": "epoch"}}) == (opt, [sched])
    for bad, match in (
            (([opt, opt], []), "single-optimizer"),
            ((opt, torch.optim.SGD(m.parameters(), lr=0.1)),
             "single-optimizer"),
            ({"optimizer": opt, "lr_scheduler": {"scheduler": sched,
                                                 "interval": "step"}},
             "once per epoch"),
            ({"lr_scheduler": {"scheduler": sched}}, "'optimizer' key"),
            ({"optimizer": opt, "lr_scheduler": {"interval": "epoch"}},
             "'scheduler' key")):
        with pytest.raises(HorovodTpuError, match=match):
            _single_optimizer(bad)


# ---------------------------------------------------------------------------
# The backend and the device
# ---------------------------------------------------------------------------

def test_local_backend_passes_only_the_callers_env(monkeypatch):
    import horovod_tpu_torch.runner.api as api

    seen = {}

    def fake_run(fn, args=(), np=1, extra_env=None, **kw):
        seen.update(np=np, env=extra_env, timeout=kw["start_timeout"])
        return ["r"] * np

    monkeypatch.setattr(api, "run", fake_run)
    assert LocalBackend(3, start_timeout=9.0).run(
        print, env={"A": "1"}) == ["r"] * 3
    assert seen == {"np": 3, "env": {"A": "1"}, "timeout": 9.0}
    LocalBackend(2).run(print, np=1)
    assert seen["np"] == 1 and seen["env"] == {}


def test_the_spec_carries_the_device(tmp_path, monkeypatch):
    from horovod_tpu_torch.spark.torch import TorchEstimator

    specs = []

    class Capture(LocalBackend):
        def run(self, fn, args=(), env=None, np=None):
            specs.append(args[0])
            return [{"model": b"", "history": {}}] * self.num_processes()

    net = torch.nn.Linear(2, 1)
    for device in (None, "cpu"):
        model = TorchEstimator(
            model=net, optimizer=torch.optim.SGD(net.parameters(), lr=0.1),
            loss=torch.nn.functional.mse_loss, feature_cols=["x1", "x2"],
            label_cols=["y"], backend=Capture(2), device=device,
            store=Store.create(str(tmp_path))).fit(make_df(8))
        assert specs[-1]["device"] == device and model.device == device


def test_the_default_device_is_the_card(tmp_path):
    """No CUDA here: a fit and a prediction that name no device refuse,
    nothing falls back to the CPU."""
    from horovod_tpu_torch.spark.torch import TorchEstimator, TorchModel

    net = torch.nn.Linear(2, 1)
    est = TorchEstimator(
        model=net, optimizer=torch.optim.SGD(net.parameters(), lr=0.1),
        loss=torch.nn.functional.mse_loss, feature_cols=["x1", "x2"],
        label_cols=["y"], backend=LocalBackend(1),
        store=Store.create(str(tmp_path)), run_id="nodev")
    with pytest.raises(HorovodTpuError, match="exit code"):
        est.fit(make_df(8))
    buf = io.BytesIO()
    torch.save(net, buf)
    model = TorchModel(_model_bytes=buf.getvalue(), feature_cols=["x1", "x2"],
                       output_cols=["p"])
    with pytest.raises((AssertionError, RuntimeError)):
        model.transform(make_df(4))


# ---------------------------------------------------------------------------
# Fits at np=2 on LocalBackend, held to a plain one-process loop
# ---------------------------------------------------------------------------

def plain_fit(module, optimizer, step_loss, df, np_, batch_size, epochs,
              validation, seed, schedulers=()):
    """The estimator's training, one process: the ranks' shards and batch
    order from `prepare_data` and `ShardDataLoader` (the same seed), each
    step the mean of the ranks' gradients; each epoch's loss the mean of
    the ranks' mean batch losses, the validation loss after it."""
    s = Store.create(None)
    try:
        PU.prepare_data(df, s, "ref", np_, ["x1", "x2"], ["y"],
                        validation=validation, seed=seed)
        loaders = [PDL.ShardDataLoader(s.get_train_data_path("ref"), r,
                                       batch_size, seed=seed,
                                       drop_last=False)
                   for r in range(np_)]
        xv, yv = (PU.load_val(s.get_val_data_path("ref")) if validation
                  else (None, None))
        losses, val_losses = [], []
        for epoch in range(epochs):
            module.train()
            sums = [0.0] * np_
            batches = list(zip(*[ld.epoch(epoch) for ld in loaders]))
            for i, per_rank in enumerate(batches):
                grads = []
                for r, (xb, yb) in enumerate(per_rank):
                    module.zero_grad()
                    loss = step_loss(module, (torch.from_numpy(xb),
                                              torch.from_numpy(yb)), i)
                    loss.backward()
                    sums[r] += float(loss.detach())
                    grads.append([p.grad.clone()
                                  for p in module.parameters()])
                for p, *gs in zip(module.parameters(), *grads):
                    p.grad = torch.stack(gs).sum(0) / np_
                optimizer.step()
            for sch in schedulers:
                sch.step()
            losses.append(float(torch.tensor(
                [x / len(batches) for x in sums]).mean()))
            if xv is not None:
                module.eval()
                with torch.no_grad():
                    val_losses.append(float(step_loss(
                        module, (torch.from_numpy(xv),
                                 torch.from_numpy(yv)), 0)))
        return losses, val_losses
    finally:
        s.cleanup()


def _held_to_plain(model, est_hist, ref, ref_module, df):
    losses, val_losses = ref
    np.testing.assert_allclose(est_hist["loss"], losses, rtol=0, atol=1e-6)
    np.testing.assert_allclose(est_hist["val_loss"], val_losses, rtol=0,
                               atol=1e-6)
    fitted = model.getModel()
    for p, q in zip(fitted.parameters(), ref_module.parameters()):
        assert p.device.type == "cpu"
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-6)
    out = model.transform(df)
    preds = np.asarray([float(np.ravel(v)[0]) for v in out["prediction"]])
    with torch.no_grad():
        want = ref_module(torch.from_numpy(
            df[["x1", "x2"]].to_numpy(np.float32))).numpy()[:, 0]
    np.testing.assert_allclose(preds, want, rtol=0, atol=1e-6)


@pytest.mark.integration
def test_torch_fit_np2_is_the_plain_loop(tmp_path):
    import copy

    from horovod_tpu_torch.spark.torch import TorchEstimator

    torch.manual_seed(0)
    net = torch.nn.Linear(2, 1)
    ref_net = copy.deepcopy(net)
    df = make_df(64)
    est = TorchEstimator(
        model=net, optimizer=torch.optim.SGD(net.parameters(), lr=0.1),
        loss=torch.nn.functional.mse_loss,
        feature_cols=["x1", "x2"], label_cols=["y"], batch_size=16,
        epochs=8, validation=0.2, random_seed=0, device="cpu",
        store=Store.create(str(tmp_path)), run_id="torchrun",
        backend=LocalBackend(2), verbose=0)
    model = est.fit(df)
    hist = model.get_history()
    assert len(hist["loss"]) == len(hist["val_loss"]) == 8
    assert hist["loss"][-1] < hist["loss"][0]
    ref = plain_fit(ref_net, torch.optim.SGD(ref_net.parameters(), lr=0.1),
                    lambda m, b, i: torch.nn.functional.mse_loss(m(b[0]),
                                                                 b[1]),
                    df, 2, 16, 8, 0.2, 0)
    _held_to_plain(model, hist, ref, ref_net, df)
    # Rank 0's checkpoint, with CPU tensors, in the store's run path.
    with open(est.store.get_checkpoint_path("torchrun"), "rb") as f:
        ckpt = pickle.load(f)
    assert all(t.device.type == "cpu" for t in ckpt["state_dict"].values())
    # The intermediate shards are gone, the run's artifacts stay.
    assert not os.path.exists(est.store.get_train_data_path("torchrun"))
    assert est.store.saving_runs() == ["torchrun"]


def _lit_env(monkeypatch):
    # The fitted module pickles by class reference: the workers import
    # lit_module from tests/data.
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [DATA, REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.mark.integration
@pytest.mark.parametrize("np_,cls,epochs", [(2, "LitRegression", 8),
                                            (1, "LitTupleConfig", 3)])
def test_lightning_fit_is_the_plain_loop(tmp_path, monkeypatch, np_, cls,
                                         epochs):
    from horovod_tpu_torch.spark.lightning import (
        LightningEstimator, _single_optimizer, _step_loss,
    )

    _lit_env(monkeypatch)
    lit = _lit()
    torch.manual_seed(0)
    module = getattr(lit, cls)(lr=0.1)
    ref_module = getattr(lit, cls)(lr=0.1)
    ref_module.load_state_dict(module.state_dict())
    df = make_df(64 if np_ == 2 else 48)
    est = LightningEstimator(
        model=module, feature_cols=["x1", "x2"], label_cols=["y"],
        batch_size=16, epochs=epochs, validation=0.2, random_seed=0,
        device="cpu", store=Store.create(str(tmp_path)), run_id="litrun",
        backend=LocalBackend(np_), verbose=0)
    model = est.fit(df)
    hist = model.get_history()
    assert len(hist["loss"]) == epochs
    assert hist["loss"][-1] < hist["loss"][0]
    opt, scheds = _single_optimizer(ref_module.configure_optimizers())
    ref = plain_fit(ref_module, opt, lambda m, b, i: _step_loss(
        m.validation_step(b, i) if not m.training
        else m.training_step(b, i)), df, np_, 16, epochs, 0.2, 0, scheds)
    _held_to_plain(model, hist, ref, ref_module, df)
    assert os.path.exists(est.store.get_checkpoint_path("litrun"))
    # The returned module is rank 0's: its epoch hooks ran once an epoch.
    m = model.getModel()
    assert m.epoch_starts == epochs and m.epoch_ends == epochs
