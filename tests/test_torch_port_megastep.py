"""Port parity: megastep (`horovod_tpu_torch/utils/megastep.py`) against
the JAX package's (`horovod_tpu/utils/megastep.py`), mirroring
tests/test_megastep.py.

On the CPU `repeat_steps` and `scan_steps` run the plain loop (the CUDA
graph's plain version; tests/test_torch_port_cuda.py holds the replay
to it on the card).  The same SGD step goes through JAX's scan and the
port's loop: bitwise on integer-valued data (every product and sum is
exact in f32), within RTOL otherwise.  A megastep call marks one cycle
and one `step` span and adds k to `steps`, with the optimizer's own step
hooks held off.  `early_reduction_body` on two gloo ranks is bitwise
accumulate-then-reduce and JAX's body over two CPU devices, at k = 2
and 4, with the sentinel too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.common.exceptions import HorovodTpuError as JaxError
from horovod_tpu.utils import megastep as JM
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.metrics import catalog as MET
from horovod_tpu_torch.utils import megastep as M
from horovod_tpu_torch.utils import timeline as TL

from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401

# Float data: f32 sums in another order (XLA's reductions against
# torch's), a few ulps a step over 5 steps.
RTOL = 1e-5
N = 2  # gloo ranks of the early-reduction world


def jax_sgd(carry, batch, lr=0.1, mean=True):
    w, b = carry
    x, y = batch

    def loss_fn(w, b):
        r = x @ w + b - y
        return jnp.mean(r ** 2) if mean else 0.5 * jnp.sum(r ** 2)

    loss, g = jax.value_and_grad(loss_fn, argnums=(0, 1))(w, b)
    return (w - lr * g[0], b - lr * g[1]), loss


def torch_sgd(carry, batch, lr=0.1, mean=True):
    """The same step in torch, functional (a new carry)."""
    w, b = (t.detach().requires_grad_() for t in carry)
    x, y = batch
    r = x @ w + b - y
    loss = (r ** 2).mean() if mean else 0.5 * (r ** 2).sum()
    gw, gb = torch.autograd.grad(loss, (w, b))
    return ((w - lr * gw).detach(), (b - lr * gb).detach()), loss.detach()


def _data(seed=0, n=32, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-1, 2, size=(n, 3)).astype(np.float32)
        y = rng.integers(-3, 4, size=(n,)).astype(np.float32)
    else:
        x = rng.normal(size=(n, 3)).astype(np.float32)
        y = (x @ np.array([1.0, -2.0, 0.5], np.float32) + 0.3).astype(
            np.float32)
    return x, y


def _both(step_kind, k, out_mode, x, y, integer):
    """JAX's jitted megastep and the port's loop on the same data."""
    kw = dict(lr=1.0, mean=False) if integer else {}
    jfn = getattr(JM, step_kind)(lambda c, b: jax_sgd(c, b, **kw), k,
                                 out_mode=out_mode)
    pfn = getattr(M, step_kind)(lambda c, b: torch_sgd(c, b, **kw), k,
                                out_mode=out_mode)
    jc = (jnp.zeros((3,), jnp.float32), jnp.zeros((), jnp.float32))
    pc = (torch.zeros(3), torch.zeros(()))
    jb, pb = (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x),
                                                torch.from_numpy(y))
    (jw, jb_), jout = jfn(jc, jb)
    (pw, pb_), pout = pfn(pc, pb)
    return [np.asarray(v) for v in (jw, jb_, jout)], \
        [v.numpy() for v in (pw, pb_, pout)]


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("out_mode", ["last", "all"])
def test_repeat_steps_matches_jax(integer, out_mode):
    x, y = _data(integer=integer, n=4 if integer else 32)
    want, got = _both("repeat_steps", 3 if integer else 5, out_mode, x, y,
                      integer)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if integer:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)
    if out_mode == "all":
        assert got[2].shape == (3 if integer else 5,)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_scan_steps_matches_jax(integer):
    k = 3 if integer else 5
    x, y = _data(integer=integer, n=4 * k if integer else 40)
    xs, ys = x.reshape(k, -1, 3), y.reshape(k, -1)
    want, got = _both("scan_steps", k, "all", xs, ys, integer)
    for w, g in zip(want, got):
        if integer:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)


def test_the_loop_is_the_python_loop():
    x, y = (torch.from_numpy(a) for a in _data())
    ref = (torch.zeros(3), torch.zeros(()))
    for _ in range(4):
        ref, loss = torch_sgd(ref, (x, y))
    (w, b), out = M.repeat_steps(torch_sgd, 4)((torch.zeros(3),
                                                torch.zeros(())), (x, y))
    assert torch.equal(w, ref[0]) and torch.equal(b, ref[1])
    assert torch.equal(out, loss)


@pytest.mark.parametrize("fn", ["repeat_steps", "scan_steps",
                                "repeat_body", "scan_body"])
def test_bad_args_match_jax(fn):
    for k, mode in ((0, "last"), (2.0, "last"), (2, "sum")):
        with pytest.raises(JaxError) as je:
            getattr(JM, fn)(jax_sgd, k, out_mode=mode)
        with pytest.raises(HorovodTpuError) as pe:
            getattr(M, fn)(torch_sgd, k, out_mode=mode)
        assert str(pe.value) == str(je.value)


def test_early_reduction_bad_k_matches_jax():
    with pytest.raises(JaxError) as je:
        JM.early_reduction_body(lambda p, b: p, 0)
    with pytest.raises(HorovodTpuError) as pe:
        M.early_reduction_body(lambda p, b: p, 0)
    assert str(pe.value) == str(je.value)


def test_one_cycle_and_step_span_per_call(tmp_path):
    """The optimizer's hooks are held off inside a call; the call marks
    one cycle and one `step` span and adds k to `steps`."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))

    def step(carry, batch):
        m, o = carry
        o.zero_grad(set_to_none=True)
        loss = m(batch).square().mean()
        loss.backward()
        o.step()
        return carry, loss.detach()

    batch = torch.from_numpy(_data()[0][:8, :].repeat(2, axis=1)[:, :4])
    steps0 = MET.steps._solo().get()
    path = tmp_path / "tl.json"
    TL.start_timeline(str(path), mark_cycles=True)
    try:
        mstep = M.repeat_steps(step, 3, out_mode="all")
        for _ in range(2):
            _, losses = mstep((model, opt), batch)
        assert losses.shape == (3,)
        assert MET.steps._solo().get() == steps0 + 6
        for _ in range(2):  # the same optimizer outside: one a step
            step((model, opt), batch)
        assert MET.steps._solo().get() == steps0 + 8
    finally:
        TL.stop_timeline()
    evs = json.loads(path.read_text())
    assert [e["name"] for e in evs if e["cat"] == "cycle"] == [
        f"CYCLE_{i}" for i in range(1, 5)]
    spans = [e for e in evs if e["cat"] == "step"]
    assert len(spans) == 4 and all(e["ph"] == "X" for e in spans)
    assert [e["step"] for e in spans] == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# early_reduction_body on two gloo ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.data_parallel import allreduce_gradients
from horovod_tpu_torch.utils.megastep import early_reduction_body

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")

def grad_fn(params, mb):
    return {"w": params["w"] + mb.sum(dim=0), "v": mb[:, :2].sum(dim=0) * 2}

def batches(r, k, nan):
    xs = np.round(np.random.RandomState(10 + r).normal(size=(k, 2, 3)) * 4)
    xs = xs.astype(np.float32)
    if nan and r == 1:
        xs[1, 0, 0] = np.nan
    return torch.from_numpy(xs)

params = {"w": torch.arange(3, dtype=torch.float32)}
res = {}
for k in (2, 4):
    for sentinel, nan in ((False, False), (True, False), (True, True)):
        xs = batches(r, k, nan)
        out = early_reduction_body(grad_fn, k, sentinel=sentinel)(params, xs)
        acc = None
        for j in range(k):
            g = grad_fn(params, xs[j])
            acc = g if acc is None else {a: acc[a] + g[a] for a in acc}
        ref = allreduce_gradients(acc, sentinel=sentinel)
        if sentinel:
            ref, rflags = ref
        ref = {a: (t / k).to(t.dtype) for a, t in ref.items()}
        res[(k, sentinel, nan)] = {"out": out, "ref": ref,
                                   "ref_flags": rflags if sentinel else None}
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("early"), N, WORKER)


def _jax_early(k, sentinel, nan):
    """JAX's early_reduction_body over two CPU devices (device r = rank
    r) on the same per-rank batches."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), (jhvd.GLOBAL_AXIS,))
    per = []
    for r in range(N):
        xs = np.round(np.random.RandomState(10 + r).normal(
            size=(k, 2, 3)) * 4).astype(np.float32)
        if nan and r == 1:
            xs[1, 0, 0] = np.nan
        per.append(xs)

    def grad_fn(params, mb):
        return {"w": params["w"] + mb.sum(axis=0),
                "v": mb[:, :2].sum(axis=0) * 2}

    body = JM.early_reduction_body(grad_fn, k, sentinel=sentinel)
    out_specs = (P(), P()) if sentinel else P()
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(
        jhvd.GLOBAL_AXIS)), out_specs=out_specs, check_vma=False))
    out = fn({"w": jnp.arange(3, dtype=jnp.float32)},
             jnp.asarray(np.concatenate(per)))
    if sentinel:
        return ({a: np.asarray(v) for a, v in out[0].items()},
                np.asarray(out[1]))
    return {a: np.asarray(v) for a, v in out.items()}, None


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("sentinel,nan", [(False, False), (True, False),
                                          (True, True)],
                         ids=["plain", "sentinel", "sentinel_nan"])
def test_early_reduction_is_bitwise_jax_and_accumulate_then_reduce(
        world, k, sentinel, nan):
    jhvd.init()
    want, jflags = _jax_early(k, sentinel, nan)
    for d in world:
        rec = d[(k, sentinel, nan)]
        out = rec["out"]
        flags = None
        if sentinel:
            out, flags = out
        for a in ("w", "v"):
            got = out[a].numpy()
            np.testing.assert_array_equal(got, rec["ref"][a].numpy())
            np.testing.assert_array_equal(got, want[a])
        if sentinel:
            np.testing.assert_array_equal(flags.numpy(), jflags)
            np.testing.assert_array_equal(flags.numpy(),
                                          rec["ref_flags"].numpy())
            assert float(flags.max()) == (1.0 if nan else 0.0)


# ---------------------------------------------------------------------------
# The trainer's --megastep and --prefetch
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
        "--n-heads", "2", "--d-head", "32", "--d-ff", "128", "--n-layers",
        "2", "--seq-len", "64", "--num-warmup-batches", "0", "--num-iters",
        "1", "--log-steps"]


def _trainer(capsys, *args):
    from horovod_tpu_torch import transformer_benchmark as TB

    assert TB.main(TINY + list(args)) == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [json.loads(l[5:]) for l in lines if l.startswith("STEP ")]
    (summary,) = [json.loads(l[8:]) for l in lines
                  if l.startswith("SUMMARY ")]
    return steps, summary


def test_trainer_megastep_is_bitwise_the_plain_loop(capsys):
    plain, _ = _trainer(capsys, "--num-batches-per-iter", "4")
    mega, summary = _trainer(capsys, "--num-batches-per-iter", "2",
                             "--megastep", "2")
    assert [s["loss"] for s in plain] == [
        v for s in mega for v in s["pass_losses"]]
    assert plain[-1]["digest"] == mega[-1]["digest"]
    assert summary["megastep"] == 2 and summary["steps"] == 2
    # The prefetched stream: a new batch a step, M stacked a call.
    fed, summary = _trainer(capsys, "--num-batches-per-iter", "2",
                            "--megastep", "2", "--prefetch", "2")
    assert summary["prefetch"] == 2
    losses = [v for s in fed for v in s["pass_losses"]]
    assert len(losses) == 4 and len(set(losses)) == 4
    assert losses != [s["loss"] for s in plain]


def test_trainer_prefetch_without_megastep(capsys):
    steps, summary = _trainer(capsys, "--num-batches-per-iter", "3",
                              "--prefetch", "2",
                              "--backward-passes-per-step", "2")
    assert len(steps) == 3 and all(len(s["pass_losses"]) == 2
                                   for s in steps)
    assert summary["passes_per_step"] == 2


@pytest.mark.parametrize("flag,why", [
    (["--guard"], "--megastep refuses --guard"),
    (["--zero-stage", "1"], "not --zero-stage"),
    (["--backward-passes-per-step", "2"], "not --backward-passes-per-step"),
])
def test_trainer_megastep_refusals(flag, why):
    from horovod_tpu_torch import transformer_benchmark as TB

    with pytest.raises(SystemExit, match=why):
        TB.main(TINY + ["--megastep", "2"] + flag)
    import horovod_tpu_torch as hvd
    hvd.shutdown()
