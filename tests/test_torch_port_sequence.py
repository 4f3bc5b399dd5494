"""Ring attention and Ulysses over an `sp` set, forward and gradients,
against the JAX package.

Four CPU ranks over gloo run each case at sp = 4 (one set) and at
sp = 2 (a dp=2 x sp=2 mesh: two sets side by side).  Each rank feeds
its shard of seeded [B, T, H, D] inputs to the port's `*_shard`
function and backpropagates sum(out · c) over its shard; the shards'
outputs and input gradients, put back in sequence order, are held:

- against JAX's `ring_attention` / `ulysses_attention` (on a mesh of the
  CPU devices) and `jax.grad` of sum(out · c) through them, and against
  the port's `dense_attention_oracle` (forward, its autograd for the
  gradients): outputs within 2e-5 (JAX's own ring test), gradients within
  1e-4 of their largest value;
- the flash engine (`ring_flash_attention_shard`, routed by
  HOROVOD_FLASH_ATTENTION=1 at T_local = 128, the kernels' plain
  versions on the CPU), causal and not, MHA and GQA, against the
  blockwise ring on the same inputs, gradients included: its merge
  differentiates through lse, which the flash backward folds into
  delta.  Same tolerances.

The mesh wrappers `ring_attention` / `ulysses_attention` (full arrays
in and out) are held to JAX's too, and Ulysses refuses H % sp != 0.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import create_hybrid_mesh as j_mesh
from horovod_tpu.parallel import sequence as JS
from horovod_tpu_torch.parallel import sequence as TS
from test_torch_port_collectives import run_world

N = 4
FWD_TOL = 2e-5
GRAD_RTOL = 1e-4
# name: (function, B, T, H, Hkv, D, causal, window, flash)
CASES = {
    "ring_causal": ("ring", 2, 32, 4, 4, 16, True, None, False),
    "ring_dense": ("ring", 2, 32, 4, 4, 16, False, None, False),
    "ring_gqa_window": ("ring", 2, 32, 4, 2, 16, True, 5, False),
    "ulysses_causal": ("ulysses", 2, 32, 4, 4, 16, True, None, False),
    "ulysses_gqa_window": ("ulysses", 2, 32, 8, 4, 16, True, 6, False),
    "flash_ring_causal": ("ring", 1, 512, 2, 2, 16, True, None, True),
    "flash_ring_dense": ("ring", 1, 512, 2, 2, 16, False, None, True),
    "flash_ring_gqa": ("ring", 1, 512, 4, 2, 16, True, None, True),
}
SP = {4: dict(sp=4), 2: dict(dp=2, sp=2)}

WORKER = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import sequence as S
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
data = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
res = {}
meshes = {sp: create_hybrid_mesh(**kw) for sp, kw in data["sp"].items()}


def run(name, sp, flash, engine=None):
    fn, B, T, H, Hkv, D, causal, window, _ = data["cases"][name]
    os.environ["HOROVOD_FLASH_ATTENTION"] = "1" if flash else "0"
    ps = meshes[sp].sets["sp"]
    i, Tl = ps.rank(), T // sp
    sl = slice(i * Tl, (i + 1) * Tl)
    q, k, v, c = (torch.from_numpy(a[:, sl].copy()).requires_grad_()
                  for a in data["inputs"][name])
    f = S.ring_attention_shard if fn == "ring" else S.ulysses_attention_shard
    out = f(q, k, v, ps, causal=causal, window=window)
    (out * c).sum().backward()
    return (out.detach(), q.grad, k.grad, v.grad)


for name, case in data["cases"].items():
    for sp in data["sp"]:
        res[(name, sp)] = run(name, sp, case[-1])
        if case[-1]:
            res[(name, sp, "blockwise")] = run(name, sp, False)
os.environ["HOROVOD_FLASH_ATTENTION"] = "0"
q, k, v, _ = (torch.from_numpy(a) for a in data["inputs"]["ring_gqa_window"])
res["ring_mesh"] = S.ring_attention(q, k, v, meshes[4], window=5)
q, k, v, _ = (torch.from_numpy(a) for a in data["inputs"]["ulysses_causal"])
res["ulysses_mesh"] = S.ulysses_attention(q, k, v, meshes[2])
try:
    S.ulysses_attention_shard(q[:, :8, :3], k[:, :8, :3], v[:, :8, :3],
                              meshes[2].sets["sp"])
except ValueError as e:
    res["refusal"] = str(e)
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _inputs(name):
    _, B, T, H, Hkv, D, *_ = CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    return tuple(rng.randn(*shape).astype(np.float32) for shape in
                 ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D),
                  (B, T, H, D)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence")
    inputs = {name: _inputs(name) for name in CASES}
    torch.save({"cases": CASES, "sp": SP, "inputs": inputs},
               tmp / "inputs.pt")
    return inputs, run_world(tmp, N, WORKER, timeout=300)


def _assemble(res, key, sp):
    """Every sp set's shards in sequence order: out, dq, dk, dv."""
    ranks = range(sp)   # the first set: ranks 0..sp-1 in both meshes
    parts = [res[r][key] for r in ranks]
    return [torch.cat([p[j] for p in parts], 1).numpy() for j in range(4)]


def _jax_ref(name, sp, inputs):
    """JAX's mesh function and jax.grad of sum(out * c) through it."""
    fn, *_, causal, window, _ = CASES[name]
    mesh = j_mesh(**SP[sp], devices=jax.devices()[:N])
    f = JS.ring_attention if fn == "ring" else JS.ulysses_attention

    @jax.jit
    def out_and_grads(q, k, v, c):
        out, vjp = jax.vjp(lambda *a: f(*a, mesh, causal=causal,
                                         window=window), q, k, v)
        return (out,) + vjp(c)

    return [np.asarray(a) for a in out_and_grads(
        *(jnp.asarray(a) for a in inputs))]


def _oracle(name, inputs):
    *_, causal, window, _ = CASES[name]
    q, k, v, c = (torch.from_numpy(a).requires_grad_() for a in inputs)
    out = TS.dense_attention_oracle(q, k, v, causal=causal, window=window)
    (out * c).sum().backward()
    return [out.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
            v.grad.numpy()]


def _close(got, want, what):
    out, *grads = got
    np.testing.assert_allclose(out, want[0], rtol=FWD_TOL, atol=FWD_TOL,
                               err_msg=what)
    for g, w, n in zip(grads, want[1:], "qkv"):
        err = np.abs(g - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (what, "d" + n, err)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", [n for n in CASES if not CASES[n][-1]])
def test_shard_matches_jax_and_the_oracle(world, name, sp):
    inputs, res = world
    got = _assemble(res, (name, sp), sp)
    _close(got, _jax_ref(name, sp, inputs[name]), f"{name} vs jax")
    _close(got, _oracle(name, inputs[name]), f"{name} vs oracle")


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][-1]])
def test_flash_engine_matches_the_blockwise_ring_and_the_oracle(world, name,
                                                                 sp):
    inputs, res = world
    got = _assemble(res, (name, sp), sp)
    _close(got, _assemble(res, (name, sp, "blockwise"), sp),
           f"{name} vs blockwise")
    _close(got, _oracle(name, inputs[name]), f"{name} vs oracle")


def test_blockwise_side_of_the_flash_cases_matches_jax(world):
    """At T_local = 128 the JAX ring (blockwise here: the flag is unset
    in this process) agrees with the port's blockwise ring."""
    inputs, res = world
    os.environ.pop("HOROVOD_FLASH_ATTENTION", None)
    name = "flash_ring_gqa"
    _close(_assemble(res, (name, 4, "blockwise"), 4),
           _jax_ref(name, 4, inputs[name]), name)


def test_mesh_wrappers_match_jax_and_ulysses_refuses(world):
    inputs, res = world
    for key, name, sp in (("ring_mesh", "ring_gqa_window", 4),
                          ("ulysses_mesh", "ulysses_causal", 2)):
        want = _jax_ref(name, sp, inputs[name])[0]
        for d in res:
            np.testing.assert_allclose(d[key].numpy(), want, rtol=FWD_TOL,
                                       atol=FWD_TOL)
    assert all("divisible by sp (2)" in d["refusal"] for d in res)
