"""Port parity: the train-to-serve handoff (`horovod_tpu_torch/serve/
handoff.py`) against the JAX package's `horovod_tpu/serve/handoff.py`.

- `handoff_meta` of the port's tree (the JAX layout, torch tensors) is
  JAX's on the same parameters: the leaves' shapes, dtypes and tp axes,
  and the shard groups of the training partition.
- The port's trainer side publishes, JAX's serve side fetches; and the
  reverse: every tp slice at tp 1, 2 and 4 bitwise the slice of the
  parameters, and bitwise what the other package fetches.
- The drift errors are JAX's, message for message.
- The borrow edges: stash and restore round-trip at any world size
  across the packages, and a peer that dies mid-stash aborts the borrow
  with nothing recorded (JAX's `TestBorrowStashRestore`).
"""

import jax
import numpy as np
import pytest
import torch

import horovod_tpu.faults as jfaults
import horovod_tpu_torch.faults as faults
from horovod_tpu.models import TransformerConfig as JConfig
from horovod_tpu.models import transformer_init as jinit
from horovod_tpu.models.transformer import transformer_pspecs as jpspecs
from horovod_tpu.parallel import reshard as jrs
from horovod_tpu.serve import handoff as jho
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.models.transformer import transformer_pspecs
from horovod_tpu_torch.parallel import reshard as rs
from horovod_tpu_torch.serve import handoff as pho
from horovod_tpu_torch.serve.autoscale import (
    AutoscaleConfig,
    AutoscaleController,
    BorrowLedger,
    SignalSnapshot,
)

# A tiny transformer whose heads and d_ff split four ways; a fusion
# threshold that cuts it into several shard groups.
KW = dict(vocab_size=64, d_model=32, n_heads=4, d_head=8, d_ff=64,
          n_layers=2)
THRESHOLD = 8192


def _trees():
    """JAX's parameters, the port's tree of the same values (the JAX
    layout, torch tensors) and each package's pspecs."""
    import jax.numpy as jnp
    from horovod_tpu_torch.models import TransformerConfig

    p = jinit(jax.random.PRNGKey(5), JConfig(**KW,
                                             compute_dtype=jnp.float32))
    tree = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), p)
    cfg = TransformerConfig(**KW, compute_dtype=torch.float32)
    return p, tree, jpspecs(JConfig(**KW)), transformer_pspecs(cfg)


def _rows(leaves, groups, n_old):
    """The stage-3 rows a trainer of n_old ranks holds: per group the
    flat buffer, padded and cut into (n_old, shard)."""
    rows, ge = [], []
    for idxs, _ in groups:
        flat = np.concatenate([np.asarray(leaves[i]).reshape(-1)
                               for i in idxs])
        ge.append(flat.size)
        s = rs._shard_sz(flat.size, n_old)
        rows.append(np.pad(flat, (0, n_old * s - flat.size))
                    .reshape(n_old, s))
    return rows, tuple(ge)


def _slice(a, axis, tp, j):
    a = np.asarray(a)
    if axis is None:
        return a
    c = a.shape[axis] // tp
    return a[(slice(None),) * axis + (slice(j * c, (j + 1) * c),)]


def test_handoff_meta_is_jax():
    p, tree, jspec, pspec = _trees()
    got = pho.handoff_meta(tree, pspec, fusion_threshold_bytes=THRESHOLD)
    want = jho.handoff_meta(p, jspec, fusion_threshold_bytes=THRESHOLD)
    assert got == want
    assert len(got[1]) > 2


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("publisher", ["port", "jax"])
def test_fetch_is_bitwise_across_packages(publisher, tp):
    """One package's trainer (n_old = 3) publishes; both packages fetch
    every tp rank's slices: each leaf bitwise the parameters' slice and
    the two fetches bitwise each other."""
    p, tree, jspec, pspec = _trees()
    leaf_meta, groups = jho.handoff_meta(p, jspec,
                                         fusion_threshold_bytes=THRESHOLD)
    leaves = jax.tree_util.tree_leaves(p)
    n_old = 3
    rows, ge = _rows(leaves, groups, n_old)
    t = jrs.LocalTransport()
    pub = pho.publish_for_serve if publisher == "port" else \
        jho.publish_for_serve
    for r in range(n_old):
        pub([torch.from_numpy(x) for x in rows] if publisher == "port"
            else rows, ge, n_old, r, t, tag="serve", chunk_bytes=256)
    for j in range(tp):
        stats = {}
        got = pho.fetch_decode_params(
            tree, pspec, t, tag="serve", tp=tp, tp_rank=j,
            fusion_threshold_bytes=THRESHOLD, chunk_bytes=256, timeout=5.0,
            stats=stats)
        want = jho.fetch_decode_params(
            p, jspec, t, tag="serve", tp=tp, tp_rank=j,
            fusion_threshold_bytes=THRESHOLD, chunk_bytes=256, timeout=5.0)
        got_leaves = pho._leaves(got)
        assert list(got) == list(tree)          # the template's structure
        assert 0 < stats["peak_bytes"] <= rs.default_peak_bytes()
        for (shape, _, axis), leaf, g, w in zip(
                leaf_meta, leaves, got_leaves,
                jax.tree_util.tree_leaves(want)):
            assert isinstance(g, torch.Tensor)
            exp = _slice(leaf, axis, tp, j)
            assert g.numpy().tobytes() == exp.tobytes()
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
            assert tuple(g.shape) == exp.shape


def test_fetch_of_a_list_template_follows_its_order():
    """A list of tensors (a model's parameters in its placement's order)
    flattens in order; the fetched list holds them so."""
    rng = np.random.RandomState(2)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in [(6, 4), (4,), (4, 8)]]
    specs = [(None, "tp"), (None,), ("tp", None)]
    _, groups = pho.handoff_meta(params, specs, fusion_threshold_bytes=64)
    rows, ge = _rows([x.numpy() for x in params], groups, 2)
    t = rs.LocalTransport()
    for r in range(2):
        pho.publish_for_serve(rows, ge, 2, r, t, chunk_bytes=16)
    got = pho.fetch_decode_params(params, specs, t, tp=2, tp_rank=1,
                                  fusion_threshold_bytes=64, chunk_bytes=16,
                                  timeout=5.0)
    assert isinstance(got, list) and len(got) == 3
    assert torch.equal(got[0], params[0][:, 2:])
    assert torch.equal(got[1], params[1])
    assert torch.equal(got[2], params[2][2:])


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_drift_errors_are_jax():
    p, tree, jspec, pspec = _trees()
    t = rs.LocalTransport()
    t.put("serve/meta", rs.plan_meta_json(
        [rs.StreamSpec("p0", 999, "float32", "shard")], 2))
    t.put("borrow/meta", rs.plan_meta_json(
        [rs.StreamSpec("p0", 10, "float32", "shard")], 2))
    got = _error(lambda: pho.fetch_decode_params(
        tree, pspec, t, tp=2, timeout=2.0))
    want = _error(lambda: jho.fetch_decode_params(
        p, jspec, t, tp=2, timeout=2.0))
    assert got == want
    assert "serve handoff drift" in got[1]
    got = _error(lambda: pho.restore_train_state(
        (10, 6), ("float32", "float32"), 1, 0, t, timeout=2.0))
    want = _error(lambda: jho.restore_train_state(
        (10, 6), ("float32", "float32"), 1, 0, t, timeout=2.0))
    assert got == want
    assert "borrow restore drift" in got[1]
    with pytest.raises(HorovodTpuError, match="structures must match"):
        pho.handoff_meta(tree, {"embed": (None, None)})


# -- the borrow edges (tests/test_autoscale.py TestBorrowStashRestore) -------

GROUPS = (10, 6)


def _stash_rows(n_old):
    g0 = np.arange(10, dtype=np.float32) + 1
    g1 = np.arange(6, dtype=np.float32) * 0.5 - 1
    out = []
    for full in (g0, g1):
        s = -(-full.size // n_old)
        pad = np.zeros(s * n_old, full.dtype)
        pad[:full.size] = full
        out.append(pad.reshape(n_old, s))
    return out


@pytest.mark.parametrize("n_old,n_new", [(2, 1), (2, 3), (1, 2), (3, 2)])
@pytest.mark.parametrize("stasher", ["port", "jax"])
def test_stash_restore_roundtrip_any_world_size(stasher, n_old, n_new):
    """One package stashes at n_old, the other hands back at n_new (and
    the port at n_new too): each new rank's row bitwise JAX's."""
    t = jrs.LocalTransport()
    stash = pho.stash_train_state if stasher == "port" else \
        jho.stash_train_state
    for rank in range(n_old):
        stash(_stash_rows(n_old), GROUPS, n_old, rank, t)
    full = [np.arange(10, dtype=np.float32) + 1,
            np.arange(6, dtype=np.float32) * 0.5 - 1]
    for rank in range(n_new):
        got = pho.restore_train_state(GROUPS, ("float32", "float32"),
                                      n_new, rank, t)
        want = jho.restore_train_state(GROUPS, ("float32", "float32"),
                                       n_new, rank, t)
        for gi, (g, w) in enumerate(zip(got, want)):
            assert isinstance(g, torch.Tensor) and g.shape[0] == 1
            assert g.numpy()[0].tobytes() == w[rank].tobytes()
            lo, hi = rs._owned_range(GROUPS[gi], n_new, rank)
            assert np.array_equal(g.numpy()[0, :hi - lo], full[gi][lo:hi])


def _cfg(**kw):
    base = dict(min_replicas=1, max_replicas=4, cooldown_steps=6,
                dwell_steps=3, occ_high=0.85, occ_low=0.30,
                queue_wait_high_ms=1000.0,
                tenant_classes={"premium": 0, "standard": 1, "batch": 2})
    base.update(kw)
    return AutoscaleConfig(**base)


def _pressure(step, fleet=1, **kw):
    return SignalSnapshot(step=step, fleet_size=fleet, occupancy=0.95,
                          queue_depth=4, queue_wait_ms=0.0,
                          pool_free_frac=0.05, **kw)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_peer_die_mid_stash_aborts_borrow(package):
    """`reshard.peer_die` fires in the stash's publish: the borrow event
    aborts and the ledger records nothing, in each package's stash
    under the port's controller."""
    t = rs.LocalTransport()
    mod, stash = ((faults, pho.stash_train_state) if package == "port"
                  else (jfaults, jho.stash_train_state))
    mod.install("reshard.peer_die@1:err")
    try:
        def borrow_fn(n):
            stash(_stash_rows(2), GROUPS, 2, 0, t)
            return n
        led = BorrowLedger(borrow_fn, lambda n: None, capacity=1)
        c = AutoscaleController(_cfg(dwell_steps=1, max_replicas=1),
                                ledger=led)
        d, ev = c.step(_pressure(0, fleet=1, borrowable=1))
        assert (d.verdict, ev.state) == ("borrow", "aborted")
        assert "peer_die" in ev.detail or "Reshard" in ev.detail
        assert led.outstanding == 0 and led.history == []
    finally:
        mod.clear()


class _CountingTransport:
    def __init__(self, inner):
        self.inner, self.waits = inner, {}

    def wait(self, key, timeout=30.0):
        self.waits[key] = self.waits.get(key, 0) + 1
        return self.inner.wait(key, timeout=timeout)

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.parametrize("tp", [2, 4])
def test_a_sliced_fetch_reads_each_payload_about_once(tp):
    """A leaf cut along an inner axis is hundreds of short runs; the
    fetch keeps the last payload it decoded, so it waits for each
    published payload at most twice (once more where a payload spans
    two leaves fetched apart), not once a run."""
    p, tree, jspec, pspec = _trees()
    _, groups = jho.handoff_meta(p, jspec, fusion_threshold_bytes=THRESHOLD)
    rows, ge = _rows(jax.tree_util.tree_leaves(p), groups, 2)
    t = rs.LocalTransport()
    for r in range(2):
        pho.publish_for_serve(rows, ge, 2, r, t, chunk_bytes=1024)
    payloads = [k for k in t.keys("serve/") if k.count("/") == 3]
    counting = _CountingTransport(t)
    pho.fetch_decode_params(tree, pspec, counting, tp=tp, tp_rank=tp - 1,
                            fusion_threshold_bytes=THRESHOLD,
                            chunk_bytes=1024, timeout=5.0)
    waits = {k: n for k, n in counting.waits.items() if k in payloads}
    assert waits and max(waits.values()) <= 2, waits
    runs = sum(len(rs._leaf_flat_intervals(s, a, tp, tp - 1))
               for s, _, a in pho.handoff_meta(
                   tree, pspec, fusion_threshold_bytes=THRESHOLD)[0])
    assert sum(waits.values()) < runs
