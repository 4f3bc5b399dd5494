"""The port's live resharding (`horovod_tpu_torch/parallel/reshard.py`)
against the JAX package's (`horovod_tpu/parallel/reshard.py`), one
process: a port case for each of `tests/test_reshard.py`'s, fed the same
seeded numpy inputs as the JAX function and bitwise where the operation
is a copy or a digest; streams published by one package and fetched by
the other; `zero_group_elems`; the restack of the port's ZeRO streams
against JAX's `reshard_opt_state` on the same flat rows."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.faults as jfaults
import horovod_tpu_torch.faults as faults
from horovod_tpu.parallel import reshard as jrs
from horovod_tpu.parallel.optimizer import (
    DistributedOptState, _ShardSlot, _WireEF, _ZeroAccum,
)
from horovod_tpu_torch.common.exceptions import HorovodTpuError, ReshardError
from horovod_tpu_torch.parallel import reshard as rs

PLAN_CASES = [(10, 2, 3), (10, 3, 2), (10, 4, 4), (5, 8, 2), (5, 2, 8),
              (1, 2, 3), (64, 1, 4), (64, 4, 1), (7, 3, 5)]


def _specs(mod, specs):
    return [mod.StreamSpec(*s) for s in specs]


# ---------------------------------------------------------------------------
# plan geometry


@pytest.mark.parametrize("elems,n_old,n_new", PLAN_CASES)
def test_plan_fetch_covers_new_range_exactly(elems, n_old, n_new):
    """Publish and fetch intervals, and each fetch's published key, are
    JAX's, and they tile every old and new range."""
    spec, jspec = (m.StreamSpec("p0", elems, "float32", "shard")
                   for m in (rs, jrs))
    plan = rs.ReshardPlan([spec], n_old, n_new, chunk_bytes=12,
                          peak_bytes=1 << 20)
    jplan = jrs.ReshardPlan([jspec], n_old, n_new, chunk_bytes=12,
                            peak_bytes=1 << 20)
    published = set()
    for r in range(n_old):
        ivs = [tuple(iv) for iv in plan.publish_intervals(spec, r)]
        assert ivs == [tuple(iv) for iv in jplan.publish_intervals(jspec, r)]
        lo, hi = rs._owned_range(elems, n_old, r)
        assert (lo, hi) == jrs._owned_range(elems, n_old, r)
        assert sum(b - a for _, a, b in ivs) == hi - lo
        published.update(ivs)
    for r in range(n_new):
        got = plan.fetch_intervals(spec, r)
        assert [tuple(iv) for iv in got] == [
            tuple(iv) for iv in jplan.fetch_intervals(jspec, r)]
        lo, hi = rs._owned_range(elems, n_new, r)
        covered = sorted((iv.start, iv.stop) for iv in got)
        assert sum(b - a for a, b in covered) == hi - lo
        for iv in got:
            pub = rs._fix_grid_cut_overlap(plan, spec, iv)
            assert tuple(pub) in published
            assert tuple(pub) == tuple(jrs._fix_grid_cut_overlap(
                jplan, jspec, jrs.Interval(*iv)))


def test_perrank_fetch_sources_partition_old_ranks():
    spec = rs.StreamSpec("e0", 9, "float32", "perrank")
    jspec = jrs.StreamSpec("e0", 9, "float32", "perrank")
    plan = rs.ReshardPlan([spec], 5, 2, chunk_bytes=64)
    jplan = jrs.ReshardPlan([jspec], 5, 2, chunk_bytes=64)
    srcs = [sorted({iv.src for iv in plan.fetch_intervals(spec, r)})
            for r in range(2)]
    assert srcs == [[0, 2, 4], [1, 3]]
    assert srcs == [sorted({iv.src for iv in jplan.fetch_intervals(jspec, r)})
                    for r in range(2)]


# ---------------------------------------------------------------------------
# the executor over a transport


def _fetch_all(mod, specs, n_old, n_new, t, **kw):
    """Every new rank's fetch at once (the verdict barrier needs every
    rank's recv_ok)."""
    outs = [None] * n_new
    reports = [None] * n_new
    errs = []

    def _one(r):
        try:
            outs[r], reports[r] = mod.reshard_streams(
                specs, None, n_old, n_new, None, r, t, **kw)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=_one, args=(r,))
               for r in range(n_new)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    return outs, reports


def _move(mod, specs, per_old, n_old, n_new, t=None, **kw):
    t = t if t is not None else mod.LocalTransport()
    reports = [mod.reshard_streams(specs, per_old[r], n_old, n_new, r,
                                   None, t, **kw)[1] for r in range(n_old)]
    outs, freps = _fetch_all(mod, specs, n_old, n_new, t, **kw)
    return outs, reports + freps


def _shard_data(spec, buf, n_old):
    return [{spec.name: buf[slice(*rs._owned_range(spec.elems, n_old, r))]}
            for r in range(n_old)]


@pytest.mark.parametrize("n_old,n_new", [(2, 1), (1, 2), (3, 2)])
def test_transport_roundtrip_bitwise(n_old, n_new):
    rng = np.random.RandomState(7)
    buf = rng.uniform(-1, 1, size=(37,)).astype(np.float32)
    spec = rs.StreamSpec("p0", buf.size, "float32", "shard")
    outs, reps = _move(rs, [spec], _shard_data(spec, buf, n_old), n_old,
                       n_new, chunk_bytes=16, peak_bytes=1 << 16)
    jouts, jreps = _move(jrs, [jrs.StreamSpec(*spec)],
                         _shard_data(spec, buf, n_old), n_old, n_new,
                         chunk_bytes=16, peak_bytes=1 << 16)
    got = np.concatenate([outs[r]["p0"] for r in range(n_new)])
    assert got.tobytes() == buf.tobytes()
    for r in range(n_new):
        assert outs[r]["p0"].tobytes() == jouts[r]["p0"].tobytes()
    assert [(x.bytes_moved, x.chunks) for x in reps] == \
        [(x.bytes_moved, x.chunks) for x in jreps]
    # The port stages up to `parallel_workers` chunks at once, JAX's one.
    inflight = rs.parallel_workers(1 << 16, 16)
    assert all(j.peak_bytes <= x.peak_bytes <= inflight * j.peak_bytes
               for x, j in zip(reps, jreps))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_streams_cross_packages_bitwise(direction):
    """JAX's old ranks publish into one transport and the port's new
    ranks fetch (and the reverse): every stream kind, bitwise."""
    rng = np.random.RandomState(5)
    n_old, n_new = 3, 2
    raw = [("p0", 29, "float32", "shard"), ("e0", 11, "float32", "perrank"),
           ("c", 1, "int64", "replicated")]
    buf = rng.uniform(-3, 3, size=(29,)).astype(np.float32)
    ef = rng.randint(-5, 5, size=(n_old, 11)).astype(np.float32)
    per_old = [{"p0": buf[slice(*rs._owned_range(29, n_old, r))],
                "e0": ef[r], "c": np.asarray([7], np.int64)}
               for r in range(n_old)]
    pub, fet = (jrs, rs) if direction == "jax_to_port" else (rs, jrs)
    t = pub.LocalTransport()
    for r in range(n_old):
        pub.reshard_streams(_specs(pub, raw), per_old[r], n_old, n_new, r,
                            None, t, chunk_bytes=12)
    outs, _ = _fetch_all(fet, _specs(fet, raw), n_old, n_new, t,
                         chunk_bytes=12, timeout=5.0)
    ref = rs.reshard_rank_streams(_specs(rs, raw), per_old, n_new)
    for r in range(n_new):
        for name in ("p0", "e0", "c"):
            assert outs[r][name].tobytes() == ref[r][name].tobytes(), name


def test_peak_is_measured_and_bounded():
    buf = np.arange(4096, dtype=np.float32)
    spec = rs.StreamSpec("p0", buf.size, "float32", "shard")
    outs, reports = _move(rs, [spec], _shard_data(spec, buf, 2), 2, 1,
                          chunk_bytes=None, peak_bytes=4096)
    _, jreports = _move(jrs, [jrs.StreamSpec(*spec)],
                        _shard_data(spec, buf, 2), 2, 1, chunk_bytes=None,
                        peak_bytes=4096)
    assert outs[0]["p0"].tobytes() == buf.tobytes()
    assert all(r.chunks > 1 and 0 < r.peak_bytes <= 4096 for r in reports)
    assert [r.peak_bytes for r in reports] == [r.peak_bytes for r in jreports]


def test_peak_overrun_raises():
    """A tracker past the ceiling is the executor's ReshardError; a
    measured peak equals JAX's on the same chunks."""
    plan = rs.ReshardPlan([rs.StreamSpec("p0", 8, "float32", "shard")], 1, 1)
    assert plan.peak_bytes == jrs.ReshardPlan(
        [jrs.StreamSpec("p0", 8, "float32", "shard")], 1, 1).peak_bytes
    tr = rs._PeakTracker()
    tr.add(plan.peak_bytes + 1)
    assert tr.peak > plan.peak_bytes
    big = np.arange(64, dtype=np.float32)
    spec = rs.StreamSpec("p0", 64, "float32", "shard")
    with pytest.raises(ReshardError, match="ceiling"):
        # The ceiling below one chunk's staging: the check must fire.
        t = rs.LocalTransport()
        orig = rs.ReshardPlan.__init__

        def tiny(self, *a, **kw):
            orig(self, *a, **kw)
            self.peak_bytes = 16
        try:
            rs.ReshardPlan.__init__ = tiny
            rs.reshard_streams([spec], {"p0": big}, 1, 1, 0, None, t,
                               chunk_bytes=256, timeout=2.0)
        finally:
            rs.ReshardPlan.__init__ = orig


def test_chunk_corrupt_detected():
    buf = np.arange(64, dtype=np.float32)
    spec = rs.StreamSpec("p0", buf.size, "float32", "shard")
    faults.install("reshard.chunk_corrupt:err")
    try:
        with pytest.raises(ReshardError, match="sha256|corrupt"):
            _move(rs, [spec], _shard_data(spec, buf, 2), 2, 1,
                  chunk_bytes=64, timeout=2.0)
        assert faults.points_hit("reshard.chunk_corrupt") > 0
    finally:
        faults.clear()
    # The same fault in JAX's publisher: the port's fetch refuses it too.
    t = jrs.LocalTransport()
    jfaults.install("reshard.chunk_corrupt:err")
    try:
        for r in range(2):
            jrs.reshard_streams([jrs.StreamSpec(*spec)],
                                _shard_data(spec, buf, 2)[r], 2, 1, r,
                                None, t, chunk_bytes=64)
    finally:
        jfaults.clear()
    with pytest.raises(ReshardError, match="sha256"):
        rs.fetch_streams(rs.ReshardPlan([spec], 2, 1, chunk_bytes=64), 0,
                         t, timeout=2.0)


def test_peer_die_leaves_fetchers_timing_out():
    buf = np.arange(64, dtype=np.float32)
    spec = rs.StreamSpec("p0", buf.size, "float32", "shard")
    t = rs.LocalTransport()
    rs.reshard_streams([spec], {"p0": buf[:32]}, 2, 1, 0, None, t,
                       chunk_bytes=64)
    faults.install("reshard.peer_die:err")
    try:
        with pytest.raises(faults.FaultInjected):
            rs.reshard_streams([spec], {"p0": buf[32:]}, 2, 1, 1, None, t,
                               chunk_bytes=64)
        assert faults.points_hit("reshard.peer_die") == 1
    finally:
        faults.clear()
    with pytest.raises(ReshardError):
        rs.reshard_streams([spec], None, 2, 1, None, 0, t, chunk_bytes=64,
                           timeout=1.0)


def test_digest_mismatch_detected():
    buf = np.arange(16, dtype=np.float32)
    spec = rs.StreamSpec("p0", buf.size, "float32", "shard")
    t = rs.LocalTransport()
    rs.reshard_streams([spec], {"p0": buf[:8]}, 2, 1, 0, None, t,
                       chunk_bytes=64)
    rs.reshard_streams([spec], {"p0": buf[8:]}, 2, 1, 1, None, t,
                       chunk_bytes=64)
    key = [k for k in t.keys("g/p0/") if "digest" not in k][0]
    evil = buf[:8].copy()
    evil[0] += 1
    payload = rs._encode_payload(evil, None, rs._PeakTracker())
    assert payload == jrs._encode_payload(evil, None, jrs._PeakTracker())
    t.put(key, payload)
    with pytest.raises(ReshardError, match="digest"):
        rs.reshard_streams([spec], None, 2, 1, None, 0, t, chunk_bytes=64,
                           timeout=2.0)


# ---------------------------------------------------------------------------
# digests, the EF fold, replicated rows


@pytest.mark.parametrize("dtype", ["float32", "float16", "int64", "uint8"])
def test_bitsum_digest_order_free_and_exact(dtype):
    rng = np.random.RandomState(3)
    a = (rng.uniform(size=(1001,)) * 100).astype(dtype)
    whole = rs.bitsum_digest(a)
    assert whole == jrs.bitsum_digest(a)
    parts = [rs.bitsum_digest(a[:301]), rs.bitsum_digest(a[301:800]),
             rs.bitsum_digest(a[800:])]
    assert rs._combine_digests(parts) == whole
    assert rs._combine_digests(list(reversed(parts))) == whole
    assert rs._combine_digests(parts) == jrs._combine_digests(parts)
    if dtype == "float32":
        b = a.copy()
        b[500] = np.nextafter(b[500], 2.0, dtype=np.float32)
        assert rs.bitsum_digest(b) != whole


def test_ef_fold_conserves_residual_on_shrink():
    rows = np.arange(4 * 12, dtype=np.float32).reshape(4, 12)
    folded = rs.reshard_ef_rows(rows, elems=10, n_new=2)
    assert folded.tobytes() == jrs.reshard_ef_rows(rows, 10, 2).tobytes()
    assert folded.shape == (2, 10) and folded.sum() == rows[:, :10].sum()


def test_ef_fold_zeroes_joiners_on_grow():
    rows = np.arange(2 * 10, dtype=np.float32).reshape(2, 10)
    grown = rs.reshard_ef_rows(rows, elems=10, n_new=4)
    assert grown.tobytes() == jrs.reshard_ef_rows(rows, 10, 4).tobytes()
    assert not grown[2:].any()


def test_replicated_divergence_raises():
    with pytest.raises(ReshardError, match="replicated"):
        rs.reshard_replicated_rows(np.array([3, 3, 4], np.int32), 2)
    assert rs.reshard_replicated_rows(np.array([5, 5]), 3).tobytes() == \
        jrs.reshard_replicated_rows(np.array([5, 5]), 3).tobytes()


# ---------------------------------------------------------------------------
# the local restack of ZeRO state: JAX's compat stacks, the port's streams


def _synthetic_state(n, group_elems=(10, 7), ef_gen=0):
    """JAX's hand-built compat state of tests/test_reshard.py, its
    per-element leaves named as the port's AdamW state (exp_avg,
    exp_avg_sq, step): integer-valued floats, zero padding."""
    rng = np.random.RandomState(42 + n)

    def _rows(lo, hi, elems, s):
        a = rng.randint(lo, hi, size=(n * s,)).astype(np.float32)
        a[elems:] = 0
        return a.reshape(n, s)

    slots, accum, ef = [], [], []
    for gi, elems in enumerate(group_elems):
        s = jrs._shard_sz(elems, n)
        mu = _rows(-50, 50, elems, s)
        nu = _rows(0, 50, elems, s)
        step = np.full((n,), 17, np.float32)
        master = _rows(-50, 50, elems, s) if gi == 0 else None
        slots.append(_ShardSlot({"exp_avg": mu, "exp_avg_sq": nu,
                                 "step": step}, master))
        accum.append(_rows(-9, 9, elems, s))
        if gi == 0:
            w = elems + (-elems) % n
            e = np.zeros((n, w), np.float32)
            e[:, :elems] = rng.randint(-5, 5, size=(n, elems))
            ef.append(e)
        else:
            ef.append(None)
    return DistributedOptState(
        tuple(slots), _ZeroAccum(tuple(accum)), np.asarray(3, np.int64),
        None, _WireEF(tuple(ef), np.asarray(ef_gen, np.int32)))


def _port_names(specs, data):
    """JAX's stream names (leaf order of the sorted dict keys) as the
    port's: o{g}.{index} → o{g}.{key}."""
    keys = ["exp_avg", "exp_avg_sq", "step"]

    def name(n):
        if n.startswith("o"):
            g, li = n[1:].split(".")
            return f"o{g}.{keys[int(li)]}"
        return n
    return ([rs.StreamSpec(name(s.name), s.elems, s.dtype, s.kind)
             for s in specs], {name(k): v for k, v in data.items()})


@pytest.mark.parametrize("n_old,n_new", [(4, 2), (2, 4), (4, 1), (1, 3)])
def test_reshard_opt_state_geometry(n_old, n_new):
    """The port's restack of every rank's streams equals, rank by rank,
    the streams of JAX's `reshard_opt_state` on the same flat rows."""
    ge = (10, 7)
    st = _synthetic_state(n_old, ge)
    per_old = [_port_names(*jrs.opt_state_streams(st, ge, n_old, r))
               for r in range(n_old)]
    specs = per_old[0][0]
    for r in range(1, n_old):  # the port carries the scalars on every rank
        per_old[r][1].update({k: v for k, v in per_old[0][1].items()
                              if k not in per_old[r][1]})
    got = rs.reshard_rank_streams(specs, [d for _, d in per_old], n_new)
    out = jrs.reshard_opt_state(st, ge, n_new)
    for j in range(n_new):
        jspecs, jdata = _port_names(*jrs.opt_state_streams(out, ge, n_new,
                                                           j))
        assert [tuple(s) for s in jspecs] == [tuple(s) for s in specs]
        for k, v in jdata.items():
            assert got[j][k].dtype == v.dtype, k
            assert got[j][k].tobytes() == v.tobytes(), (j, k)


def test_shard_rows_roundtrip_bitwise():
    rng = np.random.RandomState(9)
    rows = rng.uniform(size=(4, 5)).astype(np.float32)
    rows.reshape(-1)[17:] = 0
    back = rs.reshard_shard_rows(rs.reshard_shard_rows(rows, 17, 1), 17, 4)
    assert back.tobytes() == rows.tobytes()
    assert rs.reshard_shard_rows(rows, 17, 3).tobytes() == \
        jrs.reshard_shard_rows(rows, 17, 3).tobytes()
    st = _synthetic_state(4)
    per_old = [_port_names(*jrs.opt_state_streams(st, (10, 7), 4, r))[1]
               for r in range(4)]
    specs = _port_names(*jrs.opt_state_streams(st, (10, 7), 4, 0))[0]
    for d in per_old[1:]:
        d.update({k: v for k, v in per_old[0].items() if k not in d})
    one = rs.reshard_rank_streams(specs, per_old, 1)
    back = rs.reshard_rank_streams(specs, one, 4)
    for j in range(4):
        for s in specs:
            if s.kind != "perrank":  # the EF fold merges on purpose
                assert back[j][s.name].tobytes() == \
                    per_old[j][s.name].tobytes(), (j, s.name)


def test_live_reshard_matches_local_restack_bitwise():
    """Through the chunked transport (JAX's publishers, the port's
    fetch) equals the port's local restack and JAX's compat restack."""
    ge = (10, 7)
    st = _synthetic_state(2, ge)
    expected = jrs.reshard_opt_state(st, ge, 1)
    t = jrs.LocalTransport()
    per_old = [jrs.opt_state_streams(st, ge, 2, r) for r in range(2)]
    for r in range(2):
        jrs.reshard_streams(per_old[r][0], per_old[r][1], 2, 1, r, None, t,
                            chunk_bytes=32)
    specs = [rs.StreamSpec(*s) for s in per_old[0][0]]
    streams, _ = rs.reshard_streams(specs, None, 2, 1, None, 0, t,
                                    chunk_bytes=32, timeout=5.0)
    want = jrs.opt_state_streams(expected, ge, 1, 0)[1]
    for k, v in want.items():
        assert streams[k].tobytes() == v.tobytes(), k
    local = rs.reshard_rank_streams(specs, [d for _, d in per_old], 1)[0]
    for k in want:
        assert local[k].tobytes() == streams[k].tobytes(), k


def test_merge_rank_streams_grow_matches_restack():
    ge = (10, 7)
    st = _synthetic_state(1, ge)
    specs, data = jrs.opt_state_streams(st, ge, 1, 0)
    pspecs = [rs.StreamSpec(*s) for s in specs]
    t = rs.LocalTransport()
    rs.reshard_streams(pspecs, data, 1, 2, 0, None, t, chunk_bytes=32)
    per_new, _ = _fetch_all(rs, pspecs, 1, 2, t, chunk_bytes=32, timeout=5.0)
    merged = rs.merge_rank_streams(pspecs, per_new, 2)
    jmerged = jrs.merge_rank_streams(specs, per_new, 2)
    for k in merged:
        assert merged[k].tobytes() == jmerged[k].tobytes(), k
    got = jrs.compat_opt_state_from_streams(st, merged, ge, 2)
    want = jrs.reshard_opt_state(st, ge, 2)
    import jax
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_plan_meta_roundtrip():
    specs = [rs.StreamSpec("p0", 10, "float32", "shard"),
             rs.StreamSpec("e0", 10, "float32", "perrank"),
             rs.StreamSpec("o0.step", 1, "float32", "replicated")]
    text = rs.plan_meta_json(specs, 3)
    assert text == jrs.plan_meta_json([jrs.StreamSpec(*s) for s in specs], 3)
    back, n_old = rs.plan_meta_parse(text)
    assert back == specs and n_old == 3


# ---------------------------------------------------------------------------
# the host wire


def test_host_wire_exact_and_cast():
    from horovod_tpu.ops import wire as jwire
    from horovod_tpu_torch.ops import wire

    x = np.arange(9, dtype=np.float32) / 3
    for w in (None, "none", "fp16", "bf16"):
        enc = wire.host_encode(x, w)
        assert enc == jwire.host_encode(x, w), w
        out = wire.host_decode(enc, np.float32, w)
        assert out.tobytes() == jwire.host_decode(enc, np.float32,
                                                  w).tobytes(), w
        if w in (None, "none"):
            assert out.tobytes() == x.tobytes()
    with pytest.raises(HorovodTpuError, match="cooperative"):
        wire.host_encode(x, "int8")


# ---------------------------------------------------------------------------
# zero3 regroup, zero_group_elems, the decode handoff's helpers


def test_zero3_regroup_geometry():
    """The port's placement re-cut for another world keeps JAX's
    partition and group sizes (`regroup` needs no process group)."""
    from horovod_tpu.parallel.zero3 import zero3_placement
    from horovod_tpu_torch.parallel.zero3 import ZeroParamPlacement, shard_groups

    params = {"w": jnp.zeros((6, 4), jnp.float32),
              "b": jnp.zeros((5,), jnp.float32)}
    jpl = zero3_placement(params)
    leaves = [torch.zeros(5), torch.zeros(6, 4)]  # JAX's leaf order
    pl = object.__new__(ZeroParamPlacement)
    pl.__dict__.update(n=8, groups=shard_groups(leaves, 8), _rows=(),
                       _bound=None, _flats=[])
    for n in (2, 3):
        re, jre = pl.regroup(n), jpl.regroup(n)
        assert tuple(g.idxs for g in re.groups) == \
            tuple(tuple(g.idxs) for g in jre.groups)
        assert tuple(sum(g.sizes) for g in re.groups) == jre.group_elems
        assert tuple(g.shard_sz for g in re.groups) == \
            tuple(g.shard_sz for g in jre.groups)


@pytest.mark.parametrize("threshold", [None, 16, 64, 1 << 20])
def test_zero_group_elems_matches_jax(threshold):
    from horovod_tpu.parallel.optimizer import zero_group_elems as jzge
    from horovod_tpu_torch.parallel.optimizer import zero_group_elems

    shapes = [(6,), (4, 2), (3, 3, 2), (17,), (5, 4)]
    jleaves = [jnp.zeros(s, jnp.float32) for s in shapes]
    leaves = [torch.zeros(s) for s in shapes]
    assert zero_group_elems(leaves, fusion_threshold_bytes=threshold) == \
        jzge(jleaves, fusion_threshold_bytes=threshold)


def _handoff_params():
    rng = np.random.RandomState(11)
    return {"emb": rng.uniform(size=(5, 4)).astype(np.float32),
            "wi": rng.uniform(size=(4, 6)).astype(np.float32),
            "wo": rng.uniform(size=(6, 4)).astype(np.float32)}


def test_decode_handoff_slices_bitwise():
    """JAX's trainer publishes its stage-3 rows for serving; the port's
    `decode_leaf_slices` over `fetch_group_slice` rebuilds each tp
    slice bitwise what JAX's `fetch_decode_params` gives."""
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.serve.handoff import (
        fetch_decode_params, handoff_meta, publish_for_serve,
    )
    params = {k: jnp.asarray(v) for k, v in _handoff_params().items()}
    pspecs = {"emb": P(), "wi": P(None, "tp"), "wo": P("tp", None)}
    leaf_meta, groups = handoff_meta(params, pspecs)
    import jax
    leaves = jax.tree_util.tree_leaves(params)
    n_old = 2
    rows, ge = [], []
    for idxs, _ in groups:
        flat = np.concatenate([np.asarray(leaves[i]).reshape(-1)
                               for i in idxs])
        ge.append(flat.size)
        s = rs._shard_sz(flat.size, n_old)
        rows.append(np.pad(flat, (0, n_old * s - flat.size))
                    .reshape(n_old, s))
    t = jrs.LocalTransport()
    for r in range(n_old):
        publish_for_serve(rows, tuple(ge), n_old, r, t, tag="serve",
                          chunk_bytes=24)
    specs, n = rs.plan_meta_parse(t.get("serve/meta"))
    rs.check_plan_drift(specs, ge)
    plan = rs.ReshardPlan(specs, n, 1, chunk_bytes=24)
    by = {s.name: s for s in specs}
    for j in range(2):
        got = rs.decode_leaf_slices(
            leaf_meta, groups,
            lambda g, a, b: rs.fetch_group_slice(plan, by[f"p{g}"], t,
                                                 "serve", a, b, timeout=5.0),
            2, j)
        want = fetch_decode_params(params, pspecs, t, tag="serve", tp=2,
                                   tp_rank=j, chunk_bytes=24, timeout=5.0)
        for (k, _), g in zip(sorted(want.items()), got):
            assert g.tobytes() == np.asarray(want[k]).tobytes(), (j, k)


def test_handoff_drift_raises():
    t = rs.LocalTransport()
    t.put("serve/meta", rs.plan_meta_json(
        [rs.StreamSpec("p0", 999, "float32", "shard")], 2))
    specs, _ = rs.plan_meta_parse(t.wait("serve/meta", timeout=2.0))
    with pytest.raises(HorovodTpuError, match="drift"):
        rs.check_plan_drift(specs, (16,))
    rs.check_plan_drift(specs, (999,))
    assert rs._leaf_flat_intervals((4, 6), 1, 2, 1) == \
        jrs._leaf_flat_intervals((4, 6), 1, 2, 1)
    with pytest.raises(HorovodTpuError, match="divide"):
        rs._leaf_flat_intervals((5, 3), 0, 2, 0)


@pytest.mark.parametrize("n_old,n_new,workers", [(2, 1, 4), (1, 3, 3),
                                                  (3, 2, 8)])
def test_parallel_workers_are_bitwise_the_sequential_order(n_old, n_new,
                                                           workers):
    """Under a ceiling that lets `workers` chunks be in flight at once,
    the streams assemble bitwise what one at a time (a ceiling of one
    chunk's share, JAX's order) does, the EF fold included, with the
    staging peak within `workers` chunks."""
    rng = np.random.RandomState(13)
    buf = rng.uniform(-1, 1, size=(301,)).astype(np.float32)
    ef = rng.randint(-9, 9, size=(n_old, 77)).astype(np.float32)
    specs = [rs.StreamSpec("p0", 301, "float32", "shard"),
             rs.StreamSpec("e0", 77, "float32", "perrank")]
    per_old = [{"p0": buf[slice(*rs._owned_range(301, n_old, r))],
                "e0": ef[r]} for r in range(n_old)]
    one, peak = 4 * 64, workers * 4 * 64
    assert rs.parallel_workers(one, 64) == 1
    assert rs.parallel_workers(peak, 64) == workers
    assert rs.parallel_workers(1 << 30, 64) == 8
    seq, _ = _move(rs, specs, per_old, n_old, n_new, chunk_bytes=64,
                   peak_bytes=one)
    par, reps = _move(rs, specs, per_old, n_old, n_new, chunk_bytes=64,
                      peak_bytes=peak)
    for r in range(n_new):
        for name in ("p0", "e0"):
            assert par[r][name].tobytes() == seq[r][name].tobytes()
    assert all(x.peak_bytes <= workers * 64 for x in reps)


@pytest.mark.parametrize("n_old,n_new", [(2, 1), (1, 2), (2, 2), (3, 2)])
def test_an_owner_in_both_worlds_moves_every_chunk(n_old, n_new):
    """Each rank old and new at once (the same host, as in a shrink or
    a grow between survivors): every new rank ends bitwise the local
    restack, and every old rank's intervals cross the transport, its
    own too (as in the JAX package)."""
    rng = np.random.RandomState(17)
    buf = rng.uniform(-1, 1, size=(203,)).astype(np.float32)
    ef = rng.randint(-9, 9, size=(n_old, 41)).astype(np.float32)
    specs = [rs.StreamSpec("p0", 203, "float32", "shard"),
             rs.StreamSpec("e0", 41, "float32", "perrank"),
             rs.StreamSpec("c", 1, "int64", "replicated")]
    per_old = [{"p0": buf[slice(*rs._owned_range(203, n_old, r))],
                "e0": ef[r], "c": np.asarray([5], np.int64)}
               for r in range(n_old)]
    ref = rs.reshard_rank_streams(specs, per_old, n_new)
    t = rs.LocalTransport()
    outs, reps = [None] * max(n_old, n_new), [None] * max(n_old, n_new)
    errs = []

    def host(h):
        try:
            outs[h], reps[h] = rs.reshard_streams(
                specs, per_old[h] if h < n_old else None, n_old, n_new,
                h if h < n_old else None, h if h < n_new else None, t,
                chunk_bytes=32, timeout=10.0)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=host, args=(h,))
               for h in range(max(n_old, n_new))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs
    for j in range(n_new):
        for name in ("p0", "e0", "c"):
            assert outs[j][name].tobytes() == ref[j][name].tobytes()
    plan = rs.ReshardPlan(specs, n_old, n_new, chunk_bytes=32)
    for r in range(n_old):
        for iv in plan.publish_intervals(specs[0], r):
            assert t.get(f"g/{rs._iv_key('p0', iv)}") is not None
    assert all(x.bytes_moved > 0 for x in reps)


def test_a_reported_failure_fails_the_fetch_at_once():
    """A peer's fail marker ends the fetch without waiting the timeout."""
    import time

    spec = rs.StreamSpec("p0", 64, "float32", "shard")
    t = rs.LocalTransport()
    t.put("g/fail/r1", "peer died")
    t0 = time.monotonic()
    with pytest.raises(ReshardError, match="old rank 1 reported"):
        rs.reshard_streams([spec], None, 2, 1, None, 0, t, chunk_bytes=64,
                           timeout=30.0)
    assert time.monotonic() - t0 < 5.0


def test_this_slices_modules_import_neither_jax_nor_the_reference():
    """The reshard core, elastic ZeRO, the soak and the bench extras load
    without JAX and without the JAX package (a fresh interpreter)."""
    import os
    import subprocess
    import sys

    from test_torch_port_collectives import REPO

    code = ("import sys\n"
            "import horovod_tpu_torch.parallel.reshard, "
            "horovod_tpu_torch.torch.elastic, horovod_tpu_torch.faults.chaos, "
            "horovod_tpu_torch.bench\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'horovod_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
