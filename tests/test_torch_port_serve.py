"""Port parity: the serving stack (`horovod_tpu_torch/serve/`, with
`metrics/` and `utils/timeline.py`) against the JAX package's
`horovod_tpu/serve/`, on the CPU.

- `PagedKVPool`: alloc, free and LIFO reuse without a leak, exhaustion,
  pooled decode bitwise the contiguous-cache decode (plain and int8),
  `gather_rows` equal to the full gather;
- `ContinuousScheduler`: the decision log bitwise JAX's for the same
  submissions, admission answers and seed, under fifo, random and
  static (the random policy draws from the same `random.Random`);
- `SloController`: the toggle replay, decisions equal to JAX's on the
  same latency trace;
- `FlightRecorder`: a dump read back by the port's and by JAX's
  `load_dump`;
- `InferenceServer` (f32 weights from the JAX package's
  `transformer_init`): continuous and speculative serving give each
  request exactly the port's `transformer_generate` tokens (the same
  arithmetic on the same rows, so exact), eos stops a row, an oversized
  request is refused, the pool drains;
- `make_trace` and `make_shaped_trace` bitwise JAX's; `run_trace`'s
  record;
- the registry, budget, quantile window and timeline writer.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.serve import flightrec as JF
from horovod_tpu.serve import loadgen as JL
from horovod_tpu.serve import scheduler as JS
from horovod_tpu.serve import slo as JSLO
from horovod_tpu.metrics import history as JH
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.metrics import budget as TB
from horovod_tpu_torch.metrics import catalog as TCAT
from horovod_tpu_torch.metrics import history as TH
from horovod_tpu_torch.metrics import registry as TR
from horovod_tpu_torch.models import decode as TD
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.serve import (
    ContinuousScheduler,
    FlightRecorder,
    InferenceServer,
    PagedKVPool,
    PoolExhaustedError,
    Request,
    SloController,
    load_dump,
)
from horovod_tpu_torch.serve import loadgen as TL
from horovod_tpu_torch.serve import scheduler as TS
from horovod_tpu_torch.utils import timeline as TTL

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_head=8, d_ff=64,
             n_layers=2)


def _cfg(**kw):
    return TT.TransformerConfig(**dict(SMALL, **kw),
                                compute_dtype=torch.float32)


def _jax_params(seed=0, **kw):
    jp = JT.transformer_init(jax.random.PRNGKey(seed), JT.TransformerConfig(
        **dict(SMALL, **kw), compute_dtype=jnp.float32))
    return TT.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                       jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def model():
    return _cfg(), _jax_params()


# ---------------------------------------------------------------------------
# PagedKVPool
# ---------------------------------------------------------------------------

def test_pool_alloc_free_reuse_without_a_leak():
    pool = PagedKVPool(_cfg(), total_pages=8, page_tokens=4, device="cpu")
    a = pool.alloc(1, 10)          # 3 pages
    b = pool.alloc(2, 4)           # 1 page
    assert a == [0, 1, 2] and b == [3]
    assert pool.pages_free() == 4
    assert pool.utilization() == pytest.approx(0.5)
    pool.free(1)
    assert pool.pages_free() == 7
    assert pool.alloc(3, 8) == [0, 1]     # the last freed page first
    pool.free(2)
    pool.free(3)
    assert pool.pages_free() == 8 and pool.pages == {}


def test_pool_exhaustion_and_refusals():
    pool = PagedKVPool(_cfg(), total_pages=2, page_tokens=4, device="cpu")
    pool.alloc(1, 8)
    with pytest.raises(PoolExhaustedError):
        pool.alloc(2, 4)
    with pytest.raises(HorovodTpuError, match="already holds"):
        pool.alloc(1, 4)
    with pytest.raises(HorovodTpuError, match="holds no pages"):
        pool.free(99)
    assert pool.can_alloc(4) is False
    pool.free(1)
    assert pool.can_alloc(8) is True
    for kw in (dict(total_pages=0, page_tokens=4),
               dict(total_pages=4, page_tokens=0)):
        with pytest.raises(HorovodTpuError):
            PagedKVPool(_cfg(), device="cpu", **kw)


def _halves(kv):
    return [kv["q"], kv["scale"]] if isinstance(kv, dict) else [kv]


def _cat(a, b):
    if isinstance(a, dict):
        return {k: torch.cat([a[k], b[k]], dim=1) for k in a}
    return torch.cat([a, b], dim=1)


def _assert_same(x, y):
    for a, b in zip(_halves(x), _halves(y)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_pooled_decode_is_bitwise_the_contiguous_decode(model, quantize):
    """Both sides start from the same per-row prefill bytes; the pooled
    side routes them through scatter_pages and gather, then five decode
    steps on each, the pool scattering each written slot back."""
    cfg, params = model
    B, T0, steps, ring = 2, 4, 5, 16
    toks = np.random.RandomState(1).randint(0, 64, (B, T0))
    pool = PagedKVPool(cfg, total_pages=2 * (ring // 4), page_tokens=4,
                       quantize=quantize, device="cpu")
    ck = cv = lg0 = None
    for b in range(B):
        pool.alloc(b, ring)
        scratch = TD.init_decode_cache(cfg, 1, ring, quantize=quantize,
                                       device="cpu")
        plg, scratch = TD.transformer_prefill(params, scratch,
                                              toks[b:b + 1], cfg)
        pool.scatter_pages(b, scratch["k"], scratch["v"])
        ck = scratch["k"] if ck is None else _cat(ck, scratch["k"])
        cv = scratch["v"] if cv is None else _cat(cv, scratch["v"])
        lg0 = plg if lg0 is None else torch.cat([lg0, plg])
    vk, vv = pool.gather([0, 1], ring // 4)
    _assert_same(vk, ck)
    _assert_same(vv, cv)
    pos = np.full(B, T0, np.int64)
    tok = rtok = torch.argmax(lg0, -1)
    for _ in range(steps):
        rlg, _ = TD.transformer_decode_step(
            params, {"k": ck, "v": cv, "pos": torch.from_numpy(pos.copy())},
            rtok, cfg)
        lg, _ = TD.transformer_decode_step(
            params, {"k": vk, "v": vv, "pos": torch.from_numpy(pos.copy())},
            tok, cfg)
        pool.scatter_slots(vk, vv, [0, 1], [0, 1],
                           [int(q) % ring for q in pos])
        assert torch.equal(lg, rlg)
        pos += 1
        tok, rtok = torch.argmax(lg, -1), torch.argmax(rlg, -1)
    # The pool stayed the source of truth: a fresh gather is the
    # contiguous cache, byte for byte.
    fk, fv = pool.gather([0, 1], ring // 4)
    _assert_same(fk, ck)
    _assert_same(fv, cv)


def test_gather_rows_matches_the_full_gather(model):
    cfg, params = model
    pool = PagedKVPool(cfg, total_pages=6, page_tokens=4, device="cpu")
    for sid in (10, 11, 12):
        pool.alloc(sid, 8)
        scratch = TD.init_decode_cache(cfg, 1, 8, device="cpu")
        _, scratch = TD.transformer_prefill(
            params, scratch, np.full((1, 5), sid, np.int64), cfg)
        pool.scatter_pages(sid, scratch["k"], scratch["v"])
    vk, vv = pool.gather([10, 11, None], 2)
    pool.free(10)
    uk, uv = pool.gather_rows(vk, vv, [(2, 12)], 2)
    fk, fv = pool.gather([None, 11, 12], 2)   # row 0 may stay stale
    assert torch.equal(uk[:, 1:], fk[:, 1:]) and torch.equal(uv[:, 1:],
                                                             fv[:, 1:])
    assert uk[:, 2].abs().sum() > 0


# ---------------------------------------------------------------------------
# Scheduler, SLO controller, flight recorder
# ---------------------------------------------------------------------------

def _scheduler_log(mod, policy, seed=0):
    """A deep queue with uneven budgets and page back-pressure (every
    fifth admission refused once)."""
    sched = mod.ContinuousScheduler(3, policy=policy, seed=seed)
    for n in range(9):
        sched.submit(mod.Request(req_id=n, prompt=np.ones(4),
                                 max_new_tokens=2 + n % 3), 0)
    asked = [0]

    def can_admit(req):
        asked[0] += 1
        return asked[0] % 5 != 0

    step = 0
    while not sched.drained():
        sched.admit(step, can_admit)
        for row, seq in list(sched.active.items()):
            seq.generated.append(0)
            if seq.done:
                sched.evict(step, row)
        if step == 2:
            sched.shed(step, 1)
        step += 1
    return sched.decision_log


@pytest.mark.parametrize("policy", ["fifo", "random", "static"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_log_is_bitwise_jax(policy, seed):
    got = _scheduler_log(TS, policy, seed)
    assert got == _scheduler_log(JS, policy, seed)
    assert got == _scheduler_log(TS, policy, seed)


def test_scheduler_refusals_and_static_waves():
    with pytest.raises(HorovodTpuError, match="policy"):
        ContinuousScheduler(2, policy="nope")
    with pytest.raises(HorovodTpuError, match="max_new_tokens"):
        Request(req_id=0, prompt=np.ones(2), max_new_tokens=0)
    sched = ContinuousScheduler(2, policy="static")
    for i in range(4):
        sched.submit(Request(req_id=i, prompt=np.ones(2),
                             max_new_tokens=1), 0)
    assert len(sched.admit(0, lambda r: True)) == 2
    assert sched.admit(1, lambda r: True) == []
    sched.evict(2, 0)
    assert sched.admit(3, lambda r: True) == []
    sched.evict(3, 1)
    assert len(sched.admit(4, lambda r: True)) == 2


def test_slo_controller_replays_jax_decisions():
    lat = [1.0] * 20 + [9.0] * 30 + [1.0] * 40 + [7.0, 2.0] * 10

    def replay(cls):
        c = cls(5.0, window=8, hysteresis=0.5, dwell_steps=4)
        states = []
        for i, ms in enumerate(lat):
            c.record(ms)
            states.append(c.update(i))
        return c.decisions, states, c.p99_ms()

    got = replay(SloController)
    assert got == replay(JSLO.SloController)
    events = [e for _, e, _ in got[0]]
    assert events[:2] == ["spec_on", "spec_off"]
    assert got[1][25] is True and got[1][89] is False
    off = SloController(None)
    off.record(100.0)
    assert off.update(0) is False and off.decisions == []
    with pytest.raises(HorovodTpuError):
        SloController(5.0, hysteresis=0.0)


def test_sorted_window_quantile_is_bitwise_jax():
    rng = np.random.RandomState(4)
    tw, jw = TH.SortedWindow(16), JH.SortedWindow(16)
    for v in rng.exponential(3.0, 200):
        tw.append(v)
        jw.append(v)
        for q in (50.0, 99.0):
            assert tw.quantile(q) == jw.quantile(q)
            # numpy interpolates in another order: the last bit may part.
            assert tw.quantile(q) == pytest.approx(float(np.percentile(
                np.asarray(list(tw)), q)), rel=1e-12)


def test_flight_recorder_dump_round_trip(tmp_path):
    rec = FlightRecorder(4, out_dir=str(tmp_path))
    try:
        for i in range(6):
            rec.record("step", {"rows": i}, step=i)
        rec.record("span", {"name": "prefill"}, step=6, ts_us=1.0,
                   dur_us=2.5)
        path = rec.dump("test")
        got = load_dump(path)
        assert got == JF.load_dump(path)
        assert got["reason"] == "test" and got["depth"] == 4
        assert got["recorded_total"] == 7 and got["dropped"] == 3
        assert [e["seq"] for e in got["events"]] == [3, 4, 5, 6]
        assert got["events"][-1]["dur_us"] == 2.5
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps([1, 2]))
        with pytest.raises(ValueError, match="not a flight-recorder"):
            load_dump(str(bad))
    finally:
        rec.close()


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

def _generate(params, cfg, prompt, n, quantize=None):
    toks, _ = TD.transformer_generate(params, cfg, np.asarray(prompt)[None],
                                      n, quantize=quantize)
    return toks[0].tolist()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_continuous_serving_matches_generate(model, quantize):
    cfg, params = model
    srv = InferenceServer(params, cfg, max_seq_tokens=24, max_batch=3,
                          page_tokens=4, quantize=quantize, device="cpu")
    rng = np.random.RandomState(2)
    reqs = []
    for _ in range(7):
        prompt = rng.randint(0, 64, size=int(rng.choice([3, 5])))
        mn = int(rng.randint(2, 8))
        reqs.append((srv.submit(prompt, mn), prompt, mn))
    by_id = {s.req.req_id: s.generated for s in srv.run()}
    for rid, prompt, mn in reqs:
        assert by_id[rid] == _generate(params, cfg, prompt, mn, quantize)
    assert srv.pool.pages_free() == srv.pool.total_pages
    assert 0 < srv.occupancy_mean() <= 1 and srv.tokens_out == sum(
        mn for *_, mn in reqs)


def test_speculative_serving_matches_generate(model):
    cfg, params = model
    srv = InferenceServer(params, cfg, max_seq_tokens=24, max_batch=2,
                          page_tokens=4, draft_params=_jax_params(9),
                          draft_cfg=cfg, gamma=3, force_spec=True,
                          device="cpu")
    rng = np.random.RandomState(3)
    reqs = [(srv.submit(p, 6), p) for p in
            (rng.randint(0, 64, size=4) for _ in range(4))]
    by_id = {s.req.req_id: s.generated for s in srv.run()}
    assert srv.spec_steps > 0
    for rid, prompt in reqs:
        assert by_id[rid] == _generate(params, cfg, prompt, 6)
    assert srv.pool.pages_free() == srv.pool.total_pages
    assert srv.dpool.pages_free() == srv.dpool.total_pages


def test_eos_stops_a_row_and_an_oversized_request_is_refused(model):
    cfg, params = model
    prompt = np.arange(4)
    ref = _generate(params, cfg, prompt, 8)
    eos = ref[2]
    srv = InferenceServer(params, cfg, max_seq_tokens=16, max_batch=2,
                          page_tokens=4, device="cpu")
    srv.submit(prompt, 8, eos_id=eos)
    (seq,) = srv.run()
    assert seq.generated[-1] == eos and len(seq.generated) <= 3
    assert seq.generated == ref[:len(seq.generated)]
    with pytest.raises(HorovodTpuError, match="budget"):
        srv.submit(np.ones(8, np.int32), 16)
    with pytest.raises(HorovodTpuError, match="draft_params"):
        InferenceServer(params, cfg, max_seq_tokens=16, draft_cfg=cfg,
                        device="cpu")


def test_slo_flip_turns_speculation_on_and_dumps(model, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_FLIGHTREC_DIR", str(tmp_path))
    cfg, params = model
    srv = InferenceServer(params, cfg, max_seq_tokens=24, max_batch=2,
                          page_tokens=4, draft_params=params,
                          draft_cfg=cfg, gamma=2, slo_ms=1e-6,
                          device="cpu")
    srv.slo.dwell_steps = 0
    rng = np.random.RandomState(5)
    reqs = [(srv.submit(p, 8), p) for p in
            (rng.randint(0, 64, size=3) for _ in range(3))]
    by_id = {s.req.req_id: s.generated for s in srv.run()}
    assert srv.spec_steps > 0 and srv.slo.decisions[0][1] == "spec_on"
    assert srv.flightrec.dumps and load_dump(srv.flightrec.dumps[0])[
        "reason"] == "slo_breach"
    for rid, prompt in reqs:
        assert by_id[rid] == _generate(params, cfg, prompt, 8)


# ---------------------------------------------------------------------------
# Load generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(long_frac=0.5, long_lo=90, long_hi=99),
    dict(prompt_lens=(3, 5, 2048), arrival_every=0.5)])
def test_make_trace_is_bitwise_jax(kw):
    got = TL.make_trace(5, 24, 64, **kw)
    want = JL.make_trace(5, 24, 64, **kw)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2]
        assert g[1].dtype == w[1].dtype and g[1].tobytes() == w[1].tobytes()


@pytest.mark.parametrize("shape", TL.SHAPES)
def test_make_shaped_trace_is_bitwise_jax(shape):
    got = TL.make_shaped_trace(shape, 3, 40, 64)
    want = JL.make_shaped_trace(shape, 3, 40, 64)
    assert [(g[0], g[2], g[3], g[1].tobytes()) for g in got] == \
        [(w[0], w[2], w[3], w[1].tobytes()) for w in want]


def test_run_trace_record(model):
    cfg, params = model
    trace = TL.make_trace(3, 5, cfg.vocab_size, prompt_lens=(3, 5),
                          max_new_lo=2, max_new_hi=6, arrival_every=1.0)
    srv = InferenceServer(params, cfg, max_seq_tokens=16, max_batch=2,
                          page_tokens=4, device="cpu")
    stats = TL.run_trace(srv, trace)
    assert stats["tokens_out"] == sum(mn for _, _, mn in trace)
    assert 0 < stats["batch_occupancy_mean"] <= 1
    assert 0 < stats["kv_pool_peak_utilization"] <= 1
    assert stats["request_p99_ms"] >= stats["request_p50_ms"] > 0
    assert stats["ttft_list_p99_ms"] >= stats["ttft_list_p50_ms"] > 0
    assert srv.pool.pages_free() == srv.pool.total_pages


# ---------------------------------------------------------------------------
# Metrics and the timeline
# ---------------------------------------------------------------------------

def test_registry_budget_and_catalog():
    reg = TR.MetricsRegistry()
    h = reg.histogram("h_seconds", "help")
    for v in (1e-6, 3e-4, 2.0, 100.0):
        h.observe(v)
    cum = h._solo().cumulative()
    assert cum[-1] == (float("inf"), 4) and h._solo().count == 4
    with pytest.raises(ValueError, match="re-registered"):
        reg.counter("h_seconds", "help")
    c = reg.counter("c_total", "help", ("kind",))
    c.labels("a").inc(2)
    assert c.labels(kind="a").get() == 2.0
    before = TL.hist_cumulative(TCAT.serve_ttft)
    TCAT.serve_ttft.observe(0.01)
    assert TL.hist_delta_quantile(
        before, TL.hist_cumulative(TCAT.serve_ttft), 50) > 0
    b = TB.SloBudget("t", target=0.9, budget_window_s=100,
                     fast_window_s=10, slow_window_s=50)
    for t in range(20):
        b.record_latency(5.0 if t % 2 else 1.0, 2.0, now=float(t))
    # The fast window holds t = 9..19: 6 of 11 events over the SLO.
    assert b.burn_rate(10, now=19.0) == pytest.approx(6 / 11 / 0.1)
    assert b.budget_remaining(now=19.0) == pytest.approx(-4.0)
    assert b.breaching(now=19.0)
    names = {m.name for m in TR.get_registry().collect()}
    assert {"hvd_serve_ttft_seconds", "hvd_serve_queue_depth",
            "hvd_slo_burn_rate"} <= names
    assert TCAT.enabled() in (True, False)


def test_timeline_writes_the_server_spans(model, tmp_path):
    cfg, params = model
    path = tmp_path / "tl.json"
    TTL.start_timeline(str(path))
    try:
        srv = InferenceServer(params, cfg, max_seq_tokens=16, max_batch=2,
                              page_tokens=4, device="cpu")
        srv.submit(np.arange(3), 3)
        srv.run()
    finally:
        TTL.stop_timeline()
    events = json.loads(path.read_text())
    names = [e["name"] for e in events if e.get("tid") == "req/0"]
    assert names == ["serve_submit", "queue_wait", "prefill",
                     "serve_first_token", "decode", "serve_evict"]
    assert TTL.get_timeline() is None


def test_serve_benchmark_runs_fifo_and_static_on_the_cpu(capsys):
    from horovod_tpu_torch import serve_benchmark as SB

    assert SB.main(["--device", "cpu", "--small", "--config",
                    "gqa4+int8"]) == 0
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("SERVE ")][-1]
    rec = json.loads(line[len("SERVE "):])
    assert rec["device"] == "cpu" and rec["quantize"] == "int8"
    assert rec["model"]["n_kv_heads"] == 2 and rec["max_batch"] == 8
    for policy in ("fifo", "static"):
        assert rec[policy]["tokens_out"] == rec["tokens_requested"]
    assert rec["speedup_tokens_per_sec"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(HorovodTpuError, match="--device cpu"):
            SB.main(["--small"])
