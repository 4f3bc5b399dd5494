"""Continuous-batching inference server over the paged KV pool.

Counterpart of `horovod_tpu/serve/server.py`.  One decode step of fixed
``max_batch`` rows serves every in-flight sequence; admission and
eviction happen between steps (the scheduler), and each sequence's KV
state lives in the pool (pool.py).  The model side is the vector-``pos``
path of `models/decode.py`: continuously batched rows sit at different
depths of one step.

Step anatomy (``step()``):

  1. admit   queued requests board free rows; prefill-on-admit runs
             `transformer_prefill` into a scratch cache sized to the
             request's page budget (K4 on the card where the prompt
             routes to flash), then bulk-writes its pages.
  2. emit    each active row's next token is decided on the host from
             its pending logits (greedy); finished rows (max_new / eos)
             evict and free their pages before any device work.
  3. gather  only after an admission: refresh the admitted rows of the
             pooled view.
  4. decode  one vector-pos `transformer_decode_step`, or one
             speculative round (draft chain + chunked verify) when the
             SLO controller has turned speculation on.
  5. scatter each active row's written ring slot(s) back into its
             pages; the pool stays the source of truth.

Speculative rounds keep the greedy target chain: every decided token is
the argmax of target logits over a correct prefix (the accepted prefix
is the minimum over rows).  Host orchestration (clocks, metrics, the
timeline, the flight recorder) stays on the host; the server runs on
the card unless built with ``device="cpu"``.
"""

from __future__ import annotations

import atexit
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common import util
from ..common.exceptions import InvalidRequestError
from ..metrics import catalog as _met
from ..models.decode import (
    decode_params,
    init_decode_cache,
    transformer_decode_step,
    transformer_extend,
    transformer_prefill,
)
from ..utils import autotune
from ..utils.timeline import get_timeline
from .flightrec import FlightRecorder
from .pool import PagedKVPool, PoolExhaustedError
from .scheduler import ActiveSeq, ContinuousScheduler, Request
from .slo import SloController


def _flush_at_exit(ref: "weakref.ref") -> None:
    srv = ref()
    if srv is not None:
        srv.flush_metrics()


def _on_device(params, cfg, dev):
    def put(tree):
        return {k: put(v) if isinstance(v, dict)
                else torch.as_tensor(v).to(dev) for k, v in tree.items()}
    return decode_params(put(params), cfg)


class InferenceServer:
    """Greedy continuous-batching decode server (one model replica).

    ``params`` (and ``draft_params``): parameter trees in the JAX layout
    (`transformer_init`), moved to ``device`` (the card unless given) and
    rounded to the compute dtype where they only enter matmuls.
    ``policy="static"`` turns the same machinery into the static-batching
    baseline (admit only into an empty batch)."""

    def __init__(self, params, cfg, *,
                 max_seq_tokens: int,
                 max_batch: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 quantize: Optional[str] = None,
                 draft_params=None, draft_cfg=None,
                 gamma: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 force_spec: bool = False,
                 policy: str = "fifo", seed: int = 0,
                 device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.cfg = cfg
        self.params = _on_device(params, cfg, self.device)
        self.page_tokens = page_tokens or \
            autotune.current_serve_page_tokens()
        self.max_batch = max_batch or autotune.current_serve_max_batch()
        self.gamma = gamma or autotune.current_serve_spec_gamma()
        if self.page_tokens < 1 or self.max_batch < 1 or self.gamma < 1:
            raise InvalidRequestError(
                f"page_tokens/max_batch/gamma must be >= 1, got "
                f"{self.page_tokens}/{self.max_batch}/{self.gamma}")
        if (draft_params is None) != (draft_cfg is None):
            raise InvalidRequestError(
                "draft_params and draft_cfg come together")
        if draft_params is not None and cfg.attn_window:
            raise InvalidRequestError(
                "speculative serving does not support attn_window "
                "configs (chunked verify over a rolling ring)")
        self.draft_cfg = draft_cfg
        self.draft_params = (None if draft_params is None else
                             _on_device(draft_params, draft_cfg,
                                        self.device))
        # Per-sequence budget: the full ring a request may need, with the
        # gamma headroom of a speculative round.
        headroom = self.gamma if draft_params is not None else 0
        self.max_seq_tokens = max_seq_tokens + headroom
        self.view_pages = -(-self.max_seq_tokens // self.page_tokens)
        self.view_tokens = self.view_pages * self.page_tokens
        pool_pages = pool_pages or autotune.current_serve_pool_pages() \
            or self.max_batch * self.view_pages
        self.pool = PagedKVPool(cfg, pool_pages, self.page_tokens,
                                quantize=quantize, device=self.device)
        self.dpool = None
        if draft_params is not None:
            self.dpool = PagedKVPool(draft_cfg, pool_pages,
                                     self.page_tokens, device=self.device)
        self.sched = ContinuousScheduler(self.max_batch, policy=policy,
                                         seed=seed)
        if slo_ms is None:                 # HOROVOD_SERVE_SLO_MS
            slo_ms = util.env_float("SERVE_SLO_MS", 0.0)
        self.slo = SloController(slo_ms)
        self.force_spec = force_spec
        # Gauges are sampled every HOROVOD_SERVE_METRICS_INTERVAL steps,
        # with one flush at drain and at exit.
        self._metrics_interval = max(
            1, util.env_int("SERVE_METRICS_INTERVAL", 16))
        depth = autotune.current_serve_flightrec_depth()
        self.flightrec: Optional[FlightRecorder] = \
            FlightRecorder(depth) if depth > 0 else None
        if self.flightrec is not None:
            rec = self.flightrec
            self.sched.observer = lambda step, event, req, row: \
                rec.record("sched", {"event": event, "req": req,
                                     "row": row}, step=step)
            self.pool.on_event = lambda ev, sid, n, free: \
                rec.record("pool", {"event": ev, "req": sid,
                                    "pages": n, "free": free},
                           step=self.step_no)
            if self.dpool is not None:
                self.dpool.on_event = lambda ev, sid, n, free: \
                    rec.record("dpool", {"event": ev, "req": sid,
                                         "pages": n, "free": free},
                               step=self.step_no)
        self.slo.on_flip = self._on_slo_flip
        # Per-request lifecycle state for the timeline spans, the latency
        # histograms and the flight recorder.
        self._req_obs: Dict[int, Dict] = {}
        ref = weakref.ref(self)
        atexit.register(_flush_at_exit, ref)

        V = cfg.vocab_size
        self.row_pos = np.zeros(self.max_batch, np.int64)
        self.last_logits = np.zeros((self.max_batch, V), np.float32)
        self.row_seq: List[Optional[int]] = [None] * self.max_batch
        self.view_k = self.view_v = None
        self.dview_k = self.dview_v = None
        self._dirty_rows: Dict[int, int] = {}    # row -> seq_id to refresh
        self.step_no = 0
        self._next_req_id = 0
        self._submit_wall: Dict[int, float] = {}
        # run stats (read by loadgen and the benchmark)
        self.tokens_out = 0
        self.device_steps = 0
        self.spec_steps = 0
        self.occupancy_sum = 0.0
        self.token_latencies_ms: List[float] = []
        self.request_latencies_ms: List[float] = []
        self.ttft_ms: List[float] = []

    # -- request intake ------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               req_id: Optional[int] = None,
               slo_class: str = "standard") -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.max_seq_tokens:
            raise InvalidRequestError(
                f"request needs {prompt.size} + {max_new_tokens} "
                f"tokens > per-sequence budget {self.max_seq_tokens}")
        if req_id is None:
            req_id = self._next_req_id
        self._next_req_id = max(self._next_req_id, req_id) + 1
        req = Request(req_id=req_id, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival_step=self.step_no, slo_class=slo_class)
        self._submit_wall[req_id] = time.perf_counter()
        tl = get_timeline()
        self._req_obs[req_id] = {
            "submit_us": tl.now_us() if tl is not None else None,
            "admit_us": None, "prefill_end_us": None,
            "wall_prefill_end": None, "first": False, "spec_ms": 0.0,
        }
        if tl is not None:
            tl.instant("serve_submit", category="serve",
                       args={"req": req_id,
                             "prompt_tokens": int(prompt.size),
                             "max_new": int(max_new_tokens)},
                       tid=f"req/{req_id}")
        self.sched.submit(req, self.step_no)
        return req_id

    # -- admission -----------------------------------------------------

    def _budget_tokens(self, req: Request) -> int:
        n = int(req.prompt.size) + req.max_new_tokens
        if self.draft_params is not None:
            n += self.gamma
        return n

    def _can_admit(self, req: Request) -> bool:
        n = self._budget_tokens(req)
        if not self.pool.can_alloc(n):
            return False
        return self.dpool is None or self.dpool.can_alloc(n)

    def _prefill_into(self, pool: PagedKVPool, params, cfg, seq,
                      npages: int):
        scratch = init_decode_cache(cfg, 1, npages * self.page_tokens,
                                    quantize=pool.quantize,
                                    device=self.device)
        prompt = torch.from_numpy(seq.req.prompt[None].astype(np.int64))
        lg, scratch = transformer_prefill(params, scratch,
                                          prompt.to(self.device), cfg)
        pool.scatter_pages(seq.req.req_id, scratch["k"], scratch["v"])
        return lg

    def _admit(self) -> None:
        for seq in self.sched.admit(self.step_no, self._can_admit):
            rid = seq.req.req_id
            obs = self._req_obs.get(rid)
            tl = get_timeline()
            t_submit = self._submit_wall.get(rid)
            if t_submit is not None and _met.enabled():
                _met.serve_queue_delay.observe(
                    time.perf_counter() - t_submit)
            if tl is not None and obs is not None \
                    and obs["submit_us"] is not None:
                # queue_wait ends where prefill starts, so the request's
                # spans abut and sum to its end-to-end latency.
                tl.complete("queue_wait", category="serve",
                            start_us=obs["submit_us"],
                            args={"req": rid}, tid=f"req/{rid}")
            t_prefill_us = tl.now_us() if tl is not None else None
            wall_prefill = time.perf_counter()
            budget = self._budget_tokens(seq.req)
            pids = self.pool.alloc(rid, budget)
            lg = self._prefill_into(self.pool, self.params, self.cfg,
                                    seq, len(pids))
            if self.dpool is not None:
                dpids = self.dpool.alloc(rid, budget)
                self._prefill_into(self.dpool, self.draft_params,
                                   self.draft_cfg, seq, len(dpids))
            T0 = int(seq.req.prompt.size)
            if obs is not None:
                obs["admit_us"] = t_prefill_us
            if tl is not None and t_prefill_us is not None:
                tl.complete("prefill", category="serve",
                            start_us=t_prefill_us,
                            args={"req": rid, "prompt_tokens": T0,
                                  "row": seq.row},
                            tid=f"req/{rid}")
            self.last_logits[seq.row] = lg[0].float().cpu().numpy()
            if obs is not None:
                obs["prefill_end_us"] = (tl.now_us()
                                         if tl is not None else None)
                obs["wall_prefill_end"] = time.perf_counter()
            if self.flightrec is not None:
                dur_us = (time.perf_counter() - wall_prefill) * 1e6
                end = self.flightrec.now_us()
                self.flightrec.record(
                    "span", {"name": "prefill", "req": rid,
                             "prompt_tokens": T0, "row": seq.row},
                    step=self.step_no, ts_us=end - dur_us,
                    dur_us=dur_us)
            seq.pos = T0
            self.row_pos[seq.row] = T0
            self.row_seq[seq.row] = rid
            self._dirty_rows[seq.row] = rid

    def _first_token(self, seq: ActiveSeq) -> None:
        """Once per request, right after its first token is decided: TTFT
        = queue wait + prefill + its first emit, from submit."""
        rid = seq.req.req_id
        obs = self._req_obs.get(rid)
        if obs is None or obs["first"]:
            return
        obs["first"] = True
        t0 = self._submit_wall.get(rid)
        if t0 is not None:
            self.ttft_ms.append((time.perf_counter() - t0) * 1e3)
            if _met.enabled():
                _met.serve_ttft.observe(time.perf_counter() - t0)
        tl = get_timeline()
        if tl is not None:
            tl.instant("serve_first_token", category="serve",
                       args={"req": rid, "step": self.step_no},
                       tid=f"req/{rid}")
        if self.flightrec is not None:
            self.flightrec.record("first_token", {"req": rid},
                                  step=self.step_no)

    def _finish(self, seq: ActiveSeq) -> None:
        rid = seq.req.req_id
        self.sched.evict(self.step_no, seq.row)
        self.pool.free(rid)
        if self.dpool is not None:
            self.dpool.free(rid)
        self.row_seq[seq.row] = None
        self.row_pos[seq.row] = 0
        self._dirty_rows.pop(seq.row, None)
        t0 = self._submit_wall.pop(rid, None)
        if t0 is not None:
            self.request_latencies_ms.append(
                (time.perf_counter() - t0) * 1e3)
            if _met.enabled():
                _met.serve_e2e_latency.observe(time.perf_counter() - t0)
        obs = self._req_obs.pop(rid, None)
        tl = get_timeline()
        if tl is not None:
            if obs is not None and obs["prefill_end_us"] is not None:
                tl.complete("decode", category="serve",
                            start_us=obs["prefill_end_us"],
                            args={"req": rid,
                                  "tokens": len(seq.generated),
                                  "spec_ms": round(obs["spec_ms"], 3)},
                            tid=f"req/{rid}")
            tl.instant("serve_evict", category="serve",
                       args={"req": rid,
                             "tokens": len(seq.generated)},
                       tid=f"req/{rid}")
        if self.flightrec is not None and obs is not None \
                and obs["wall_prefill_end"] is not None:
            dur_us = (time.perf_counter()
                      - obs["wall_prefill_end"]) * 1e6
            self.flightrec.record(
                "span", {"name": "decode", "req": rid,
                         "tokens": len(seq.generated)},
                step=self.step_no,
                ts_us=self.flightrec.now_us() - dur_us, dur_us=dur_us)

    def _refresh_views(self) -> None:
        """Bring the pooled view up to date: a full gather the first
        time, then the admitted rows only."""
        if self.view_k is None:
            self.view_k, self.view_v = self.pool.gather(
                self.row_seq, self.view_pages)
            if self.dpool is not None:
                self.dview_k, self.dview_v = self.dpool.gather(
                    self.row_seq, self.view_pages)
        elif self._dirty_rows:
            pairs = sorted(self._dirty_rows.items())
            self.pool.gather_rows(self.view_k, self.view_v, pairs,
                                  self.view_pages)
            if self.dpool is not None:
                self.dpool.gather_rows(self.dview_k, self.dview_v, pairs,
                                       self.view_pages)
        self._dirty_rows.clear()

    # -- the step ------------------------------------------------------

    def step(self) -> List[ActiveSeq]:
        """One scheduler + decode iteration; returns the sequences that
        finished this step.  An exception inside the step (including
        PoolExhaustedError) dumps the flight recorder before it
        propagates."""
        try:
            return self._step_impl()
        except BaseException as e:
            if self.flightrec is not None:
                reason = ("pool_exhausted"
                          if isinstance(e, PoolExhaustedError)
                          else f"crash:{type(e).__name__}")
                self.flightrec.record(
                    "error", {"type": type(e).__name__,
                              "msg": str(e)[:200]}, step=self.step_no)
                self.flightrec.dump(reason)
            raise

    def _step_impl(self) -> List[ActiveSeq]:
        t0 = time.perf_counter()
        self._admit()
        finished: List[ActiveSeq] = []
        feed = np.zeros(self.max_batch, np.int64)
        for row in sorted(self.sched.active):
            seq = self.sched.active[row]
            if not seq.done:
                tok = int(np.argmax(self.last_logits[row]))
                seq.generated.append(tok)
                self.tokens_out += 1
                feed[row] = tok
                if len(seq.generated) == 1:
                    self._first_token(seq)
            if seq.done:
                finished.append(seq)
                self._finish(seq)
        rows = sorted(self.sched.active)
        decided = 0
        if rows:
            self._refresh_views()
            spec = (self.draft_params is not None
                    and (self.force_spec or self.slo.update(self.step_no)))
            if spec:
                t_spec = time.perf_counter()
                decided = self._spec_round(rows, feed)
                spec_ms = (time.perf_counter() - t_spec) * 1e3
                for r in rows:
                    sid = self.row_seq[r]
                    ob = (self._req_obs.get(sid)
                          if sid is not None else None)
                    if ob is not None:
                        ob["spec_ms"] += spec_ms
                self.spec_steps += 1
            else:
                self._plain_step(rows, feed)
            self.device_steps += 1
            self.occupancy_sum += len(rows) / self.max_batch
            dt_ms = (time.perf_counter() - t0) * 1e3
            per_tok = dt_ms / (1 + decided)
            self.token_latencies_ms.append(per_tok)
            self.slo.record(per_tok)
            if _met.enabled():
                _met.serve_intertoken.observe(per_tok / 1e3)
        self._update_gauges()
        if self.flightrec is not None:
            self.flightrec.record(
                "step", {"rows": len(rows), "decided": 1 + decided,
                         "finished": len(finished)}, step=self.step_no)
        self.step_no += 1
        return finished

    def _feed(self, tokens) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tokens, np.int64)).to(
            self.device)

    def _plain_step(self, rows: Sequence[int], feed: np.ndarray) -> None:
        base = self.row_pos.copy()
        cache = {"k": self.view_k, "v": self.view_v,
                 "pos": torch.from_numpy(base.copy())}
        lg, _ = transformer_decode_step(self.params, cache,
                                        self._feed(feed), self.cfg)
        sids = [self.row_seq[r] for r in rows]
        slots = [int(base[r]) % self.view_tokens for r in rows]
        self.pool.scatter_slots(self.view_k, self.view_v, sids, rows,
                                slots)
        self.last_logits = lg.float().cpu().numpy()
        for r in rows:
            self.row_pos[r] += 1
            self.sched.active[r].pos = int(self.row_pos[r])

    def _spec_round(self, rows: Sequence[int], feed: np.ndarray) -> int:
        """Draft-propose / chunk-verify round; returns how many extra
        tokens (beyond the step's emit) were decided per row."""
        gamma = self.gamma
        base = self.row_pos.copy()
        dcache = {"k": self.dview_k, "v": self.dview_v,
                  "pos": torch.from_numpy(base.copy())}
        drafts: List[np.ndarray] = []     # d_1 .. d_gamma, each [B]
        cur = feed
        for _ in range(gamma):
            dlg, dcache = transformer_decode_step(
                self.draft_params, dcache, self._feed(cur), self.draft_cfg)
            cur = torch.argmax(dlg, -1).cpu().numpy()
            drafts.append(cur)

        chunk = np.stack([feed] + drafts[:-1], axis=1)     # [B, gamma]
        tcache = {"k": self.view_k, "v": self.view_v,
                  "pos": torch.from_numpy(base.copy())}
        tlg, _ = transformer_extend(self.params, tcache, self._feed(chunk),
                                    self.cfg)
        tlogits = tlg.float().cpu().numpy()                 # [B, g, V]

        # Accepted prefix per row, capped at gamma-1 so the round always
        # ends holding verified logits for the next undecided position
        # (tlogits[:, n_acc]).  Min-acceptance keeps every row's advance
        # equal; a row that accepted further replays its own draft.
        n_acc = gamma - 1
        for r in rows:
            acc = 0
            while acc < gamma - 1 and \
                    int(drafts[acc][r]) == \
                    int(np.argmax(tlogits[r, acc])):
                acc += 1
            n_acc = min(n_acc, acc)
        for r in rows:
            seq = self.sched.active[r]
            for i in range(n_acc):
                if seq.done:
                    break
                seq.generated.append(int(drafts[i][r]))
                self.tokens_out += 1
            self.last_logits[r] = tlogits[r, n_acc]
            self.row_pos[r] = int(base[r]) + n_acc + 1
            seq.pos = int(self.row_pos[r])
        # Scatter the verified slots (the emit token and the accepted
        # drafts): ring positions base .. base + n_acc per row.
        sids = [self.row_seq[r] for r in rows]
        for off in range(n_acc + 1):
            slots = [(int(base[r]) + off) % self.view_tokens
                     for r in rows]
            self.pool.scatter_slots(self.view_k, self.view_v, sids,
                                    rows, slots)
            if self.dpool is not None:
                self.dpool.scatter_slots(self.dview_k, self.dview_v,
                                         sids, rows, slots)
        return n_acc

    # -- loops / observability -----------------------------------------

    def run(self, max_steps: int = 100000) -> List[ActiveSeq]:
        """Step until queue and batch drain; returns the finished
        sequences in completion order."""
        done: List[ActiveSeq] = []
        for _ in range(max_steps):
            if self.sched.drained():
                break
            done.extend(self.step())
        self.flush_metrics()
        if not self.sched.drained():
            raise InvalidRequestError(
                f"server did not drain within {max_steps} steps "
                f"({self.sched.queue_depth()} queued, "
                f"{len(self.sched.active)} active)")
        return done

    def occupancy_mean(self) -> float:
        return self.occupancy_sum / max(1, self.device_steps)

    def oldest_queue_wait_ms(self) -> float:
        """Wall-clock wait of the oldest queued request (zero when the
        queue is empty)."""
        now = time.perf_counter()
        waits = [now - self._submit_wall[r.req_id]
                 for r in self.sched.queue
                 if r.req_id in self._submit_wall]
        return max(waits) * 1e3 if waits else 0.0

    def shed_queued(self, n: int,
                    tenant_priority: Optional[Dict[str, int]] = None
                    ) -> List[Request]:
        """Drop up to ``n`` queued requests in tenant-priority order
        (`ContinuousScheduler.shed`) and release their lifecycle state.
        Returns the shed requests for the caller to fail back."""
        shed = self.sched.shed(self.step_no, n, tenant_priority)
        for req in shed:
            self._submit_wall.pop(req.req_id, None)
            self._req_obs.pop(req.req_id, None)
            if self.flightrec is not None:
                self.flightrec.record(
                    "shed", {"req": req.req_id,
                             "slo_class": req.slo_class},
                    step=self.step_no)
        if shed and _met.enabled():
            _met.autoscale_shed.inc(len(shed))
        return shed

    def _update_gauges(self) -> None:
        if not _met.enabled() \
                or self.step_no % self._metrics_interval:
            return
        self._set_gauges()

    def _set_gauges(self) -> None:
        _met.serve_queue_depth.set(self.sched.queue_depth())
        _met.serve_batch_occupancy.set(self.sched.occupancy())
        _met.serve_pool_pages_free.set(self.pool.pages_free())
        p99 = self.slo.p99_ms()
        if p99:
            _met.serve_p99_ms.set(p99)
        self.slo.export_budget()

    def flush_metrics(self) -> None:
        """Unconditional gauge sample (at drain and at exit)."""
        if _met.enabled():
            self._set_gauges()

    def _on_slo_flip(self, step: int, event: str, p99: float) -> None:
        tl = get_timeline()
        if tl is not None:
            tl.instant("slo_toggle", category="serve",
                       args={"step": step, "event": event,
                             "p99_ms": round(p99, 3)})
        if self.flightrec is not None:
            self.flightrec.record(
                "slo", {"event": event, "p99_ms": round(p99, 3)},
                step=step)
            if event == "spec_on":
                # The SLO just went over budget: snapshot the ring.
                self.flightrec.dump("slo_breach")


__all__ = ["InferenceServer"]
