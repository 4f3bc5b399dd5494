"""Paged KV-cache pool: the serving engine's memory allocator.

Counterpart of `horovod_tpu/serve/pool.py`.  One fixed-size page table
per model, a page being ``page_tokens`` tokens x layers x kv heads,
carved out of `init_decode_cache` storage (so the int8 / fp8_e4m3
layouts ride along unchanged), with per-sequence page lists and LIFO
alloc/free on admit/evict.

The decode step never sees pages.  ``gather`` materialises the active
rows' pages as a ``[L, B, view_tokens, Hkv, Dh]`` view, the shape
`transformer_decode_step` takes, and ``scatter_slots`` copies the ring
slot each step writes back into the owning page.  Both are pure data
movement (index ops over every row at once), so pooled decode is
bitwise the contiguous-cache decode.  The view is rebuilt only on
membership change (admit), and the pool stays the source of truth.
Where the JAX kernels donate their buffers and return new ones, these
write the pool's (and a view's) tensors in place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.exceptions import HorovodTpuError, InvalidRequestError
from ..models.decode import init_decode_cache


def _each(kv, f):
    """f(tensor, is_scale) on a plain cache half or on both parts of a
    quantized {"q", "scale"} one (payload and scale move together)."""
    if isinstance(kv, dict):
        return {"q": f(kv["q"], False), "scale": f(kv["scale"], True)}
    return f(kv, False)


def _part(c, scale: bool):
    if isinstance(c, dict):
        return c["scale"] if scale else c["q"]
    return c


def _flat_pages(g: torch.Tensor) -> torch.Tensor:
    """[L, B, Vp, pt, ...] -> [L, B, Vp * pt, ...]."""
    return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])


class PoolExhaustedError(HorovodTpuError):
    """Admission asked for more KV pages than the pool has free.  The
    scheduler treats it as back-pressure (the request waits in the
    queue), not as a crash."""


class PagedKVPool:
    """Fixed-size page table over `init_decode_cache` storage.

    ``k``/``v`` are decode-cache tensors with the batch axis read as the
    page axis, ``[L, total_pages, page_tokens, Hkv, Dh]`` (quantized: the
    same {"q", "scale"} dicts), on `device` (the card unless given).  A
    sequence's ring of ``n`` tokens maps to ``ceil(n / page_tokens)``
    pages; slot ``s`` lives at ``(pages[s // page_tokens], s %
    page_tokens)``."""

    def __init__(self, cfg, total_pages: int, page_tokens: int,
                 quantize: Optional[str] = None, device=None):
        if total_pages < 1:
            raise InvalidRequestError(
                f"total_pages must be >= 1, got {total_pages}")
        if page_tokens < 1:
            raise InvalidRequestError(
                f"page_tokens must be >= 1, got {page_tokens}")
        store = init_decode_cache(cfg, total_pages, page_tokens,
                                  quantize=quantize, device=device)
        self.k = store["k"]
        self.v = store["v"]
        self.device = _part(self.k, False).device
        self.cfg = cfg
        self.total_pages = total_pages
        self.page_tokens = page_tokens
        self.quantize = quantize
        # LIFO free stack, page 0 on top: a fresh pool allocates 0, 1, 2,
        # ... (a deterministic reuse order).
        self._free: List[int] = list(range(total_pages - 1, -1, -1))
        self.pages: Dict[int, List[int]] = {}
        #: Optional observer called after every alloc/free with (event,
        #: seq_id, n_pages, pages_free); the server wires it to the
        #: flight recorder.
        self.on_event: Optional[Callable[[str, int, int, int],
                                         None]] = None

    def _idx(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    # -- accounting ----------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    def pages_free(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.total_pages

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    # -- alloc / free ---------------------------------------------------

    def alloc(self, seq_id: int, n_tokens: int) -> List[int]:
        """Allocate (and zero) enough pages for ``n_tokens`` ring slots.
        Zeroing on alloc keeps eviction O(1) and makes a freshly gathered
        view bitwise a fresh contiguous cache."""
        if seq_id in self.pages:
            raise InvalidRequestError(
                f"sequence {seq_id} already holds pages "
                f"{self.pages[seq_id]}")
        need = self.pages_needed(n_tokens)
        if need > len(self._free):
            raise PoolExhaustedError(
                f"need {need} pages for {n_tokens} tokens, only "
                f"{len(self._free)}/{self.total_pages} free")
        pids = [self._free.pop() for _ in range(need)]
        idx = self._idx(pids)
        for half in (self.k, self.v):
            _each(half, lambda c, _s: c.index_fill_(1, idx, 0))
        self.pages[seq_id] = pids
        if self.on_event is not None:
            self.on_event("alloc", seq_id, len(pids), len(self._free))
        return pids

    def free(self, seq_id: int) -> List[int]:
        """Return a sequence's pages to the free stack (on evict/EOS)."""
        try:
            pids = self.pages.pop(seq_id)
        except KeyError:
            raise InvalidRequestError(
                f"sequence {seq_id} holds no pages") from None
        # Reversed: the most recently used page is reused first.
        self._free.extend(reversed(pids))
        if self.on_event is not None:
            self.on_event("free", seq_id, len(pids), len(self._free))
        return pids

    # -- view gather / scatter -----------------------------------------

    def _page_table(self, seq_ids, view_pages: int) -> np.ndarray:
        idx = np.zeros((len(seq_ids), view_pages), np.int64)
        for b, sid in enumerate(seq_ids):
            if sid is None:
                continue
            pids = self.pages[sid]
            if len(pids) > view_pages:
                raise InvalidRequestError(
                    f"sequence {sid} holds {len(pids)} pages > view "
                    f"capacity {view_pages}")
            idx[b, :len(pids)] = pids
        return idx

    def gather(self, seq_ids: Sequence[Optional[int]],
               view_pages: int) -> Tuple:
        """The active rows' pages as a contiguous decode view ``[L, B,
        view_pages * page_tokens, Hkv, Dh]``.  ``seq_ids[b] is None``
        marks an idle row; idle rows (and the tail of short page lists)
        read page 0, which is never read back (the ring's mask hides
        slots past each row's pos) and never written back
        (``scatter_slots`` runs over active rows only)."""
        idx = self._idx(self._page_table(seq_ids, view_pages))
        return tuple(_each(half, lambda c, _s: _flat_pages(c[:, idx]))
                     for half in (self.k, self.v))

    def gather_rows(self, view_k, view_v,
                    row_sids: Sequence[Tuple[int, int]],
                    view_pages: int) -> Tuple:
        """Refresh only the given (row, seq_id) pairs of an existing view
        (in place), the admit-time fast path: rows whose sequence was
        evicted need no refresh (their stale bytes are masked off and
        never scattered back)."""
        if not row_sids:
            return view_k, view_v
        idx = self._idx(self._page_table([s for _, s in row_sids],
                                         view_pages))
        rows = self._idx([r for r, _ in row_sids])
        for view, half in ((view_k, self.k), (view_v, self.v)):
            _each(view, lambda vc, scale, half=half: vc.index_copy_(
                1, rows, _flat_pages(_part(half, scale)[:, idx])))
        return view_k, view_v

    def scatter_slots(self, view_k, view_v, seq_ids: Sequence[int],
                      rows: Sequence[int], slots: Sequence[int]) -> None:
        """Copy one written ring slot per active row from the view back
        into the owning page: row ``rows[i]`` (sequence ``seq_ids[i]``)
        wrote view slot ``slots[i]``.  An exact copy: a quantized payload
        and its scale move together."""
        if not seq_ids:
            return
        pt = self.page_tokens
        pids = self._idx([self.pages[sid][s // pt]
                          for sid, s in zip(seq_ids, slots)])
        offs = self._idx([s % pt for s in slots])
        rows_t, slots_t = self._idx(list(rows)), self._idx(list(slots))
        for half, view in ((self.k, view_k), (self.v, view_v)):
            def put(c, scale, view=view):
                c[:, pids, offs] = _part(view, scale)[:, rows_t, slots_t]
                return c
            _each(half, put)

    def scatter_pages(self, seq_id: int, cache_k, cache_v) -> None:
        """Install a freshly prefilled contiguous cache (batch 1, ring
        length exactly this sequence's page budget) into its pages: the
        admit-time bulk write."""
        pids = self.pages[seq_id]
        pt = self.page_tokens
        ring = _part(cache_k, False).shape[2]
        if ring != len(pids) * pt:
            raise InvalidRequestError(
                f"prefill cache ring {ring} != page budget "
                f"{len(pids) * pt} of sequence {seq_id}")
        idx = self._idx(pids)
        for half, src in ((self.k, cache_k), (self.v, cache_v)):
            def put(c, scale, src=src):
                s = _part(src, scale)[:, 0]
                c[:, idx] = s.reshape(s.shape[0], len(pids), pt,
                                      *s.shape[2:])
                return c
            _each(half, put)


__all__ = ["PagedKVPool", "PoolExhaustedError"]
