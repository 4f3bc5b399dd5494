"""Train-to-serve handoff: reshard the ZeRO-3 training layout into the
dp x tp decode layout without a full gather (counterpart of
`horovod_tpu/serve/handoff.py`).

The training side owns parameters as stage-3 rows: per shard group, a
flat buffer cut into `n_train` rows (`parallel/zero3.py`; each rank its
own placed row).  The decode side wants each leaf sliced along its
tensor-parallel axis (`models.transformer.transformer_pspecs`): a serve
host holding tp rank `j` of `tp` needs exactly `1/tp` of every sharded
leaf and all of every replicated one.  Those are two partitions of the
same logical buffers, so the handoff is a reshard, not a gather: the
trainer publishes its rows in peak-bounded chunks
(`publish_for_serve`), and each serve host fetches only the
group-logical intervals its decode slices cover
(`fetch_decode_params`), chunk by chunk, never holding a whole leaf it
needs a slice of.

Integrity is the reshard module's: a sha256 a chunk and the publish
side's bit-pattern digests a stream.  A dead trainer or a corrupt chunk
surfaces as `ReshardError`; the caller then loads a checkpoint.

A parameter tree is a dict (leaves in sorted-key order, the JAX
package's flatten order, so that a tree in the JAX layout partitions
as JAX's does) or a list of tensors (in order: a model's parameters,
as its placement sees them); `pspecs` is the same structure of spec
tuples (`transformer_pspecs`' entries).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.exceptions import HorovodTpuError
from ..ops.compression import Compression
from ..parallel import reshard as _rs
from ..parallel.data_parallel import shard_group_partition

logger = logging.getLogger("horovod_tpu_torch.serve.handoff")


def _is_spec(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x))


def _leaves(tree, is_leaf=None) -> list:
    """The leaves of a dict / list tree: dict keys sorted (the JAX
    package's flatten order), lists in order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, is_leaf)]
    return [tree]


def _unflatten(template, leaves) -> Any:
    """`template`'s structure with `leaves` (in `_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def _tp_axis(spec) -> Optional[int]:
    """Position of the 'tp' axis in one spec, or None."""
    if spec is None:
        return None
    for ax, entry in enumerate(spec):
        if entry == "tp" or (isinstance(entry, tuple) and "tp" in entry):
            return ax
    return None


def handoff_meta(params_template: Any, pspecs: Any,
                 compression=Compression.none,
                 fusion_threshold_bytes: Optional[int] = None,
                 bucket_order=None
                 ) -> Tuple[List[Tuple[Tuple[int, ...], str,
                                       Optional[int]]],
                            List[Tuple[List[int], List[int]]]]:
    """(leaf_meta, groups) for the decode handoff.

    `leaf_meta[i]` is (shape, dtype, tp_axis or None) for leaf i in
    flatten order; `groups` is [(idxs, sizes)] of the training shard-
    group partition: pass the tunables training used, or the
    group-logical offsets do not line up (the published plan meta
    checks this, see `fetch_decode_params`)."""
    leaves = _leaves(params_template)
    spec_leaves = _leaves(pspecs, is_leaf=_is_spec)
    if len(spec_leaves) != len(leaves):
        raise HorovodTpuError(
            f"pspec tree has {len(spec_leaves)} leaves but params have "
            f"{len(leaves)} — structures must match")
    leaf_meta = [
        (tuple(int(d) for d in l.shape), str(l.dtype).replace("torch.", ""),
         _tp_axis(s))
        for l, s in zip(leaves, spec_leaves)]
    fakes = [torch.empty(tuple(l.shape), dtype=l.dtype, device="meta")
             for l in leaves]
    groups = [
        (list(idxs), [fakes[i].numel() for i in idxs])
        for idxs in shard_group_partition(
            fakes, compression=compression,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order)]
    return leaf_meta, groups


def publish_for_serve(rows, group_elems: Tuple[int, ...], n_old: int,
                      old_rank: int, transport, tag: str = "serve",
                      chunk_bytes: Optional[int] = None,
                      peak_bytes: Optional[int] = None,
                      wire: Optional[str] = None) -> "_rs.ReshardReport":
    """Training side: publish this rank's stage-3 parameter rows (its
    placed (1, shard) rows, or (n_old, shard) stacks) for serve hosts
    to fetch.  Every old rank calls this; rank 0 also writes the plan
    meta.  Returns the publish report."""
    specs, data = _rs.param_streams(rows, group_elems, n_old, old_rank)
    if old_rank == 0:
        transport.put(f"{tag}/meta", _rs.plan_meta_json(specs, n_old))
    _, report = _rs.reshard_streams(
        specs, data, n_old, n_old, old_rank, None, transport, tag=tag,
        chunk_bytes=chunk_bytes, peak_bytes=peak_bytes, wire=wire)
    logger.info(
        "serve handoff: rank %d/%d published %d group(s), %d bytes",
        old_rank, n_old, len(specs), report.bytes_moved)
    return report


def fetch_decode_params(params_template: Any, pspecs: Any, transport,
                        tag: str = "serve", tp: int = 1,
                        tp_rank: int = 0,
                        compression=Compression.none,
                        fusion_threshold_bytes: Optional[int] = None,
                        bucket_order=None,
                        chunk_bytes: Optional[int] = None,
                        peak_bytes: Optional[int] = None,
                        timeout: Optional[float] = None,
                        stats: Optional[Dict] = None) -> Any:
    """Serve side: rebuild this host's tp slice of every decode leaf
    from the trainer's published rows.  Returns a tree shaped like
    `params_template` of CPU tensors, each tp-sharded leaf cut to
    `1/tp` along its axis: ready for `make_decode_step`'s placement.
    `stats`, when given, receives the staging peak in bytes."""
    leaf_meta, groups = handoff_meta(
        params_template, pspecs, compression=compression,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_order=bucket_order)
    timeout = _rs.default_timeout() if timeout is None else timeout
    specs, n_old = _rs.plan_meta_parse(
        transport.wait(f"{tag}/meta", timeout=timeout))
    by_name = {s.name: s for s in specs}
    for gi, (idxs, sizes) in enumerate(groups):
        spec = by_name.get(f"p{gi}")
        if spec is None or spec.elems != sum(sizes):
            raise HorovodTpuError(
                f"serve handoff drift: local group {gi} "
                f"({sum(sizes)} elems) does not match the published "
                f"plan ({spec.elems if spec else 'missing'}) — "
                "recompute handoff_meta with the trainer's tunables")
    plan = _rs.ReshardPlan(specs, n_old, 1, chunk_bytes=chunk_bytes,
                           peak_bytes=peak_bytes)
    tracker = _rs._PeakTracker()
    # The runs of a leaf cut along an inner axis are many and short:
    # the payloads they read are fetched ahead, each once.
    payloads = _rs.PayloadReader(
        plan, transport, tag,
        [(by_name[f"p{gi}"], start, stop) for _, gi, start, stop, _
         in _rs.leaf_runs(leaf_meta, groups, tp, tp_rank)],
        timeout, tracker)

    def _fetch(gi: int, start: int, stop: int) -> np.ndarray:
        return _rs.fetch_group_slice(
            plan, by_name[f"p{gi}"], transport, tag, start, stop,
            timeout=timeout, tracker=tracker, payloads=payloads)

    try:
        leaves = _rs.decode_leaf_slices(leaf_meta, groups, _fetch, tp,
                                        tp_rank)
    finally:
        payloads.close()
    out = _unflatten(params_template,
                     [torch.from_numpy(np.ascontiguousarray(a))
                      for a in leaves])
    if stats is not None:
        stats["peak_bytes"] = tracker.peak
    logger.info(
        "serve handoff: tp rank %d/%d fetched %d leaf slices from "
        "old world %d (staging peak %d bytes)", tp_rank, tp,
        len(leaves), n_old, tracker.peak)
    return out


# -- chip borrowing (serve/autoscale.py BorrowLedger's actuation edges) ------

def stash_train_state(rows, group_elems: Tuple[int, ...], n_old: int,
                      old_rank: int, transport, tag: str = "borrow",
                      chunk_bytes: Optional[int] = None,
                      peak_bytes: Optional[int] = None,
                      wire: Optional[str] = None) -> "_rs.ReshardReport":
    """Borrow, step 1: before lending chips to serving, the training
    job publishes its stage-3 parameter rows under the ``borrow`` tag,
    the decode handoff's publish in another namespace.  A
    `ReshardError` here (a peer dying mid-publish) aborts the borrow
    with the training state untouched: the ledger never records chips
    that were not safely stashed."""
    return publish_for_serve(rows, group_elems, n_old, old_rank,
                             transport, tag=tag,
                             chunk_bytes=chunk_bytes,
                             peak_bytes=peak_bytes, wire=wire)


def restore_train_state(group_elems: Tuple[int, ...], dtypes, n_new: int,
                        new_rank: int, transport, tag: str = "borrow",
                        chunk_bytes: Optional[int] = None,
                        peak_bytes: Optional[int] = None,
                        timeout: Optional[float] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Borrow, step 2 (hand-back): training resumes by fetching its
    stashed rows back at any new world size, since the stash is a
    reshard plan, not a checkpoint: each of the ``n_new`` ranks fetches
    exactly its owned intervals (digest-verified a chunk) and gets its
    placed (1, shard) rows (`reshard.streams_to_param_rows`)."""
    timeout = _rs.default_timeout() if timeout is None else timeout
    specs, n_old = _rs.plan_meta_parse(
        transport.wait(f"{tag}/meta", timeout=timeout))
    by_name = {s.name: s for s in specs}
    for gi, elems in enumerate(group_elems):
        spec = by_name.get(f"p{gi}")
        if spec is None or spec.elems != elems:
            raise HorovodTpuError(
                f"borrow restore drift: local group {gi} ({elems} "
                f"elems) does not match the stashed plan "
                f"({spec.elems if spec else 'missing'})")
    plan = _rs.ReshardPlan(specs, n_old, n_new,
                           chunk_bytes=chunk_bytes,
                           peak_bytes=peak_bytes)
    tracker = _rs._PeakTracker()
    streams: Dict[str, np.ndarray] = {}
    for gi, elems in enumerate(group_elems):
        lo, hi = _rs._owned_range(elems, n_new, new_rank)
        streams[f"p{gi}"] = _rs.fetch_group_slice(
            plan, by_name[f"p{gi}"], transport, tag, lo, hi,
            timeout=timeout, tracker=tracker)
    logger.info(
        "borrow hand-back: rank %d/%d restored %d group(s) from "
        "stash world %d (staging peak %d bytes)", new_rank, n_new,
        len(group_elems), n_old, tracker.peak)
    return _rs.streams_to_param_rows(streams, group_elems, dtypes,
                                     n_new, new_rank)


__all__ = ["fetch_decode_params", "handoff_meta", "publish_for_serve",
           "restore_train_state", "stash_train_state"]
