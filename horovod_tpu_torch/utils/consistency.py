"""Cross-rank collective-consistency checking (semantic race detection;
counterpart of `horovod_tpu/utils/consistency.py`).

Reference parity (SURVEY.md §5 "race detection"): the reference's
controller rejects duplicate tensor names submitted in one cycle and
errors on mismatched shapes/dtypes when building responses
(controller.cc "Duplicate tensor name", message.cc construction checks)
— its negotiation phase sees every rank's submission, so divergence is
caught before the collective runs.

A torch.distributed collective negotiates nothing either: a rank calling
`allreduce` with a different shape (or a different op sequence) than its
peers hangs or corrupts silently.  HOROVOD_COLLECTIVE_CONSISTENCY_CHECK=1
restores the reference's diagnostic: before executing, every eager
collective publishes its signature (kind/shapes/dtypes/op,
sequence-numbered) to the launcher's rendezvous KV
(`runner.elastic_worker.client_from_env()`) and waits for all ranks'
signatures for that sequence number; any divergence raises with a
per-rank dump.  This is a debug mode — it adds one KV round-trip per
collective, the same traffic class as the reference's per-cycle
negotiation.

One process is one rank here, so the submitters a check waits for are
the participating ranks themselves (the JAX package maps each rank's
device to its owning process).
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from typing import Any, Dict

from ..common import basics, util
from ..common.exceptions import HorovodTpuError

logger = logging.getLogger("horovod_tpu_torch.consistency")

_lock = threading.Lock()
# Sequence counter PER participant set: disjoint process sets run
# concurrent, independently-numbered streams (reference: one controller
# per process set), and interleaving set-scoped with global collectives
# must not desynchronize either stream.
_seqs: Dict[tuple, int] = {}
# Bumped on reset(): scopes the KV namespace so keys from before a
# shutdown/re-init can never satisfy a later barrier (the same stale-key
# hazard join.py solves with its _round component).
_round = 0
_kv = None

_POLL_S = 0.02


def _timeout_s() -> float:
    """How long to wait for peers' signatures before declaring them
    divergent/stalled (HOROVOD_CONSISTENCY_TIMEOUT seconds; read per
    check so tests and long-compile phases can adjust it live)."""
    return util.env_float("CONSISTENCY_TIMEOUT", 30.0)


def enabled() -> bool:
    return util.env_bool("COLLECTIVE_CONSISTENCY_CHECK", False)


def reset() -> None:
    global _seqs, _round, _kv
    with _lock:
        _seqs = {}
        _round += 1
        _kv = None


def _client():
    global _kv
    if _kv is None:
        from ..runner.elastic_worker import client_from_env
        _kv = client_from_env()
    return _kv


def _ns() -> str:
    gen = util.getenv("ELASTIC_GEN", "0")
    return f"cc/{gen}/{basics.size()}/{_round}"


# Keys older than this many (completed) sequence numbers are reclaimed:
# a rank at seq s has completed the seq s-1 barrier, so every
# participant has read seq <= s-1's keys and anything at s-_GC_LAG is
# dead (prevents unbounded KV growth over a long debug run).
_GC_LAG = 4


def check(sig: Dict[str, Any], ranks=None) -> None:
    """Publish this rank's signature for the next collective and verify
    every participating rank submitted the same one.  `ranks` scopes the
    barrier to a process set's members (disjoint sets run concurrent,
    independent sequences — reference: one controller per process set).
    No-op unless enabled and multi-process."""
    if not enabled() or basics.size() <= 1:
        return
    # One submission per rank: each process is one rank.
    if ranks:
        member_ranks = tuple(sorted(int(r) for r in ranks))
    else:
        member_ranks = tuple(range(basics.size()))
    with _lock:
        s = _seqs.get(member_ranks, 0)
        _seqs[member_ranks] = s + 1
    # Short stable id for the participant set's key stream.
    setid = "-".join(map(str, member_ranks))
    if len(setid) > 40:
        setid = hashlib.sha1(setid.encode()).hexdigest()[:16]
    base = f"{_ns()}/{setid}/{s}"
    kv = _client()
    me = basics.rank()
    mine = json.dumps(sig, sort_keys=True)
    kv.put(f"{base}/{me}", mine)
    timeout_s = _timeout_s()
    deadline = time.monotonic() + timeout_s
    while True:
        keys = kv.keys(f"{base}/")
        have = {int(k.rsplit("/", 1)[1]) for k in keys}
        if all(r in have for r in member_ranks):
            break
        if time.monotonic() > deadline:
            missing = sorted(set(member_ranks) - have)
            raise HorovodTpuError(
                f"collective consistency check: processes {missing} did "
                f"not submit collective #{s} within {timeout_s}s (this "
                f"process submitted {mine}) — peers are running a "
                f"different program or have stalled")
        time.sleep(_POLL_S)
    per_proc = {p: kv.get(f"{base}/{p}") for p in member_ranks}
    if len(set(per_proc.values())) > 1:
        dump = "\n".join(f"  process {p}: {v}"
                         for p, v in sorted(per_proc.items()))
        raise HorovodTpuError(
            f"collective consistency check FAILED at collective #{s} — "
            f"processes submitted different collectives:\n{dump}")
    if s >= _GC_LAG:
        try:
            kv.delete(f"{_ns()}/{setid}/{s - _GC_LAG}/{me}")
        # lint: allow-swallow(KV GC is best-effort; stale rows are harmless)
        except Exception:  # noqa: BLE001
            pass


__all__ = ["check", "enabled", "reset"]
