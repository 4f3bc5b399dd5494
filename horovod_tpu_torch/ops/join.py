"""Uneven-data join (reference: EnqueueJoin + JoinOp, operations.cc /
controller.cc).

Counterpart of `horovod_tpu/ops/join.py`.  A rank that runs out of data
calls `join()`; from then on it takes part in every collective of the
ranks still training with a zero contribution, until every rank has
joined; Average then divides by the count of active ranks, and `join()`
returns the last rank to join.

Two parts, as in the JAX package:

1. **Masked collectives** (`collectives._masked`, `_active_count`).
   While join mode is armed, a joined rank contributes its op's identity
   (zeros for Sum and Average, the dtype's largest value for Min, its
   smallest for Max, 1 for Product) and Average divides, at f32, by the
   sum of the ranks' active flags (at least 1): JAX
   `masked_reduce_in_graph`.
2. **Signature mirroring** (`_join_service_loop`, `_mirror_collective`).
   Active ranks publish each eager collective's signature (kind, shapes,
   dtypes, op, root, process set), numbered by a sequence counter, in
   the key-value store that `init` built for the process group (the JAX
   package's rendezvous KV).  `join()` loops: read the next signature,
   run that collective with zeros, repeat, until every rank has joined.
   Keys live under `join/<HOROVOD_ELASTIC_GEN>/<size>/<round>/`: a
   later join cycle never reads an earlier one's keys.

Join mode must be armed on every process before training (`join_mode()`
or HOROVOD_JOIN_MODE=1): every rank has to publish and run the masked
collectives from the first step, or a lone rank switching mid-run would
leave the others waiting.  A one-rank job returns from `join()` at once.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..common import basics, util
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError

_JOIN_NS = "join"
_POLL_S = 0.05
_JOIN_TIMEOUT_S = 120.0


class _JoinState:
    """The process's join state; `reset` starts it afresh."""

    def __init__(self):
        self.lock = threading.Lock()
        self.joined = False      # this rank has joined in this round
        self.seq = 0             # next collective's sequence number
        self.round = 0           # completed join cycles
        self.mode_forced: Optional[bool] = None


_state = _JoinState()


def reset() -> None:
    """Forget every join (called by `init` and `shutdown`)."""
    global _state
    _state = _JoinState()


def join_mode(enabled: bool = True) -> None:
    """Arm (or disarm) the masked collectives on this process; required
    on every process before uneven-data training."""
    _state.mode_forced = enabled


def armed() -> bool:
    if _state.mode_forced is not None:
        return _state.mode_forced
    return util.env_bool("JOIN_MODE") or _state.joined


def is_joined() -> bool:
    """Whether this rank has joined in the current round."""
    return _state.joined


def joined_ranks() -> List[int]:
    """The ranks of this process that have joined in the current round
    (JAX `joined_ranks`, whose process drives several simulated ranks):
    this rank while it serves its `join()`, else none."""
    return [basics.rank()] if _state.joined else []


def _store():
    """The process group's key-value store (the one `init` built)."""
    return dist.distributed_c10d._get_default_store()


def _ns() -> str:
    gen = util.getenv("ELASTIC_GEN", "0")
    return f"{_JOIN_NS}/{gen}/{basics.size()}/{_state.round}"


def next_seq() -> int:
    with _state.lock:
        s = _state.seq
        _state.seq += 1
        return s


def publish_signature(sig: Dict[str, Any]) -> int:
    """Record this collective's signature under the next sequence number
    for joined ranks to mirror.  Every active rank writes the same value
    (the last write wins harmlessly), from the first collective on: a
    guard on "has anyone joined" would race with a rank joining between
    the check and the collective."""
    s = next_seq()
    if basics.size() > 1:
        _store().set(f"{_ns()}/op/{s}", json.dumps(sig, sort_keys=True))
    return s


def join(process_set: Optional[ProcessSet] = None) -> int:
    """Join this rank: contribute zeros to every later collective of the
    others until all ranks have joined; return the last rank to join
    (reference: hvd.join())."""
    ps = process_set or basics.global_process_set()
    if basics.size() == 1:
        _complete_round()
        return basics.rank()
    if not armed():
        raise HorovodTpuError(
            "join() in multi-process mode requires join mode to be armed "
            "on every process before training: call hvd.join_mode() "
            "after init, or set HOROVOD_JOIN_MODE=1")
    with _state.lock:
        _state.joined = True
    return _join_service_loop(ps)


def _complete_round() -> None:
    """Every rank joined: clear the joined flag and move to the next
    round's keys, so later collectives run unmasked."""
    with _state.lock:
        _state.joined = False
        _state.round += 1


def _join_service_loop(ps: ProcessSet) -> int:
    """Mirror the active ranks' collectives with zero contributions until
    every rank of `ps` has joined (the reference's background JoinOp
    service, run inline since join() blocks anyway)."""
    from . import collectives as C

    store = _store()
    ns = _ns()
    my_seq = _state.seq  # the next signature to mirror
    store.set(f"{ns}/joined/{basics.rank()}", str(my_seq))
    store.add(f"{ns}/joined_count", 1)
    deadline = time.monotonic() + _JOIN_TIMEOUT_S
    while store.add(f"{ns}/joined_count", 0) < ps.size():
        key = f"{ns}/op/{my_seq}"
        if not store.check([key]):
            if time.monotonic() > deadline:
                raise HorovodTpuError(
                    f"join(): no collective signature for seq {my_seq} "
                    f"within {_JOIN_TIMEOUT_S}s and not all ranks joined")
            time.sleep(_POLL_S)
            continue
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        _mirror_collective(json.loads(store.get(key)), C)
        my_seq = _state.seq  # the collectives advance the counter
    # The last rank to join: the largest sequence number, ties by rank.
    best = max((int(store.get(f"{ns}/joined/{r}")), r) for r in ps.ranks)
    _complete_round()
    return best[1]


def _zeros(sig: Dict[str, Any], rows: Optional[int] = None):
    shape = list(sig["shapes"][0])
    if rows is not None:
        shape[0] = rows
    return torch.zeros(shape, dtype=getattr(torch, sig["dtypes"][0]),
                       device=basics.device())


def _mirror_collective(sig: Dict[str, Any], C) -> bool:
    """Take part in one collective with a zero contribution.  Returns
    False when this rank is outside the op's process set: it only keeps
    its sequence number in step with the active ranks."""
    ps = basics.get_process_set(sig.get("ps", 0))
    if not ps.included():
        next_seq()
        return False
    kind = sig["kind"]
    scale = {"prescale_factor": sig.get("pre", 1.0),
             "postscale_factor": sig.get("post", 1.0)}
    if kind == "allreduce":
        C.allreduce(_zeros(sig), op=_op_by_name(C, sig["op"]),
                    process_set=ps, **scale)
    elif kind == "grouped_allreduce":
        zeros = [torch.zeros(sh, dtype=getattr(torch, dt),
                             device=basics.device())
                 for sh, dt in zip(sig["shapes"], sig["dtypes"])]
        C.grouped_allreduce(zeros, op=_op_by_name(C, sig["op"]),
                            process_set=ps, **scale)
    elif kind == "allgather":
        C.allgather(_zeros(sig, rows=0), process_set=ps)
    elif kind == "grouped_allgather":
        C.grouped_allgather(
            [torch.zeros([0] + sh[1:], dtype=getattr(torch, dt),
                         device=basics.device())
             for sh, dt in zip(sig["shapes"], sig["dtypes"])],
            process_set=ps)
    elif kind == "broadcast":
        C.broadcast(_zeros(sig), root_rank=sig["root_rank"], process_set=ps)
    elif kind == "reducescatter":
        C.reducescatter(_zeros(sig), op=_op_by_name(C, sig["op"]),
                        process_set=ps)
    elif kind == "alltoall":
        C.alltoall(_zeros(sig), process_set=ps)
    elif kind == "alltoallv":
        # Zero rows to every rank: the others receive nothing from it.
        C.alltoall(_zeros(sig, rows=0), splits=[0] * ps.size(),
                   process_set=ps)
    elif kind == "barrier":
        C.barrier(process_set=ps)
    else:
        raise HorovodTpuError(f"join(): cannot mirror collective {kind!r}")
    return True


def _op_by_name(C, name: str):
    ops = {"Average": C.Average, "Sum": C.Sum, "Min": C.Min,
           "Max": C.Max, "Product": C.Product}
    if name not in ops:
        raise HorovodTpuError(f"join(): cannot mirror op {name!r}")
    return ops[name]


__all__ = ["armed", "is_joined", "join", "join_mode", "reset"]
