"""Env parsing, as in `horovod_tpu/common/util.py` (own copy).

Every knob keeps the `HOROVOD_` prefix of the reference, so one launcher
env drives both packages.
"""

from __future__ import annotations

import os
from typing import Optional

_ENV_PREFIXES = ("HOROVOD_", "HVD_TPU_")


def getenv(name: str, default: Optional[str] = None) -> Optional[str]:
    """Look up NAME under every accepted prefix (HOROVOD_NAME wins)."""
    for prefix in _ENV_PREFIXES:
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


def env_bool(name: str, default: bool = False) -> bool:
    val = getenv(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def env_int(name: str, default: int) -> int:
    val = getenv(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    val = getenv(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        return default


# -- knobs of the ZeRO ladder and the fused collective pipeline ---------
# Raw env reads, with the JAX package's defaults; `utils/autotune.py`
# validates them and is what the rest of the port calls.

def fusion_threshold() -> int:
    """HOROVOD_FUSION_THRESHOLD in bytes (64 MiB)."""
    return env_int("FUSION_THRESHOLD", 64 * 1024 * 1024)


def fused_collectives() -> bool:
    """HOROVOD_FUSED_COLLECTIVES: arm the chunked collective pipeline."""
    return env_bool("FUSED_COLLECTIVES", False)


def fused_pallas() -> bool:
    """HOROVOD_FUSED_PALLAS: run the fused matmul chunks through K3."""
    return env_bool("FUSED_PALLAS", False)


def fused_chunk_bytes() -> int:
    """HOROVOD_FUSED_CHUNK_BYTES: the pipeline's chunk size (1 MiB)."""
    return env_int("FUSED_CHUNK_BYTES", 1 << 20)


def zero_stage() -> int:
    """HOROVOD_ZERO_STAGE, unvalidated; default 1 when
    HOROVOD_SHARD_OPTIMIZER is set (the two spellings are aliases),
    else 0."""
    return env_int("ZERO_STAGE", 1 if shard_optimizer() else 0)


def shard_optimizer() -> bool:
    """HOROVOD_SHARD_OPTIMIZER: ZeRO-1 under its older name."""
    return env_bool("SHARD_OPTIMIZER", False)


def zero_gather_wire() -> Optional[str]:
    """HOROVOD_ZERO_GATHER_WIRE: the ZeRO-3 parameter gather's wire
    (unset or empty: exact)."""
    return getenv("ZERO_GATHER_WIRE") or None


def wire_policy() -> Optional[str]:
    """HOROVOD_WIRE_POLICY: the per-bucket wire policy's spec (unset or
    empty: no policy)."""
    return getenv("WIRE_POLICY") or None


def shard_ag_wire() -> Optional[str]:
    """HOROVOD_SHARD_AG_WIRE: the sharded optimizer's parameter
    allgather wire (unset or empty: exact)."""
    return getenv("SHARD_AG_WIRE") or None


def bucket_order() -> str:
    """HOROVOD_BUCKET_ORDER, unvalidated ("reverse" when unset)."""
    return getenv("BUCKET_ORDER") or "reverse"


def min_buckets() -> int:
    """HOROVOD_MIN_BUCKETS (1: no floor)."""
    return max(1, env_int("MIN_BUCKETS", 1))


def flatten_tree(tree):
    """The leaves of a tree of dicts, lists and tuples (insertion order;
    anything else is a leaf), and a function that rebuilds the tree from
    new leaves in that order."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [flatten_tree(tree[k]) for k in keys]
        kind = type(tree)

        def rebuild(vals):
            return kind(zip(keys, _rebuild_parts(parts, vals)))
    elif isinstance(tree, (list, tuple)):
        parts = [flatten_tree(v) for v in tree]
        kind = type(tree)
        named = hasattr(tree, "_fields")

        def rebuild(vals):
            items = _rebuild_parts(parts, vals)
            return kind(*items) if named else kind(items)
    else:
        return [tree], lambda vals: vals[0]
    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def _rebuild_parts(parts, vals) -> list:
    out, i = [], 0
    for leaves, rebuild in parts:
        out.append(rebuild(vals[i:i + len(leaves)]))
        i += len(leaves)
    return out
