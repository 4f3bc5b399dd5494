"""Catalog of every `HOROVOD_*` environment variable the port reads.

The port's own copy of the entries of `horovod_tpu/common/env_catalog.py`
for the variables it reads, with what each does here.  Reads go through
`common/util.py` (`getenv`, `env_bool`, `env_int`), which also accepts
the `HVD_TPU_` prefix; the catalog lists the canonical name.
tests/test_torch_port_surface.py checks that the variables the port's
sources read and this catalog name the same set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

PREFIXES = ("HOROVOD_", "HVD_TPU_")


@dataclass(frozen=True)
class EnvVar:
    name: str
    default: str      # human-readable default ("" = unset)
    component: str    # grouping key
    description: str


def _v(name, default, component, description):
    return EnvVar(name, default, component, description)


CATALOG: Tuple[EnvVar, ...] = (
    # -- topology: the launcher's contract, read by basics.init ------------
    _v("HOROVOD_COORDINATOR_ADDR", "", "topology",
       "host:port of rank 0's store, or a full tcp:// or file:// init "
       "URL; its presence makes init() join a process group."),
    _v("HOROVOD_NUM_PROCESSES", "1", "topology",
       "World size of the process group."),
    _v("HOROVOD_PROCESS_ID", "0", "topology",
       "This process's rank in the process group."),
    _v("HOROVOD_LOCAL_RANK", "rank", "topology",
       "Rank among the processes on this host; picks the card "
       "(local_rank mod the card count)."),
    _v("HOROVOD_LOCAL_SIZE", "size", "topology",
       "Processes on this host; more than the cards selects gloo."),
    _v("HOROVOD_CROSS_RANK", "rank // local_size", "topology",
       "Index of this process's host among the hosts."),
    _v("HOROVOD_CROSS_SIZE", "size // local_size", "topology",
       "Number of hosts."),
    _v("HOROVOD_ELASTIC_GEN", "0", "elastic",
       "Elastic generation; scopes the join keys in the store."),
    # -- the data-parallel optimizer and the ZeRO ladder --------------------
    _v("HOROVOD_FUSION_THRESHOLD", "67108864", "autotune",
       "Gradient-fusion bucket size in bytes; also sets the ZeRO shard "
       "groups."),
    _v("HOROVOD_BUCKET_ORDER", "reverse", "autotune",
       "Gradient bucketing order: reverse, forward, or a comma "
       "permutation."),
    _v("HOROVOD_MIN_BUCKETS", "1", "autotune",
       "Lower bound on gradient buckets per step."),
    _v("HOROVOD_SHARD_OPTIMIZER", "0", "ops",
       "1: ZeRO-1 (the older name of HOROVOD_ZERO_STAGE=1)."),
    _v("HOROVOD_ZERO_STAGE", "0 (1 if HOROVOD_SHARD_OPTIMIZER)", "ops",
       "ZeRO rung 0..3: 1 shards the optimizer state, 2 adds sharded "
       "gradient accumulation, 3 adds parameter sharding through "
       "zero3_placement."),
    _v("HOROVOD_ZERO_GATHER_WIRE", "(exact)", "ops",
       "Wire of the ZeRO-3 parameter gather: bf16 or fp16 (the "
       "cooperative codecs are not ported)."),
    # -- the fused collective pipeline --------------------------------------
    _v("HOROVOD_FUSED_COLLECTIVES", "0", "ops",
       "1 routes the ZeRO scatter and gather through the chunked "
       "collective pipeline."),
    _v("HOROVOD_FUSED_PALLAS", "0", "ops",
       "1 runs the fused matmul chunks through K3 (csrc/tiled_matmul.cu) "
       "instead of torch.matmul."),
    _v("HOROVOD_FUSED_CHUNK_BYTES", "1048576", "autotune",
       "Chunk size of the fused collective pipeline."),
    # -- attention and join --------------------------------------------------
    _v("HOROVOD_FLASH_ATTENTION", "auto", "ops",
       "1 forces the flash-attention kernels, 0 the dense attention; "
       "unset: flash on the card from HOROVOD_FLASH_ATTENTION_MIN_T."),
    _v("HOROVOD_FLASH_ATTENTION_MIN_T", "16384", "ops",
       "Sequence length from which attention routes to flash when "
       "HOROVOD_FLASH_ATTENTION is unset."),
    _v("HOROVOD_JOIN_MODE", "0", "ops",
       "1 arms join mode: joined ranks contribute masked zeros to every "
       "collective."),
)

BY_NAME: Dict[str, EnvVar] = {v.name: v for v in CATALOG}

__all__ = ["BY_NAME", "CATALOG", "EnvVar", "PREFIXES"]
