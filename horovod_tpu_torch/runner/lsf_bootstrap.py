"""Per-task env bootstrap for jsrun launches (counterpart of
`horovod_tpu/runner/lsf_bootstrap.py`; reference: js_run wraps
the worker with horovod's env setup; jsrun exposes rank placement via
OMPI/PMIX env vars).

Usage (installed by runner/lsf.py onto the jsrun command line):

    jsrun --nrs N --tasks_per_rs 1 python -m horovod_tpu_torch.runner.lsf_bootstrap \
        python train.py
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Tuple

# (rank, local_rank, size) sources, in preference order.
_RANK_VARS = ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "JSM_NAMESPACE_RANK",
              "PMI_RANK")
_LOCAL_RANK_VARS = ("OMPI_COMM_WORLD_LOCAL_RANK", "JSM_NAMESPACE_LOCAL_RANK",
                    "MPI_LOCALRANKID")
_SIZE_VARS = ("OMPI_COMM_WORLD_SIZE", "JSM_NAMESPACE_SIZE", "PMI_SIZE")
_LOCAL_SIZE_VARS = ("OMPI_COMM_WORLD_LOCAL_SIZE", "JSM_NAMESPACE_LOCAL_SIZE",
                    "MPI_LOCALNRANKS")


def _first(env: Dict[str, str], names) -> Optional[str]:
    for n in names:
        if n in env and env[n] != "":
            return env[n]
    return None


def derive_horovod_env(env: Dict[str, str]) -> Dict[str, str]:
    """HOROVOD_* vars from the scheduler-provided placement env."""
    rank = _first(env, _RANK_VARS)
    if rank is None:
        raise RuntimeError(
            "lsf_bootstrap: no rank variable found (expected one of "
            f"{_RANK_VARS}) — run this under jsrun")
    size = _first(env, _SIZE_VARS) or env.get("HOROVOD_SIZE")
    if size is None:
        raise RuntimeError("lsf_bootstrap: no world-size variable found")
    local_rank = _first(env, _LOCAL_RANK_VARS) or "0"
    local_size = _first(env, _LOCAL_SIZE_VARS) or "1"
    out = {
        "HOROVOD_RANK": rank,
        "HOROVOD_SIZE": size,
        "HOROVOD_LOCAL_RANK": local_rank,
        "HOROVOD_LOCAL_SIZE": local_size,
        "HOROVOD_PROCESS_ID": rank,
        "HOROVOD_NUM_PROCESSES": size,
    }
    # Rank 0's c10d TCPStore runs beside rank 0; its host is the first
    # entry of the LSF host list.
    if "HOROVOD_COORDINATOR_ADDR" not in env and int(size) > 1:
        from .lsf import lsf_hosts

        try:
            first = lsf_hosts(env)[0].hostname
            out["HOROVOD_COORDINATOR_ADDR"] = f"{first}:46331"
        except Exception:  # noqa: BLE001 — single-host fallback
            out["HOROVOD_COORDINATOR_ADDR"] = "127.0.0.1:46331"
    return out


def main() -> None:
    os.environ.update(derive_horovod_env(dict(os.environ)))
    cmd = sys.argv[1:]
    if not cmd:
        raise SystemExit("lsf_bootstrap: no command given")
    os.execvp(cmd[0], cmd)


if __name__ == "__main__":
    main()
