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
