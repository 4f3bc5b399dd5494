"""The wire-format registry: how a buffer travels through a collective.

Counterpart of `horovod_tpu/ops/wire.py` (`_BLOCK` :53, `WireCodec`
:118, `get_codec` :204).  This slice registers the exact wire ("none")
and the cast wires "fp16" and "bf16", which a reduce-scatter or an
allgather rides directly in the cast dtype.  The cooperative codecs
(int8, int4, fp8_e4m3, fp8_e5m2: block-scaled payloads that need a
ring with f32 accumulation) are not ported yet; `get_codec` names them
as such and raises, and never hands back the exact wire in their place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..common.exceptions import HorovodTpuError

#: Quantization block (elements) of the block-scaled codecs; the fused
#: pipeline aligns its chunks to it.
_BLOCK = 128

COOPERATIVE_NOT_PORTED = ("fp8_e4m3", "fp8_e5m2", "int4", "int8")


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One wire format.  `cast_dtype` is set for the cast wires: the
    buffer is cast to it before the collective and back after."""

    name: str
    cast_dtype: Optional[torch.dtype] = None

    @property
    def exact(self) -> bool:
        return self.name == "none"


_REGISTRY: Dict[str, WireCodec] = {
    c.name: c for c in (
        WireCodec("none"),
        WireCodec("fp16", torch.float16),
        WireCodec("bf16", torch.bfloat16),
    )
}
NONE = _REGISTRY["none"]


def wire_names() -> Tuple[str, ...]:
    """Every registered codec name, sorted."""
    return tuple(sorted(_REGISTRY))


def get_codec(wire: Optional[str]) -> WireCodec:
    """Resolve a wire-format string; None (and "none") is the exact
    codec.  Raises `HorovodTpuError` for a cooperative codec (not ported
    yet) and for an unknown name."""
    if wire is None:
        return NONE
    codec = _REGISTRY.get(wire)
    if codec is not None:
        return codec
    if wire in COOPERATIVE_NOT_PORTED:
        raise HorovodTpuError(
            f"wire format {wire!r} is a cooperative block-scaled codec, "
            "which horovod_tpu_torch has not ported yet; the port "
            f"supports {', '.join(wire_names())}")
    raise HorovodTpuError(
        f"unknown wire format {wire!r}: valid formats are "
        f"{', '.join(wire_names())} (cooperative, not ported yet: "
        f"{', '.join(COOPERATIVE_NOT_PORTED)})")
