"""Object collectives (counterpart of `horovod_tpu/ops/functions.py`;
reference: horovod/torch/functions.py): pickle into a uint8 tensor on
the rank's device, exchange, unpickle."""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np
import torch

from ..common import basics
from ..common.basics import ProcessSet
from ..common.util import flatten_tree
from . import collectives as C


def broadcast_parameters(params: Any, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None) -> Any:
    """Broadcast a tree of tensors (dicts, lists, tuples) from
    `root_rank`; returns a tree of the same structure with every leaf
    root's, on the rank's device (JAX `ops/functions.py
    broadcast_parameters`).  The inputs are left as they were: the
    in-place form for a model is `horovod_tpu_torch.torch.
    broadcast_parameters`."""
    leaves, rebuild = flatten_tree(params)
    dev = basics.device()
    return rebuild([C.broadcast(torch.as_tensor(t).to(dev),
                                root_rank=root_rank, process_set=process_set)
                    for t in leaves])


# An optimizer state given as a tree is broadcast the same way (JAX's
# optax states are trees too).
broadcast_optimizer_state = broadcast_parameters


def _to_bytes(obj: Any) -> torch.Tensor:
    data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()
    return torch.from_numpy(data).to(basics.device())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """Broadcast a picklable object from root: size, then payload."""
    del name
    ps = C._resolve_set(process_set)
    is_root = ps.rank() == root_rank
    data = _to_bytes(obj) if is_root else None
    size = torch.tensor([data.numel() if is_root else 0], dtype=torch.int64,
                        device=basics.device())
    n = int(C.broadcast(size, root_rank=root_rank, process_set=ps)[0])
    if data is None:
        data = torch.zeros((n,), dtype=torch.uint8, device=basics.device())
    out = C.broadcast(data, root_rank=root_rank, process_set=ps)
    return pickle.loads(out.cpu().numpy().tobytes())


def allgather_object(obj: Any,
                     process_set: Optional[ProcessSet] = None) -> list:
    """Gather a picklable object from every rank, in rank order: sizes,
    then the payloads padded to the longest."""
    ps = C._resolve_set(process_set)
    data = _to_bytes(obj)
    sizes = C.allgather(torch.tensor([data.numel()], dtype=torch.int64,
                                     device=data.device), process_set=ps)
    sizes = [int(s) for s in sizes.cpu()]
    padded = torch.zeros((max(sizes),), dtype=torch.uint8,
                         device=data.device)
    padded[: data.numel()] = data
    gathered = C.allgather(padded.unsqueeze(0), process_set=ps).cpu()
    return [pickle.loads(gathered[i, :s].numpy().tobytes())
            for i, s in enumerate(sizes)]
