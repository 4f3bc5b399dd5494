"""Shared per-worker training plumbing for the torch-family estimators
(counterpart of `horovod_tpu/spark/torch/_worker.py`).

`TorchEstimator` and `LightningEstimator` run the same worker skeleton
(reference: horovod/spark/torch/remote.py vs lightning/remote.py share
their Petastorm/broadcast/optimizer scaffolding the same way): init +
seed, parameter/optimizer broadcast, hook-driven DistributedOptimizer,
memory-mapped shard iteration, cross-rank epoch metrics, rank-0
checkpoint and model return.  Only the inner step differs — supplied
here as callbacks.

The module trains on `hvd.device()` (the rank's card unless the spec's
`device` is "cpu"): the trainers move it there before they build its
optimizer, and every batch goes there.  Rank 0 ships it back, and
checkpoints it, with CPU tensors, so a driver without a card loads it.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from ..common.store import save_checkpoint
from ..common.data_loader import ShardDataLoader
from ..common.util import load_val, resolve_compression


def init_worker(spec: Dict[str, Any]):
    """hvd init on the spec's device + per-rank seeding; returns the
    horovod torch module."""
    import torch

    import horovod_tpu_torch.torch as hvd_t

    hvd_t.init(device=spec.get("device"))
    if spec["seed"] is not None:
        torch.manual_seed(spec["seed"] + hvd_t.rank())
    return hvd_t


def label_tensor(arr):
    """numpy labels → torch targets: integer single-column labels become
    1-D Long targets, the shape torch classification losses expect."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.dtype in (torch.int64, torch.int32) and t.shape[1] == 1:
        return t[:, 0].long()
    return t


def run_worker(
    spec: Dict[str, Any],
    hvd_t,
    module,
    optimizer,
    train_step: Callable[[Any, int], Any],
    val_step: Optional[Callable[[Any], Any]] = None,
    schedulers: Sequence[Any] = (),
    on_epoch_start: Optional[Callable[[], None]] = None,
    on_epoch_end: Optional[Callable[[], None]] = None,
):
    """The worker epoch loop shared by both torch-family trainers.

    `module` is on `hvd_t.device()` already, and `optimizer` is built
    over its parameters there.  `train_step(batch, i)` returns the loss
    tensor for one minibatch (the loop owns zero_grad/backward/step);
    `val_step((xv, yv))` returns the rank-0 validation loss.  Rank 0 returns the result
    payload; other ranks return None.
    """
    import torch

    dev = hvd_t.device()
    hvd_t.broadcast_parameters(module.state_dict(), root_rank=0)
    hvd_t.broadcast_optimizer_state(optimizer, root_rank=0)
    comp = resolve_compression(hvd_t, spec.get("compression"))
    dist_opt = hvd_t.DistributedOptimizer(
        optimizer, named_parameters=module.named_parameters(),
        compression=comp,
        backward_passes_per_step=spec["backward_passes_per_step"])

    # Memory-mapped minibatch iteration (reference: data_loaders/ over
    # Petastorm).  prepare_data guarantees equal shard sizes, so every
    # rank sees the same batch count (collectives stay in lockstep);
    # drop_last=False keeps the partial final batch training.
    loader = ShardDataLoader(
        spec["train_dir"], hvd_t.rank(), spec["batch_size"],
        shuffle=spec["shuffle"], seed=spec["seed"], drop_last=False)
    val = None
    # Only rank 0 reports history, so only it loads/evaluates val data
    # (keras differs: its MetricAverageCallback allreduces val metrics,
    # so every keras worker needs the val set).
    if spec["val_dir"] and val_step is not None and hvd_t.rank() == 0:
        xv, yv = load_val(spec["val_dir"])
        val = (torch.from_numpy(np.ascontiguousarray(xv)).to(dev),
               label_tensor(yv).to(dev))

    losses, val_losses = [], []
    for epoch in range(spec["epochs"]):
        if on_epoch_start is not None:
            on_epoch_start()
        module.train()
        epoch_loss, batches = 0.0, 0
        for i, (xb, yb) in enumerate(loader.epoch(epoch)):
            dist_opt.zero_grad()
            batch = (torch.from_numpy(xb).to(dev), label_tensor(yb).to(dev))
            loss = train_step(batch, i)
            loss.backward()
            dist_opt.step()
            epoch_loss += float(loss.detach())
            batches += 1
        for s in schedulers:
            s.step()
        if on_epoch_end is not None:
            on_epoch_end()
        avg = epoch_loss / max(1, batches)
        # Cross-rank epoch metric, like the reference's metric averaging.
        avg = float(hvd_t.allreduce(torch.tensor([avg], device=dev),
                                    name="epoch_loss"))
        losses.append(avg)
        if val is not None:
            module.eval()
            with torch.no_grad():
                val_losses.append(float(val_step(val)))

    if hvd_t.rank() != 0:
        return None  # only rank 0 ships the trained model back
    module.cpu()
    save_checkpoint(spec["run_path"], {"state_dict": module.state_dict()})
    buf = io.BytesIO()
    torch.save(module, buf)
    return {"model": buf.getvalue(),
            "history": {"loss": losses, "val_loss": val_losses}}
