"""DistributedGradientTape MNIST on the port: the flow of
`examples/tape_mnist.py` (the reference's tape-style pattern), through
the framework-neutral tape, `data_parallel` and the callbacks.

    hvd.init() → MnistNet (a seed a rank) → the parameters as a tree →
    BroadcastGlobalVariablesCallback(0).on_train_begin → epochs of
    @hvd.data_parallel steps: DistributedGradientTape().gradient of
    nll_loss, Adam at LearningRateWarmupCallback's rate →
    MetricAverageCallback's epoch loss

The data are `synthetic_mnist` (the JAX example's draws); each global
batch of 64 × size images is split between the ranks in rank order, and
`data_parallel` places a rank's share on its device (`shard_batch`).
Prints, on rank 0, one line an epoch; on every rank a SUMMARY line
(each epoch's averaged loss, every step's loss, the parameters'
SHA-256).  It runs on the rank's card unless `--device cpu` is given.

Run:  python -m horovod_tpu_torch.tape_mnist --device cpu
      python -m horovod_tpu_torch.runner -np 2 python -m \
          horovod_tpu_torch.tape_mnist --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
from torch.func import functional_call

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import MnistNet, nll_loss
from horovod_tpu_torch.synthetic_benchmark import param_digest
from horovod_tpu_torch.torch_mnist import synthetic_mnist


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-samples", type=int, default=4096)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--device", default=None,
                   help="default: the rank's card; 'cpu' runs on the host")
    args = p.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = hvd.rank(), hvd.size()
    images, labels = synthetic_mnist(args.num_samples)
    images = np.ascontiguousarray(images.transpose(0, 3, 1, 2))

    model = MnistNet(seed=rank).to(dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    # Reference: BroadcastGlobalVariablesCallback(0) on train begin.
    bcast = hvd.callbacks.BroadcastGlobalVariablesCallback(0)
    params = bcast.on_train_begin(params)
    with torch.no_grad():
        for k, v in params.items():
            model.get_parameter(k).copy_(v)
    warmup = hvd.callbacks.LearningRateWarmupCallback(
        warmup_epochs=1, initial_lr=args.lr * size)
    metric_avg = hvd.callbacks.MetricAverageCallback()
    opt = torch.optim.Adam(model.parameters(), lr=warmup.lr(0))
    tape = hvd.DistributedGradientTape()

    def loss_fn(p, x, y):
        return nll_loss(functional_call(model, p, (x,)), y)

    @hvd.data_parallel
    def train_step(params, opt, batch):
        x, y = batch
        loss, grads = tape.gradient(loss_fn, params, x, y)
        for k, g in grads.items():
            model.get_parameter(k).grad = g
        opt.step()
        return loss

    global_bs = args.batch_size * size
    steps = len(images) // global_bs
    epoch_losses, step_losses = [], []
    for epoch in range(args.epochs):
        perm = np.random.RandomState(epoch).permutation(len(images))
        for i in range(steps):
            for group in opt.param_groups:
                group["lr"] = warmup.lr(epoch, steps, i)
            lo = i * global_bs + rank * args.batch_size
            idx = perm[lo:lo + args.batch_size]
            loss = train_step(dict(model.named_parameters()), opt,
                              (images[idx], labels[idx]))
            step_losses.append(float(loss))
        metrics = metric_avg.on_epoch_end({"loss": loss})
        epoch_losses.append(float(metrics["loss"]))
        if rank == 0:
            print(f"epoch {epoch}: loss={epoch_losses[-1]:.4f}", flush=True)
    print("SUMMARY " + json.dumps({
        "rank": rank, "size": size, "model": "mnist", "steps": len(
            step_losses), "epoch_losses": epoch_losses,
        "step_losses": step_losses, "last_loss": step_losses[-1],
        "digest": param_digest(model), "device": str(dev),
        "backend": hvd.backend()}), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
