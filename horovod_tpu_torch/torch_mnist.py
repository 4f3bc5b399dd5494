"""MNIST trainer on the port: BASELINE config 1, the reference's
`examples/pytorch/pytorch_mnist.py` flow.

Counterpart of `examples/torch_mnist.py` and `examples/mnist.py`:

    hvd.init() → MnistNet → SGD(lr × size, momentum 0.5) →
    DistributedOptimizer → broadcast_parameters /
    broadcast_optimizer_state → epochs of nll_loss → held-out accuracy
    averaged across ranks

The data are `synthetic_mnist` (the JAX example's digit-like blobs, the
same numpy draws): the first eighth is held out, the rest is shuffled
each epoch by one seeded permutation that every rank shares, and each
global batch of `batch_size × size` images is split between the ranks
in rank order, as `hvd.shard_batch` splits it in the JAX example.  f32
throughout, as the reference.

Prints, on rank 0, one line per epoch with the loss and the held-out
accuracy; on every rank a SUMMARY line (each epoch's mean loss and
accuracy, img/sec per rank, the parameters' SHA-256) and, with
`--log-steps`, one STEP line per step (loss, digest) for checks across
ranks.  It runs on the rank's card unless `--device cpu` is given: one
process on the CPU is the reference's config (gloo, one rank).

Run:  python -m horovod_tpu_torch.torch_mnist --epochs 2
      python -m horovod_tpu_torch.torch_mnist --device cpu
Multi-process: set HOROVOD_COORDINATOR_ADDR, HOROVOD_NUM_PROCESSES,
HOROVOD_PROCESS_ID (and HOROVOD_LOCAL_RANK / HOROVOD_LOCAL_SIZE) per rank.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import MnistNet, nll_loss
from horovod_tpu_torch.synthetic_benchmark import param_digest


def synthetic_mnist(n: int = 8192, seed: int = 0):
    """Digit-like synthetic data: each class is a fixed blob plus noise.
    The numpy draws of `examples/mnist.py` `synthetic_mnist`: images
    (n, 28, 28, 1) f32 and labels (n,) int."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(10, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=n)
    images = protos[labels] + 0.3 * rng.randn(n, 28, 28).astype(np.float32)
    return images[..., None], labels


def train_step(model: torch.nn.Module, opt, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """One step: the loss of this rank's batch, backward (the
    optimizer's hooks reduce the gradients), step.  Returns the loss."""
    opt.zero_grad()
    loss = nll_loss(model(x), y)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def accuracy(model: torch.nn.Module, x: torch.Tensor,
             y: torch.Tensor) -> float:
    """This rank's held-out accuracy, averaged across the ranks."""
    model.eval()
    acc = (model(x).argmax(-1) == y).float().mean()
    model.train()
    return float(hvd.allreduce(acc, op=hvd.Average))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--num-samples", type=int, default=8192,
                   help="synthetic images in all, an eighth held out")
    p.add_argument("--device", default=None,
                   help="default: the rank's card; 'cpu' runs on the host")
    p.add_argument("--log-steps", action="store_true",
                   help="one JSON line per step: loss, digest")
    args = p.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    if dev.type == "cuda":
        # f32 convolutions and products in full precision.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = hvd.rank(), hvd.size()

    images, labels = synthetic_mnist(args.num_samples)
    images = torch.from_numpy(
        np.ascontiguousarray(images.transpose(0, 3, 1, 2))).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    n_test = len(images) // 8
    train_x, train_y = images[n_test:], labels[n_test:]
    global_bs = args.batch_size * size
    steps = len(train_x) // global_bs
    # The JAX example evaluates four global batches of the held-out set.
    n_eval = min(n_test, global_bs * 4) // size
    test_x = images[rank * n_eval:(rank + 1) * n_eval]
    test_y = labels[rank * n_eval:(rank + 1) * n_eval]

    model = MnistNet(seed=rank).to(dev)
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=args.lr * size,
                          momentum=args.momentum)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    perm_rng = np.random.RandomState(42)
    epoch_losses, test_acc = [], []
    step_no, last_loss, train_s = 0, float("nan"), 0.0
    for epoch in range(args.epochs):
        perm = torch.from_numpy(perm_rng.permutation(len(train_x))).to(dev)
        losses = []
        t0 = time.perf_counter()
        for i in range(steps):
            lo = i * global_bs + rank * args.batch_size
            idx = perm[lo:lo + args.batch_size]
            loss = train_step(model, opt, train_x[idx], train_y[idx])
            losses.append(loss)
            if args.log_steps:
                print("STEP " + json.dumps({
                    "step": step_no, "rank": rank, "epoch": epoch,
                    "loss": float(loss), "digest": param_digest(model),
                    "launches": {}}), flush=True)
            step_no += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s += time.perf_counter() - t0
        last_loss = float(losses[-1])
        epoch_losses.append(float(torch.stack(losses).mean()))
        test_acc.append(accuracy(model, test_x, test_y))
        if rank == 0:
            print(f"epoch {epoch}: loss={last_loss:.4f} "
                  f"mean_loss={epoch_losses[-1]:.4f} "
                  f"test_acc={test_acc[-1]:.3f}", flush=True)

    summary = {"rank": rank, "size": size, "model": "mnist",
               "epochs": args.epochs, "steps": step_no,
               "epoch_losses": epoch_losses, "test_acc": test_acc,
               "last_loss": last_loss,
               "img_sec_per_rank": step_no * args.batch_size / train_s
               if train_s else None,
               "digest": param_digest(model), "device": str(dev),
               "backend": hvd.backend()}
    print("SUMMARY " + json.dumps(summary), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
