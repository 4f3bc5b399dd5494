"""Elastic ResNet training on the port (BASELINE config 5, "horovod.elastic
ResNet-50").

Counterpart of `examples/elastic_resnet.py` (reference:
examples/elastic/pytorch/pytorch_imagenet_resnet50_elastic.py): the
commit / restore / sync protocol around a training loop that survives a
failed collective.  Defaults: full-width ResNet-50, 224x224, 1000
classes, batch 32 per rank, bf16 compute with synchronized batch norm
over the global set (`sync_bn`), `DistributedOptimizer(SGD(0.01 * size,
momentum 0.9))`.  The data is a synthetic set of batches_per_epoch x
batch x size images, each made from its index with a seed, and an
`ElasticSampler` shards it.  The state is `TorchState(model, optimizer,
epoch, batch_idx, sampler)`, committed every --commit-every batches
and at the end of each epoch, and the loop runs under
`@hvd.elastic.run`.  An epoch ends when the rank's shard has no full
batch left: after a membership change the ranks share the rest of the
epoch's indices anew.

Run it with HOROVOD_FAULT_SPEC (and HOROVOD_FAULT_SEED) to inject
collective failures: every rank makes the same calls, so a fault fires
at the same hit on each, and both restore their last commit.

Each rank prints JSON lines: STEP (loss, the parameters' SHA-256, the
resets so far, the world size, the step's host ms and its wall-clock
time), COMMIT (the digest committed), RESET (after each reset: the
digest the restore left, before the sync), ENTER (each entry of the
training function: the digest after the sync and `state_digest`, that
of the model's whole state_dict and the optimizer's state, the process
id, the elastic generation and whether the worker joined a running
job), EPOCH
(whether the ranks processed every index of the epoch exactly once) and
SUMMARY (with the hits of `collective.allreduce` when a fault spec
names it).

    python -m horovod_tpu_torch.elastic_resnet --epochs 2 \\
        --batches-per-epoch 4 --commit-every 2 --log-steps
Multi-process: HOROVOD_COORDINATOR_ADDR, HOROVOD_NUM_PROCESSES and
HOROVOD_PROCESS_ID per rank, as for the synthetic benchmark; or under
the elastic driver, which sets them for each generation:

    horovodrun_tpu_torch --host-discovery-script ./hosts.sh --min-np 1 \\
        --max-np 2 python -m horovod_tpu_torch.elastic_resnet
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch.models import ResNet
from horovod_tpu_torch.runner import elastic_worker
from horovod_tpu_torch.synthetic_benchmark import param_digest

SEED = 0  # of the synthetic images and the sampler's shuffle


def synthetic_batch(indices, image_size: int, num_classes: int,
                    seed: int):
    """The images and labels of `indices`, each made from its index, so
    that a replayed batch is the same batch."""
    xs, ys = [], []
    for i in indices:
        g = torch.Generator().manual_seed(seed * 1_000_003 + int(i))
        xs.append(torch.rand((3, image_size, image_size), generator=g))
        ys.append(int(torch.randint(0, num_classes, (1,), generator=g)))
    return torch.stack(xs), torch.tensor(ys)


def state_digest(model: torch.nn.Module, opt) -> str:
    """SHA-256 of what a sync carries: every entry of the model's
    state_dict (parameters and batch-norm buffers) and the optimizer's
    state tensors, in parameter-index order."""
    h = hashlib.sha256()
    tensors = list(model.state_dict().values())
    sd = opt.state_dict()["state"]
    tensors += [v for i in sorted(sd) for _, v in sorted(sd[i].items())
                if isinstance(v, torch.Tensor)]
    for t in tensors:
        h.update(t.detach().cpu().clone().numpy().tobytes())
    return h.hexdigest()


def _pending_start(sampler, batch_size: int) -> int:
    """The batch of `sampler.local_indices` to take next: a reset's sync
    shards the unprocessed indices again, and a rollback leaves the
    processed ones in place, so count the ones already done."""
    done = set(sampler.processed_indices)
    first = sum(1 for i in sampler.local_indices if i in done)
    return first // batch_size


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batches-per-epoch", type=int, default=4)
    p.add_argument("--commit-every", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="default: the rank's card; 'cpu' runs on the host")
    p.add_argument("--log-steps", action="store_true",
                   help="one STEP line per step")
    p.add_argument("--notify-at-step", type=int, default=-1,
                   help="report a membership change before this step's "
                        "commit (counted over the whole run, from 0)")
    args = p.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = ResNet(args.depth, args.num_classes,
                   compute_dtype=torch.bfloat16, seed=hvd.rank(),
                   sync_bn=True).to(dev)
    model.train()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    # A worker joining a running job takes its state in the sync that
    # `hvd.elastic.run` starts with, beside the ranks' reset.
    joining = elastic_worker.is_joining_worker()
    if not joining:
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)

    bs = args.batch_size
    sampler = hvd.elastic.ElasticSampler(
        args.batches_per_epoch * bs * hvd.size(), shuffle=True, seed=SEED)
    state = hvd.elastic.TorchState(model, opt, epoch=0, batch_idx=0,
                                   sampler=sampler)

    def emit(tag, **rec):
        print(f"{tag} " + json.dumps(dict(rec, rank=hvd.rank())),
              flush=True)

    state.register_reset_callbacks([lambda: emit(
        "RESET", resets=len(state.reset_seconds) + 1,
        epoch=state.epoch, batch=state.batch_idx,
        digest=param_digest(model))])
    stats = {"steps": 0, "images": 0, "losses": {}, "notified": False}
    # Host ms of each step's parts: the batch built on the CPU, forward,
    # backward and step (to the loss on the host), the STEP line's
    # digest, and each commit (its digest and the snapshot).
    parts = {"data": [], "train": [], "digest": [], "commit": []}

    @hvd.elastic.run
    def train(state):
        emit("ENTER", resets=len(state.reset_seconds), epoch=state.epoch,
             batch=state.batch_idx, digest=param_digest(model),
             state_digest=state_digest(model, opt), pid=os.getpid(),
             gen=elastic_worker._known_gen, joining=joining)
        while state.epoch < args.epochs:
            smp = state.sampler
            rel = _pending_start(smp, bs)
            while (rel + 1) * bs <= len(smp.local_indices):
                t0 = time.perf_counter()
                idx = smp.local_indices[rel * bs:(rel + 1) * bs]
                x, y = synthetic_batch(idx, args.image_size,
                                       args.num_classes, SEED)
                t1 = time.perf_counter()
                opt.zero_grad(set_to_none=True)
                loss = F.cross_entropy(model(x.to(dev)), y.to(dev))
                loss.backward()
                opt.step()
                lv = float(loss.detach())
                t2 = time.perf_counter()
                parts["data"].append((t1 - t0) * 1e3)
                parts["train"].append((t2 - t1) * 1e3)
                smp.record_batch(rel, bs)
                rel += 1
                state.batch_idx += 1
                step = stats["steps"]
                stats["steps"] += 1
                stats["images"] += bs
                stats["losses"][f"{state.epoch}.{state.batch_idx - 1}"] = lv
                if args.log_steps:
                    emit("STEP", step=step, epoch=state.epoch,
                         batch=state.batch_idx - 1, loss=lv,
                         digest=param_digest(model),
                         resets=len(state.reset_seconds),
                         size=hvd.size(), train_ms=(t2 - t1) * 1e3,
                         wall=time.time())
                    parts["digest"].append((time.perf_counter() - t2) * 1e3)
                if step == args.notify_at_step and not stats["notified"]:
                    stats["notified"] = True
                    hvd.elastic.notify_hosts_updated()
                if state.batch_idx % args.commit_every == 0:
                    t3 = time.perf_counter()
                    emit("COMMIT", epoch=state.epoch,
                         batch=state.batch_idx, digest=param_digest(model))
                    state.commit()
                    parts["commit"].append((time.perf_counter() - t3) * 1e3)
            everyone = hvd.allgather_object(smp.processed_indices)
            union = sorted({i for got in everyone for i in got})
            emit("EPOCH", epoch=state.epoch,
                 covered=union == list(range(smp.num_samples)),
                 no_repeats=all(len(set(got)) == len(got)
                                for got in everyone),
                 processed=len(union), num_samples=smp.num_samples)
            state.epoch += 1
            state.batch_idx = 0
            smp.set_epoch(state.epoch)
            emit("COMMIT", epoch=state.epoch, batch=0,
                 digest=param_digest(model))
            state.commit()

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    train(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    emit("SUMMARY", size=hvd.size(), device=str(dev),
         backend=hvd.backend(), steps_run=stats["steps"],
         img_sec_per_rank=stats["images"] / wall, wall_s=wall,
         resets=len(state.reset_seconds),
         reset_seconds=state.reset_seconds, losses=stats["losses"],
         allreduce_hits=faults.points_hit("collective.allreduce"),
         host_ms={k: sum(v) / len(v) for k, v in parts.items() if v},
         digest=param_digest(model))
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
