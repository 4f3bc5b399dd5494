"""Worker-side shard data loader (counterpart of
`horovod_tpu/spark/common/data_loader.py`).

Reference parity: `horovod/spark/data_loaders/` (Petastorm-backed
`PytorchDataLoader`/`PytorchAsyncDataLoader` ≈400 LoC) — the piece that
feeds each worker minibatches from its materialized shard without
holding the whole dataset in training-framework memory.

Design: shards are raw `.npy` pairs (see `util.py`), so
the loader memory-maps them (`np.load(mmap_mode="r")`) and yields
shuffled minibatch views per epoch.  No reader threads are needed —
the OS page cache plays the role of Petastorm's row-group buffering,
and batches materialize only when the framework copies them.

    loader = ShardDataLoader(train_dir, rank, batch_size=64, seed=0)
    for epoch in range(epochs):
        for xb, yb in loader.epoch(epoch):
            ...
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ...common.exceptions import HorovodTpuError


class ShardDataLoader:
    """Minibatch iterator over one rank's materialized shard.

    `drop_last=True` (default) keeps every rank's batch count identical
    when shards are equal-sized — the lockstep requirement the equal
    sharding in `prepare_data` exists for.
    """

    def __init__(self, data_dir: str, rank: int, batch_size: int,
                 shuffle: bool = True, seed: Optional[int] = None,
                 drop_last: bool = True):
        from .util import shard_paths

        x_path, y_path = shard_paths(data_dir, rank)
        if not (os.path.exists(x_path) and os.path.exists(y_path)):
            raise HorovodTpuError(
                f"no shard for rank {rank} under {data_dir}")
        # mmap: batches are materialized lazily by the consumer's copy.
        self._x = np.load(x_path, mmap_mode="r")
        self._y = np.load(y_path, mmap_mode="r")
        if len(self._x) != len(self._y):
            raise HorovodTpuError(
                f"shard length mismatch: {len(self._x)} features vs "
                f"{len(self._y)} labels")
        self._bs = int(batch_size)
        self._shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last

    def __len__(self) -> int:
        """Batches per epoch."""
        n = len(self._x)
        return n // self._bs if self._drop_last else -(-n // self._bs)

    @property
    def rows(self) -> int:
        return len(self._x)

    def epoch(self, epoch: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) minibatches; a fresh seeded shuffle per epoch
        (same convention as ElasticSampler: seed + epoch)."""
        n = len(self._x)
        if self._shuffle:
            # Seeded: reproducible per (seed, epoch).  Unseeded: fresh
            # entropy per call — independent SGD noise across runs,
            # matching unseeded-sampler convention.
            rng = (np.random.default_rng(self._seed + epoch)
                   if self._seed is not None else np.random.default_rng())
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        end = n - n % self._bs if self._drop_last else n
        for i in range(0, end, self._bs):
            idx = np.sort(order[i:i + self._bs])  # sorted → mmap-friendly
            yield np.ascontiguousarray(self._x[idx]), \
                np.ascontiguousarray(self._y[idx])

    def __iter__(self):
        return self.epoch(0)


__all__ = ["ShardDataLoader"]
