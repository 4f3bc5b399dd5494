"""Double-buffered host -> device input prefetcher.

Counterpart of `horovod_tpu/utils/prefetch.py`: keep up to `size`
batches in flight ahead of the consumer, so that the copy of batch N+1
runs while the card computes batch N.

    for batch in prefetch_to_device(host_batches(), size=2):
        loss = step(batch)

On the card each tensor of a batch is copied from pinned host memory
with `non_blocking=True` on a side stream, and an event is recorded
after the copy; before the batch is yielded the consumer's stream waits
on that event, and each tensor is marked used on the consumer's stream
(`record_stream`), so that the caching allocator does not hand its
memory out again before the consumer's work on it is done.  On the CPU
the tensors pass through.  Either way a numpy array becomes a tensor
(`torch.from_numpy`); other leaves pass through.

The JAX package's `sharding=` (dim 0 split over the global mesh) is
`device=` here, by default hvd's device: each rank holds its own batch,
where the JAX package shards the global one.  Batches are tensors or
numpy arrays in tuples, lists and dicts.  Errors of the source iterator
reach the consumer at their position in the stream.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np
import torch


def _resolve(device: Union[str, torch.device, None]) -> torch.device:
    if device is not None:
        return torch.device(device)
    from ..common import basics

    return basics.device()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class _Stager:
    """Copies batches to one device: on the card through pinned memory
    on a side stream of its own, on the CPU not at all."""

    def __init__(self, device: torch.device):
        self.device = device
        self._side = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)

    def _leaf(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor) or self._side is None:
            return x
        if x.device.type == "cpu" and not x.is_pinned():
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)

    def put(self, batch):
        """`(batch on the device, the copy's event or None)`; the copies
        are only launched."""
        if self._side is None:
            return _map(self._leaf, batch), None
        with torch.cuda.stream(self._side):
            out = _map(self._leaf, batch)
            event = torch.cuda.Event()
            event.record(self._side)
        return out, event

    def take(self, staged):
        """The batch, once the consumer's stream waits for its copy."""
        batch, event = staged
        if event is None:
            return batch
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        _map(lambda x: x.record_stream(consumer)
             if isinstance(x, torch.Tensor) and x.is_cuda else None, batch)
        return batch


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    device: Union[str, torch.device, None] = None,
) -> Iterator[Any]:
    """Yield the batches of `iterator` on `device` (default: hvd's),
    keeping up to `size` copies in flight ahead of the consumer.  With
    `size >= 2` a step never waits on its copy unless the host iterator
    itself is the bottleneck.  An exception of the source iterator
    reaches the consumer at its position in the stream, after the
    batches before it."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    it = iter(iterator)
    stager = _Stager(_resolve(device))
    buf: collections.deque = collections.deque()
    src_error: Optional[BaseException] = None
    done = False
    while True:
        # Fill the look-ahead window (the copies are only launched).
        while len(buf) < size and not done:
            try:
                buf.append(stager.put(next(it)))
            except StopIteration:
                done = True
            except BaseException as e:  # noqa: BLE001 — re-raised below
                done = True
                src_error = e
        if buf:
            yield stager.take(buf.popleft())
            continue
        if src_error is not None:
            raise src_error
        return


class BackgroundPrefetcher:
    """`prefetch_to_device` with a host producer THREAD in front of the
    queue, for sources that do real work (decode, augment, reads): the
    thread also overlaps producing the batches with the device's compute.

        with BackgroundPrefetcher(loader, size=2) as it:
            for batch in it:
                ...

    The producer is a daemon thread, joined with a bounded timeout on
    `close()` (a source stuck in a blocking read is abandoned, not
    waited on); source exceptions re-raise on the consumer side in
    order.  Single consumer, single pass."""

    _END = object()

    def __init__(self, iterator: Iterable[Any], size: int = 2,
                 device: Union[str, torch.device, None] = None):
        if size < 1:
            raise ValueError(f"prefetch size must be >= 1, got {size}")
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._stager = _Stager(_resolve(device))
        self._src = iterator
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, name="hvd-prefetch", daemon=True)
        self._started = False
        self._finished = False

    def _produce(self):
        try:
            for batch in self._src:
                if self._stop.is_set():
                    return
                self._q.put(self._stager.put(batch))
            self._q.put(self._END)
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer
            self._q.put(e)

    def __iter__(self):
        """Iterating again after the end yields nothing (rather than
        blocking on a sentinel that will never come)."""
        if not self._started:
            self._started = True
            self._thread.start()
        if self._finished:
            return
        while True:
            item = self._q.get()
            if item is self._END:
                self._finished = True
                return
            if isinstance(item, BaseException):
                self._finished = True
                raise item
            yield self._stager.take(item)

    def close(self, timeout: float = 2.0):
        """Stop the producer and release the queued batches.  A producer
        blocked in `q.put` is unblocked by draining; one blocked inside
        the source itself cannot be interrupted from here and is
        abandoned as a daemon thread after `timeout` seconds."""
        self._stop.set()
        if not self._started:
            return
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return iter(self)

    def __exit__(self, *exc):
        self.close()


__all__ = ["prefetch_to_device", "BackgroundPrefetcher"]
