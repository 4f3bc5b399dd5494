"""Megastep: k training steps a call, captured into one CUDA graph.

Counterpart of `horovod_tpu/utils/megastep.py`, which scans k steps
inside one compiled XLA program so that one dispatch carries k steps.
On the card the same lever is a CUDA graph: k calls of the step are
captured into one `torch.cuda.CUDAGraph` and replayed, so a call costs
one graph launch instead of k steps of kernel launches from the host.

Contract: ``step_fn(carry, batch) -> (carry, out)``.  The carry is
whatever the step updates (typically ``(model, optimizer)``).  On the
card the step must update it in place and return the carry it was
given (a graph replays into the same memory); the CPU loop also takes a
functional step.  `out` is a tensor or a tuple, list or dict of tensors
(the loss).  Two drivers:

  - `repeat_steps(step_fn, k)`: the SAME batch every step (the
    synthetic-benchmark methodology);
  - `scan_steps(step_fn, k)`: batches stacked on a leading [k, ...]
    axis, one slice a step (a real input pipeline, with
    `utils/prefetch.py`).

Only the last `out` is returned (`out_mode="last"`) or all k stacked on
a new leading axis (`out_mode="all"`).

On the CPU the drivers run the plain loop (the tests' path, and the
graph's plain version).  On the card every call performs exactly k
steps:

  1. the first call runs them eagerly on a side stream (the warm-up
     torch requires before a capture: it builds the optimizer's state
     and the allocator's pools);
  2. the second copies its batch into a static buffer, captures k steps
     into the graph, then replays the graph once (a capture records the
     work, it does not run it);
  3. every later call copies its batch into the static buffer and
     replays;
  4. a call after the straggler reaction armed or disarmed its bucket
     cap (`data_parallel.reaction_generation()` moved since the
     capture) captures the graph again, which replays the new
     partition: the JAX package retraces on the same key.

The outputs on the card are the graph's static tensors, overwritten by
the next call: clone what you keep.  A failed capture raises; nothing
falls back to eager.

What a capture changes:

  - Python runs at capture only.  The optimizers' step hooks (cycle
    marks, `step` spans, `steps`, the bucket metrics: data_parallel's
    `record_step`) are held off for the whole call and recorded once
    per call instead, with k added to `steps`, as JAX's `data_parallel`
    marks one cycle per compiled dispatch.  The kernels' launch counts
    (`flash_fwd.launches`, ...) count the captured launches once; a
    replay's launches show in a profiler trace only.  The collective
    bracket registers nothing with the stall inspector while a stream
    captures (its watchdog must not poll a captured event).
  - The step must not reach the host: the one-rank `DistributedOptimizer`
    path does not, and the AdamW it wraps needs `capturable=True`.
    Refused, each with its reason: a gloo group of more than one rank
    (its collectives run on the host), and an optimizer under the guard
    (`guard=`: its verdict reads the host once a step; JAX's gate is in
    the graph).  NCCL collectives can be captured; across cards that is
    allowed but not checked on one card.
  - The capture uses `capture_error_mode="thread_local"`, so that other
    threads (the stall watchdog, a `BackgroundPrefetcher`) may use CUDA
    meanwhile.

`early_reduction_body` is eager everywhere: JAX's unrolled loop, with
its two accumulators and the sentinel's running max.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..common.exceptions import HorovodTpuError


def _check(k: int, out_mode: str) -> None:
    if not isinstance(k, int) or k < 1:
        raise HorovodTpuError(f"megastep: k must be an int >= 1, got {k!r}")
    if out_mode not in ("last", "all"):
        raise HorovodTpuError(
            f"megastep: out_mode must be 'last' or 'all', got {out_mode!r}")


# -- small tree helpers (tensors in tuples, lists and dicts) ----------------

def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _stack(outs: List[Any]):
    """k outputs of one structure stacked leaf by leaf."""
    return _map(lambda *xs: torch.stack(list(xs)), *outs)


# -- the drivers -------------------------------------------------------------

def repeat_body(step_fn: Callable[[Any, Any], Tuple[Any, Any]],
                k: int, out_mode: str = "last") -> Callable:
    """The plain loop `fn(carry, batch)`: `step_fn` k times over the
    SAME batch."""
    _check(k, out_mode)

    def many(carry, batch):
        outs = []
        for _ in range(k):
            carry, out = step_fn(carry, batch)
            outs.append(out)
        return carry, (_stack(outs) if out_mode == "all" else outs[-1])

    return many


def scan_body(step_fn: Callable[[Any, Any], Tuple[Any, Any]],
              k: int, out_mode: str = "last") -> Callable:
    """The plain loop `fn(carry, batches)`: one `step_fn` call per slice
    of batches stacked on a leading [k, ...] axis."""
    _check(k, out_mode)

    def many(carry, batches):
        outs = []
        for j in range(k):
            carry, out = step_fn(carry, _map(lambda b: b[j], batches))
            outs.append(out)
        return carry, (_stack(outs) if out_mode == "all" else outs[-1])

    return many


def _refuse(carry) -> None:
    """Megastep's refusals on the card (see the module docstring)."""
    from ..common import basics

    if (basics.is_initialized() and basics.size() > 1
            and basics.backend() == "gloo"):
        raise HorovodTpuError(
            "megastep: a gloo group of more than one rank runs its "
            "collectives on the host, which a CUDA graph cannot capture; "
            "give each rank a card of its own (NCCL) or call the step "
            "in a loop")
    for x in _leaves(carry):
        if getattr(x, "guard_state", None) is not None:
            raise HorovodTpuError(
                "megastep: the optimizer runs under the guard (guard=), "
                "whose skip-step verdict reads the host once a step, which "
                "a CUDA graph cannot capture; drop guard= or call the step "
                "in a loop")


class _Megastep:
    """`repeat_steps` / `scan_steps`: the plain loop on the CPU, a CUDA
    graph of k steps on the card (see the module docstring)."""

    def __init__(self, body: Callable, k: int):
        self._body = body
        self.k = k
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0
        self._static_batch = None
        self._static_out = None
        self._generation = 0  # the reaction generation at capture
        self.captures = 0

    def __call__(self, carry, batch):
        from ..parallel import data_parallel as _dp

        clock = _dp.step_clock()
        with _dp.hold_step_hooks():
            if self._device(batch).type == "cuda":
                out = self._on_card(carry, batch)
            else:
                carry, out = self._body(carry, batch)
        self.calls += 1
        _dp.record_step(clock, steps=self.k)
        return carry, out

    @staticmethod
    def _device(batch) -> torch.device:
        """hvd's device once `init` ran, else the batch's."""
        from ..common import basics

        if basics.is_initialized():
            return basics.device()
        for x in _leaves(batch):
            if isinstance(x, torch.Tensor):
                return x.device
        return torch.device("cpu")

    def _on_card(self, carry, batch):
        _refuse(carry)
        for x in _leaves(batch):
            if not (isinstance(x, torch.Tensor) and x.is_cuda):
                raise HorovodTpuError(
                    "megastep on the card takes its batch as CUDA tensors "
                    "(prefetch_to_device puts it there); got "
                    f"{type(x).__name__}"
                    + (f" on {x.device}" if isinstance(x, torch.Tensor)
                       else ""))
        if self.calls == 0:
            # The warm-up: k eager steps on a side stream.
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                carry_out, out = self._body(carry, batch)
            torch.cuda.current_stream().wait_stream(side)
            if carry_out is not carry:
                raise HorovodTpuError(
                    "megastep on the card needs a step that updates its "
                    "carry in place and returns the carry it was given "
                    "(a graph replays into the same memory)")
            return out
        from ..parallel import data_parallel as _dp

        gen = _dp.reaction_generation()
        if self.graph is not None and gen != self._generation:
            # The graph baked the old bucket partition in: capture again.
            self.graph = self._static_out = None
        if self.graph is None:
            self._static_batch = _map(lambda x: x.clone(), batch)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._body(carry, self._static_batch)[1]
            for x in _leaves(out):
                if not isinstance(x, torch.Tensor):
                    raise HorovodTpuError(
                        "megastep: a captured step returns tensors only "
                        f"(got {type(x).__name__}, which a replay would "
                        "not update)")
            self.graph, self._static_out = graph, out
            self._generation = gen
            self.captures += 1
        else:
            _map(lambda s, x: s.copy_(x), self._static_batch, batch)
        self.graph.replay()
        return self._static_out


def repeat_steps(step_fn: Callable[[Any, Any], Tuple[Any, Any]],
                 k: int, out_mode: str = "last") -> Callable:
    """`repeat_body` as one CUDA graph of k steps on the card (the plain
    loop on the CPU); `fn(carry, batch) -> (carry, out)`."""
    return _Megastep(repeat_body(step_fn, k, out_mode), k)


def scan_steps(step_fn: Callable[[Any, Any], Tuple[Any, Any]],
               k: int, out_mode: str = "last") -> Callable:
    """`scan_body` as one CUDA graph of k steps on the card (the plain
    loop on the CPU); `fn(carry, batches) -> (carry, out)`, batches
    stacked on a leading [k, ...] axis."""
    return _Megastep(scan_body(step_fn, k, out_mode), k)


def early_reduction_body(grad_fn: Callable[[Any, Any], Any], k: int,
                         reduce_fn: Callable[[Any], Any] = None,
                         average: bool = True,
                         sentinel: bool = False) -> Callable:
    """`fn(params, batches) -> reduced_grads`: gradients over k
    microbatches stacked on a leading [k, ...] axis, microbatch j's
    cross-rank reduction issued before microbatch j+1's backward (JAX
    `early_reduction_body`).  The partial sums alternate between two
    accumulators, as JAX's unrolled loop does; `average=True` divides the
    k-sum by k.  The reduction is linear, so the result equals
    accumulate-then-reduce, bitwise when every addend is exactly
    representable (integer-valued floats, k a power of two).

    `grad_fn(params, microbatch) -> grads` (a tensor, or a list, tuple or
    dict of them); `reduce_fn(grads) -> reduced` defaults to
    `allreduce_gradients`.  `sentinel=True` reduces each microbatch with
    the non-finite sentinel and returns `(reduced_grads, flags)`, flags
    the elementwise max of every pass's cross-rank per-bucket vector (a
    custom `reduce_fn` must then take `sentinel=` and return the pair)."""
    if not isinstance(k, int) or k < 1:
        raise HorovodTpuError(
            f"megastep: k must be an int >= 1, got {k!r}")
    if reduce_fn is None:
        from ..parallel.data_parallel import allreduce_gradients
        reduce_fn = allreduce_gradients
    if sentinel:
        reduce_fn = partial(reduce_fn, sentinel=True)

    def many(params, batches):
        acc = [None, None]
        flags = None
        for j in range(k):
            mb = _map(lambda b: b[j], batches)
            r = reduce_fn(grad_fn(params, mb))
            if sentinel:
                r, f = r
                flags = f if flags is None else torch.maximum(flags, f)
            prev = acc[j % 2]
            acc[j % 2] = r if prev is None else _map(
                lambda a, g: a + g, prev, r)
        total = acc[0] if acc[1] is None else _map(
            lambda a, b: a + b, acc[0], acc[1])
        if average:
            total = _map(lambda g: (g / k).to(g.dtype), total)
        return (total, flags) if sentinel else total

    return many


def early_reduction_steps(grad_fn: Callable[[Any, Any], Any], k: int,
                          reduce_fn: Callable[[Any], Any] = None,
                          average: bool = True,
                          sentinel: bool = False) -> Callable:
    """`early_reduction_body` (the JAX package jits it; here it runs
    eagerly: its reductions are collectives)."""
    return early_reduction_body(grad_fn, k, reduce_fn, average, sentinel)


__all__ = ["repeat_body", "scan_body", "repeat_steps", "scan_steps",
           "early_reduction_body", "early_reduction_steps"]
