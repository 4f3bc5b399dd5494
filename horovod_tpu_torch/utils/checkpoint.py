"""Durable checkpoints of training state: rank 0 writes, every rank reads.

Counterpart of `horovod_tpu/utils/checkpoint.py`.  The JAX package's
one-process path is orbax, which the port does not have: the port takes
the JAX package's multi-process path in both modes.  Rank 0 copies the
state (a tree of tensors, e.g. `{"model": model.state_dict(), "opt":
opt.state_dict()}`) to host memory and writes one `torch.save` payload
per step; restore reads on rank 0 and broadcasts the payload's bytes, so
every rank reaches the broadcast whether or not its filesystem has the
files.

    from horovod_tpu_torch.utils import checkpoint as ckpt

    mgr = ckpt.CheckpointManager("/path/run1", max_to_keep=3)
    mgr.save(step, {"model": model.state_dict(), "opt": opt.state_dict()})
    state = mgr.restore_latest(template=...)   # None if no checkpoint yet

Layout: `step_N/state.pt` and its `state.sha256` sidecar, both fsynced,
published with one atomic rename of `step_N.tmp`; a leftover `.tmp` is
swept at the next save.  A sha256 mismatch or a payload that does not
load raises `CheckpointCorruptError`; `restore_latest` moves such a step
aside as `step_N.corrupt` and rolls back to the next good one.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import re
import shutil
from typing import Any, Callable, List, Optional, Tuple

import torch

from .. import faults as _faults
from ..common import basics, util
from ..common.exceptions import CheckpointCorruptError
from ..guard._tree import flatten
from ..metrics import catalog as _met

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

_STEP_RE = re.compile(r"^step_(\d+)$")
_CORRUPT_RE = re.compile(r"^step_(\d+)\.corrupt$")
_PAYLOAD_FILE = "state.pt"
_DIGEST_FILE = "state.sha256"


def _to_host(tree: Any) -> Any:
    """Host copies of every tensor leaf (a view gets storage of its own,
    so a parameter that views a larger buffer saves only itself)."""
    vals, rebuild = flatten(tree)
    return rebuild([v.detach().to("cpu", copy=True)
                    if isinstance(v, torch.Tensor) else v for v in vals])


def _onto(restored: Any, template: Any) -> Any:
    """`restored` with each tensor moved to the device of the template's
    tensor in the same place (a leaf the template lacks stays on the
    host)."""
    if template is None:
        return restored
    vals, rebuild = flatten(restored)
    tvals, _ = flatten(template)
    if len(tvals) != len(vals):
        raise ValueError(
            f"restore template has {len(tvals)} leaves, the checkpoint "
            f"{len(vals)}")
    return rebuild([v.to(t.device) if isinstance(v, torch.Tensor)
                    and isinstance(t, torch.Tensor) else v
                    for v, t in zip(vals, tvals)])


def _load(blob: bytes, step: int) -> Any:
    try:
        return torch.load(io.BytesIO(blob), map_location="cpu",
                          weights_only=False)
    except Exception as e:  # noqa: BLE001 — truncated / garbled payload
        raise CheckpointCorruptError(
            f"checkpoint step {step} failed to load: "
            f"{type(e).__name__}: {e}") from e


def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    """Rank 0 writes; every rank reads the same state."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep

    @staticmethod
    def _multiprocess() -> bool:
        return basics.is_initialized() and basics.size() > 1

    @staticmethod
    def _is_root() -> bool:
        return not basics.is_initialized() or basics.rank() == 0

    # -- write -----------------------------------------------------------
    def save(self, step: int, state: Any) -> bool:
        """Persist `state` at `step`.  Only rank 0 writes (the Horovod
        convention); the other ranks return False."""
        _faults.point("checkpoint.save")
        if not self._is_root():
            return False
        os.makedirs(self._dir, exist_ok=True)
        buf = io.BytesIO()
        torch.save(_to_host(state), buf)
        blob = buf.getvalue()
        final = os.path.join(self._dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)  # left by a crash mid-save
        os.makedirs(tmp)
        # Payload and sidecar, both fsynced, then one atomic rename: a
        # crash at any point leaves the previous complete step or a .tmp
        # the next save sweeps, never a truncated step_N.
        _fsync_write(os.path.join(tmp, _PAYLOAD_FILE), blob)
        _fsync_write(os.path.join(tmp, _DIGEST_FILE),
                     hashlib.sha256(blob).hexdigest().encode())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()
        return True

    def _prune(self) -> None:
        if self._keep is None:
            return
        steps = self._local_steps()
        for s in steps[: max(0, len(steps) - self._keep)]:
            shutil.rmtree(os.path.join(self._dir, f"step_{s}"),
                          ignore_errors=True)

    def _local_steps(self) -> List[int]:
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := _STEP_RE.match(n)))

    # -- read ------------------------------------------------------------
    def _bcast(self, obj: Any) -> Any:
        if not self._multiprocess():
            return obj
        from ..ops.functions import broadcast_object
        return broadcast_object(obj, root_rank=0)

    def latest_step(self) -> Optional[int]:
        """The latest persisted step, rank 0's view broadcast to all, so
        `if mgr.latest_step() is not None: mgr.restore(...)` is safe on
        every rank even when only rank 0's disk has the files."""
        steps = self._local_steps() if self._is_root() else None
        steps = self._bcast(steps)
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return self._bcast(self._local_steps() if self._is_root() else None)

    def _read_blob(self, step: int) -> Tuple[Any, bytes]:
        """Read and verify one step on this rank: (state, payload)."""
        _faults.point("checkpoint.restore")
        d = os.path.join(self._dir, f"step_{step}")
        try:
            with open(os.path.join(d, _PAYLOAD_FILE), "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step} unreadable: {e}") from e
        digest_path = os.path.join(d, _DIGEST_FILE)
        if os.path.exists(digest_path):
            with open(digest_path) as f:
                want = f.read().strip()
            got = hashlib.sha256(blob).hexdigest()
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} digest mismatch "
                    f"(want {want[:12]}…, got {got[:12]}…)")
        return _load(blob, step), blob

    def _quarantine(self, step: int) -> None:
        """Move a corrupt step_N aside as step_N.corrupt (kept for
        forensics, out of the step listing), so that rollback cannot pick
        it again; the quarantine keeps the newest
        HOROVOD_CKPT_QUARANTINE_KEEP entries (default 3)."""
        src = os.path.join(self._dir, f"step_{step}")
        dst = src + ".corrupt"
        try:
            shutil.rmtree(dst, ignore_errors=True)
            os.replace(src, dst)
        except OSError:
            shutil.rmtree(src, ignore_errors=True)
        if _met.enabled():
            _met.checkpoint_rollbacks.inc()
        self._prune_quarantine()

    def _prune_quarantine(self) -> None:
        keep = max(0, util.env_int("CKPT_QUARANTINE_KEEP", 3))
        try:
            names = os.listdir(self._dir)
        except OSError:
            return
        steps = sorted(int(m.group(1)) for n in names
                       if (m := _CORRUPT_RE.match(n)))
        stale = steps[:-keep] if keep else steps
        for s in stale:
            shutil.rmtree(os.path.join(self._dir, f"step_{s}.corrupt"),
                          ignore_errors=True)
        if stale:
            logger.info("pruned %d quarantined checkpoint(s) older than "
                        "the newest %d (steps %s)", len(stale), keep, stale)

    def _read_latest_good(self) -> Optional[Tuple[Any, bytes]]:
        """Newest step first; a corrupt step is quarantined and the scan
        rolls back to the next older one."""
        for step in reversed(self._local_steps()):
            try:
                return self._read_blob(step)
            except CheckpointCorruptError as e:
                logger.warning("checkpoint step %d corrupt (%s): rolling "
                               "back", step, e)
                self._quarantine(step)
        return None

    def _restore_bcast(self, read_fn: Callable[[], Optional[Tuple[Any, bytes]]],
                       template: Any) -> Optional[Any]:
        """Rank 0 reads (or records the failure) and broadcasts the
        payload's bytes; every rank reaches the broadcast, so no rank
        waits forever and none restores other bits."""
        if not self._multiprocess():
            got = read_fn()
            return None if got is None else _onto(got[0], template)
        out = blob = err = None
        if self._is_root():
            try:
                got = read_fn()
                if got is not None:
                    out, blob = got
            except Exception as e:  # noqa: BLE001 — raise on every rank
                err = f"{type(e).__name__}: {e}"
        blob, err = self._bcast((blob, err))
        if out is None and blob is not None:
            out = _load(blob, -1)
        if err is not None:
            raise RuntimeError(f"checkpoint restore failed on rank 0: {err}")
        return None if out is None else _onto(out, template)

    def restore(self, step: int, template: Any = None) -> Any:
        """The state saved at `step`; with `template` (a tree of the same
        structure) each tensor lands on its template tensor's device,
        else on the host."""
        return self._restore_bcast(lambda: self._read_blob(step), template)

    def restore_latest(self, template: Any = None) -> Optional[Any]:
        """The newest good step's state (rolling back past corrupt
        steps), or None when there is none."""
        return self._restore_bcast(self._read_latest_good, template)

    def close(self) -> None:
        """Nothing to release (the JAX package's orbax backend has a
        handle here)."""

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_checkpoint(directory: str, state: Any, step: int = 0) -> bool:
    """One-shot: rank 0 saves `state` at `step`."""
    with CheckpointManager(directory, max_to_keep=None) as mgr:
        return mgr.save(step, state)


def restore_checkpoint(directory: str, template: Any = None,
                       step: Optional[int] = None) -> Optional[Any]:
    """One-shot: restore `step` (default: the latest good one)."""
    with CheckpointManager(directory, max_to_keep=None) as mgr:
        if step is None:
            return mgr.restore_latest(template=template)
        return mgr.restore(step, template=template)


__all__ = ["CheckpointManager", "restore_checkpoint", "save_checkpoint"]
