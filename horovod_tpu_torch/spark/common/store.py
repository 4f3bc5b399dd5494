"""Estimator data/artifact store (counterpart of
`horovod_tpu/spark/common/store.py`).

Reference parity: `horovod/spark/common/store.py` (`Store`,
`LocalStore`, `HDFSStore`, `DBFSLocalStore` ≈900 LoC) — the filesystem
abstraction Spark estimators use for three things: intermediate
training data materialized from the DataFrame, checkpoints, and logs.

Design: the reference materializes DataFrames to Parquet
and reads them back through Petastorm.  Here intermediate shards are
**raw `.npy` pairs, one per worker rank** — readable fully via
`np.load` or memory-mapped via `ShardDataLoader` (zero extra deps),
and the shard count is the worker count so each worker reads exactly
its own pair.  Checkpoints are single pickled blobs written atomically
(tmp + rename).

`Store.create(prefix)` mirrors the reference factory's URI routing
(store.py `Store.create`): local paths (and `file://`) get a
`LocalStore`; `dbfs:/` maps to the `/dbfs` FUSE mount
(`DBFSLocalStore`, exactly the reference's translation); `hdfs://` and
object-store schemes get a `FilesystemStore` over a duck-typed client —
pyarrow/fsspec when importable, or any injected `filesystem=` object
(the mocked-client seam the tests use, since the real cluster clients
are not in this image).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import uuid
from typing import List, Optional

from ...common.exceptions import HorovodTpuError

_HDFS_SCHEMES = ("hdfs://",)
_OBJECT_SCHEMES = ("s3://", "s3a://", "s3n://", "gs://", "abfs://",
                   "abfss://", "wasb://", "wasbs://")


class Store:
    """Abstract store (reference: store.py `Store`)."""

    @staticmethod
    def create(prefix_path: Optional[str] = None, **kwargs) -> "Store":
        if prefix_path is None:
            return LocalStore(None, **kwargs)
        low = prefix_path.lower()
        if low.startswith("dbfs:/"):
            return DBFSLocalStore(prefix_path, **kwargs)
        if any(low.startswith(s) for s in _HDFS_SCHEMES):
            return HDFSStore(prefix_path, **kwargs)
        if any(low.startswith(s) for s in _OBJECT_SCHEMES):
            return FilesystemStore(prefix_path, **kwargs)
        if prefix_path.startswith("file://"):
            prefix_path = prefix_path[len("file://"):]
        return LocalStore(prefix_path, **kwargs)

    # -- path layout (names follow the reference API) --
    def get_run_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_train_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_val_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    # -- io --
    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def list_dir(self, path: str) -> List[str]:
        raise NotImplementedError


class LocalStore(Store):
    """Filesystem store (reference: store.py `LocalStore`).

    `prefix_path=None` creates a private temp directory owned by this
    store (removed by `cleanup()`), the pattern the reference tests use
    with `tempdir` fixtures.
    """

    def __init__(self, prefix_path: Optional[str] = None):
        if prefix_path is None:
            self._prefix = tempfile.mkdtemp(prefix="hvd_tpu_store_")
            self._owns_prefix = True
        else:
            self._prefix = os.path.abspath(prefix_path)
            self._owns_prefix = False
            os.makedirs(self._prefix, exist_ok=True)

    @property
    def prefix_path(self) -> str:
        return self._prefix

    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self._prefix, "runs", run_id)

    def get_train_data_path(self, run_id: str) -> str:
        return os.path.join(self._prefix, "intermediate_train_data", run_id)

    def get_val_data_path(self, run_id: str) -> str:
        return os.path.join(self._prefix, "intermediate_val_data", run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), CHECKPOINT_FILE)

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "logs")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def list_dir(self, path: str) -> List[str]:
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def saving_runs(self) -> List[str]:
        """Run ids with artifacts (reference: Store.get_runs analog)."""
        return self.list_dir(os.path.join(self._prefix, "runs"))

    def cleanup(self) -> None:
        if self._owns_prefix and os.path.isdir(self._prefix):
            shutil.rmtree(self._prefix, ignore_errors=True)


class DBFSLocalStore(LocalStore):
    """Databricks DBFS store (reference: store.py `DBFSLocalStore`):
    `dbfs:/path` is the cluster-local FUSE mount `/dbfs/path`, so the
    whole LocalStore machinery applies after the prefix translation —
    the same trick the reference plays."""

    def __init__(self, prefix_path: str, **kwargs):
        if kwargs:
            raise HorovodTpuError(
                "DBFSLocalStore is the local /dbfs FUSE mount and takes "
                f"no client options; got {sorted(kwargs)} — remote "
                "clients belong to hdfs://…/s3://… stores")
        if not prefix_path.lower().startswith("dbfs:/"):
            raise HorovodTpuError(
                f"DBFSLocalStore expects a dbfs:/ path, got {prefix_path!r}")
        # Defer directory creation: the FUSE mount only exists on a
        # Databricks node, but path layout must be computable anywhere.
        self._prefix = "/dbfs/" + prefix_path[len("dbfs:/"):].lstrip("/")
        self._owns_prefix = False

    @staticmethod
    def normalize_datasets_dir(path: str) -> str:
        """dbfs:/... → /dbfs/... (reference helper name)."""
        return ("/dbfs/" + path[len("dbfs:/"):].lstrip("/")
                if path.lower().startswith("dbfs:/") else path)


class FilesystemStore(Store):
    """Remote store over a duck-typed filesystem client (reference:
    store.py `HDFSStore` / the fsspec-style object stores).

    The client needs five methods — `open(path, mode)`, `exists(path)`,
    `mkdirs(path)` (or `makedirs`), `ls(path)` (or `list`), and
    optionally `rename(src, dst)` for atomic checkpoint writes (falls
    back to direct write when absent).  Pass one via `filesystem=`;
    without it, fsspec is tried for the URI's scheme.  This is the
    URI-level API-parity seam: real cluster deployments inject their
    client, tests inject a mock."""

    def __init__(self, prefix_path: str, filesystem=None):
        self._prefix = prefix_path.rstrip("/")
        if filesystem is None:
            scheme = prefix_path.split("://", 1)[0]
            try:
                import fsspec
                filesystem = fsspec.filesystem(scheme)
            except Exception as e:  # noqa: BLE001
                raise HorovodTpuError(
                    f"Store for {prefix_path!r} needs a filesystem "
                    f"client: pass filesystem=<client> (fsspec-style "
                    f"open/exists/mkdirs/ls) — no fsspec driver for "
                    f"{scheme!r} in this environment") from e
        self._fs = filesystem

    @property
    def prefix_path(self) -> str:
        return self._prefix

    def _join(self, *parts: str) -> str:
        return "/".join([self._prefix.rstrip("/"), *parts])

    def get_run_path(self, run_id: str) -> str:
        return self._join("runs", run_id)

    def get_train_data_path(self, run_id: str) -> str:
        return self._join("intermediate_train_data", run_id)

    def get_val_data_path(self, run_id: str) -> str:
        return self._join("intermediate_val_data", run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return self.get_run_path(run_id) + "/" + CHECKPOINT_FILE

    def get_logs_path(self, run_id: str) -> str:
        return self.get_run_path(run_id) + "/logs"

    def exists(self, path: str) -> bool:
        return bool(self._fs.exists(path))

    def read_bytes(self, path: str) -> bytes:
        if not self.exists(path):
            # Crash-window recovery: a write interrupted between the
            # two swap renames leaves the previous good file at .bak.
            bak = f"{path}.bak"
            if self.exists(bak):
                with self._fs.open(bak, "rb") as f:
                    return f.read()
        with self._fs.open(path, "rb") as f:
            return f.read()

    def _reap_bak(self, path: str) -> None:
        """Best-effort removal of a superseded/stale `.bak` once a good
        `path` exists (covers crash leftovers from interrupted swaps)."""
        bak = f"{path}.bak"
        rm = getattr(self._fs, "delete", None) or \
            getattr(self._fs, "rm", None)
        if rm is not None and self.exists(bak):
            rm(bak)

    def write_bytes(self, path: str, data: bytes) -> None:
        self.mkdirs(path.rsplit("/", 1)[0])
        if hasattr(self._fs, "rename"):
            tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
            with self._fs.open(tmp, "wb") as f:
                f.write(data)
            try:
                # POSIX-like clients overwrite on rename — fully atomic.
                self._fs.rename(tmp, path)
            except Exception:  # noqa: BLE001 — dst-exists rename refusal
                # Only treat the failure as HDFS no-overwrite semantics
                # when the destination actually exists; anything else
                # (permissions, quota, partition) must propagate without
                # touching the live file.
                if not self.exists(path):
                    raise
                # Move the old checkpoint ASIDE (never delete-first): a
                # crash between these renames leaves a recoverable .bak
                # (read_bytes falls back to it), not a window with no
                # checkpoint at all.  The bak name is FIXED so leftovers
                # are reaped, not accumulated.
                bak = f"{path}.bak"
                rm = getattr(self._fs, "delete", None) or \
                    getattr(self._fs, "rm", None)
                if self.exists(bak):
                    if rm is not None:
                        rm(bak)
                    else:
                        # No delete capability: rotate the stale backup
                        # to a unique name so the fixed slot frees up.
                        # This leaks one file per rewrite — loudly, once.
                        if not getattr(self, "_warned_bak_leak", False):
                            self._warned_bak_leak = True
                            logging.getLogger(__name__).warning(
                                "store client for %s has no delete/rm: "
                                "checkpoint rewrites on a no-overwrite "
                                "filesystem will accumulate .bak files",
                                self.prefix_path)
                        self._fs.rename(
                            bak, f"{bak}.{uuid.uuid4().hex[:8]}")
                self._fs.rename(path, bak)
                self._fs.rename(tmp, path)
            self._reap_bak(path)
        else:
            with self._fs.open(path, "wb") as f:
                f.write(data)

    def mkdirs(self, path: str) -> None:
        mk = getattr(self._fs, "mkdirs", None) or \
            getattr(self._fs, "makedirs", None)
        if mk is not None:
            try:
                mk(path)
            except FileExistsError:
                pass

    def list_dir(self, path: str) -> List[str]:
        ls = getattr(self._fs, "ls", None) or getattr(self._fs, "list", None)
        if ls is None or not self.exists(path):
            return []
        return sorted(str(p).rstrip("/").rsplit("/", 1)[-1]
                      for p in ls(path))

    def saving_runs(self) -> List[str]:
        return self.list_dir(self._join("runs"))

    def cleanup(self) -> None:
        """Remote prefixes are caller-owned; nothing to remove."""


class HDFSStore(FilesystemStore):
    """HDFS store (reference: store.py `HDFSStore` ≈L200-400).

    Accepts the reference's connection kwargs (host/port/user/
    kerb_ticket) and builds a pyarrow HadoopFileSystem when no client
    is injected; with `filesystem=` any duck-typed client works (the
    reference similarly accepts a ready `pyarrow.fs` object)."""

    def __init__(self, prefix_path: str, host: Optional[str] = None,
                 port: Optional[int] = None, user: Optional[str] = None,
                 kerb_ticket: Optional[str] = None, filesystem=None):
        if filesystem is None:
            try:
                from pyarrow.fs import HadoopFileSystem

                filesystem = _PyarrowFsAdapter(HadoopFileSystem(
                    host=host or "default", port=port or 0, user=user,
                    kerb_ticket=kerb_ticket))
            except Exception as e:  # noqa: BLE001
                raise HorovodTpuError(
                    "HDFSStore needs a hadoop client: pyarrow's "
                    "HadoopFileSystem is unavailable here — pass "
                    "filesystem=<client> (open/exists/mkdirs/ls)"
                ) from e
        super().__init__(prefix_path, filesystem=filesystem)


class _PyarrowFsAdapter:
    """Duck-type a pyarrow.fs.FileSystem to the five-method client
    surface FilesystemStore expects."""

    def __init__(self, fs):
        self._fs = fs

    def open(self, path: str, mode: str):
        p = _strip_scheme(path)
        return (self._fs.open_input_stream(p) if "r" in mode
                else self._fs.open_output_stream(p))

    def exists(self, path: str) -> bool:
        from pyarrow.fs import FileType

        return self._fs.get_file_info(
            _strip_scheme(path)).type != FileType.NotFound

    def mkdirs(self, path: str) -> None:
        self._fs.create_dir(_strip_scheme(path), recursive=True)

    def ls(self, path: str):
        from pyarrow.fs import FileSelector

        return [i.path for i in self._fs.get_file_info(
            FileSelector(_strip_scheme(path)))]

    def rename(self, src: str, dst: str) -> None:
        self._fs.move(_strip_scheme(src), _strip_scheme(dst))

    def delete(self, path: str) -> None:
        self._fs.delete_file(_strip_scheme(path))


def _strip_scheme(path: str) -> str:
    """`hdfs://host:port/a/b` → `/a/b` (the client is already bound to
    the authority; keeping `host:port` would make every path a bogus
    relative path).  `hdfs:///a/b` → `/a/b`; scheme-less paths pass
    through."""
    if "://" not in path:
        return path
    rest = path.split("://", 1)[1]
    slash = rest.find("/")
    return rest[slash:] if slash >= 0 else "/"


# Shard base name shared by writer (util.py) and the remote trainers;
# actual files are <base>.x.npy / <base>.y.npy (see util.shard_paths).
def part_name(rank: int) -> str:
    return f"part-{rank:05d}"


# Single source of truth for the checkpoint filename used by
# Store.get_checkpoint_path and the remote trainers' save_checkpoint.
CHECKPOINT_FILE = "checkpoint.pkl"


def save_checkpoint(run_path: str, payload) -> str:
    """Atomically pickle `payload` to `<run_path>/checkpoint.pkl`
    (shared by the keras/torch remote trainers; same tmp+rename
    pattern as LocalStore.write_bytes)."""
    import pickle

    os.makedirs(run_path, exist_ok=True)
    ckpt = os.path.join(run_path, CHECKPOINT_FILE)
    tmp = f"{ckpt}.tmp.{uuid.uuid4().hex[:8]}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, ckpt)
    return ckpt


__all__ = ["Store", "LocalStore", "part_name", "CHECKPOINT_FILE",
           "save_checkpoint"]
