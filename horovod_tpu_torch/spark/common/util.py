"""DataFrame → worker-shard materialization (counterpart of
`horovod_tpu/spark/common/util.py`).

Reference parity: `horovod/spark/common/util.py` (`prepare_data`,
`check_validation`, metadata helpers ≈800 LoC) — the reference writes
the DataFrame to Parquet via Spark and computes row-count/shape
metadata for Petastorm readers.

Design: columns become dense numpy arrays, split into one
`.npy` pair per worker rank in the store.  Works with pandas
DataFrames directly and with pyspark DataFrames via `toPandas()` (the
datasets estimators train on here are host-memory sized; pod-scale
input pipelines belong to tf.data/grain, not the estimator layer).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...common.exceptions import HorovodTpuError
from .store import Store, part_name

# Single replicated validation shard (every rank reads the same data);
# files are val.x.npy / val.y.npy (see shard_paths).
VAL_BASE = "val"

# Wire-compression names the estimators accept (resolved on the worker
# against the frontend's Compression registry).
VALID_COMPRESSION = (None, "none", "fp16", "bf16")


def resolve_compression(frontend, name):
    """Map an estimator compression name to the frontend shim's
    Compression member (`frontend` is horovod_tpu_torch.torch or
    horovod_tpu_torch.tensorflow.keras — both expose the same
    registry)."""
    if name in (None, "none"):
        return frontend.Compression.none
    return getattr(frontend.Compression, name)


def to_pandas(df):
    """Accept a pandas DataFrame or anything exposing `toPandas()`
    (pyspark DataFrame)."""
    if hasattr(df, "toPandas"):
        return df.toPandas()
    return df


def _column_matrix(pdf, cols: Sequence[str],
                   preserve_int: bool = False) -> np.ndarray:
    """Stack columns into [N, F]; array-valued cells are flattened per
    row (the reference's DenseVector handling analog).

    `preserve_int=True` (labels): if EVERY column is integer-typed the
    matrix stays int64 — classification labels must survive as ints
    (torch cross_entropy wants Long targets)."""
    parts = []
    for c in cols:
        if c not in pdf.columns:
            raise HorovodTpuError(
                f"column {c!r} not in DataFrame (have: {list(pdf.columns)})")
        col = pdf[c].to_numpy()
        if col.dtype == object:  # per-cell arrays/lists
            col = np.stack([np.asarray(v, dtype=np.float32).ravel()
                            for v in col])
        else:
            col = col[:, None]
        parts.append(col.reshape(len(pdf), -1))
    all_int = all(np.issubdtype(p.dtype, np.integer) or
                  p.dtype == np.bool_ for p in parts)
    dtype = np.int64 if (preserve_int and all_int) else np.float32
    return np.concatenate(
        [p.astype(dtype) for p in parts], axis=1)


def _split_validation(n: int, validation, pdf,
                      seed: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Row index split (reference: `check_validation` — a fraction or
    the name of a boolean indicator column)."""
    idx = np.arange(n)
    if validation is None:
        return idx, np.empty((0,), np.int64)
    if isinstance(validation, str):
        if validation not in pdf.columns:
            raise HorovodTpuError(
                f"validation column {validation!r} not in DataFrame "
                f"(have: {list(pdf.columns)})")
        mask = pdf[validation].to_numpy().astype(bool)
        return idx[~mask], idx[mask]
    frac = float(validation)
    if not 0.0 < frac < 1.0:
        raise HorovodTpuError(
            f"validation must be a fraction in (0,1) or a column name, "
            f"got {validation!r}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(round(n * frac)))
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])


def prepare_data(
    df,
    store: Store,
    run_id: str,
    num_shards: int,
    feature_cols: Sequence[str],
    label_cols: Sequence[str],
    validation=None,
    shuffle: bool = True,
    seed: Optional[int] = None,
) -> Dict[str, int]:
    """Materialize `df` into per-rank shards in the store.

    Train rows are shuffled (optionally) and sharded into EQUAL-SIZED
    part files (the remainder after dividing by `num_shards` is
    dropped): every rank must run the same number of optimizer steps
    per epoch or the per-batch gradient allreduces desynchronize — the
    reference enforces the same via steps_per_epoch over Petastorm
    readers.  Validation rows go to ONE shared val shard (read via
    `load_val`) since they are identical for every rank.

    Shards are raw `.npy` pairs (`<base>.x.npy` / `<base>.y.npy`) so
    workers can memory-map them (`ShardDataLoader`) instead of
    decompressing a zip into RAM.
    Returns metadata {train_rows, val_rows, features_dim, labels_dim};
    train_rows is the post-truncation total actually used.
    """
    pdf = to_pandas(df)
    n = len(pdf)
    if n < num_shards:
        raise HorovodTpuError(
            f"dataset has {n} rows < num_proc={num_shards}; every worker "
            "needs at least one row")
    x = _column_matrix(pdf, feature_cols)
    y = _column_matrix(pdf, label_cols, preserve_int=True)
    tr_idx, va_idx = _split_validation(n, validation, pdf, seed)
    if shuffle:
        rng = np.random.default_rng(seed)
        tr_idx = tr_idx[rng.permutation(len(tr_idx))]
    if len(tr_idx) < num_shards:
        raise HorovodTpuError(
            f"{len(tr_idx)} training rows after validation split < "
            f"num_proc={num_shards}")

    train_dir = store.get_train_data_path(run_id)
    val_dir = store.get_val_data_path(run_id)
    store.mkdirs(train_dir)
    xv, yv = x[va_idx], y[va_idx]
    if len(va_idx):
        store.mkdirs(val_dir)
    per_shard = len(tr_idx) // num_shards
    tr_idx = tr_idx[:per_shard * num_shards]
    for r in range(num_shards):
        shard = tr_idx[r * per_shard:(r + 1) * per_shard]
        _write_shard(store, os.path.join(train_dir, part_name(r)),
                     x[shard], y[shard])
    if len(va_idx):
        # Replicated by design → ONE shard all ranks read, not one
        # identical copy per rank.
        _write_shard(store, os.path.join(val_dir, VAL_BASE), xv, yv)
    return {
        "train_rows": int(len(tr_idx)),
        "val_rows": int(len(va_idx)),
        "features_dim": int(x.shape[1]),
        "labels_dim": int(y.shape[1]),
    }


def shard_paths(data_dir: str, rank) -> Tuple[str, str]:
    """(features, labels) .npy paths for a shard base: an int rank maps
    to its part file; a string is used as the base directly (val)."""
    base = part_name(rank) if isinstance(rank, int) else rank
    base = os.path.join(data_dir, base)
    return f"{base}.x.npy", f"{base}.y.npy"


def _write_shard(store: Store, base_path: str, x: np.ndarray,
                 y: np.ndarray):
    import io

    for suffix, arr in ((".x.npy", x), (".y.npy", y)):
        buf = io.BytesIO()
        np.save(buf, arr)
        store.write_bytes(base_path + suffix, buf.getvalue())


def load_shard(data_dir: str, rank: int) -> Tuple[np.ndarray, np.ndarray]:
    """Worker-side: load this rank's shard fully into memory (use
    `ShardDataLoader` to iterate it memory-mapped instead)."""
    xp, yp = shard_paths(data_dir, rank)
    return np.load(xp), np.load(yp)


def load_val(val_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Worker-side: load the shared (replicated) validation shard."""
    xp, yp = shard_paths(val_dir, VAL_BASE)
    return np.load(xp), np.load(yp)


def to_output_frame(pdf, output_cols: List[str], preds: np.ndarray):
    """Attach prediction columns to an already-materialized pandas
    frame.  One output column gets the per-row prediction (scalar or
    array); multiple output columns require preds' second dim to match.
    """
    pdf = pdf.copy()
    preds = preds.reshape(len(pdf), -1)
    if len(output_cols) == 1:
        pdf[output_cols[0]] = (preds[:, 0] if preds.shape[1] == 1
                               else list(preds))
        return pdf
    if preds.shape[1] != len(output_cols):
        raise HorovodTpuError(
            f"model produced {preds.shape[1]} outputs per row but "
            f"output_cols has {len(output_cols)} names")
    for i, c in enumerate(output_cols):
        pdf[c] = preds[:, i]
    return pdf


__all__ = ["prepare_data", "load_shard", "load_val", "shard_paths",
           "VAL_BASE", "to_pandas", "to_output_frame"]
