"""Parquet vector codec via pyarrow.

Parity with the reference's parquet-go codec (reference:
pkg/persistence/parquet.go:16-174): schema {id: dictionary-encoded utf8,
vector: FixedSizeList<float32>[dim], metadata: utf8 JSON-string}, Snappy
compression, batched reads, and crash-safe writes (tmp + fsync + rename,
parquet.go:29-92).

A copy of ``quiver_tpu/persistence/parquet_io.py`` (the same files on
disk), with one change: ``pyarrow`` is imported inside the Parquet
functions, never at module top, so the package imports and runs where
pyarrow is missing. There a Parquet write raises ImportError, and the
persistence manager takes the reference's own JSON fallback
(``vectors.json``, ``manager.py:369-373``)."""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

READ_BATCH_ROWS = 1000  # reference: parquet.go reads in 1000-row batches


def _schema(dim: int):
    import pyarrow as pa

    return pa.schema(
        [
            pa.field("id", pa.dictionary(pa.int32(), pa.utf8())),
            pa.field("vector", pa.list_(pa.float32(), dim)),
            pa.field("metadata", pa.utf8()),
        ]
    )


def write_vectors_parquet(
    path: str,
    ids: Sequence[str],
    vectors: np.ndarray,
    metadatas: Sequence[Optional[dict]],
) -> None:
    """Atomic Parquet snapshot write (tmp + fsync + rename)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    dim = int(vectors.shape[1]) if len(vectors) else 0
    md_strings = [
        json.dumps(m, separators=(",", ":")) if m is not None else None
        for m in metadatas
    ]
    table = pa.table(
        {
            "id": pa.array(ids, pa.utf8()).dictionary_encode(),
            "vector": pa.FixedSizeListArray.from_arrays(
                pa.array(np.asarray(vectors, np.float32).reshape(-1), pa.float32()),
                dim,
            )
            if dim
            else pa.array([], pa.list_(pa.float32(), 0)),
            "metadata": pa.array(md_strings, pa.utf8()),
        },
        schema=_schema(dim),
    )
    tmp = path + ".tmp"
    pq.write_table(table, tmp, compression="snappy")
    _fsync_file(tmp)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def read_vectors_parquet(path: str):
    """-> (ids, vectors f32[n, d], metadatas). Streams in row batches."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    ids: list[str] = []
    vecs: list[np.ndarray] = []
    mds: list[Optional[dict]] = []
    dim = None
    for batch in pf.iter_batches(batch_size=READ_BATCH_ROWS):
        col_id = batch.column("id").to_pylist()
        col_vec = batch.column("vector")
        col_md = batch.column("metadata").to_pylist()
        if isinstance(col_vec, pa.ChunkedArray):  # pragma: no cover
            col_vec = col_vec.combine_chunks()
        flat = col_vec.flatten().to_numpy(zero_copy_only=False).astype(np.float32)
        if dim is None:
            t = col_vec.type
            dim = t.list_size if isinstance(t, pa.FixedSizeListType) else 0
        n = len(col_id)
        vecs.append(flat.reshape(n, dim) if dim else np.zeros((n, 0), np.float32))
        ids.extend(col_id)
        mds.extend(json.loads(m) if m else None for m in col_md)
    if not ids:
        return [], np.zeros((0, dim or 0), np.float32), []
    return ids, np.concatenate(vecs, axis=0), mds


def write_vectors_json(path: str, ids, vectors, metadatas) -> None:
    """JSON fallback codec (reference: manager.go:320-328 falls back to JSON
    when Parquet writes fail)."""
    rows = [
        {
            "id": i,
            "vector": np.asarray(v, np.float32).tolist(),
            "metadata": m,
        }
        for i, v, m in zip(ids, vectors, metadatas)
    ]
    safe_write_file(path, json.dumps(rows).encode())


def read_vectors_json(path: str):
    with open(path, "rb") as f:
        rows = json.loads(f.read() or b"[]")
    ids = [r["id"] for r in rows]
    vecs = (
        np.asarray([r["vector"] for r in rows], np.float32)
        if rows
        else np.zeros((0, 0), np.float32)
    )
    mds = [r.get("metadata") for r in rows]
    return ids, vecs, mds


def safe_write_file(path: str, data: bytes) -> None:
    """temp file + fsync + atomic rename (reference safeWriteFile,
    manager.go:625-662)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - some filesystems disallow dir fsync
        pass
    finally:
        os.close(fd)
