"""Arrow IPC collection snapshots.

Parity with the reference's ``ArrowHNSWIndex.Save/Load`` (reference:
index/arrow_hnsw.go:138-241): one Arrow IPC record-batch file with schema
{id: utf8, vector: FixedSizeList<float32>[dim], metadata: utf8-JSON}. The
reference rebuilds the graph on load (topology is not serialized); here the
topology sidecar (persistence/manager.py) covers that separately, so Arrow
IPC is an interchange format — anything that speaks Arrow can produce or
consume collection snapshots zero-copy.

A copy of ``quiver_tpu/persistence/arrow_io.py`` (the same files on disk),
with ``pyarrow`` imported inside each function that needs it, never at
module top (see ``parquet_io.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from quiver_tpu_torch.persistence.parquet_io import _fsync_dir, _fsync_file


def _schema(dim: int):
    import pyarrow as pa

    return pa.schema(
        [
            pa.field("id", pa.utf8()),
            pa.field("vector", pa.list_(pa.float32(), dim)),
            pa.field("metadata", pa.utf8()),
        ]
    )


def save_arrow_ipc(
    path: str,
    ids: Sequence[str],
    vectors: np.ndarray,
    metadatas: Optional[Sequence[Optional[dict]]] = None,
) -> None:
    """Write one IPC file (tmp + fsync + rename, like every other writer)."""
    import pyarrow as pa

    dim = int(vectors.shape[1]) if len(vectors) else 0
    if metadatas is None:
        metadatas = [None] * len(ids)
    md_strings = [
        json.dumps(m, separators=(",", ":")) if m is not None else None
        for m in metadatas
    ]
    batch = pa.record_batch(
        {
            "id": pa.array(ids, pa.utf8()),
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
    with pa.OSFile(tmp, "wb") as sink:
        with pa.ipc.new_file(sink, batch.schema) as writer:
            writer.write_batch(batch)
    _fsync_file(tmp)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def load_arrow_ipc(path: str):
    """-> (ids, vectors f32[n, d], metadatas); vectors come back zero-copy
    from the memory-mapped IPC buffer where alignment allows."""
    import pyarrow as pa

    with pa.memory_map(path, "rb") as source:
        table = pa.ipc.open_file(source).read_all()
    ids = table.column("id").to_pylist()
    vec_col = table.column("vector").combine_chunks()
    n = len(ids)
    t = vec_col.type
    dim = t.list_size if isinstance(t, pa.FixedSizeListType) else 0
    flat = vec_col.flatten().to_numpy(zero_copy_only=False).astype(np.float32)
    vectors = flat.reshape(n, dim) if dim else np.zeros((n, 0), np.float32)
    metadatas = [
        json.loads(m) if m else None for m in table.column("metadata").to_pylist()
    ]
    return ids, vectors, metadatas


def export_collection(collection, path: str) -> None:
    """Snapshot a live collection to Arrow IPC."""
    ids, vectors, metadatas = collection.store.snapshot()
    save_arrow_ipc(path, ids, vectors, metadatas)


def import_collection(collection, path: str) -> int:
    """Bulk-load an IPC snapshot into an (empty or partial) collection;
    returns rows loaded. Rebuilds indexes through the normal write path,
    matching the reference's Load-replays-rows semantics
    (index/arrow_hnsw.go:201-241)."""
    ids, vectors, metadatas = load_arrow_ipc(path)
    if len(ids):
        collection.add_batch(ids, vectors, metadatas)
    return len(ids)
