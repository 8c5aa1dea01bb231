"""Persistence manager — snapshot flush loop, WAL, backup/restore.

Parity with the reference's ``persistence.Manager`` (reference:
pkg/persistence/manager.go:78-662): per-collection ``config.json`` +
``vectors.parquet`` snapshots (JSON fallback on Parquet failure,
manager.go:320-328), a JSON-lines WAL between flushes (manager.go:39-59,
458-507), background flush on a ticker (manager.go:136-148), and
backup/restore as a recursive copy skipping ``.wal`` (manager.go:510-617).

Improvements over the reference, on purpose:
* the distance metric is stored as an enum string, fixing the hardcoded
  "cosine" reload bug (pkg/core/db.go:266-270);
* WAL replay honors deletes (the reference logs but never replays them,
  manager.go:442-455, which can resurrect vectors after a crash).

Vectors are the source of truth; index topology is derived and rebuilt on
load (the reference never persists topology either — SURVEY.md §5.4). An
optional topology sidecar (HNSW CSR arrays) can skip the rebuild.

PyTorch port of ``quiver_tpu/persistence/manager.py``: the same files on
disk (``config.json``, ``vectors.parquet`` or ``vectors.json``, the
JSON-lines or native-framed WAL, ``topology.npz``), so a storage directory
written by either package loads in the other. One change: the WAL is
always the native writer (``quiver_tpu_torch/native``, built with g++ at
first use; a failed build raises), where the reference falls back to the
Python writer when its library is not built (``manager.py:242-257``);
``read_wal_any`` still reads both formats, and ``WalWriter`` stays for
callers that want JSON lines.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

import numpy as np

from quiver_tpu_torch import native
from quiver_tpu_torch.observability import logging as qlog
from quiver_tpu_torch.persistence.parquet_io import (
    read_vectors_json,
    read_vectors_parquet,
    safe_write_file,
    write_vectors_json,
    write_vectors_parquet,
)

CONFIG_VERSION = 1


@dataclass
class CollectionConfig:
    """Persisted collection config (reference CollectionConfig,
    manager.go:14-27) — with the metric stored as an enum string."""

    name: str
    dimension: int
    distance_func: str
    created_at: float = field(default_factory=time.time)
    facet_fields: list[str] = field(default_factory=list)
    #: engine kind chosen at create time (exact | hnsw | hybrid | ...);
    #: empty = use the DB default (pre-v1 configs). The reference persists
    #: enough to reconstruct the right index (db.go:150-206, 380-397);
    #: without this a collection created with engine="hnsw" silently
    #: reloads as the DB default.
    engine: str = ""
    #: JSON-safe per-collection engine knobs (quiver_tpu_torch.index.
    #: resolve_engine_config shape) — persisted so a reload reconstructs
    #: the same tuning, e.g. {"ivf": {"recall_target": 0.95}}
    engine_config: dict = field(default_factory=dict)
    version: int = CONFIG_VERSION

    def to_json(self) -> bytes:
        return json.dumps(asdict(self), indent=2).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "CollectionConfig":
        d = json.loads(data)
        return cls(
            name=d["name"],
            dimension=d["dimension"],
            distance_func=d["distance_func"],
            created_at=d.get("created_at", time.time()),
            facet_fields=d.get("facet_fields", []),
            engine=d.get("engine", ""),
            engine_config=d.get("engine_config", {}) or {},
            version=d.get("version", CONFIG_VERSION),
        )


class WalWriter:
    """Append-only JSON-lines WAL (reference WalEntry + appendWal,
    manager.go:39-59, 458-485)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    @staticmethod
    def _entry_line(entry_type: str, vec_id: str, vector, metadata) -> str:
        entry = {
            "timestamp": time.time(),
            "type": entry_type,
            "vector_id": vec_id,
        }
        if vector is not None:
            entry["vector"] = np.asarray(vector, np.float32).tolist()
        if metadata is not None:
            entry["metadata"] = metadata
        return json.dumps(entry, separators=(",", ":")) + "\n"

    def append(self, entry_type: str, vec_id: str,
               vector: Optional[np.ndarray] = None,
               metadata: Optional[dict] = None) -> None:
        self.append_many([(entry_type, vec_id, vector, metadata)])

    def append_many(self, entries) -> None:
        """Group commit: one write + ONE fsync for a whole batch (the
        per-entry-fsync alternative caps ingest at the disk's fsync rate)."""
        lines = "".join(self._entry_line(*e) for e in entries)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(lines)
                f.flush()
                os.fsync(f.fileno())


def read_wal_any(path: str) -> list[dict]:
    """Read a WAL in either format: CRC-framed (native writer) first, then
    JSON-lines (Python writer)."""
    entries = native.read_native_wal(path)
    if entries:
        return entries
    return read_wal(path)


def read_wal(path: str) -> list[dict]:
    entries = []
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except json.JSONDecodeError:
                # torn tail write after a crash: stop at the first bad line
                break
    return entries


class WalHandle:
    """Stable per-collection WAL facade: resolves the live writer at call
    time, so truncation (which closes and recreates writers) can't leave
    collections appending into a closed handle."""

    def __init__(self, manager: "PersistenceManager", name: str):
        self._manager = manager
        self._name = name

    def append(self, *a, **kw) -> None:
        self._manager.wal(self._name).append(*a, **kw)

    def append_many(self, entries) -> None:
        self._manager.wal(self._name).append_many(entries)


class PersistenceManager:
    """Flush loop + WAL + backup/restore over a storage root."""

    def __init__(
        self,
        root: str,
        *,
        flush_interval_s: float = 300.0,
        get_collection: Optional[Callable[[str], object]] = None,
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.flush_interval_s = flush_interval_s
        self.get_collection = get_collection
        self._dirty: set[str] = set()
        self._dirty_lock = threading.Lock()
        self._wal_lock = threading.Lock()
        self._flush_locks: dict[str, threading.Lock] = {}
        self._wals: dict[str, WalWriter] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is None and self.flush_interval_s > 0:
            self._thread = threading.Thread(
                target=self._background_flush, daemon=True,
                name="quiver-flush")
            self._thread.start()

    def stop(self) -> None:
        """Final flush then stop (reference Stop, manager.go:151-164)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.flush_dirty()
        for w in self._wals.values():
            if hasattr(w, "close"):
                w.close()
        self._wals.clear()

    def _background_flush(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            try:
                self.flush_dirty()
            except Exception as e:  # pragma: no cover - keep the loop alive
                qlog.error("background flush failed", error=str(e))

    # ----------------------------------------------------------------- dirty

    def mark_dirty(self, name: str) -> None:
        with self._dirty_lock:
            self._dirty.add(name)

    def flush_dirty(self) -> None:
        with self._dirty_lock:
            dirty = list(self._dirty)
            self._dirty.clear()
        for name in dirty:
            coll = self.get_collection(name) if self.get_collection else None
            if coll is not None:
                self.flush_collection(coll)

    # ------------------------------------------------------------------ wal

    def wal_handle(self, name: str) -> WalHandle:
        return WalHandle(self, name)

    def wal(self, name: str):
        with self._wal_lock:
            return self._wal_locked(name)

    def _wal_locked(self, name: str):
        if name not in self._wals:
            path = self._wal_path(name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # CRC32C-framed group-commit writer (C++); exact torn-tail
            # detection instead of the JSON heuristic
            self._wals[name] = native.NativeWalWriter(path)
        return self._wals[name]

    def _wal_path(self, name: str) -> str:
        return os.path.join(self.root, name, f"{name}.wal")

    def _wal_segments(self, name: str) -> list[str]:
        """Rotated (sealed) WAL segments on disk, oldest first."""
        cdir = self.collection_dir(name)
        if not os.path.isdir(cdir):
            return []
        prefix = f"{name}.wal."
        segs = []
        for fn in os.listdir(cdir):
            if fn.startswith(prefix):
                try:
                    segs.append((int(fn[len(prefix):]), os.path.join(cdir, fn)))
                except ValueError:
                    continue
        return [p for _n, p in sorted(segs)]

    def rotate_wal(self, name: str) -> list[str]:
        """Seal the live WAL segment and start a fresh one; returns every
        sealed segment now on disk (oldest first), for deletion once the
        snapshot that covers them is durable.

        MUST be called with the collection's write lock held so no append
        is in flight: the flush contract is snapshot ⊇ sealed segments, and
        that only holds if rotation happens at a quiescent point. This
        replaces in-place truncation, which lost any write acknowledged
        between snapshot and truncate (the reference shares that window —
        manager.go:267-351 vs :488-507; we close it)."""
        with self._wal_lock:
            w = self._wals.pop(name, None)
            if w is not None and hasattr(w, "close"):
                w.close()  # drains the group-commit queue; all records durable
            live = self._wal_path(name)
            if os.path.exists(live):
                existing = self._wal_segments(name)
                next_gen = 1
                if existing:
                    last = os.path.basename(existing[-1])
                    next_gen = int(last.rsplit(".", 1)[1]) + 1
                os.replace(live, f"{live}.{next_gen}")
        return self._wal_segments(name)

    # ---------------------------------------------------------------- paths

    def collection_dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def list_collections(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, d, "config.json"))
        )

    # ---------------------------------------------------------------- flush

    def save_config(self, cfg: CollectionConfig) -> None:
        cdir = self.collection_dir(cfg.name)
        os.makedirs(cdir, exist_ok=True)
        safe_write_file(os.path.join(cdir, "config.json"), cfg.to_json())

    def load_config(self, name: str) -> CollectionConfig:
        with open(os.path.join(self.collection_dir(name), "config.json"), "rb") as f:
            return CollectionConfig.from_json(f.read())

    def flush_collection(self, collection) -> None:
        """Snapshot a collection (reference FlushCollection,
        manager.go:267-351): vectors.parquet (JSON fallback) + config.json.
        Serialized per collection: concurrent flushes (background loop +
        explicit backup) share tmp paths and would interleave writes.

        Durability protocol (closes the reference's snapshot→truncate loss
        window): under the COLLECTION write lock, seal the live WAL into a
        rotated segment and capture the store snapshot — so the snapshot
        provably covers everything in the sealed segments, and any write
        that lands during the (slow) disk phase goes to the fresh live
        segment, which is never deleted. Sealed segments are removed only
        after the snapshot files are durably written; on any failure they
        stay and replay on load."""
        name = collection.name
        with self._wal_lock:
            lock = self._flush_locks.setdefault(name, threading.Lock())
        wlock = getattr(collection, "write_lock", None) or contextlib.nullcontext()
        with lock:
            with wlock:
                sealed = self.rotate_wal(name)
                ids, vectors, metadatas = collection.store.snapshot()
                topo = self._capture_topology(collection)
            self._write_snapshot(collection, ids, vectors, metadatas, topo)
            for seg in sealed:
                try:
                    os.remove(seg)
                except FileNotFoundError:
                    pass

    def _write_snapshot(self, collection, ids, vectors, metadatas, topo) -> None:
        name = collection.name
        cdir = self.collection_dir(name)
        os.makedirs(cdir, exist_ok=True)
        pq_path = os.path.join(cdir, "vectors.parquet")
        try:
            write_vectors_parquet(pq_path, ids, vectors, metadatas)
            # a stale JSON fallback from an earlier failure would shadow
            # fresher parquet data on load — remove it
            try:
                os.remove(os.path.join(cdir, "vectors.json"))
            except FileNotFoundError:
                pass
        except Exception as e:
            qlog.warn("parquet write failed; falling back to JSON",
                      collection=name, error=str(e))
            write_vectors_json(os.path.join(cdir, "vectors.json"),
                               ids, vectors, metadatas)
        self.save_config(
            CollectionConfig(
                name=name,
                dimension=collection.dim,
                distance_func=collection.metric.value,
                created_at=collection.created_at,
                facet_fields=collection.get_facet_fields(),
                engine=getattr(collection, "engine_kind", ""),
                engine_config=getattr(collection, "engine_config_json", {}),
            )
        )
        self._write_topology(topo, cdir)

    def _capture_topology(self, collection):
        """Capture the topology sidecar payload (CSR graph arrays + the
        snapshot's slot map) consistently with the snapshot — caller holds
        the collection write lock. Load skips the graph rebuild (the
        reference always rebuilds — SURVEY.md §5.4)."""
        engine = getattr(collection, "engine", None)
        data = None
        if engine is not None and hasattr(engine, "export_topology"):
            data = engine.export_topology()
        if data is None:
            return None
        data = dict(data)
        data["snapshot_slots"] = collection.store.live_slots()
        snap_ids, _, _ = collection.store.snapshot()
        data["snapshot_ids"] = np.asarray(snap_ids, dtype=object).astype(str)
        return data

    def _write_topology(self, data, cdir: str) -> None:
        topo_path = os.path.join(cdir, "topology.npz")
        if data is None:
            try:
                os.remove(topo_path)
            except FileNotFoundError:
                pass
            return
        tmp = topo_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, topo_path)

    def load_topology(self, name: str):
        """-> dict of arrays or None."""
        topo_path = os.path.join(self.collection_dir(name), "topology.npz")
        if not os.path.exists(topo_path):
            return None
        try:
            with np.load(topo_path) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:
            qlog.warn("topology sidecar unreadable; will rebuild",
                      collection=name, error=str(e))
            return None

    # ----------------------------------------------------------------- load

    def load_collection_data(self, name: str):
        """-> (ids, vectors, metadatas) merged snapshot + WAL replay
        (reference LoadCollection, manager.go:354-425). WAL wins over the
        snapshot; deletes are honored."""
        cdir = self.collection_dir(name)
        pq_path = os.path.join(cdir, "vectors.parquet")
        js_path = os.path.join(cdir, "vectors.json")
        ids: list[str] = []
        vectors = np.zeros((0, 0), np.float32)
        metadatas: list[Optional[dict]] = []
        if os.path.exists(pq_path):
            try:
                ids, vectors, metadatas = read_vectors_parquet(pq_path)
            except Exception as e:
                qlog.warn("parquet read failed; trying JSON",
                          collection=name, error=str(e))
                if os.path.exists(js_path):
                    ids, vectors, metadatas = read_vectors_json(js_path)
        elif os.path.exists(js_path):
            ids, vectors, metadatas = read_vectors_json(js_path)

        # replay sealed segments (crash-leftovers from an interrupted
        # flush), oldest first, then the live segment — entries are ordered
        wal_paths = self._wal_segments(name) + [self._wal_path(name)]
        wal_paths = [p for p in wal_paths if os.path.exists(p)]
        if wal_paths:
            by_id = {i: (v, m) for i, v, m in zip(ids, vectors, metadatas)}
            for wal_path in wal_paths:
                for entry in read_wal_any(wal_path):
                    et = entry.get("type")
                    vid = entry.get("vector_id")
                    if et == "add" and "vector" in entry:
                        by_id[vid] = (
                            np.asarray(entry["vector"], np.float32),
                            entry.get("metadata"),
                        )
                    elif et == "delete":
                        by_id.pop(vid, None)
            ids = list(by_id.keys())
            if ids:
                vectors = np.stack([by_id[i][0] for i in ids])
                metadatas = [by_id[i][1] for i in ids]
            else:
                vectors = np.zeros((0, vectors.shape[1] if vectors.ndim == 2 else 0), np.float32)
                metadatas = []
        return ids, vectors, metadatas

    # --------------------------------------------------------- backup/restore

    def backup(self, dest: str) -> None:
        """Recursive copy of the storage tree, skipping WALs
        (reference backupDirectory, manager.go:510-586). Call flush first."""
        os.makedirs(dest, exist_ok=True)
        for dirpath, _dirnames, filenames in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            out_dir = os.path.join(dest, rel) if rel != "." else dest
            os.makedirs(out_dir, exist_ok=True)
            for fn in filenames:
                # skip live WALs, sealed segments (<name>.wal.N), and temps
                if ".wal" in fn or fn.endswith(".tmp"):
                    continue
                shutil.copy2(os.path.join(dirpath, fn), os.path.join(out_dir, fn))

    def restore(self, src: str) -> None:
        """Replace the storage tree with a backup (reference RestoreDatabase,
        db.go:462-520)."""
        if not os.path.isdir(src):
            raise FileNotFoundError(f"backup directory not found: {src}")
        # drop cached WAL writers BEFORE the tree goes away: a writer kept
        # across the rmtree holds an fd to an unlinked inode — post-restore
        # appends would be journaled into nothing and lost on crash
        with self._wal_lock:
            writers = list(self._wals.values())
            self._wals.clear()
        for w in writers:
            if hasattr(w, "close"):
                w.close()
        if os.path.isdir(self.root):
            shutil.rmtree(self.root)
        shutil.copytree(src, self.root)

    def delete_collection_dir(self, name: str) -> None:
        with self._wal_lock:
            w = self._wals.pop(name, None)
        if w is not None and hasattr(w, "close"):
            w.close()
        cdir = self.collection_dir(name)
        if os.path.isdir(cdir):
            shutil.rmtree(cdir)
