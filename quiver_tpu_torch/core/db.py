"""DB — collection registry, cross-collection ops, persistence wiring.

Parity with the reference's ``core.DB`` (reference: pkg/core/db.go:96-868):
options with validation and defaults (db.go:31-79), collection lifecycle with
persisted ``config.json`` (db.go:293-403), startup load (db.go:150-206),
batch ops (db.go:619-845), backup/restore (db.go:462-520), close-with-flush
(db.go:277-290). The distance function is persisted as an enum string —
fixing the reference's %p-formatted function-pointer identification
(db.go:326-334) and its hardcoded-"cosine" reload bug (db.go:266-270).

PyTorch port of ``quiver_tpu/core/db.py``. ``DBOptions`` gains ``device``
("cuda" by default): every collection's store and engine live there, and a
CUDA device with no card raises when the DB is made (``core/store.py``'s
``resolve_device``); the tests pass "cpu". ``compute_dtype`` keeps its
strings and maps them to torch dtypes. At the defaults (engine "hybrid",
"float32") a collection is served by the hybrid engine over an IVF engine
with f32 blocks, as in the reference. The storage directory's files are the
reference's (``persistence/manager.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from quiver_tpu_torch.core.collection import Collection
from quiver_tpu_torch.core.store import resolve_device
from quiver_tpu_torch.index import make_engine, resolve_engine_config
from quiver_tpu_torch.observability import logging as qlog
from quiver_tpu_torch.observability.metrics import global_metrics
from quiver_tpu_torch.persistence.manager import CollectionConfig, PersistenceManager
from quiver_tpu_torch.types import DistanceType, SearchRequest, SearchResponse


@dataclass
class DBOptions:
    """(reference DBOptions, pkg/core/db.go:31-79)."""

    storage_path: str = "./data"
    enable_metrics: bool = True
    enable_persistence: bool = True
    flush_interval_s: float = 300.0
    default_engine: str = "hybrid"  # exact | hnsw | hybrid
    compute_dtype: str = "float32"  # float32 | bfloat16
    #: constructor kwargs for every collection's engine; its ``"mesh"``
    #: (None | int | device names, ``parallel/sharded.resolve_mesh``)
    #: places the sharded kinds and is dropped for the others
    engine_config: dict = field(default_factory=dict)
    #: where every collection lives: "cuda" (the current card), "cuda:N"
    #: or "cpu"
    device: str = "cuda"

    def validate(self) -> None:
        if self.enable_persistence and not self.storage_path:
            raise ValueError("storage_path required when persistence is enabled")
        if self.flush_interval_s < 0:
            raise ValueError("flush_interval_s must be >= 0")
        if self.default_engine not in (
            "exact", "hnsw", "hybrid", "ivf",
            "sharded_exact", "sharded_hnsw", "sharded_hybrid",
        ):
            raise ValueError(f"unknown default_engine {self.default_engine!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")


class DB:
    """The top-level database object."""

    def __init__(self, options: Optional[DBOptions] = None):
        self.options = options or DBOptions()
        self.options.validate()
        self.device = resolve_device(self.options.device)
        self._collections: dict[str, Collection] = {}
        self._lock = threading.RLock()
        self._closed = False
        if self.options.enable_metrics:
            global_metrics().enable(True)
        self.persistence: Optional[PersistenceManager] = None
        if self.options.enable_persistence:
            self.persistence = PersistenceManager(
                self.options.storage_path,
                flush_interval_s=self.options.flush_interval_s,
                get_collection=lambda name: self._collections.get(name),
            )
            self._load_collections()
            self.persistence.start()

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        """Flush everything and stop background work (reference Close,
        db.go:277-290)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self.persistence:
                for name in self._collections:
                    self.persistence.mark_dirty(name)
                self.persistence.stop()

    def __enter__(self) -> "DB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- collections

    def _compute_dtype(self):
        return torch.bfloat16 if self.options.compute_dtype == "bfloat16" else torch.float32

    def _engine_factory(self, engine: str, engine_config: Optional[dict] = None):
        cfg = dict(self.options.engine_config)
        if not engine.startswith("sharded_"):
            cfg.pop("mesh", None)  # the DB-wide mesh places the sharded kinds only
        if engine_config:
            # per-collection JSON knobs (REST create / persisted config)
            # override the DB-wide defaults
            cfg.update(resolve_engine_config(engine, engine_config))
        cfg.setdefault("compute_dtype", self._compute_dtype())
        return lambda store: make_engine(engine, store, **cfg)

    def create_collection(
        self,
        name: str,
        dim: int,
        metric: DistanceType | str = DistanceType.COSINE,
        *,
        engine: Optional[str] = None,
        engine_config: Optional[dict] = None,
        facet_fields: Sequence[str] = (),
    ) -> Collection:
        """(reference CreateCollection, db.go:293-403). ``engine_config``
        is a JSON-safe per-collection knob dict — see
        quiver_tpu_torch.index.resolve_engine_config — persisted alongside the
        engine kind so a reload reconstructs the same tuning (e.g.
        ``{"ivf": {"recall_target": 0.95}}``)."""
        with self._lock:
            if name in self._collections:
                raise ValueError(f"collection {name!r} already exists")
            engine = engine or self.options.default_engine
            coll = Collection(
                name,
                dim,
                metric,
                facet_fields=facet_fields,
                engine_factory=self._engine_factory(engine, engine_config),
                device=self.device,
            )
            coll.engine_kind = engine
            coll.engine_config_json = dict(engine_config or {})
            self._register(coll)
            if self.persistence:
                self.persistence.save_config(
                    CollectionConfig(
                        name=name,
                        dimension=dim,
                        distance_func=coll.metric.value,
                        created_at=coll.created_at,
                        facet_fields=list(facet_fields),
                        engine=engine,
                        engine_config=dict(engine_config or {}),
                    )
                )
            return coll

    def _register(self, coll: Collection) -> None:
        self._collections[coll.name] = coll
        if self.persistence:
            coll.add_write_listener(self.persistence.mark_dirty)
            coll.wal = self.persistence.wal_handle(coll.name)

    def get_collection(self, name: str) -> Collection:
        coll = self._collections.get(name)
        if coll is None:
            raise KeyError(f"collection not found: {name}")
        return coll

    def has_collection(self, name: str) -> bool:
        return name in self._collections

    def list_collections(self) -> list[str]:
        return sorted(self._collections.keys())

    def delete_collection(self, name: str) -> None:
        with self._lock:
            if name not in self._collections:
                raise KeyError(f"collection not found: {name}")
            del self._collections[name]
            if self.persistence:
                self.persistence.delete_collection_dir(name)

    # ---------------------------------------------------------------- load

    def _load_collections(self) -> None:
        """Startup load (reference loadCollections, db.go:150-206): read each
        config.json, rebuild the collection, replay snapshot + WAL."""
        assert self.persistence is not None
        for name in self.persistence.list_collections():
            try:
                cfg = self.persistence.load_config(name)
                # honor the engine chosen at create time; pre-engine-field
                # configs fall back to the DB default (db.go:150-206 parity)
                engine_kind = cfg.engine or self.options.default_engine
                coll = Collection(
                    cfg.name,
                    cfg.dimension,
                    DistanceType.parse(cfg.distance_func),
                    facet_fields=cfg.facet_fields,
                    engine_factory=self._engine_factory(
                        engine_kind, cfg.engine_config
                    ),
                    device=self.device,
                )
                coll.engine_kind = engine_kind
                coll.engine_config_json = dict(cfg.engine_config or {})
                coll.created_at = cfg.created_at
                ids, vectors, metadatas = self.persistence.load_collection_data(name)
                rebuilt = False
                if len(ids):
                    slots = coll.load_rows(ids, vectors, metadatas)
                    topo = self.persistence.load_topology(name)
                    engine = coll.engine
                    if topo is not None and hasattr(engine, "import_topology"):
                        # remap old slot -> new slot BY VECTOR ID, so WAL
                        # deletes/adds between flushes can't skew row order
                        import numpy as np

                        snap_slots = np.asarray(topo.pop("snapshot_slots"))
                        snap_ids = [str(x) for x in topo.pop("snapshot_ids")]
                        remap = np.full(
                            int(snap_slots.max(initial=-1)) + 1, -1, np.int64
                        )
                        new_by_id = {vid: int(s) for vid, s in zip(ids, slots)}
                        for old_slot, vid in zip(snap_slots, snap_ids):
                            ns = new_by_id.get(vid)
                            if ns is not None:
                                remap[int(old_slot)] = ns
                        engine.import_topology(topo, remap)
                        # WAL-added rows aren't in the sidecar: fresh inserts
                        in_snap = set(snap_ids)
                        extra_rows = [
                            i for i, vid in enumerate(ids) if vid not in in_snap
                        ]
                        if extra_rows and hasattr(engine, "on_insert"):
                            engine.on_insert(
                                slots[extra_rows], vectors[extra_rows]
                            )
                    elif hasattr(engine, "on_insert"):
                        engine.on_insert(slots, vectors)
                        rebuilt = True
                self._register(coll)
                qlog.info("loaded collection", collection=name,
                          vectors=len(ids), topology="rebuilt" if rebuilt else "sidecar")
            except Exception as e:
                qlog.error("failed to load collection", collection=name,
                           error=str(e))

    # ------------------------------------------------------------------ ops

    def search(self, collection: str, request: SearchRequest) -> SearchResponse:
        """(reference DB.Search with latency recording, db.go:533-554)."""
        return self.get_collection(collection).search(request)

    def batch_search(
        self, collection: str, requests: Sequence[SearchRequest]
    ) -> list[SearchResponse]:
        """(reference DB.BatchSearch, db.go:707-845 — here always kernel-
        batched; no goroutine fallback tier exists or is needed)."""
        return self.get_collection(collection).search_batch(requests)

    def batch_insert(self, collection: str, ids, vectors, metadatas=None) -> None:
        self.get_collection(collection).add_batch(ids, vectors, metadatas)

    def batch_delete(self, collection: str, ids) -> int:
        return self.get_collection(collection).delete_batch(ids)

    # --------------------------------------------------------- backup/restore

    def backup(self, dest: str) -> None:
        """Flush all then copy the tree (reference BackupDatabase,
        db.go:462-487)."""
        if not self.persistence:
            raise RuntimeError("persistence is disabled")
        with self._lock:
            for coll in self._collections.values():
                self.persistence.flush_collection(coll)
            self.persistence.backup(dest)

    def restore(self, src: str) -> None:
        """Clear in-memory state, copy the backup in, reload (reference
        RestoreDatabase, db.go:490-520)."""
        if not self.persistence:
            raise RuntimeError("persistence is disabled")
        with self._lock:
            self.persistence.restore(src)
            self._collections.clear()
            self._load_collections()

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        return {
            "collections": {
                name: vars(c.stats()) for name, c in self._collections.items()
            },
            "storage_path": self.options.storage_path if self.persistence else None,
            "uptime_hint": time.time(),
        }
