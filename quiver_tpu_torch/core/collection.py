"""Collection — vectors + metadata + facets with the full search pipeline.

Parity with the reference's ``core.Collection`` (reference:
pkg/core/collection.go:98-1206): Add/AddBatch/Update/Delete, the staged search
pipeline (validate -> filter compile -> traversal -> post-filter -> assemble,
collection.go:637-807), the fluent query builder (collection.go:873-1108), and
the facet API (collection.go:1111-1206) — redesigned around one columnar store
and fused-mask kernels:

* filters compile to device bitmasks at write time (facets/columns.py), so a
  filtered search is ONE kernel call at unfiltered cost, instead of the
  reference's retrieve-searchK=Size() + per-candidate JSON unmarshal
  (collection.go:679-682, 704-753); the reference's behavior remains as the
  fallback for non-compilable filters (correctness-equal, host-side).
* batched search vectorizes same-shaped requests into one kernel launch,
  replacing goroutine-per-query fan-out (pkg/hnsw/adapter.go:238-290).

PyTorch port of ``quiver_tpu/core/collection.py``, with two changes:

* the device is explicit: ``Collection(..., device=...)`` passes it to its
  ``VectorStore``; nothing picks the CPU or the card by default (the
  database, ``core/db.py``, passes its ``DBOptions.device``);
* compiled filter masks stay numpy ``bool[cap]``; the engine moves them to
  its device.

``compute_dtype`` (``torch.float32`` or ``torch.bfloat16``) goes to the
default exact engine, as in the reference. ``wal`` is set by the database
when persistence is on (``persistence/manager.py``'s per-collection handle).
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.facets.columns import FacetColumns
from quiver_tpu_torch.facets.filters import (
    FacetFilter,
    matches_all,
    matches_request_filters,
)
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.observability.metrics import global_metrics
from quiver_tpu_torch.utils.profiling import trace_span
from quiver_tpu_torch.types import (
    DistanceType,
    Filter,
    SearchOptions,
    SearchRequest,
    SearchResponse,
    SearchResponseMetadata,
    SearchResultItem,
    VectorRecord,
    as_f32_matrix,
)

#: Max auto-tracked facet fields (bounds per-field column memory).
_MAX_AUTO_FACET_FIELDS = 64


@dataclass
class CollectionStats:
    name: str
    dimension: int
    metric: str
    vector_count: int
    capacity: int
    facet_fields: list[str]
    index: str
    created_at: float


class Collection:
    """A named set of vectors with one shared columnar store."""

    def __init__(
        self,
        name: str,
        dim: int,
        metric: DistanceType | str = DistanceType.COSINE,
        *,
        facet_fields: Iterable[str] = (),
        auto_facet_fields: bool = True,
        engine_factory: Optional[Callable[[VectorStore], Any]] = None,
        compute_dtype=torch.float32,
        device,
    ):
        if not name:
            raise ValueError("collection name must not be empty")
        self.name = name
        self.dim = int(dim)
        self.metric = DistanceType.parse(metric)
        self.created_at = time.time()
        self.store = VectorStore(dim=dim, metric=self.metric, device=device)
        self.facets = FacetColumns(self.store.capacity, facet_fields)
        self.auto_facet_fields = auto_facet_fields
        if engine_factory is None:
            engine_factory = lambda store: ExactIndex(
                store, compute_dtype=compute_dtype
            )
        self.engine = engine_factory(self.store)
        #: engine kind name (exact | hnsw | hybrid | ...), set by the DB
        #: layer; persisted in CollectionConfig so reloads reconstruct the
        #: same engine (reference persists the analogous config —
        #: db.go:380-397)
        self.engine_kind = ""
        #: JSON-safe per-collection engine knobs (set by the DB layer,
        #: persisted next to engine_kind)
        self.engine_config_json: dict = {}
        self._lock = threading.RLock()
        self._write_listeners: list[Callable[[str], None]] = []
        #: optional WAL sink (persistence.WalWriter) set by the DB layer;
        #: unlike the reference — whose main collection never WALs its writes
        #: (SURVEY.md §2.14 note) — every mutation is journaled here.
        self.wal = None

    @property
    def write_lock(self):
        """The mutation lock. The persistence manager holds it across WAL
        rotation + snapshot so the flush's durability contract (snapshot ⊇
        sealed WAL segments) holds."""
        return self._lock

    # ------------------------------------------------------------ listeners

    def add_write_listener(self, fn: Callable[[str], None]) -> None:
        """fn(collection_name) called after each mutation (persistence dirty
        marking — reference MarkCollectionDirty, manager.go:226-230)."""
        self._write_listeners.append(fn)

    def _notify_write(self) -> None:
        for fn in self._write_listeners:
            fn(self.name)

    # ---------------------------------------------------------------- write

    def add(self, vec_id: str, vector, metadata: Optional[dict] = None) -> None:
        self.add_batch([vec_id], [np.asarray(vector)], [metadata])

    def add_batch(
        self,
        ids: Sequence[str],
        vectors,
        metadatas: Optional[Sequence[Optional[dict]]] = None,
    ) -> None:
        """Validate-all-then-insert (reference AddBatch,
        collection.go:209-331)."""
        t0 = time.perf_counter()
        metrics = global_metrics()
        if metadatas is None:
            metadatas = [None] * len(ids)
        vecs = as_f32_matrix(vectors, self.dim) if len(ids) else np.zeros((0, self.dim), np.float32)
        if vecs.shape[0] != len(ids):
            raise ValueError("ids/vectors length mismatch")
        for md in metadatas:
            if md is not None and not isinstance(md, dict):
                raise ValueError("metadata must be a JSON object (dict) or None")
        with self._lock:
            try:
                slots = self.store.add_batch(ids, vecs, metadatas)
            except ValueError:
                metrics.record_error(self.name, "insert")
                raise
            self.facets.grow(self.store.capacity)
            if self.auto_facet_fields:
                self._auto_track_fields(metadatas)
            self.facets.index_rows(slots, metadatas)
            if hasattr(self.engine, "on_insert"):
                with trace_span(
                    "insert.engine", collection=self.name, batch=len(ids)
                ):
                    self.engine.on_insert(slots, vecs)
            if self.wal is not None:
                self.wal.append_many(
                    ("add", vid, vec, md)
                    for vid, vec, md in zip(ids, vecs, metadatas)
                )
        ms = (time.perf_counter() - t0) * 1e3
        if len(ids) == 1:
            metrics.record_insert(self.name, ms)
        else:
            metrics.record_batch(self.name, "batch_insert", ms)
            metrics.record_insert(self.name, ms, n=len(ids))
        metrics.set_index_size(
            self.name, self.store.size, self.store.capacity * self.dim * 4
        )
        self._notify_write()

    def load_rows(self, ids, vectors, metadatas=None) -> np.ndarray:
        """Bulk-load persisted rows WITHOUT notifying the engine or WAL —
        the startup path; the DB decides afterwards whether to import a
        topology sidecar or rebuild the index."""
        if metadatas is None:
            metadatas = [None] * len(ids)
        vecs = as_f32_matrix(vectors, self.dim)
        with self._lock:
            slots = self.store.add_batch(ids, vecs, metadatas)
            self.facets.grow(self.store.capacity)
            if self.auto_facet_fields:
                self._auto_track_fields(metadatas)
            self.facets.index_rows(slots, metadatas)
        return slots

    def _auto_track_fields(self, metadatas) -> None:
        new_fields = []
        tracked = set(self.facets.fields)
        for md in metadatas:
            if isinstance(md, dict):
                for key in md:
                    if key not in tracked and len(tracked) + len(new_fields) < _MAX_AUTO_FACET_FIELDS:
                        if key not in new_fields:
                            new_fields.append(key)
        if new_fields:
            self._ensure_fields(list(self.facets.fields) + new_fields)

    def _ensure_fields(self, fields: list[str]) -> None:
        """Configure facet fields, backfilling columns for existing rows."""
        added = self.facets.set_fields(fields)
        if added:
            live = [
                (s, self.store.metadata_of_slot(s))
                for s in range(self.store.capacity)
                if self.store.id_of(s) is not None
            ]
            if live:
                slots = [s for s, _ in live]
                mds = [m for _, m in live]
                for f in added:
                    col = self.facets.fields[f]
                    from quiver_tpu_torch.facets.columns import _field_present
                    from quiver_tpu_torch.facets.filters import extract_path

                    for slot, md in zip(slots, mds):
                        col.index_row(slot, _field_present(md, f), extract_path(md, f))

    def set_facet_fields(self, fields: Iterable[str]) -> None:
        """Reconfigure + re-index (reference SetFacetFields,
        collection.go:1111-1130)."""
        with self._lock:
            self._ensure_fields(list(fields))

    def get_facet_fields(self) -> list[str]:
        return self.facets.configured_fields()

    def update(self, vec_id: str, vector=None, metadata: Optional[dict] = None) -> None:
        self.update_batch([vec_id], None if vector is None else [vector],
                          None if metadata is None else [metadata])

    def update_batch(self, ids, vectors=None, metadatas=None) -> None:
        with self._lock:
            self.store.update_batch(ids, vectors, metadatas)
            slots = [self.store.slot_of(i) for i in ids]
            if metadatas is not None:
                if self.auto_facet_fields:
                    self._auto_track_fields(metadatas)
                self.facets.index_rows(slots, metadatas)
            if vectors is not None and hasattr(self.engine, "on_update"):
                self.engine.on_update(np.asarray(slots), as_f32_matrix(vectors, self.dim))
            if self.wal is not None:
                self.wal.append_many(
                    ("add", vid, self.store.vector_of_slot(slot),
                     self.store.metadata_of_slot(slot))
                    for vid, slot in zip(ids, slots)
                )
        self._notify_write()

    def delete(self, vec_id: str) -> bool:
        return self.delete_batch([vec_id]) == 1

    def delete_batch(self, ids: Iterable[str]) -> int:
        with self._lock:
            ids = list(ids)
            slots = [self.store.slot_of(i) for i in ids if i in self.store]
            deletable = [i for i in ids if i in self.store]
            n = self.store.delete_batch(ids)
            self.facets.clear_rows(slots)
            if hasattr(self.engine, "on_delete"):
                self.engine.on_delete(np.asarray(slots))
            if self.wal is not None:
                self.wal.append_many(
                    ("delete", vid, None, None) for vid in deletable
                )
        metrics = global_metrics()
        metrics.record_delete(self.name, n)
        metrics.set_index_size(self.name, self.store.size)
        self._notify_write()
        return n

    def get(self, vec_id: str) -> VectorRecord:
        return self.store.get(vec_id)

    @property
    def size(self) -> int:
        return self.store.size

    # ---------------------------------------------------------------- search

    def search(self, request: SearchRequest) -> SearchResponse:
        return self.search_batch([request])[0]

    def search_batch(self, requests: Sequence[SearchRequest]) -> list[SearchResponse]:
        """Vectorized batched search: same-shaped requests share one kernel
        launch (replaces goroutine fan-out, pkg/hybrid/hybrid_index.go:677)."""
        groups: dict[tuple, list[int]] = {}
        for i, req in enumerate(requests):
            key = self._group_key(req)
            groups.setdefault(key, []).append(i)
        out: list[Optional[SearchResponse]] = [None] * len(requests)
        for idxs in groups.values():
            batch = [requests[i] for i in idxs]
            for i, resp in zip(idxs, self._search_group(batch)):
                out[i] = resp
        return out  # type: ignore[return-value]

    def _group_key(self, req: SearchRequest) -> tuple:
        filt = tuple((f.field, f.operator, _hashable(f.value)) for f in req.filters)
        return (
            req.top_k,
            req.options.exact_search,
            filt,
            req.negative_example is not None,
            float(req.negative_weight),
            req.strategy,
        )

    def _search_group(self, requests: list[SearchRequest]) -> list[SearchResponse]:
        t_start = time.perf_counter()
        metrics = global_metrics()
        req0 = requests[0]
        k = req0.top_k
        if k <= 0:
            raise ValueError("top_k must be positive")
        for r in requests:
            r_vec = np.asarray(r.vector, dtype=np.float32)
            if r_vec.shape != (self.dim,):
                metrics.record_error(self.name, "search")
                raise ValueError(
                    f"query dimension mismatch: got {r_vec.shape}, want ({self.dim},)"
                )
            for f in r.filters:
                f.validate()
        B = len(requests)
        if self.store.size == 0:
            return [self._empty_response(r, t_start) for r in requests]

        queries = np.stack([np.asarray(r.vector, np.float32) for r in requests])

        # --- filter stage: compile request filters to a device mask
        t_f0 = time.perf_counter()
        mask = None
        host_filter = False
        if req0.filters:
            with trace_span("search.filter", collection=self.name):
                mask_np = self.facets.compile_request_filters(req0.filters)
            if mask_np is None:
                host_filter = True
            else:
                mask = mask_np
        filter_ms = (time.perf_counter() - t_f0) * 1e3

        negative = None
        if req0.negative_example is not None:
            negative = np.stack([
                np.asarray(r.negative_example, np.float32) for r in requests
            ])

        # --- traversal stage
        t_t0 = time.perf_counter()
        search_k = k
        if host_filter:
            # reference behavior: retrieve everything, post-filter to true
            # top-k (collection.go:679-682)
            search_k = self.store.size
        engine_kw = dict(
            mask=mask, negative=negative,
            negative_weight=req0.negative_weight,
            exact=req0.options.exact_search,
        )
        if req0.strategy is not None and hasattr(self.engine, "selector"):
            engine_kw["strategy"] = req0.strategy
        with trace_span(
            "search.traversal", collection=self.name, batch=len(requests)
        ):
            dist, slots = self._engine_search(queries, search_k, **engine_kw)
        traversal_ms = (time.perf_counter() - t_t0) * 1e3

        # --- post-filter + assemble
        t_r0 = time.perf_counter()
        responses = []
        for b, req in enumerate(requests):
            items = self._assemble(
                dist[b], slots[b], req, k, host_filter=host_filter
            )
            elapsed_ms = (time.perf_counter() - t_start) * 1e3
            responses.append(
                SearchResponse(
                    results=items,
                    metadata=SearchResponseMetadata(
                        total_count=len(items),
                        search_time_ms=elapsed_ms,
                        index_size=self.store.size,
                        index_name=self.name,
                        strategy=getattr(self.engine, "last_strategy", self.engine.name),
                    ),
                    query=queries[b],
                )
            )
        rerank_ms = (time.perf_counter() - t_r0) * 1e3
        total_ms = (time.perf_counter() - t_start) * 1e3
        for _ in requests:
            metrics.record_search(
                self.name,
                total_ms / B,
                stages={
                    "filter": filter_ms / B,
                    "traversal": traversal_ms / B,
                    "rerank": rerank_ms / B,
                },
            )
        return responses

    def _engine_search(self, queries, k, **kw):
        return self.engine.search_slots(queries, k, **kw)

    def _assemble(
        self, dist_row, slot_row, req: SearchRequest, k: int, *, host_filter: bool
    ) -> list[SearchResultItem]:
        items: list[SearchResultItem] = []
        for d, s in zip(dist_row, slot_row):
            if len(items) >= k:
                break
            s = int(s)
            if s < 0:
                continue
            vid = self.store.id_of(s)
            if vid is None:
                continue
            md = self.store.metadata_of_slot(s)
            if host_filter and not matches_request_filters(md, req.filters):
                continue
            item = SearchResultItem(id=vid, distance=float(d))
            if req.options.include_vectors:
                item.vector = self.store.vector_of_slot(s).copy()
            if req.options.include_metadata:
                # result items are caller-owned: never hand out the store's
                # live dict (same aliasing contract as VectorStore.get)
                item.metadata = copy.deepcopy(md) if md is not None else None
            items.append(item)
        return items

    def _empty_response(self, req: SearchRequest, t_start: float) -> SearchResponse:
        return SearchResponse(
            results=[],
            metadata=SearchResponseMetadata(
                total_count=0,
                search_time_ms=(time.perf_counter() - t_start) * 1e3,
                index_size=0,
                index_name=self.name,
            ),
            query=np.asarray(req.vector, np.float32),
        )

    # ---------------------------------------------------------- facet search

    def search_with_facets(
        self, query, k: int, filters: Sequence[FacetFilter]
    ) -> list[SearchResultItem]:
        """Facet-filtered search (reference SearchWithFacets,
        collection.go:1133-1206): compiled filters fuse into the kernel;
        otherwise candidates post-filter until k match."""
        if k <= 0:
            raise ValueError("top_k must be positive")
        q = as_f32_matrix(query, self.dim)
        if self.store.size == 0:
            return []
        if not filters:
            dist, slots = self._engine_search(q, k)
            return self._rows_to_items(dist[0], slots[0], k)
        mask_np = self.facets.compile_facet_filters(list(filters))
        if mask_np is not None:
            dist, slots = self._engine_search(q, k, mask=mask_np)
            return self._rows_to_items(dist[0], slots[0], k)
        # host fallback: scan everything, keep first k matching
        dist, slots = self._engine_search(q, self.store.size)
        items = []
        for d, s in zip(dist[0], slots[0]):
            if len(items) >= k:
                break
            s = int(s)
            if s < 0:
                continue
            md = self.store.metadata_of_slot(s)
            if matches_all(filters, md):
                vid = self.store.id_of(s)
                items.append(SearchResultItem(id=vid, distance=float(d)))
        return items

    def _rows_to_items(self, dist_row, slot_row, k: int) -> list[SearchResultItem]:
        items = []
        for d, s in zip(dist_row, slot_row):
            if len(items) >= k:
                break
            s = int(s)
            if s < 0:
                continue
            vid = self.store.id_of(s)
            if vid is not None:
                items.append(SearchResultItem(id=vid, distance=float(d)))
        return items

    # ----------------------------------------------------------- fluent API

    def fluent_search(self, vector) -> "FluentSearch":
        return FluentSearch(self, vector)

    # ---------------------------------------------------------------- stats

    def stats(self) -> CollectionStats:
        return CollectionStats(
            name=self.name,
            dimension=self.dim,
            metric=self.metric.value,
            vector_count=self.store.size,
            capacity=self.store.capacity,
            facet_fields=self.get_facet_fields(),
            index=getattr(self.engine, "name", "exact"),
            created_at=self.created_at,
        )


def _hashable(v: Any):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


class FluentSearch:
    """Chainable query builder (reference FluentSearch,
    collection.go:873-1108): fail-fast validation, filter ops, execution."""

    def __init__(self, collection: Collection, vector):
        self._c = collection
        self._err: Optional[str] = None
        vec = np.asarray(vector, dtype=np.float32)
        if vec.ndim != 1 or vec.shape[0] != collection.dim:
            self._err = (
                f"query dimension mismatch: got {vec.shape}, "
                f"want ({collection.dim},)"
            )
        self._vector = vec
        self._k = 10
        self._filters: list[Filter] = []
        self._opts = SearchOptions()
        self._namespace = ""
        self._negative = None
        self._negative_weight = 0.5
        self._strategy = None
        self._include_stats = False

    def with_k(self, k: int) -> "FluentSearch":
        if k <= 0:
            self._err = self._err or "k must be positive"
        self._k = k
        return self

    def _add_filter(self, field: str, op: str, value) -> "FluentSearch":
        if not field:
            self._err = self._err or "filter field must not be empty"
        self._filters.append(Filter(field, op, value))
        return self

    def filter(self, field: str, value) -> "FluentSearch":
        return self._add_filter(field, "=", value)

    def filter_not_equals(self, field: str, value) -> "FluentSearch":
        return self._add_filter(field, "!=", value)

    def filter_greater_than(self, field: str, value) -> "FluentSearch":
        return self._add_filter(field, ">", value)

    def filter_less_than(self, field: str, value) -> "FluentSearch":
        return self._add_filter(field, "<", value)

    def filter_in(self, field: str, values) -> "FluentSearch":
        return self._add_filter(field, "in", list(values))

    def include_vectors(self) -> "FluentSearch":
        self._opts.include_vectors = True
        return self

    def include_metadata(self) -> "FluentSearch":
        self._opts.include_metadata = True
        return self

    def use_exact_search(self) -> "FluentSearch":
        self._opts.exact_search = True
        return self

    def with_namespace(self, ns: str) -> "FluentSearch":
        self._namespace = ns
        return self

    def with_negative_example(self, vector) -> "FluentSearch":
        vec = np.asarray(vector, dtype=np.float32)
        if vec.shape != (self._c.dim,):
            self._err = self._err or "negative example dimension mismatch"
        self._negative = vec
        return self

    def with_negative_weight(self, w: float) -> "FluentSearch":
        self._negative_weight = float(w)
        return self

    def with_strategy(self, strategy: str) -> "FluentSearch":
        """Force exact|ann ("hnsw"/"ivf"/"ann" all force the ANN side;
        reference FluentHybridSearch.WithStrategy,
        pkg/hybrid/hybrid_index.go:814-881)."""
        if strategy not in ("exact", "hnsw", "ivf", "ann"):
            self._err = self._err or f"unknown strategy {strategy!r}"
        self._strategy = strategy
        return self

    def include_stats(self) -> "FluentSearch":
        """Attach engine stats to the response metadata (reference
        IncludeStats, hybrid_index.go:814-881)."""
        self._include_stats = True
        return self

    def execute(self) -> SearchResponse:
        if self._err:
            raise ValueError(self._err)
        if self._strategy == "exact":
            self._opts.exact_search = True
        req = SearchRequest(
            vector=self._vector,
            top_k=self._k,
            filters=self._filters,
            options=self._opts,
            namespace_id=self._namespace,
            negative_example=self._negative,
            negative_weight=self._negative_weight,
            strategy=self._strategy,
        )
        resp = self._c.search(req)
        if self._include_stats and hasattr(self._c.engine, "stats"):
            resp.metadata.engine_stats = self._c.engine.stats()
        return resp
