"""HNSW engine — a fixed-degree CSR graph per layer on the device, batched
build and query (PyTorch port of ``quiver_tpu/index/hnsw.py``).

* adjacency is a fixed-degree matrix per layer (i32[rows, deg], -1 padded)
  on the store's device next to the vector matrix, with a host mirror
  fetched lazily (:class:`_Layer`);
* queries run as one batched beam search (``ops/hnsw_kernels.py``) after a
  greedy descent through the upper layers;
* construction is level-synchronous and batched: a whole insert batch
  takes its candidates from an exact masked scan of each level it joins,
  selects with the occlusion heuristic and commits forward and reverse
  edges on the device (:func:`_fused_build_step`);
* levels come from a seeded ``numpy.random.default_rng`` (geometric,
  p=0.25, capped at 16), so builds are reproducible and both packages give
  a node the same level;
* deletes are tombstones (the store's valid mask) with entry-point
  re-election; queries that come back short are supplemented from the
  exact scan;
* the phases of a search and the stages of a build are spans of the
  port's tracer (``utils/profiling.trace_span``), and ``search_slots``
  keeps counters (``get_detailed_metrics()["search"]``).

The topology sidecar (:meth:`HNSWIndex.export_topology` /
:meth:`HNSWIndex.import_topology`) has the reference's format, so either
package reads the other's ``topology.npz``.

What changes against the reference, each with the lines it replaces:

* the construction scan is exact: the port's ``flat_scan_topk`` has no
  ``approx_max_k`` (``_fused_build_step``'s ``approx``, ``:145-149``), so
  ``HNSWConfig.build_approx`` is accepted and ignored (the candidates are
  then at least as good as the reference's);
* ``_pad_batch_pow2`` (``:61-69``; its uses ``:887``, ``:909``) and the
  pow2 padding of the insert batch and of each level's sub-batch
  (``:579``, ``:596-602``, ``:611-616``) exist for XLA's static shapes: the
  port runs each level on exactly its members, which gives the same graph
  (a padded row never connects). The pow2 row capacity of a layer's
  device adjacency (``_row_capacity``) stays: it keeps the rows an insert
  appends from reallocating the adjacency on every batch;
* the pow2 padding of the pending pos-map scatter (``:370-380``) and
  ``jax.jit``'s buffer donation (``:80``): the port scatters exactly the
  pending rows, and :func:`~quiver_tpu_torch.ops.hnsw_kernels.connect_level`
  returns new tensors;
* the host fetch helper (``utils/transfer.py``; ``:916``): one ``.cpu()``.

The device adjacency is int32 as in the reference; the pos maps on the
device are int64 (they index). Results are int64 slots.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.query import query_rows, supplement
from quiver_tpu_torch.ops.hnsw_kernels import (
    beam_max_iters,
    beam_search,
    connect_level,
    descend,
    pairwise_block,
    select_neighbors,
)
from quiver_tpu_torch.ops.scan import (
    MASKED_DIST,
    SINGLE_SHOT_BUDGET_BYTES,
    flat_scan_topk,
)
from quiver_tpu_torch.utils.profiling import trace_span

#: :meth:`HNSWIndex.search_slots`' counters (``get_detailed_metrics()["search"]``)
_SEARCH_COUNTERS = ("calls", "queries", "exact_route_calls", "underfill_calls",
                    "underfill_rows", "beam_loops", "beam_iters", "descent_steps")


def _pad_rows_to(arr: np.ndarray, rows: int, fill: int = -1) -> np.ndarray:
    """``arr`` with ``rows`` rows, the new ones ``fill``."""
    if arr.shape[0] == rows:
        return arr
    out = np.full((rows,) + arr.shape[1:], fill, arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _pow2(n: int, lo: int = 8) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _wait(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op off CUDA), so that a
    build stage's span holds the device time of its own work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fused_build_step(
    q,  # f32[B, d] insert batch
    slots,  # i64[B] store slots
    levels,  # i64[B] sampled levels
    view,  # the store's device view
    c_adjs, c_fills, c_poss,  # connect layers, top-down .. level 0
    *,
    metric, efc, compute_dtype,
    b_ls,  # the member count of each connect layer
    u_budgets, e_budget, tile,
    keep_pruned=True,
):
    """One insert batch's device work (``:82-172``): the batch sorts by
    level (descending, stable), so the members of level l are a prefix; per
    connected level, an exact masked scan of the level's nodes for
    candidates (depth ~3x the degree), the occlusion selection, and the
    forward/reverse commit with the overflow re-selection
    (``connect_level``). Each stage of each level is a span under the
    caller's ``hnsw.build``: ``hnsw.build.scan``, ``hnsw.build.select``,
    ``hnsw.build.connect``, ``n`` the level's members, each ending in a wait
    for the device. Returns (adjs, fills, spill i64[] on the device,
    changed-row masks)."""
    order = torch.argsort(-levels, stable=True)
    q_s, slots_s, levels_s = q[order], slots[order], levels[order]
    out_adjs, out_fills, out_changed = [], [], []
    spill = torch.zeros((), dtype=torch.int64, device=q.device)
    for adj, fill, pos, b_l, u_b in zip(c_adjs, c_fills, c_poss, b_ls, u_budgets):
        q_l, slots_l = q_s[:b_l], slots_s[:b_l]
        deg = adj.shape[1]
        kc = min(max(efc, deg), _pow2(3 * deg, lo=32))
        with trace_span("hnsw.build.scan", b_l):
            eligible = (pos >= 0) & view.valid
            cand_d, cand_i = flat_scan_topk(
                q_l, view.vectors, eligible, None, view.norms_sq, view.inv_norms,
                metric=metric, k=kc + 1, tile=tile, compute_dtype=compute_dtype,
            )
            self_hit = cand_i == slots_l[:, None]
            cand_d = torch.where(self_hit, MASKED_DIST, cand_d)
            cand_i = torch.where(self_hit, -1, cand_i)
            _wait(q.device)
        with trace_span("hnsw.build.select", b_l):
            sel_i, _ = select_neighbors(
                q_l, cand_i, cand_d, view.vectors, metric=metric, m=deg,
                compute_dtype=compute_dtype, keep_pruned=keep_pruned,
            )
            _wait(q.device)
        with trace_span("hnsw.build.connect", b_l):
            connect = torch.ones(b_l, dtype=torch.bool, device=q.device)
            adj, fill, sp, changed = connect_level(
                adj, fill, pos, view.vectors, slots_l, connect, sel_i,
                metric=metric, u_budget=u_b, e_budget=e_budget,
                compute_dtype=compute_dtype, keep_pruned=keep_pruned,
            )
            _wait(q.device)
        out_adjs.append(adj)
        out_fills.append(fill)
        out_changed.append(changed)
        spill = spill + sp
    return out_adjs, out_fills, spill, out_changed


@dataclass
class HNSWConfig:
    """Defaults mirror the reference (hnsw.go:16-25, 219-250)."""

    m: int = 16  # upper-layer degree
    m0: int = 32  # layer-0 degree (2*M)
    ef_construction: int = 200
    ef_search: int = 100
    max_level: int = 16
    level_prob: float = 0.25
    #: inserts per level-synchronous build round
    build_batch: int = 4096
    #: visited-set structure for layer-0 beam search: "ring" (a rolling
    #: window of recent ids) or "bitmap" (a per-query bitset over the
    #: capacity, the reference VisitedList's semantics)
    visited: str = "ring"
    #: the reference's recall target for its construction scan's partial
    #: top-k; the port's scan is exact, so this is accepted and ignored
    build_approx: Optional[float] = 0.95
    #: back-fill each node's remaining degree slots with the nearest
    #: candidates the diversity heuristic pruned (hnswlib/FAISS
    #: keepPrunedConnections)
    keep_pruned: bool = True
    #: product input dtype of QUERY-path distances ("float32"|"bfloat16");
    #: construction runs at the engine's ``compute_dtype``
    query_dtype: str = "float32"
    #: rebuild from the live rows once appended adjacency rows exceed this
    #: multiple of the live count (churn appends a row per reinsert)
    compact_growth: float = 4.0
    seed: int = 42


class _Layer:
    """One graph layer: compacted node list + fixed-degree adjacency.

    The adjacency lives on the device during builds: every batch replaces
    it with the result of ``connect_level``, and the host mirror is fetched
    lazily when persistence or tests read ``.adj``.
    """

    def __init__(self, deg: int, capacity: int, device: torch.device):
        self.deg = deg
        self._device = device
        self.nodes = np.zeros(0, np.int32)  # global slots, append order
        self.pos = np.full(capacity, -1, np.int32)  # global slot -> row
        self.fill = np.zeros(0, np.int16)  # per-row live-edge count (host)
        self._adj_host = np.zeros((0, deg), np.int32)
        self._host_stale = False
        self._adj_dev: Optional[torch.Tensor] = None  # i32[row_cap, deg]
        self._fill_dev: Optional[torch.Tensor] = None  # i32[row_cap]
        self._pos_dev: Optional[torch.Tensor] = None  # i64[capacity]
        self._pos_pending: list[int] = []
        self._pos_full_sync = True
        # mutated-row feed for external mirrors (the reference's sharded
        # stack scatters just these rows); None = everything is dirty
        self._dirty_rows: Optional[list] = None

    # ------------------------------------------------------- mutation feed

    def _note_rows(self, rows) -> None:
        if self._dirty_rows is not None:
            self._dirty_rows.append(np.asarray(rows, np.int64))

    def _note_changed_mask(self, mask: torch.Tensor) -> None:
        """Record a device bool[rows] changed-row mask (resolved to indices
        only when a mirror drains)."""
        if self._dirty_rows is not None:
            self._dirty_rows.append(mask)

    def drain_dirty_rows(self) -> Optional[np.ndarray]:
        """Adjacency rows mutated since the last drain; ``None`` means the
        caller must re-mirror fully. Draining arms tracking."""
        out: Optional[np.ndarray]
        if self._dirty_rows is None:
            out = None
        else:
            parts = [
                item if isinstance(item, np.ndarray)
                else np.flatnonzero(item.cpu().numpy()).astype(np.int64)
                for item in self._dirty_rows
            ]
            out = np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)
        self._dirty_rows = []
        return out

    # ------------------------------------------------------------- host side

    @property
    def adj(self) -> np.ndarray:
        """Host mirror of the adjacency (fetched from the device if stale)."""
        if self._host_stale and self._adj_dev is not None:
            self._adj_host = self._adj_dev[: len(self.nodes)].cpu().numpy()
            self.fill = (self._adj_host >= 0).sum(axis=1).astype(np.int16)
            self._host_stale = False
        return self._adj_host

    @adj.setter
    def adj(self, value: np.ndarray) -> None:
        """Host-side replacement (the import path): the device arrays are
        rebuilt from the host on next access."""
        self._adj_host = np.asarray(value, np.int32)
        self.fill = (self._adj_host >= 0).sum(axis=1).astype(np.int16)
        self._host_stale = False
        self._adj_dev = None
        self._fill_dev = None
        self._dirty_rows = None

    def add_nodes(self, slots: np.ndarray) -> None:
        base = len(self.nodes)
        self.nodes = np.concatenate([self.nodes, slots.astype(np.int32)])
        self.fill = np.concatenate([self.fill, np.zeros(len(slots), np.int16)])
        if not self._host_stale:
            self._adj_host = np.concatenate(
                [self._adj_host, np.full((len(slots), self.deg), -1, np.int32)]
            )
        self.pos[slots] = base + np.arange(len(slots), dtype=np.int32)
        self._pos_pending.extend(int(x) for x in slots)
        self._note_rows(np.arange(base, base + len(slots)))

    def grow_capacity(self, capacity: int) -> None:
        extra = capacity - len(self.pos)
        if extra > 0:
            self.pos = np.concatenate([self.pos, np.full(extra, -1, np.int32)])
            self._pos_full_sync = True
            _ = self.adj  # fetch before dropping the device copy
            self._adj_dev = None
            self._fill_dev = None
            self._dirty_rows = None

    def remove_nodes(self, slots: np.ndarray) -> None:
        # tombstone: keep the row (queries skip invalid ids via the valid
        # mask); forget the mapping so re-inserts get fresh rows
        self.pos[slots] = -1
        self._pos_pending.extend(int(x) for x in slots)

    # ----------------------------------------------------------- device side

    def _row_capacity(self, capacity: int) -> int:
        """Device adjacency rows: the store capacity, doubled as needed
        (rows are append-only: an update appends a fresh row)."""
        return _pow2(max(len(self.nodes), capacity), lo=max(capacity, 8))

    def device(self, capacity: int):
        """(adj_dev i32[row_cap, deg], pos_dev i64[capacity]), synced
        lazily."""
        row_cap = self._row_capacity(capacity)
        if self._adj_dev is not None and self._adj_dev.shape[0] < row_cap:
            _ = self.adj
            self._adj_dev = None
            self._fill_dev = None
            self._dirty_rows = None
        if self._adj_dev is None:
            self._adj_dev = torch.from_numpy(_pad_rows_to(self.adj, row_cap)).to(self._device)
            self._pos_full_sync = True
        if self._pos_dev is None or self._pos_full_sync:
            self._pos_dev = torch.from_numpy(self.pos.astype(np.int64)).to(self._device)
            self._pos_full_sync = False
            self._pos_pending.clear()
        elif self._pos_pending:
            idx = np.unique(np.asarray(self._pos_pending, np.int64))
            self._pos_dev[torch.from_numpy(idx).to(self._device)] = torch.from_numpy(
                self.pos[idx].astype(np.int64)).to(self._device)
            self._pos_pending.clear()
        return self._adj_dev, self._pos_dev

    def device_fill(self) -> torch.Tensor:
        """Device live-edge counts, aligned with ``device()``'s rows."""
        if self._fill_dev is None:
            f = np.zeros(self._adj_dev.shape[0], np.int32)
            f[: len(self.fill)] = self.fill
            self._fill_dev = torch.from_numpy(f).to(self._device)
        return self._fill_dev

    def write_rows_dev(self, rows: np.ndarray, values: torch.Tensor, counts: np.ndarray) -> None:
        """Replace whole adjacency rows on the device; the host mirror
        goes stale."""
        self.device_fill()
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self._device)
        self._adj_dev[idx] = values.to(self._adj_dev.dtype)
        self._fill_dev[idx] = torch.from_numpy(counts.astype(np.int32)).to(self._device)
        self.fill[rows] = counts.astype(np.int16)
        self._host_stale = True
        self._note_rows(rows)


class HNSWIndex:
    """Graph engine over a shared VectorStore."""

    name = "hnsw"

    def __init__(
        self,
        store: VectorStore,
        *,
        config: Optional[HNSWConfig] = None,
        compute_dtype=torch.float32,
        **cfg_overrides,
    ):
        self.store = store
        self.config = config or HNSWConfig(**cfg_overrides)
        self.compute_dtype = compute_dtype
        self.device = store.device
        cap = store.capacity
        c = self.config
        self.layer0 = _Layer(c.m0, cap, self.device)
        self.layers: list[_Layer] = []  # index l-1 == level l
        self.node_level = np.full(cap, -1, np.int16)
        self.entry_point = -1
        self.current_max_level = -1
        self._rng = np.random.default_rng(c.seed)
        self._exact = ExactIndex(store, compute_dtype=compute_dtype)
        # held across the write hooks and the device search: a search must
        # not read a layer's pos map while a write scatters into it
        self._lock = threading.RLock()
        self._dev_gen = -1
        self._graph_version = 0
        self._dev = None
        self._n_compactions = 0
        #: device running count of reverse edges dropped past the connect
        #: budgets (read only by get_detailed_metrics)
        self._spill_dev: Optional[torch.Tensor] = None
        self._search_counts = dict.fromkeys(_SEARCH_COUNTERS, 0)
        self._counts_lock = threading.Lock()

    # ------------------------------------------------------------ properties

    @property
    def size(self) -> int:
        return self.store.size

    def _metric(self) -> str:
        return self.store.metric.value

    def _query_dtype(self):
        return torch.bfloat16 if self.config.query_dtype == "bfloat16" else torch.float32

    # ------------------------------------------------------------- write API

    def on_insert(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        """Index new rows, ``build_batch`` a round: one ``hnsw.build`` span
        (``n`` the rows) over the stage spans of every round and level."""
        with self._lock, trace_span("hnsw.build", len(slots)):
            self._grow_capacity()
            bb = self.config.build_batch
            for i in range(0, len(slots), bb):
                self._insert_batch(
                    np.asarray(slots[i : i + bb], np.int64),
                    np.asarray(vectors[i : i + bb], np.float32),
                )
            self._dirty()

    def on_update(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        """Vector changed -> stale edges; delete + reinsert, as the
        reference (collection.go:417-466)."""
        with self._lock:
            self.on_delete(slots)
            self.on_insert(slots, vectors)
            self._maybe_compact()

    def on_delete(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        with self._lock:
            self.node_level[slots] = -1
            self.layer0.remove_nodes(slots)
            for layer in self.layers:
                layer.remove_nodes(slots)
            if self.entry_point in set(int(s) for s in slots):
                self._reelect_entry()
            self._dirty()
            self._maybe_compact()

    def _maybe_compact(self) -> None:
        # only once rows exceed the store capacity does the device pad grow
        live = int((self.node_level >= 0).sum())
        rows = len(self.layer0.nodes)
        if rows > self.store.capacity and rows > self.config.compact_growth * max(live, 1):
            self.rebuild()

    def rebuild(self) -> None:
        """Rebuild the graph from the store's live rows: compacts the
        append-only row space and re-derives the topology, deterministic
        given the config seed."""
        c = self.config
        cap = self.store.capacity
        self.layer0 = _Layer(c.m0, cap, self.device)
        self.layers = []
        self.node_level = np.full(cap, -1, np.int16)
        self.entry_point = -1
        self.current_max_level = -1
        self._rng = np.random.default_rng(c.seed)
        self._dev = None
        self._spill_dev = None
        self._n_compactions += 1
        self._dirty()
        live = np.flatnonzero(self.store._np_valid)
        if len(live):
            self.on_insert(live, self.store._np_vectors[live])

    def _reelect_entry(self) -> None:
        """Entry-point re-election after a delete (hnsw.go:797-830)."""
        self.entry_point = -1
        self.current_max_level = -1
        live = self.node_level >= 0
        if not live.any():
            return
        lvl = int(self.node_level[live].max())
        self.entry_point = int(np.flatnonzero(live & (self.node_level == lvl))[0])
        self.current_max_level = lvl

    def _grow_capacity(self) -> None:
        cap = self.store.capacity
        if len(self.node_level) < cap:
            self.node_level = np.concatenate(
                [self.node_level, np.full(cap - len(self.node_level), -1, np.int16)]
            )
            self.layer0.grow_capacity(cap)
            for layer in self.layers:
                layer.grow_capacity(cap)

    # ---------------------------------------------------------------- build

    def _sample_levels(self, n: int) -> np.ndarray:
        """Geometric level sampling, p per level, capped (hnsw.go:716-738)."""
        u = self._rng.random((n, self.config.max_level))
        succ = u < self.config.level_prob
        first_fail = np.argmin(succ, axis=1)
        levels = np.where(succ.all(axis=1), self.config.max_level, first_fail)
        return levels.astype(np.int16)

    def _ensure_layers(self, max_lvl: int) -> None:
        while len(self.layers) < max_lvl:
            self.layers.append(_Layer(self.config.m, self.store.capacity, self.device))

    def _layer(self, level: int) -> _Layer:
        return self.layer0 if level == 0 else self.layers[level - 1]

    def _insert_batch(self, slots: np.ndarray, vecs: np.ndarray) -> None:
        c = self.config
        levels = self._sample_levels(len(slots))
        self.node_level[slots] = levels
        top = int(levels.max(initial=0))
        self._ensure_layers(top)
        for l in range(top + 1):
            self._layer(l).add_nodes(slots[levels >= l])

        if self.entry_point < 0:
            self._bootstrap(slots, vecs, levels)
            return

        view = self.store.device_view()
        cap = self.store.capacity
        batch_max = min(top, self.current_max_level)
        c_lvls = list(range(batch_max, -1, -1))
        c_layers = [self._layer(l) for l in c_lvls]
        c_adjs, c_fills, c_poss = [], [], []
        for layer in c_layers:
            adj_dev, pos_dev = layer.device(cap)
            c_adjs.append(adj_dev)
            c_fills.append(layer.device_fill())
            c_poss.append(pos_dev)
        b_ls = [int((levels >= l).sum()) for l in c_lvls]
        # corpus rows per scan tile: the batch's score tile within the
        # scan's single-shot budget
        tile = min(cap, max(8192, SINGLE_SHOT_BUDGET_BYTES // (4 * len(slots))))
        dev = self.device
        out_adjs, out_fills, spill, out_changed = _fused_build_step(
            torch.from_numpy(vecs).to(dev),
            torch.from_numpy(slots).to(dev),
            torch.from_numpy(levels.astype(np.int64)).to(dev),
            view, c_adjs, c_fills, c_poss,
            metric=self._metric(), efc=c.ef_construction,
            compute_dtype=self.compute_dtype, b_ls=b_ls,
            # overflow rows per re-selection chunk: a batch's worth
            u_budgets=[_pow2(max(b, 64)) for b in b_ls],
            # appended sources kept per overflow row per batch: scales with
            # the layer-0 degree (the reference's ``:625-631``)
            e_budget=max(16, _pow2(c.m0 // 2, lo=16)),
            tile=tile, keep_pruned=c.keep_pruned,
        )
        for layer, adj_new, fill_new, changed in zip(c_layers, out_adjs, out_fills, out_changed):
            layer._note_changed_mask(changed)
            layer._adj_dev = adj_new
            layer._fill_dev = fill_new
            layer._host_stale = True
        self._spill_dev = spill if self._spill_dev is None else self._spill_dev + spill

        # entry point promotion
        best = int(levels.max(initial=-1))
        if best > self.current_max_level:
            self.entry_point = int(slots[int(np.argmax(levels))])
            self.current_max_level = best

    def _bootstrap(self, slots: np.ndarray, vecs: np.ndarray, levels: np.ndarray) -> None:
        """First batch into an empty graph: the exact kNN graph per layer."""
        view = self.store.device_view()
        for l in range(int(levels.max(initial=0)) + 1):
            layer = self._layer(l)
            members = slots[levels >= l]
            n = len(members)
            if n <= 1:
                continue
            with trace_span("hnsw.build.scan", n):
                m_vecs = torch.from_numpy(vecs[levels >= l]).to(self.device)
                dist = pairwise_block(m_vecs, m_vecs, self._metric(), self.compute_dtype)
                dist = dist + torch.where(
                    torch.eye(n, dtype=torch.bool, device=self.device), MASKED_DIST, 0.0
                )
                kk = min(layer.deg + 8, n - 1)
                # lax.top_k's tie order: the lower index first
                cand_d, idx_local = torch.sort(dist, dim=1, stable=True)
                cand_d, idx_local = cand_d[:, :kk], idx_local[:, :kk]
                cand_i = torch.from_numpy(members).to(self.device)[idx_local]
                _wait(self.device)
            with trace_span("hnsw.build.select", n):
                sel_i, _ = select_neighbors(
                    m_vecs, cand_i, cand_d, view.vectors, metric=self._metric(), m=layer.deg,
                    compute_dtype=self.compute_dtype, keep_pruned=self.config.keep_pruned,
                )
                _wait(self.device)
            with trace_span("hnsw.build.connect", n):
                layer.device(self.store.capacity)
                layer.write_rows_dev(layer.pos[members], sel_i,
                                     (sel_i >= 0).sum(dim=1).cpu().numpy())
        self.entry_point = int(slots[int(np.argmax(levels))])
        self.current_max_level = int(levels.max(initial=0))

    def _dirty(self) -> None:
        self._graph_version += 1

    def _device_graph(self):
        if self._dev is not None and self._dev_gen == self._graph_version:
            return self._dev
        layers = [
            self._layer(l).device(self.store.capacity)
            for l in range(self.current_max_level, 0, -1)
        ]
        adj0, pos0 = self.layer0.device(self.store.capacity)
        self._dev = (layers, adj0, pos0)
        self._dev_gen = self._graph_version
        return self._dev

    # ----------------------------------------------------------- tunables

    def get_optimization_parameters(self) -> dict:
        """Tunables surface (reference GetOptimizationParameters,
        pkg/hnsw/adapter.go:175-190)."""
        c = self.config
        return {
            "ef_search": c.ef_search,
            "ef_construction": c.ef_construction,
            "m": c.m,
            "m0": c.m0,
            "visited": c.visited,
            "query_dtype": c.query_dtype,
        }

    def set_optimization_parameters(self, **params) -> None:
        """Query-time knobs (ef_search, visited, query_dtype) are settable
        after the build; construction parameters are immutable."""
        if "ef_search" in params:
            ef = int(params["ef_search"])
            if ef <= 0:
                raise ValueError("ef_search must be positive")
            self.config.ef_search = ef
        if "visited" in params:
            v = str(params["visited"])
            if v not in ("ring", "bitmap"):
                raise ValueError("visited must be 'ring' or 'bitmap'")
            self.config.visited = v
        if "query_dtype" in params:
            qd = str(params["query_dtype"])
            if qd not in ("float32", "bfloat16"):
                raise ValueError("query_dtype must be 'float32' or 'bfloat16'")
            self.config.query_dtype = qd
        unknown = set(params) - {"ef_search", "visited", "query_dtype"}
        if unknown:
            raise ValueError(f"immutable or unknown parameters: {sorted(unknown)}")

    def get_detailed_metrics(self) -> dict:
        """The reference's keys (GetDetailedMetrics, adapter.go:312-334),
        and ``search``: :meth:`search_slots`' counters since the engine was
        made (calls, queries, calls routed whole to the exact scan, calls
        with under-filled rows and those rows, the beam's loop iterations,
        and its useful work: each query's iterations while it was active,
        summed; the descent's steps over the upper layers, summed)."""
        with self._counts_lock:
            search = dict(self._search_counts)
        return {
            "size": self.size,
            "entry_point": self.entry_point,
            "max_level": self.current_max_level,
            "layer_nodes": [len(self.layer0.nodes)] + [len(l.nodes) for l in self.layers],
            "reverse_edges_spilled": 0 if self._spill_dev is None else int(self._spill_dev),
            "compactions": self._n_compactions,
            "search": search,
            "device_bytes": self.device_bytes(),
            "config": self.get_optimization_parameters(),
        }

    def _count(self, **counts: int) -> None:
        with self._counts_lock:
            for key, v in counts.items():
                self._search_counts[key] += v

    def device_bytes(self) -> dict:
        """Device footprint: the adjacency layers, their pos maps and fill
        counts and the spill counter (the engine's own, the store excluded),
        and the store's synced view."""
        from quiver_tpu_torch.utils.memory import device_bytes, store_device_bytes

        own = device_bytes(self, skip=(VectorStore,))
        st = store_device_bytes(self.store)
        n = max(self.size, 1)
        return {"engine": own, "store": st, "total": own + st,
                "per_vector": round((own + st) / n, 1)}

    # ---------------------------------------------------------- persistence

    def export_topology(self) -> Optional[dict]:
        """CSR arrays for the topology sidecar (slot-addressed)."""
        if self.entry_point < 0:
            return None
        out = {
            "format_version": np.int64(1),
            "entry_point": np.int64(self.entry_point),
            "max_level": np.int64(self.current_max_level),
            "node_level": self.node_level.copy(),
            "layer0_nodes": self.layer0.nodes.copy(),
            "layer0_adj": self.layer0.adj.copy(),
            "n_layers": np.int64(len(self.layers)),
        }
        for li, layer in enumerate(self.layers):
            out[f"layer{li + 1}_nodes"] = layer.nodes.copy()
            out[f"layer{li + 1}_adj"] = layer.adj.copy()
        return out

    def import_topology(self, data: dict, slot_remap: np.ndarray) -> None:
        """Restore a topology sidecar. ``slot_remap[old_slot]`` is the new
        store slot (-1 if that vector no longer exists); edges to dropped
        vectors become -1."""
        slot_remap = np.asarray(slot_remap, np.int64)

        def remap_ids(arr):
            arr = np.asarray(arr, np.int64)
            out = np.where(
                (arr >= 0) & (arr < len(slot_remap)),
                slot_remap[np.clip(arr, 0, len(slot_remap) - 1)],
                -1,
            )
            return out.astype(np.int32)

        cap = self.store.capacity
        self._grow_capacity()
        old_levels = np.asarray(data["node_level"])
        self.node_level[:] = -1
        old_slots = np.flatnonzero(old_levels >= 0)
        old_slots = old_slots[old_slots < len(slot_remap)]
        new_slots = slot_remap[old_slots]
        live = new_slots >= 0
        self.node_level[new_slots[live]] = old_levels[old_slots[live]]

        def load_layer(layer: _Layer, nodes, adj):
            nodes_new = remap_ids(nodes)
            keep = nodes_new >= 0
            layer.nodes = nodes_new[keep]
            layer.adj = remap_ids(adj)[keep]
            layer.pos = np.full(cap, -1, np.int32)
            layer.pos[layer.nodes] = np.arange(len(layer.nodes), dtype=np.int32)
            # layer0 is reused: drop its cached device pos map too
            layer._pos_dev = None
            layer._pos_full_sync = True
            layer._pos_pending.clear()

        load_layer(self.layer0, data["layer0_nodes"], data["layer0_adj"])
        self.layers = []
        for li in range(int(data["n_layers"])):
            layer = _Layer(self.config.m, cap, self.device)
            load_layer(layer, data[f"layer{li + 1}_nodes"], data[f"layer{li + 1}_adj"])
            self.layers.append(layer)
        old_ep = int(data["entry_point"])
        ep = int(slot_remap[old_ep]) if 0 <= old_ep < len(slot_remap) else -1
        if ep >= 0 and self.node_level[ep] >= 0:
            self.entry_point = ep
            self.current_max_level = int(data["max_level"])
        else:
            self._reelect_entry()
        self._dirty()

    # ---------------------------------------------------------------- query

    def search_device(self, queries: torch.Tensor, ef: int, *, stats: Optional[dict] = None):
        """Device serving path: f32[B, d] queries on the store's device in,
        the layer-0 beam (dist f32[B, ef], slot i64[B, ef]) out, after the
        greedy descent through the upper layers. Needs a non-empty graph.
        Two spans: ``hnsw.descent`` (``n`` the queries; on the card the
        descent kernel's launch) and ``hnsw.beam`` (``n`` the beam's loop
        iterations; on the card it ends on the read of that count, so it
        holds both kernels' device time). ``stats``, when given, receives
        ``beam_search``'s counters and ``descend``'s ``descent_steps``."""
        if queries.device != self.device:
            raise ValueError(f"queries on {queries.device}, index on {self.device}")
        stats = {} if stats is None else stats
        with self._lock:
            with trace_span("hnsw.descent", queries.shape[0]):
                view = self.store.device_view()
                entries = torch.full((queries.shape[0],), self.entry_point, dtype=torch.int64,
                                     device=self.device)
                layers, adj0, pos0 = self._device_graph()
                qdt = self._query_dtype()
                entries = descend(queries, entries, view.vectors, view.valid, layers,
                                  metric=self._metric(), compute_dtype=qdt, stats=stats)
            with trace_span("hnsw.beam") as beam:
                out = beam_search(
                    queries, entries, view.vectors, view.valid, adj0, pos0,
                    metric=self._metric(), ef=ef, max_iters=beam_max_iters(ef),
                    compute_dtype=qdt, visited=self.config.visited, stats=stats,
                )
                beam.n = stats["loops"]
            return out

    def search_slots(
        self,
        queries,
        k: int,
        *,
        mask=None,
        negative=None,
        negative_weight: float = 0.5,
        exact: bool = False,
    ):
        """Batched ANN query. Masked, forced-exact and small-store searches
        delegate to the exact scan over the same store.

        Its phases are spans (``utils/profiling.trace_span``), one after
        the other under ``hnsw.search``: ``hnsw.copy_in`` (the queries to
        the device), ``hnsw.descent`` and ``hnsw.beam`` (:meth:`search_device`),
        ``hnsw.results`` (the wait for the device and the copies out; ``n``
        the beam's useful work, each query's iterations while it was
        active, summed on the device and copied out after the results in
        one copy with the descent's steps, summed),
        ``hnsw.finish`` (the negative rerank, the under-fill test and
        supplement); ``hnsw.exact`` wherever the exact scan answers for the
        engine, ``n`` being the rows it answered."""
        with trace_span("hnsw.search") as span:
            with trace_span("hnsw.copy_in") as copy_in:
                q = query_rows(queries)
                span.n = copy_in.n = B = q.shape[0]
                routed = (
                    exact
                    or mask is not None
                    or self.entry_point < 0
                    or self.store.size <= max(self.config.m0, 2 * k)
                )
                if not routed:
                    q_dev = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
            if routed:
                self._count(calls=1, queries=B, exact_route_calls=1)
                with trace_span("hnsw.exact", B):
                    return self._exact.search_slots(
                        q, k, mask=mask, negative=negative, negative_weight=negative_weight,
                    )
            retrieve_k = k if negative is None else min(max(2 * k, 30), self.store.size)
            ef = max(self.config.ef_search, retrieve_k)
            stats = {}
            bd, bi = self.search_device(q_dev, ef, stats=stats)
            with trace_span("hnsw.results", B) as results:
                sums = torch.stack([stats["iters"].sum(), stats["descent_steps"].sum()])
                if negative is None:
                    dist, idx = bd[:, :k].cpu().numpy(), bi[:, :k].cpu().numpy()
                beam_iters, descent_steps = sums.cpu().tolist()
                results.n = beam_iters
            with trace_span("hnsw.finish", B):
                if negative is not None:
                    bd, bi = self._exact.rerank_negative(
                        q, bd[:, :retrieve_k], bi[:, :retrieve_k], negative,
                        negative_weight, k,
                    )
                    dist, idx = bd[:, :k].cpu().numpy(), bi[:, :k].cpu().numpy()

                # under-fill supplement (hnsw.go:676-710): fewer than k live
                # results (deletes can disconnect the graph) merge in an
                # exact scan
                def exact_scan(n_short):
                    with trace_span("hnsw.exact", n_short):
                        return self._exact.search_slots(
                            q, k, negative=negative, negative_weight=negative_weight
                        )

                dist, idx, n_short = supplement(dist, idx, k, self.store.size, exact_scan)
            self._count(calls=1, queries=B, underfill_calls=int(n_short > 0),
                        underfill_rows=n_short, beam_loops=stats["loops"],
                        beam_iters=beam_iters, descent_steps=descent_steps)
            return dist, idx
