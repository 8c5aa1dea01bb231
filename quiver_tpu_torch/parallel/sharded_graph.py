"""HNSW over a shard list: a subgraph per shard, one merged query (PyTorch
port of ``quiver_tpu/parallel/sharded_graph.py``).

Corpus rows go round-robin to the shards; each shard owns an independent
HNSW subgraph over its rows only (its own sub-store, local slot space, the
config's seed plus the shard index), so construction needs no cross-shard
edges. A query searches every subgraph with the full ``ef`` and merges the
shards' top k (``parallel/sharded.merge_topk``).

Placement: shard ``s``'s sub-store and subgraph live on ``mesh[s]``, as
the reference ``device_put``s each shard's subgraph stack to its chip
(``sharded_graph.py:343-360, 442-444``).

The subgraphs share no edges, so the shards placed together on one device
run as ONE batched descent and beam over their concatenation
(:meth:`_stack`, one per device): each shard's local slots are offset by
``j * Lc`` (j its place in the device's group, Lc the group's largest
sub-store capacity), its adjacency rows by the rows before it, and the
batch is the group's shards x B queries, each started from its own shard's
entry point; the results split back per shard before the merge. A query
only ever reaches its own shard's nodes, and the descent and beam treat
every query row alone, so this equals one call per shard (held in the
tests) at 1/n the launches. A shard that lacks an upper level has no rows
there, so the descent keeps its entry (the reference's identity routing,
``sharded_graph.py:78-81``). Four shards on one card are one beam; four
cards run four beams, one per card, each from a thread of the engine's
pool (the beam's done test reads the card), so no card waits on another's
reads; the workers queue on the caller's current streams, and the merge
runs on the first device. One ``HNSWIndex`` call per shard
(``search_device(batched=False)``) stays only as the batched search's
parity oracle.

One lock (``_lock``, reentrant) covers the write hooks, the topology
import and every search: a search reads the subgraphs' entry points,
levels and device arrays, and the cached stack, which a write changes in
several steps (``HNSWIndex`` holds its own lock the same way).

The reference's incremental stack (``sharded_graph.py:264-452``: dirty-row
device scatters instead of an O(N) host restack and upload) becomes a
device-side concatenation of the subgraphs' own device arrays, rebuilt
when a subgraph or sub-store changed: it has no host copy to avoid, and
the sub-engines already keep their device arrays current incrementally.

Masked, forced-exact and under-filled queries fall back to the sharded
exact scan over the main store; the negative rerank runs over the shards
(``parallel/sharded.sharded_negative_rerank``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
from quiver_tpu_torch.index.query import query_rows, supplement
from quiver_tpu_torch.ops.hnsw_kernels import beam_max_iters, beam_search, descend
from quiver_tpu_torch.ops.scan import MASKED_DIST
from quiver_tpu_torch.parallel.sharded import (
    MeshLike,
    ShardedExactIndex,
    distinct,
    merge_topk,
    resolve_mesh,
)


class ShardedHNSWIndex:
    """Engine protocol over per-shard HNSW subgraphs
    (``sharded_graph.py:137-608``). ``mirrors_of`` names an exact engine
    over the same store and mesh whose row mirrors the exact fallback reads
    (a hybrid's exact side)."""

    name = "sharded_hnsw"

    def __init__(
        self,
        store: VectorStore,
        mesh: MeshLike = None,
        *,
        config: Optional[HNSWConfig] = None,
        compute_dtype=torch.float32,
        mirrors_of: Optional[ShardedExactIndex] = None,
        **cfg_overrides,
    ):
        self.store = store
        self.mesh = resolve_mesh(mesh, store.device)
        self.device = self.mesh[0]
        self.n = len(self.mesh)
        #: device -> the shards on it, in mesh order (one stacked beam each)
        self._groups = {dev: [s for s in range(self.n) if self.mesh[s] == dev]
                        for dev in distinct(self.mesh)}
        self.config = config or HNSWConfig(**cfg_overrides)
        self.compute_dtype = compute_dtype
        self._sub_stores = [VectorStore(store.dim, store.metric, device=dev)
                            for dev in self.mesh]
        self._subs = [
            HNSWIndex(s, config=dataclasses.replace(self.config, seed=self.config.seed + i),
                      compute_dtype=compute_dtype)
            for i, s in enumerate(self._sub_stores)
        ]
        self._owner = np.full(store.capacity, -1, np.int16)
        self._local_slot = np.full(store.capacity, -1, np.int64)
        self._l2g = [np.full(s.capacity, -1, np.int64) for s in self._sub_stores]
        self._rr = 0  # round-robin cursor
        self._exact = ShardedExactIndex(store, self.mesh, compute_dtype=compute_dtype,
                                        mirrors_of=mirrors_of)
        # device -> its group's stack and the signature it was made at;
        # None (or a missing device) restacks
        self._stacked: Optional[dict] = None
        self._stack_sig: Optional[dict] = None
        # writes and searches (module doc); reentrant: search_slots holds it
        # across search_device
        self._lock = threading.RLock()
        # one thread per device group, made at the first search over
        # several devices (:meth:`_query_batched`)
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def size(self) -> int:
        return self.store.size

    def _metric(self) -> str:
        return self.store.metric.value

    def _grow_maps(self) -> None:
        extra = self.store.capacity - len(self._owner)
        if extra > 0:
            self._owner = np.concatenate([self._owner, np.full(extra, -1, np.int16)])
            self._local_slot = np.concatenate([self._local_slot, np.full(extra, -1, np.int64)])

    def _add_to_shard(self, s: int, g: np.ndarray, vecs: np.ndarray) -> np.ndarray:
        """Add global slots ``g`` to shard s's sub-store; returns their
        local slots."""
        sub_store = self._sub_stores[s]
        local = sub_store.add_batch([str(int(x)) for x in g], vecs)
        if len(self._l2g[s]) < sub_store.capacity:
            self._l2g[s] = np.concatenate([
                self._l2g[s], np.full(sub_store.capacity - len(self._l2g[s]), -1, np.int64),
            ])
        self._l2g[s][local] = g
        self._owner[g] = s
        self._local_slot[g] = local
        return local

    # ------------------------------------------------------------- write API

    def on_insert(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        vectors = np.asarray(vectors, np.float32)
        with self._lock:
            self._grow_maps()
            shard_of = (self._rr + np.arange(len(slots))) % self.n
            self._rr = (self._rr + len(slots)) % self.n
            for s in range(self.n):
                pick = shard_of == s
                if pick.any():
                    local = self._add_to_shard(s, slots[pick], vectors[pick])
                    self._subs[s].on_insert(local, vectors[pick])

    def on_update(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        vectors = np.asarray(vectors, np.float32)
        with self._lock:
            for s in range(self.n):
                pick = self._owner[slots] == s
                if not pick.any():
                    continue
                g = slots[pick]
                self._sub_stores[s].update_batch([str(int(x)) for x in g], vectors[pick])
                self._subs[s].on_update(self._local_slot[g], vectors[pick])

    def on_delete(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        with self._lock:
            for s in range(self.n):
                pick = self._owner[slots] == s
                if not pick.any():
                    continue
                g = slots[pick]
                local = self._local_slot[g]
                self._subs[s].on_delete(local)
                self._sub_stores[s].delete_batch([str(int(x)) for x in g])
                self._l2g[s][local] = -1
                self._owner[g] = -1
                self._local_slot[g] = -1

    # -------------------------------------------------------------- stacking

    def _stack(self, dev):
        """The subgraphs of the shards on ``dev`` concatenated there:
        (entries i64[g], vectors f32[g*Lc, d], valid bool[g*Lc], l2g
        i64[g*Lc], upper layers [(adj, pos)] top-down, adj0, pos0) for the
        group's g shards; ids offset per shard as the module doc says.
        Rebuilt when a subgraph or sub-store of the group changed. The
        caller holds ``_lock``."""
        group = self._groups[dev]
        subs = [self._subs[s] for s in group]
        views = [self._sub_stores[s].device_view() for s in group]
        l2gs = [self._l2g[s] for s in group]
        sig = tuple(
            (sub._graph_version, sub.entry_point, v.generation, v.capacity, len(l2g))
            for sub, v, l2g in zip(subs, views, l2gs)
        )
        if self._stacked is None or self._stack_sig is None:
            self._stacked, self._stack_sig = {}, {}
        if dev in self._stacked and sig == self._stack_sig[dev]:
            return self._stacked[dev]
        g, d = len(group), self.store.dim
        Lc = max(v.capacity for v in views)
        vecs = torch.zeros(g * Lc, d, device=dev)
        valid = torch.zeros(g * Lc, dtype=torch.bool, device=dev)
        l2g = np.full(g * Lc, -1, np.int64)
        entries = np.full(g, -1, np.int64)
        graphs = []
        for j, (sub, v, sl2g) in enumerate(zip(subs, views, l2gs)):
            vecs[j * Lc: j * Lc + v.capacity] = v.vectors
            valid[j * Lc: j * Lc + v.capacity] = v.valid
            m = min(len(sl2g), v.capacity)
            l2g[j * Lc: j * Lc + m] = sl2g[:m]
            if sub.entry_point >= 0:
                entries[j] = sub.entry_point + j * Lc
            graphs.append(sub._device_graph() if sub.entry_point >= 0 else ([], None, None))
        max_level = max(sub.current_max_level for sub in subs)

        def cat_level(parts):
            """One level's (adj, pos) over the group; ``parts[j]`` is the
            shard's (adj, pos) or None where it lacks the level."""
            adjs = []
            pos = torch.full((g * Lc,), -1, dtype=torch.int64, device=dev)
            row0 = 0
            for j, part in enumerate(parts):
                if part is None:
                    continue
                adj, p = part
                adjs.append(torch.where(adj >= 0, adj + j * Lc, -1))
                pos[j * Lc: j * Lc + p.shape[0]] = torch.where(p >= 0, p + row0, -1)
                row0 += adj.shape[0]
            if not adjs:  # no shard of the group has the level
                adjs.append(torch.full((1, 1), -1, dtype=torch.int32, device=dev))
            return torch.cat(adjs).to(torch.int32), pos

        layers = []
        for level in range(max_level, 0, -1):
            layers.append(cat_level([
                gr[0][sub.current_max_level - level]
                if sub.entry_point >= 0 and level <= sub.current_max_level else None
                for sub, gr in zip(subs, graphs)
            ]))
        adj0, pos0 = cat_level([
            (gr[1], gr[2]) if gr[1] is not None else None for gr in graphs
        ])
        self._stacked[dev] = (
            torch.from_numpy(entries).to(dev), vecs, valid,
            torch.from_numpy(l2g).to(dev), layers, adj0, pos0,
        )
        self._stack_sig[dev] = sig
        return self._stacked[dev]

    def _beam_group(self, dev, q: torch.Tensor, ef: int, k: int, stats=None):
        """One descent + beam over the stack of the shards on ``dev``.
        Returns the group's per-shard ([B, kk] dist, global id) lists on
        ``dev``."""
        entries, vecs, valid, l2g, layers, adj0, pos0 = self._stack(dev)
        B = q.shape[0]
        g = len(self._groups[dev])
        qq = q.to(dev).repeat(g, 1)  # shard-major: rows j*B .. j*B+B-1
        e = entries.repeat_interleave(B)
        qdt = self._subs[0]._query_dtype()
        e = descend(qq, e, vecs, valid, layers, metric=self._metric(), compute_dtype=qdt)
        bd, bi = beam_search(
            qq, e, vecs, valid, adj0, pos0, metric=self._metric(), ef=ef,
            max_iters=beam_max_iters(ef), compute_dtype=qdt,
            visited=self.config.visited, stats=stats,
        )
        kk = min(k, ef)
        bd, bi = bd[:, :kk], bi[:, :kk]
        gi = torch.where(bi >= 0, l2g[bi.clamp_min(0)], -1)
        bd = torch.where(gi >= 0, bd, MASKED_DIST)
        return list(bd.split(B)), list(gi.split(B))

    def _query_batched(self, q: torch.Tensor, ef: int, k: int, stats=None):
        """One descent + beam per device group (:meth:`_beam_group`); with
        several devices each group runs on a thread of the engine's pool,
        so every device's beam is queued before any is read. Each worker
        queues its work on the caller's current streams (the query's copy
        waits for the caller's writes to ``q``; the caller's merge is
        ordered after the beams). ``stats`` covers the first device's beam
        only. Returns per-shard ([B, kk] dist, global id) lists in mesh
        order."""
        devs = list(self._groups)
        if len(devs) == 1:
            parts = [self._beam_group(devs[0], q, ef, k, stats)]
        else:
            streams = [torch.cuda.current_stream(d) for d in distinct([q.device, *devs])
                       if d.type == "cuda"]

            def beam(i, dev):
                with contextlib.ExitStack() as stack:
                    for st in streams:
                        stack.enter_context(torch.cuda.stream(st))
                    return self._beam_group(dev, q, ef, k, stats if i == 0 else None)

            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=len(devs),
                                                thread_name_prefix="sharded-hnsw")
            futs = [self._pool.submit(beam, i, dev) for i, dev in enumerate(devs)]
            parts = [f.result() for f in futs]
        out_d, out_i = [None] * self.n, [None] * self.n
        for dev, (gd, gi) in zip(devs, parts):
            for j, s in enumerate(self._groups[dev]):
                out_d[s], out_i[s] = gd[j], gi[j]
        return out_d, out_i

    def _query_per_shard(self, q: torch.Tensor, ef: int, k: int):
        """One ``HNSWIndex.search_device`` call per shard: the parity
        oracle of :meth:`_query_batched`."""
        kk = min(k, ef)
        out_d, out_i = [], []
        for s, sub in enumerate(self._subs):
            dev = self.mesh[s]
            if sub.entry_point < 0:
                out_d.append(torch.full((q.shape[0], kk), MASKED_DIST, device=dev))
                out_i.append(torch.full((q.shape[0], kk), -1, dtype=torch.int64, device=dev))
                continue
            bd, bi = sub.search_device(q.to(dev), ef)
            bd, bi = bd[:, :kk], bi[:, :kk]
            l2g = torch.from_numpy(self._l2g[s]).to(dev)
            gi = torch.where(bi >= 0, l2g[bi.clamp_min(0)], -1)
            out_d.append(torch.where(gi >= 0, bd, MASKED_DIST))
            out_i.append(gi)
        return out_d, out_i

    def search_device(self, queries: torch.Tensor, ef: int, k: int, *, batched: bool = True,
                      stats=None):
        """The merged graph search: (dist f32[B, k'], global slot i64[B, k'])
        on the first device of the mesh, k' = min(k, n * min(k, ef)).
        ``stats`` receives the first device's beam statistics.
        ``batched=False`` makes one sub-engine call per shard instead: the
        parity oracle of the batched search, not a serving path."""
        q = queries.to(self.device)
        with self._lock:
            if batched:
                out_d, out_i = self._query_batched(q, ef, k, stats=stats)
            else:
                out_d, out_i = self._query_per_shard(q, ef, k)
            return merge_topk(out_d, out_i, k)

    # ---------------------------------------------------------------- query

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
        q = query_rows(queries)
        with self._lock:
            graph = not (
                exact
                or mask is not None
                or not any(sub.entry_point >= 0 for sub in self._subs)
                or self.store.size <= max(self.config.m0, 2 * k)
            )
            if graph:
                retrieve_k = k if negative is None else min(max(2 * k, 30), self.store.size)
                ef = max(self.config.ef_search, retrieve_k)
                qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
                bd, bi = self.search_device(qd, ef, retrieve_k)
        if not graph:
            return self._exact.search_slots(
                q, k, mask=mask, negative=negative, negative_weight=negative_weight,
            )
        if negative is not None:
            bd, bi = self._exact.rerank_negative(qd, bd, bi, negative, negative_weight, k)
        dist, idx = bd[:, :k].cpu().numpy(), bi[:, :k].cpu().numpy()
        # under-fill supplement (hnsw.go:676-710), from the sharded exact scan
        dist, idx, _ = supplement(
            dist, idx, k, self.store.size,
            lambda n_short: self._exact.search_slots(
                q, k, negative=negative, negative_weight=negative_weight),
        )
        return dist, idx

    # ---------------------------------------------------------- persistence

    def export_topology(self) -> Optional[dict]:
        """Sidecar: every shard's subgraph in its local slot space plus the
        local -> global slot map (``sharded_graph.py:516-536``)."""
        with self._lock:
            if not any(sub.entry_point >= 0 for sub in self._subs):
                return None
            out = {
                "format_version": np.int64(1),
                "kind": np.bytes_(b"sharded_hnsw"),
                "n_shards": np.int64(self.n),
            }
            for s, sub in enumerate(self._subs):
                top = sub.export_topology()
                out[f"s{s}_present"] = np.int64(top is not None)
                out[f"s{s}_l2g"] = self._l2g[s].copy()
                if top is not None:
                    for k_, v in top.items():
                        out[f"s{s}_{k_}"] = v
            return out

    def import_topology(self, data: dict, slot_remap: np.ndarray) -> None:
        """Restore the subgraphs: each shard's surviving rows are re-added
        to a fresh sub-store in their old local order, then its topology is
        imported through an old-local -> new-local remap. A sidecar of
        another kind or shard count is ignored: the caller's re-insert
        rebuilds (``sharded_graph.py:538-590``)."""
        kind = data.get("kind")
        if kind is None or bytes(kind) != b"sharded_hnsw":
            return
        if int(data.get("n_shards", -1)) != self.n:
            return
        with self._lock:
            self._import_shards(data, slot_remap)

    def _import_shards(self, data: dict, slot_remap: np.ndarray) -> None:
        store = self.store
        self._grow_maps()
        for s in range(self.n):
            old_l2g = np.asarray(data[f"s{s}_l2g"], np.int64)
            old_locals = np.flatnonzero(old_l2g >= 0)
            new_globals = np.where(
                old_l2g[old_locals] < len(slot_remap),
                slot_remap[np.clip(old_l2g[old_locals], 0, len(slot_remap) - 1)],
                -1,
            )
            live = new_globals >= 0
            if live.any():
                live &= store._np_valid[np.maximum(new_globals, 0)]
            old_keep = old_locals[live]
            g_keep = new_globals[live]
            new_locals = self._add_to_shard(s, g_keep, store._np_vectors[g_keep])
            if int(data.get(f"s{s}_present", 0)):
                local_remap = np.full(len(old_l2g), -1, np.int64)
                local_remap[old_keep] = new_locals
                prefix = f"s{s}_"
                sub_data = {k_[len(prefix):]: v for k_, v in data.items() if k_.startswith(prefix)}
                self._subs[s].import_topology(sub_data, local_remap)
        self._stacked = None
        self._stack_sig = None

    # ----------------------------------------------------------- tunables

    def get_optimization_parameters(self) -> dict:
        return self._subs[0].get_optimization_parameters()

    def set_optimization_parameters(self, **params) -> None:
        with self._lock:
            for sub in self._subs:
                sub.set_optimization_parameters(**params)
            if "ef_search" in params:
                self.config.ef_search = int(params["ef_search"])

    def get_detailed_metrics(self) -> dict:
        return {
            "size": self.size,
            "shards": [sub.get_detailed_metrics() for sub in self._subs],
            "mesh": self.n,
            "devices": [str(dev) for dev in self.mesh],
        }
