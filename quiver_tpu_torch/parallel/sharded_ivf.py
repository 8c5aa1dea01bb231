"""IVF over a mesh: cluster-sharded blocks, a per-shard candidate stage
and one top-k merge (PyTorch port of ``quiver_tpu/parallel/sharded_ivf.py``).

The block tensor ``[K, d, Cmax]`` shards by cluster: shard ``s`` owns the
contiguous id range ``[s*KL, (s+1)*KL)``, of which the first ``owned_s``
ids are live clusters and the rest are reserved empty ids (keep all
False, centroid scores masked out of the probe selection); the last
reserved id of each range groups the shard's pad rows.

Placement, as the reference's ``NamedSharding`` places it
(``sharded_ivf.py:319-339``): shard ``s`` holds its ``[KL, d, Cmax]``
blocks, slot map, residual norms, inverse norms and keep mask on
``mesh[s]``; the centroids (and the live mask) are replicated on every
device of the mesh. The layout is made on the host
(``_layout_on_device = False``, ``sharded_ivf.py:232-235``): the build,
a sidecar import and a refresh read each shard's rows from the store's
host rows and lay them out on the shard's device, and the write path sends
each row to the device of the shard that owns its cluster (cluster id //
KL). The k-means of a build runs on the exact engine's row mirrors, each
part where it lives (``ops/ivf_kernels._lloyd_iters``). The store's own
device view is never made. Shards on one device and shards on distinct
devices run the same code.

A query batch (:func:`sharded_ivf_query`):

1. runs the probe stage once, on the first device, over all the centroids
   (the reference replicates it on every chip; on four H100 cards,
   probing on every card measured 22.0 against 14.2 ms per B=65536
   batch, ``PERF.md`` section 6);
2. for each shard keeps the (query, probe) pairs whose cluster it owns, at
   most ``M = _m_pairs(B, P)`` of them, the lowest probe ranks first (two
   stable argsorts, ``sharded_ivf.py:151-168``), so a skewed batch drops
   its least valuable pairs; the pair list, the probes and the queries are
   then copied to the shard's device;
3. launches every shard's candidate stage on its device before reading
   anything back: ``block_topw`` over the truncated pair list against the
   shard's blocks (``ops/ivf_kernels._pairs_candidates``), the shard's
   top k resolved against its slot map;
4. merges the shards' ``[B, k]`` results on the first device
   (``parallel/sharded.merge_topk``).

Each shard's ``max_load`` (its local pair count) is kept; the engine reads
their max lazily at the next batch and raises ``local_pair_factor`` when
pairs dropped (``_auto_raise_check``). Serving is score-derived only
(``rescore=False``), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex, _layout_dev, _pow2, _scatter_blocks_dev
from quiver_tpu_torch.ops.distance import norms_sq
from quiver_tpu_torch.ops.ivf_kernels import _pairs_candidates, probe_stage, scores_to_distances
from quiver_tpu_torch.ops.scan import MASKED_DIST, NEG_BIG
from quiver_tpu_torch.parallel.sharded import (
    MeshLike,
    ShardedExactIndex,
    distinct,
    merge_topk,
    resolve_mesh,
)
from quiver_tpu_torch.types import DistanceType


class _Timer:
    """CUDA-event spans of one query on the first device's current stream,
    read after the caller synchronizes; a no-op off CUDA or without a
    ``stats`` dict. A shard on another device queues its work there, so
    its span on the first device holds only its copies, and the merge
    span waits for it."""

    def __init__(self, stats: Optional[dict], device: torch.device):
        self.stats = stats if device.type == "cuda" else None
        self.stream = torch.cuda.current_stream(device) if self.stats is not None else None
        self.marks: list = []

    def mark(self, name: str) -> None:
        if self.stats is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            self.marks.append((name, ev))

    def close(self) -> None:
        if self.stats is not None:
            self.stats["events"] = self.marks


def span_ms(stats: dict) -> dict:
    """Milliseconds between consecutive marks of a query's ``stats``
    (after a synchronize): ``{"probe": ms, "shard0": ms, ..., "merge": ms}``."""
    ev = stats["events"]
    return {name: a_ev.elapsed_time(b_ev) for (_, a_ev), (name, b_ev) in zip(ev, ev[1:])}


def _shard_pairs(flat_c, rank, lo, KL, M, P, Kg):
    """One shard's truncated pair list on ``flat_c``'s device: (order
    i32[M], starts i32[KL+1], load i64[]). Keeps the M lowest-rank pairs
    whose cluster lies in ``[lo, lo+KL)``, grouped by cluster; pad rows
    (non-local pairs past the local count) group under the shard's last id,
    a reserved empty block."""
    is_local = (flat_c >= lo) & (flat_c < lo + KL)
    ord1 = torch.argsort(torch.where(is_local, rank, P), stable=True)[:M]
    kept = is_local[ord1]
    ord2 = torch.argsort(torch.where(kept, flat_c[ord1], Kg), stable=True)
    order = ord1[ord2]
    sorted_c = torch.where(kept[ord2], flat_c[order] - lo, KL - 1)
    starts = torch.zeros(KL + 1, dtype=torch.int32, device=flat_c.device)
    starts[1:] = torch.cumsum(torch.bincount(sorted_c, minlength=KL), 0)
    return order.to(torch.int32), starts, is_local.sum()


def sharded_ivf_query(
    q: torch.Tensor,  # f32[B, d] on the first device
    centroids: dict,  # device -> (f32[Kg, d], f32[Kg], bool[Kg] | None)
    shards: list,  # per shard (blocks_t, block_slot, block_rns, block_inv, block_keep)
    *,
    metric: DistanceType | str,
    k: int,
    n_probe: int,
    m_pairs: int,
    oversample: int = 4,
    probe_sel_approx: float | None = 0.99,
    seg_width: int | None = 32,
    stats: Optional[dict] = None,
):
    """The sharded pruned search (``sharded_ivf.py:81-215``; module doc).

    ``centroids`` maps every device of the mesh (and ``q``'s) to its
    replica of the centroids, their squared norms and the live mask
    (reserved ids False; None = all live). ``shards[s]`` holds shard s's
    ``KL`` clusters on its device: residual blocks ``[KL, d, Cmax]``, slot
    map i32, residual norms, inverse norms and keep mask ``[KL, Cmax]``.

    Returns ``(dist f32[B, k], slot i64[B, k], max_load i64[])`` on ``q``'s
    device: global store slots, -1 empty, score-derived distances;
    ``max_load`` is the largest per-shard local pair count (``> m_pairs``:
    pairs dropped on the hottest shard). ``stats``, when given on CUDA,
    receives CUDA events around the probe, each shard's launch and the
    merge (:func:`span_ms`)."""
    metric = DistanceType.parse(metric)
    home = q.device
    n = len(shards)
    KL, _, Cmax = shards[0][0].shape
    Kg = n * KL
    B, d = q.shape
    P = min(n_probe, Kg)
    M = min(m_pairs, B * P)
    timer = _Timer(stats, home)
    timer.mark("start")

    devs = distinct([home] + [sh[0].device for sh in shards])
    # the probe, and each shard's inputs staged on its device before any
    # shard's candidates launch: a copy to the CPU waits for the card, so
    # it must not queue behind a card shard's kernels
    cent, c_ns, live = centroids[home]
    c_dots, _, probe, caff = probe_stage(
        q, cent, c_ns, metric, P, probe_sel_approx, cluster_live=live
    )
    flat_c = probe.reshape(B * P)
    rank = torch.arange(P, device=home).repeat(B)  # probe rank of each pair
    # the cosine epilogue's operand: the query-centroid dots at the probes
    pair_dots = torch.gather(c_dots, 1, probe) if metric == DistanceType.COSINE else None
    probes = {dev: tuple(None if t is None else t.to(dev) for t in (q, probe, caff, pair_dots))
              for dev in devs}
    staged = []
    for s, sh in enumerate(shards):
        order, starts, load = _shard_pairs(flat_c, rank, s * KL, KL, M, P, Kg)
        staged.append((order.to(sh[0].device), starts.to(sh[0].device), load))
    timer.mark("probe")

    out_d, out_i = [], []
    for s, ((blocks_t, block_slot, rns, inv, keep), (order, starts, _)) in enumerate(
            zip(shards, staged)):
        dev = blocks_t.device
        qd, probe, caff, pair_dots = probes[dev]
        sl = slice(s * KL, (s + 1) * KL)
        best_s, best_flat = _pairs_candidates(
            qd, centroids[dev][0][sl], None, caff, probe, order, starts,
            blocks_t, rns, inv, keep, metric=metric, k=k, oversample=oversample,
            seg_width=seg_width, pair_dots=pair_dots,
        )
        # the shard's top k, slots resolved against its own slot map
        kk = min(k, best_s.shape[1])
        top_s, posn = torch.topk(best_s, kk, dim=1)
        flat_k = torch.gather(best_flat, 1, posn)
        local_flat = (flat_k - s * KL * Cmax).clamp(0, KL * Cmax - 1)
        slot = torch.where(top_s > NEG_BIG / 2, block_slot.reshape(-1)[local_flat].long(), -1)
        dist = scores_to_distances(top_s, qd, metric)
        out_d.append(torch.where(slot >= 0, dist, MASKED_DIST))
        out_i.append(slot)
        timer.mark(f"shard{s}")
    dist, slot = merge_topk(out_d, out_i, k)
    load = torch.stack([ld for _, _, ld in staged]).max()
    timer.mark("merge")
    timer.close()
    if dist.shape[1] < k:
        pad = k - dist.shape[1]
        dist = torch.nn.functional.pad(dist, (0, pad), value=MASKED_DIST)
        slot = torch.nn.functional.pad(slot, (0, pad), value=-1)
    return dist, slot, load


class ShardedIVFIndex(IVFIndex):
    """The IVF engine over a mesh (``sharded_ivf.py:218-467``): the base
    engine's layout with clusters renumbered by shard, each shard's blocks
    on its device (module doc), queried shard by shard and merged. Exact
    fallbacks (unbuilt, per-query masks, manhattan, the under-fill
    supplement), the tuner's oracle and the negative rerank run on a
    :class:`ShardedExactIndex` over the same mesh; ``mirrors_of`` names an
    exact engine whose row mirrors it reads (a hybrid's exact side), so the
    corpus is on the devices once. The engine's ``device`` is the first of
    the mesh: queries come in and results go out there."""

    name = "sharded_ivf"

    def __init__(
        self,
        store: VectorStore,
        mesh: MeshLike = None,
        *,
        config: Optional[IVFConfig] = None,
        compute_dtype=torch.bfloat16,
        local_pair_factor: float = 2.0,
        mirrors_of: Optional[ShardedExactIndex] = None,
        **cfg_overrides,
    ):
        if config is None:
            cfg_overrides.setdefault("rescore", False)
            config = IVFConfig(**cfg_overrides)
        if config.rescore:
            raise ValueError(
                "sharded IVF serves score-derived distances; the exact "
                "survivor re-rank would gather store rows across shards — "
                "set rescore=False"
            )
        super().__init__(store, config=config, compute_dtype=compute_dtype)
        self.mesh = resolve_mesh(mesh, store.device)
        self.device = self.mesh[0]
        self.n_shards = len(self.mesh)
        self.local_pair_factor = float(local_pair_factor)
        self._exact = ShardedExactIndex(store, self.mesh, mirrors_of=mirrors_of)
        self._k_local: Optional[int] = None  # per-shard cluster range KL
        #: device -> (centroids, squared norms, live mask): the replicas
        self._cent_rep: Optional[dict] = None
        # skew auto-raise state: (device max_load, M, mean) of the last
        # dispatched batch, checked lazily before the next one
        self._pending_load = None
        self._overflow_raises = 0

    #: a refresh's staging clone keeps the cluster-ownership geometry and
    #: the centroid replicas
    _CLONE_EXTRA = ("_k_local", "_cent_rep")

    def _clone_for_maintenance(self) -> "ShardedIVFIndex":
        eng = ShardedIVFIndex(
            self.store, self.mesh, config=dataclasses.replace(self.config),
            compute_dtype=self.compute_dtype,
            local_pair_factor=self.local_pair_factor,
        )
        # share the row mirrors (internally locked) instead of a second
        # device copy of the corpus per maintenance job
        eng._exact = self._exact
        return eng

    # ------------------------------------------------------------ placement

    def _put_cent_dev(self, cents: np.ndarray):
        """The centroids replicated on every device of the mesh, with the
        live mask (``_cluster_live``, set just before); returns the first
        device's (``sharded_ivf.py:319-326``)."""
        cents = np.ascontiguousarray(cents, np.float32)
        live = None if self._cluster_live is None else np.asarray(self._cluster_live, bool)
        rep = {}
        for dev in distinct(self.mesh):
            c = torch.from_numpy(cents).to(dev)
            rep[dev] = (c, torch.sum(c * c, dim=1),
                        None if live is None else torch.from_numpy(live).to(dev))
        self._cent_rep = rep
        return rep[self.device][:2]

    def _live_dev(self) -> Optional[torch.Tensor]:
        return self._cent_rep[self.device][2]

    def _cent_tensors(self) -> list:
        return [t for rep in (self._cent_rep or {}).values() for t in rep if t is not None]

    def _layout_tensors(self) -> list:
        return [*self._cent_tensors(), *self._blocks_t, *self._block_slot, *self._block_ns,
                *self._block_inv, *self._block_keep]

    def _cuda_devices(self) -> list:
        return [dev for dev in distinct(self.mesh) if dev.type == "cuda"]

    def _kmeans_source(self):
        """Lloyd runs on the exact engine's row mirrors, each part where it
        lives."""
        shards = self._exact.shards()
        return [sh[0] for sh in shards], [sh[1] for sh in shards]

    def _rows_dev(self, slots_np: np.ndarray):
        """Store rows by slot from the store's host rows, uploaded to the
        first device (the write path's assignment, a refresh's chunks, the
        overflow scan)."""
        vecs, _ = self.store.read_rows(np.asarray(slots_np, np.int64))
        v = torch.from_numpy(vecs).to(self.device)
        return v, norms_sq(v)

    def _layout_blocks(self, block_slot: np.ndarray) -> float:
        """Each shard's ``KL`` clusters laid out on its device from the
        store's host rows (``_layout_on_device = False``): the shard's rows
        upload once, compacted, and its slot map indexes them."""
        KL = self._k_local
        d = self.store.dim
        blocks, slots, rns, inv, keep, rsum = [], [], [], [], [], []
        for s, dev in enumerate(self.mesh):
            bs = np.ascontiguousarray(block_slot[s * KL:(s + 1) * KL])
            occupied = bs >= 0
            rows = bs[occupied].astype(np.int64)
            local = np.full(bs.shape, -1, np.int32)
            local[occupied] = np.arange(len(rows), dtype=np.int32)
            vecs = self.store.read_rows(rows)[0] if len(rows) else np.zeros((1, d), np.float32)
            v = torch.from_numpy(vecs).to(dev)
            b, r, i, kp, rs = _layout_dev(
                torch.from_numpy(local).to(dev), v, norms_sq(v),
                self._cent_rep[dev][0][s * KL:(s + 1) * KL], self.compute_dtype,
            )
            blocks.append(b)
            slots.append(torch.from_numpy(bs).to(dev))
            rns.append(r)
            inv.append(i)
            keep.append(kp)
            rsum.append(rs)
        self._blocks_t, self._block_slot, self._block_ns = blocks, slots, rns
        self._block_inv, self._block_keep = inv, keep
        return float(sum(float(r) for r in rsum))

    def _scatter_block_rows(self, rows_np, pos_np, slots_np) -> None:
        """Each written row goes to the device of the shard that owns its
        cluster (cluster id // KL), read from the store's host rows."""
        rows_np = np.asarray(rows_np, np.int64)
        if not len(rows_np):
            return
        KL = self._k_local
        pos_np, slots_np = np.asarray(pos_np, np.int64), np.asarray(slots_np, np.int64)
        vecs, _ = self.store.read_rows(slots_np)
        owner = rows_np // KL
        for s in np.unique(owner):
            pick = owner == s
            dev = self.mesh[s]

            def idx(a):
                return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

            v = torch.from_numpy(vecs[pick]).to(dev)
            _scatter_blocks_dev(
                self._blocks_t[s], self._block_ns[s], self._block_inv[s], self._block_slot[s],
                v, norms_sq(v), self._cent_rep[dev][0][s * KL:(s + 1) * KL],
                idx(rows_np[pick] - s * KL), idx(pos_np[pick]), idx(slots_np[pick]),
            )

    def _keep_dev(self) -> list:
        """Apply pending keep-bit scatters, each on its shard's device;
        returns the per-shard keep masks."""
        if self._keep_pending:
            last = {(r, c): v for r, c, v in self._keep_pending}
            rc = np.asarray(list(last), np.int64).reshape(-1, 2)
            vals = np.asarray(list(last.values()), bool)
            KL = self._k_local
            owner = rc[:, 0] // KL
            for s in np.unique(owner):
                pick = owner == s
                dev = self.mesh[s]
                self._block_keep[s].index_put_(
                    (torch.from_numpy(rc[pick, 0] - s * KL).to(dev),
                     torch.from_numpy(rc[pick, 1]).to(dev)),
                    torch.from_numpy(vals[pick]).to(dev),
                )
            self._keep_pending = []
        return self._block_keep

    # ------------------------------------------------------------- layout

    def _prepare_clusters(self, cents, assign):
        """Renumber clusters so shard ``s`` owns ``[s*KL, s*KL + owned_s)``
        (KL = max owned + 1; the tail ids are reserved empty clusters).
        Clusters go to shards by greedy bin packing of their row counts,
        biggest first to the lightest shard (``sharded_ivf.py:285-317``)."""
        n = self.n_shards
        K = len(cents)
        counts = np.bincount(assign[assign >= 0], minlength=K)
        load = np.zeros(n, np.int64)
        members: list[list[int]] = [[] for _ in range(n)]
        for c in np.argsort(-counts):
            s = int(np.argmin(load))
            load[s] += counts[c]
            members[s].append(int(c))
        KL = max(len(m) for m in members) + 1  # >= 1 reserved id per shard
        Kg = n * KL
        remap = np.full(K, -1, np.int64)
        for s, m in enumerate(members):
            for j, c in enumerate(m):
                remap[c] = s * KL + j
        new_cents = np.zeros((Kg, len(cents[0])), np.float32)
        live = np.zeros(Kg, bool)
        new_cents[remap] = np.asarray(cents, np.float32)
        live[remap] = True
        self._cluster_live = live
        self._k_local = KL
        return new_cents, np.where(assign >= 0, remap[assign], -1)

    # -------------------------------------------------------------- query

    def _m_pairs(self, B: int, P: int) -> int:
        """Local-pair bound: ``local_pair_factor`` x the mean load B*P/n,
        rounded up to a power of two (``sharded_ivf.py:341-348``, kept
        exactly: the rounding decides which pairs drop)."""
        mean = B * P / max(self.n_shards, 1)
        return min(B * P, _pow2(max(64, int(np.ceil(self.local_pair_factor * mean)))))

    def _auto_raise_check(self) -> None:
        """Read the previous batch's largest shard load (lazily: the read
        waits only for that batch) and, when the hottest shard overflowed
        its bound, raise ``local_pair_factor`` to cover the load with 1.5x
        headroom, capped at ``n_shards`` (where M >= B*P and nothing can
        drop) (``sharded_ivf.py:350-369``)."""
        if self._pending_load is None:
            return
        load_dev, m_bound, mean = self._pending_load
        self._pending_load = None
        load = int(load_dev)
        if load <= m_bound or self.local_pair_factor >= self.n_shards:
            return
        self.local_pair_factor = float(
            min(max(1.5 * load / mean, self.local_pair_factor), self.n_shards)
        )
        self._overflow_raises += 1

    def search_slots_device(self, queries: torch.Tensor, k: int, *, mask=None, stats=None):
        """The base engine's device path over the shards: ``queries`` and
        ``mask`` (an optional bool[cap] slot mask) on the first device;
        ``stats`` as in :func:`sharded_ivf_query`."""
        with self._lock:
            if not self._built:
                raise RuntimeError("IVF index is not built")
            if queries.device != self.device:
                raise ValueError(f"queries on {queries.device}, index on {self.device}")
            self._auto_raise_check()
            keeps = self._keep_dev()
            if mask is not None:
                keeps = [
                    keep & mask.to(keep.device)[slot.clamp_min(0).long()]
                    for keep, slot in zip(keeps, self._block_slot)
                ]
            shards = list(zip(self._blocks_t, self._block_slot, self._block_ns,
                              self._block_inv, keeps))
            P = min(self.config.n_probe, int(self._cluster_live.sum()))
            m_pairs = self._m_pairs(queries.shape[0], P)
            dist, slot, load = sharded_ivf_query(
                queries, self._cent_rep, shards,
                metric=self.store.metric, k=k, n_probe=P, m_pairs=m_pairs,
                oversample=self.config.oversample,
                probe_sel_approx=self.config.probe_sel_approx,
                seg_width=self.config.seg_width, stats=stats,
            )
            self._pending_load = (load, m_pairs, queries.shape[0] * P / max(self.n_shards, 1))
            return dist, slot

    def get_detailed_metrics(self) -> dict:
        m = super().get_detailed_metrics()
        m["sharded"] = {
            "n_shards": self.n_shards,
            "mesh": [str(dev) for dev in self.mesh],
            "local_pair_factor": round(self.local_pair_factor, 3),
            "overflow_raises": self._overflow_raises,
        }
        return m

    # --------------------------------------------------------- persistence

    def export_topology(self) -> Optional[dict]:
        data = super().export_topology()
        if data is not None:
            data["cluster_live"] = self._cluster_live.copy()
            data["k_local"] = np.int64(self._k_local)
        return data

    def import_topology(self, data: dict, slot_remap: np.ndarray) -> None:
        """The id space holds only for the shard count it was exported
        under; a sidecar from another engine or shard count rebuilds
        (``sharded_ivf.py:447-467``)."""
        live = data.get("cluster_live")
        kl = data.get("k_local")
        if live is None or kl is None or int(kl) * self.n_shards != len(live):
            self.build()
            return
        self._cluster_live = np.asarray(live, bool)
        self._k_local = int(kl)
        super().import_topology(data, slot_remap)
