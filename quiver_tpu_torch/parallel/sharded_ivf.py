"""IVF over a shard list: cluster-sharded blocks, a per-shard candidate
stage and one top-k merge (PyTorch port of
``quiver_tpu/parallel/sharded_ivf.py``).

The block tensor ``[K, d, Cmax]`` shards by cluster: shard ``s`` owns the
contiguous id range ``[s*KL, (s+1)*KL)``, of which the first ``owned_s``
ids are live clusters and the rest are reserved empty ids (keep all
False, centroid scores masked out of the probe selection); the last
reserved id of each range groups the shard's pad rows. A query batch:

1. runs the probe stage once over all the centroids (the reference
   replicates it on every chip; the shards here share one device);
2. on each shard keeps the (query, probe) pairs whose cluster it owns, at
   most ``M = _m_pairs(B, P)`` of them, the lowest probe ranks first (two
   stable argsorts, ``sharded_ivf.py:151-168``), so a skewed batch drops
   its least valuable pairs;
3. scores that truncated pair list against the shard's contiguous slice of
   the blocks with ``block_topw`` (``ops/ivf_kernels._pairs_candidates``,
   the truncated form) and resolves the shard's top k against its slice of
   the slot map;
4. merges the shards' ``[B, k]`` results (``parallel/sharded.merge_topk``).

Each shard's ``max_load`` (its local pair count) is kept; the engine reads
their max lazily at the next batch and raises ``local_pair_factor`` when
pairs dropped (``_auto_raise_check``). Serving is score-derived only
(``rescore=False``), as in the reference.

Placement: every shard of this engine lives on the store's device (a
mesh may repeat it: ``(cuda:0,) * 4`` is four shards on one card). The
layout tensors are the base engine's, on that device, and a shard's
blocks are a contiguous slice of them (no copy), so the write path, the
keep mask, refresh and background maintenance are the base engine's.
Shards on other cards run through ``parallel/distributed.py``, one rank
per card. The reference's device placement hooks (``_put_block_arrays``,
``_gather_source``, ``_layout_on_device``; ``sharded_ivf.py:232-235``,
``:328-337``, ``:406-412``) have nothing to place here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex, _pow2
from quiver_tpu_torch.ops.ivf_kernels import _pairs_candidates, probe_stage, scores_to_distances
from quiver_tpu_torch.ops.scan import MASKED_DIST, NEG_BIG
from quiver_tpu_torch.parallel.sharded import MeshLike, ShardedExactIndex, colocated_mesh, merge_topk
from quiver_tpu_torch.types import DistanceType


class _Timer:
    """CUDA-event spans of one query, read after the caller synchronizes;
    a no-op off CUDA or without a ``stats`` dict."""

    def __init__(self, stats: Optional[dict], device: torch.device):
        self.stats = stats if device.type == "cuda" else None
        self.marks: list = []

    def mark(self, name: str) -> None:
        if self.stats is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def close(self) -> None:
        if self.stats is not None:
            self.stats["events"] = self.marks


def span_ms(stats: dict) -> dict:
    """Milliseconds between consecutive marks of a query's ``stats``
    (after a synchronize): ``{"shard0": ms, ..., "merge": ms}``."""
    ev = stats["events"]
    return {name: a_ev.elapsed_time(b_ev) for (_, a_ev), (name, b_ev) in zip(ev, ev[1:])}


def sharded_ivf_query(
    q: torch.Tensor,  # f32[B, d]
    centroids: torch.Tensor,  # f32[Kg, d] (Kg = n * KL)
    cent_norms_sq: torch.Tensor,  # f32[Kg]
    cluster_live: torch.Tensor,  # bool[Kg] (False: reserved id)
    blocks_t: torch.Tensor,  # [Kg, d, Cmax] residuals
    block_slot: torch.Tensor,  # i32[Kg, Cmax]
    block_rns: torch.Tensor,  # f32[Kg, Cmax]
    block_inv_norms: torch.Tensor,  # f32[Kg, Cmax]
    block_keep: torch.Tensor,  # bool[Kg, Cmax] (facet mask applied)
    *,
    n_shards: int,
    metric: DistanceType | str,
    k: int,
    n_probe: int,
    m_pairs: int,
    oversample: int = 4,
    probe_sel_approx: float | None = 0.99,
    seg_width: int | None = 32,
    stats: Optional[dict] = None,
):
    """The sharded pruned search (``sharded_ivf.py:81-215``). Returns
    ``(dist f32[B, k], slot i64[B, k], max_load i64[])``: global store
    slots, -1 empty, score-derived distances; ``max_load`` is the largest
    per-shard local pair count (``> m_pairs``: pairs dropped on the hottest
    shard). ``stats``, when given on CUDA, receives CUDA events around each
    shard's candidate stage and the merge (:func:`span_ms`)."""
    metric = DistanceType.parse(metric)
    Kg = centroids.shape[0]
    n = n_shards
    if Kg % n != 0:
        raise ValueError(f"padded cluster count {Kg} not divisible by {n}")
    KL = Kg // n
    Cmax = blocks_t.shape[2]
    B, d = q.shape
    P = min(n_probe, Kg)
    BP = B * P
    M = min(m_pairs, BP)
    dev = q.device
    timer = _Timer(stats, dev)
    timer.mark("start")

    c_dots, _, probe, caff = probe_stage(
        q, centroids, cent_norms_sq, metric, P, probe_sel_approx, cluster_live=cluster_live
    )
    flat_c = probe.reshape(BP)
    rank = torch.arange(P, device=dev).repeat(B)  # probe rank of each pair
    timer.mark("probe")
    out_d, out_i, loads = [], [], []
    for s in range(n):
        lo = s * KL
        is_local = (flat_c >= lo) & (flat_c < lo + KL)
        loads.append(is_local.sum())
        # keep the M lowest-rank local pairs, then group them by cluster;
        # pad rows (non-local pairs past the local count) group under the
        # shard's last id, a reserved empty block
        ord1 = torch.argsort(torch.where(is_local, rank, P), stable=True)[:M]
        kept = is_local[ord1]
        ord2 = torch.argsort(torch.where(kept, flat_c[ord1], Kg), stable=True)
        order = ord1[ord2]
        sorted_c = torch.where(kept[ord2], flat_c[order] - lo, KL - 1)
        starts = torch.zeros(KL + 1, dtype=torch.int32, device=dev)
        starts[1:] = torch.cumsum(torch.bincount(sorted_c, minlength=KL), 0)
        sl = slice(lo, lo + KL)
        best_s, best_flat = _pairs_candidates(
            q, centroids[sl], c_dots, caff, probe, order.to(torch.int32), starts,
            blocks_t[sl], block_rns[sl], block_inv_norms[sl], block_keep[sl],
            metric=metric, k=k, oversample=oversample, seg_width=seg_width,
        )
        # the shard's top k, slots resolved against its own slot map slice
        kk = min(k, best_s.shape[1])
        top_s, posn = torch.topk(best_s, kk, dim=1)
        flat_k = torch.gather(best_flat, 1, posn)
        local_flat = (flat_k - lo * Cmax).clamp(0, KL * Cmax - 1)
        slot = torch.where(
            top_s > NEG_BIG / 2, block_slot[sl].reshape(-1)[local_flat].long(), -1
        )
        dist = scores_to_distances(top_s, q, metric)
        out_d.append(torch.where(slot >= 0, dist, MASKED_DIST))
        out_i.append(slot)
        timer.mark(f"shard{s}")
    dist, slot = merge_topk(out_d, out_i, k)
    timer.mark("merge")
    timer.close()
    if dist.shape[1] < k:
        pad = k - dist.shape[1]
        dist = torch.nn.functional.pad(dist, (0, pad), value=MASKED_DIST)
        slot = torch.nn.functional.pad(slot, (0, pad), value=-1)
    return dist, slot, torch.stack(loads).max()


class ShardedIVFIndex(IVFIndex):
    """The IVF engine over a shard list (``sharded_ivf.py:218-467``): the
    base engine's layout with clusters renumbered by shard, queried shard
    by shard and merged. Exact fallbacks (unbuilt, per-query masks,
    manhattan, the under-fill supplement) and the negative rerank run on a
    :class:`ShardedExactIndex` over the same mesh."""

    name = "sharded_ivf"

    def __init__(
        self,
        store: VectorStore,
        mesh: MeshLike = None,
        *,
        config: Optional[IVFConfig] = None,
        compute_dtype=torch.bfloat16,
        local_pair_factor: float = 2.0,
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
        self.mesh = colocated_mesh(mesh, store.device, "sharded IVF")
        self.n_shards = len(self.mesh)
        self.local_pair_factor = float(local_pair_factor)
        self._exact = ShardedExactIndex(store, self.mesh)
        self._k_local: Optional[int] = None  # per-shard cluster range KL
        # skew auto-raise state: (device max_load, M, mean) of the last
        # dispatched batch, checked lazily before the next one
        self._pending_load = None
        self._overflow_raises = 0

    #: a refresh's staging clone keeps the cluster-ownership geometry
    _CLONE_EXTRA = ("_k_local",)

    def _clone_for_maintenance(self) -> "ShardedIVFIndex":
        return ShardedIVFIndex(
            self.store, self.mesh, config=dataclasses.replace(self.config),
            compute_dtype=self.compute_dtype,
            local_pair_factor=self.local_pair_factor,
        )

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
        """The base engine's device path over the shards: ``mask`` an
        optional bool[cap] slot mask on the device; ``stats`` as in
        :func:`sharded_ivf_query`."""
        with self._lock:
            if not self._built:
                raise RuntimeError("IVF index is not built")
            if queries.device != self.device:
                raise ValueError(f"queries on {queries.device}, index on {self.device}")
            self._auto_raise_check()
            block_keep = self._keep_dev()
            if mask is not None:
                block_keep = block_keep & mask[self._block_slot.clamp_min(0).long()]
            cent, c_ns = self._cent_dev
            P = min(self.config.n_probe, int(self._cluster_live.sum()))
            m_pairs = self._m_pairs(queries.shape[0], P)
            dist, slot, load = sharded_ivf_query(
                queries, cent, c_ns, self._live_dev(),
                self._blocks_t, self._block_slot, self._block_ns,
                self._block_inv, block_keep,
                n_shards=self.n_shards, metric=self.store.metric, k=k,
                n_probe=P, m_pairs=m_pairs, oversample=self.config.oversample,
                probe_sel_approx=self.config.probe_sel_approx,
                seg_width=self.config.seg_width, stats=stats,
            )
            self._pending_load = (load, m_pairs, queries.shape[0] * P / max(self.n_shards, 1))
            return dist, slot

    def _rerank_negative(self, q, dist, idx, negative, weight, k):
        """The negative rerank over the store's rows, shard by shard
        (``sharded_ivf.py:414-427``)."""
        d2, i2 = self._exact.rerank_negative(
            q, torch.as_tensor(dist, device=self.mesh[0]),
            torch.as_tensor(idx, device=self.mesh[0]), negative, weight, k,
        )
        return d2.cpu().numpy(), i2.cpu().numpy()

    def get_detailed_metrics(self) -> dict:
        m = super().get_detailed_metrics()
        m["sharded"] = {
            "n_shards": self.n_shards,
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
