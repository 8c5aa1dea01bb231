"""Corpus sharding: a shard list, per-shard exact scans and their top-k
merge (PyTorch port of ``quiver_tpu/parallel/sharded.py``).

A *mesh* here is an ordered tuple of ``torch.device``s, one per shard
(:func:`make_mesh`, :func:`resolve_mesh`); the reference's is a 1-D JAX
device mesh (``sharded.py:41-47``). A device may repeat: ``(cuda:0,) * 4``
is four shards placed together on one card, which is how one card runs
the sharded engines and how the CPU tests run 8 shards (the reference's
8-device virtual CPU mesh). Shard ``s`` owns the rows
``[s * cap/n, (s+1) * cap/n)`` of the store's slot space.

What the reference's collectives become:

* ``shard_map`` over the mesh -> a loop over the shards, each shard's work
  on its own device;
* ``all_gather`` of the per-shard ``[B, kk]`` results + re-top-k
  (``sharded.py:109-120``) -> a ``torch.cat`` onto the first shard's
  device and one stable sort (:func:`merge_topk`), so ties keep the lower
  shard first, as ``lax.top_k`` over the gathered axis does;
* ``psum`` (``sharded.py:164``) -> a sum over the shards on that device.

Across processes (one card or host per rank) the same merge runs over
``torch.distributed`` (``parallel/distributed.py``).

The engines of this package place every shard on the store's device
(:func:`colocated_mesh`); shards on distinct cards run one rank per card.
So the functions below take shards on any devices, and the engines hand
them row slices of one device's tensors.

Not ported: ``_sharded_scatter_fn`` (``sharded.py:178-199``): the store's
own sync writes the rows, and the exact engine's shards are views of its
device tensors; the host fetch helper (``utils/transfer.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.ops.distance import distance_pairs, inv_norms, norms_sq
from quiver_tpu_torch.ops.scan import MASKED_DIST, flat_scan_topk
from quiver_tpu_torch.types import DistanceType

#: a mesh: one device per shard, devices may repeat
Mesh = tuple
MeshLike = Union[None, int, Sequence]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """One shard per device of ``devices`` (default: every visible card, or
    the CPU when there is none), the first ``n_devices`` of them. Asking for
    more shards than the list holds raises (``sharded.py:45-46``); to place
    several shards on one device, list it several times."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n_cuda)] or ["cpu"]
    devs = tuple(torch.device(d) for d in devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return devs[:n]


def resolve_mesh(mesh: MeshLike, device) -> Mesh:
    """An engine's ``mesh`` argument as a device tuple: None is one shard on
    ``device`` (the store's); an int ``n`` is n shards placed together on
    ``device``; a sequence of devices is taken as it is."""
    device = torch.device(device)
    if mesh is None:
        return (device,)
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"mesh of {mesh} shards")
        return (device,) * mesh
    devs = tuple(torch.device(d) for d in mesh)
    if not devs:
        raise ValueError("empty mesh")
    return devs


def merge_topk(dists: Sequence[torch.Tensor], idx: Sequence[torch.Tensor], k: int):
    """Merge per-shard ascending ``[B, kk]`` (dist, global id) results into
    the global top ``k`` on the first shard's device: the all_gather +
    re-top-k of ``sharded.py:109-117``. The sort is stable over the shards
    in mesh order, so equal distances keep the lower shard first. Entries at
    MASKED_DIST become id -1."""
    home = dists[0].device
    all_d = torch.cat([d.to(home) for d in dists], dim=1)
    all_i = torch.cat([i.to(home) for i in idx], dim=1)
    out_d, sel = torch.sort(all_d, dim=1, stable=True)
    kk = min(k, all_d.shape[1])
    out_d, sel = out_d[:, :kk], sel[:, :kk]
    out_i = torch.gather(all_i, 1, sel)
    return out_d, torch.where(out_d >= MASKED_DIST, -1, out_i)


def sharded_scan_topk(
    queries: torch.Tensor,
    shards: Sequence[tuple],
    mask: Optional[Sequence[torch.Tensor]] = None,
    *,
    metric: DistanceType | str,
    k: int,
    tile: int = 8192,
    compute_dtype=torch.float32,
):
    """Exact scan of every shard, then the merge (``sharded.py:57-121``).

    ``shards[s]`` is ``(vectors f32[L, d], valid bool[L], norms_sq f32[L],
    inv_norms f32[L])`` on shard s's device, for the rows ``[s*L, (s+1)*L)``;
    ``mask`` an optional bool[L] per shard. Each shard runs the port's
    ``flat_scan_topk`` on its rows; local ids become global by the shard's
    row offset. Returns (dist f32[B, k], id i64[B, k]) on the first shard's
    device, -1 for empty."""
    L = shards[0][0].shape[0]
    kk = min(k, L)
    out_d, out_i = [], []
    for s, (v, va, ns, inv) in enumerate(shards):
        q = queries.to(v.device)
        d_loc, i_loc = flat_scan_topk(
            q, v, va, None if mask is None else mask[s], ns, inv,
            metric=metric, k=kk, tile=min(tile, L), compute_dtype=compute_dtype,
        )
        out_d.append(d_loc)
        out_i.append(torch.where(i_loc >= 0, i_loc + s * L, -1))
    return merge_topk(out_d, out_i, k)


def sharded_negative_rerank(
    cand_dist: torch.Tensor,
    cand_idx: torch.Tensor,
    shard_vectors: Sequence[torch.Tensor],
    negative: torch.Tensor,
    *,
    metric: DistanceType | str,
    k: int,
    weight: float = 0.5,
):
    """Negative-example rerank over row-sharded vectors
    (``sharded.py:124-175``): each shard computes d(negative, candidate)
    for the candidates it owns (a local gather), the partial distances sum
    over the shards, and the adjusted top-k is taken where ``cand_*`` live.
    The same formula as ``ops/scan.negative_rerank``. Returns (dist f32[B,
    k], id i64[B, k])."""
    metric = DistanceType.parse(metric)
    home = cand_dist.device
    B, R = cand_idx.shape
    L = shard_vectors[0].shape[0]
    d_neg = torch.zeros(B, R, device=home)
    for s, v in enumerate(shard_vectors):
        ci = cand_idx.to(v.device)
        loc = ci - s * L
        mine = (ci >= 0) & (loc >= 0) & (loc < L)
        rows = v[loc.clamp(0, L - 1)].float()  # [B, R, d]
        neg = negative.to(v.device).float()[:, None, :].expand_as(rows)
        part = distance_pairs(rows.reshape(B * R, -1), neg.reshape(B * R, -1), metric)
        d_neg += torch.where(mine, part.reshape(B, R), 0.0).to(home)
    adjusted = torch.where(cand_idx >= 0, cand_dist - weight * d_neg, MASKED_DIST)
    kk = min(k, R)
    top, sel = torch.topk(adjusted, kk, dim=1, largest=False)
    out_i = torch.gather(cand_idx, 1, sel)
    out_d = torch.gather(cand_dist, 1, sel)
    out_i = torch.where(top >= MASKED_DIST, -1, out_i)
    return torch.where(out_i >= 0, out_d, MASKED_DIST), out_i


def shard_rows(x: np.ndarray, mesh: Mesh) -> list[torch.Tensor]:
    """Split a host array's rows into the mesh's equal shards, each on its
    device."""
    L = len(x) // len(mesh)
    return [torch.from_numpy(np.ascontiguousarray(x[s * L:(s + 1) * L])).to(dev)
            for s, dev in enumerate(mesh)]


def colocated_mesh(mesh: MeshLike, device, engine: str) -> Mesh:
    """:func:`resolve_mesh` for a sharded engine, which places every shard
    on its store's ``device`` (the mesh may repeat it); shards on distinct
    cards run one rank per card through ``parallel/distributed.py``."""
    devs = resolve_mesh(mesh, device)
    if any(dev != torch.device(device) for dev in devs):
        raise ValueError(
            f"{engine} places its shards on the store's device {device} (mesh {devs}); "
            "shards on other cards run one rank per card (parallel/distributed.py)"
        )
    return devs


class ShardedExactIndex:
    """The exact engine over a shard list (``sharded.py:202-326``).

    Every shard lives on the store's device (:func:`colocated_mesh`), so
    shard s's rows are a contiguous row slice of the store's device view:
    no copy, and writes reach the shards through the store's own sync.
    Per-query (2-D) masks raise, as in the reference: a mask row per query
    would have to be split across shards per query."""

    name = "sharded_exact"

    def __init__(
        self,
        store: VectorStore,
        mesh: MeshLike = None,
        *,
        tile: int = 8192,
        compute_dtype=torch.float32,
        approx_recall: float | None = None,
        precision: str | None = "auto",
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"ShardedExactIndex compute_dtype={compute_dtype}: torch.float32 or torch.bfloat16"
            )
        self.store = store
        self.mesh = colocated_mesh(mesh, store.device, "sharded exact")
        self.n_shards = len(self.mesh)
        self.tile = int(tile)
        self.compute_dtype = compute_dtype
        # kept for inspection, as ExactIndex keeps them: the port's top-k is
        # exact and its f32 products run with TF32 off
        self.approx_recall = approx_recall
        if precision == "auto":
            precision = (
                "highest"
                if compute_dtype == torch.float32 and approx_recall is None
                else None
            )
        self.precision = precision

    @property
    def size(self) -> int:
        return self.store.size

    def shards(self) -> list[tuple]:
        """Per-shard (vectors, valid, norms_sq, inv_norms): row slices of
        the store's synced device view."""
        view = self.store.device_view()
        n = self.n_shards
        if view.capacity % n != 0:
            raise ValueError(f"store capacity {view.capacity} not divisible by mesh size {n}")
        L = view.capacity // n
        cols = (view.vectors, view.valid, view.norms_sq, view.inv_norms)
        return [tuple(t[s * L:(s + 1) * L] for t in cols) for s in range(n)]

    def search_slots_device(self, queries: torch.Tensor, k: int, *, mask=None):
        """(dist f32[B, k], slot i64[B, k]) tensors on the store's device;
        ``mask`` an optional host bool[cap] corpus-wide mask."""
        shards = self.shards()
        mask_sh = None
        if mask is not None:
            mask = np.asarray(mask, bool)
            if mask.ndim != 1:
                raise ValueError("sharded search supports corpus-wide masks only")
            mask_sh = shard_rows(mask, self.mesh)
        return sharded_scan_topk(
            queries, shards, mask_sh, metric=self.store.metric, k=k,
            tile=self.tile, compute_dtype=self.compute_dtype,
        )

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
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        retrieve_k = k if negative is None else max(2 * k, 30)
        retrieve_k = min(retrieve_k, self.store.capacity)
        qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.mesh[0])
        dist, idx = self.search_slots_device(qd, retrieve_k, mask=mask)
        if negative is not None:
            dist, idx = self.rerank_negative(
                qd, dist, idx, negative, negative_weight, min(k, retrieve_k)
            )
        return dist.cpu().numpy()[:, :k], idx.cpu().numpy()[:, :k]

    def rerank_negative(self, q, dist, idx, negative, weight, k):
        """:func:`sharded_negative_rerank` of retrieved candidates against
        this engine's shards (the corpus is never gathered onto one
        device)."""
        neg = torch.as_tensor(np.asarray(negative, np.float32), device=dist.device)
        if neg.dim() == 1:
            neg = neg[None, :].expand(q.shape[0], -1)
        return sharded_negative_rerank(
            dist, idx, [sh[0] for sh in self.shards()], neg,
            metric=self.store.metric, k=k, weight=weight,
        )
