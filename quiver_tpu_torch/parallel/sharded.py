"""Corpus sharding: a mesh of devices, per-shard exact scans and their top-k
merge (PyTorch port of ``quiver_tpu/parallel/sharded.py``).

A *mesh* here is an ordered tuple of ``torch.device``s, one per shard
(:func:`make_mesh`, :func:`resolve_mesh`); the reference's is a 1-D JAX
device mesh (``sharded.py:41-47``). Shard ``s`` lives on ``mesh[s]`` and
owns the rows ``[s * cap/n, (s+1) * cap/n)`` of the store's slot space.
The devices may be distinct (one shard per card, as the JAX mesh places
them; a mixed ``(cuda:0, cpu)``), or repeat: ``(cuda:0,) * 4`` is four
shards placed together on one card, which is how one card runs the sharded
engines and how the CPU tests run 8 shards (the reference's 8-device
virtual CPU mesh). Both run the same code.

What the reference's collectives become:

* ``shard_map`` over the mesh -> a loop over the shards, each shard's work
  on its own device. The loops stage every shard's inputs first and then
  launch every shard's work before anything is read back, so distinct
  cards run at once;
* ``all_gather`` of the per-shard ``[B, kk]`` results + re-top-k
  (``sharded.py:109-120``) -> a copy onto the first shard's device and one
  stable sort (:func:`merge_topk`), so ties keep the lower shard first, as
  ``lax.top_k`` over the gathered axis does;
* ``psum`` (``sharded.py:164``) -> a sum over the shards on that device.

The exact engine keeps its own row mirror on each shard's device
(:class:`ShardedExactIndex`): the reference's ``_full_resync`` and
``_sharded_scatter_fn`` (``sharded.py:178-199, 237-276``), fed from the
store's host rows and its change feed. No sharded engine makes the store's
own device view, so the corpus never becomes whole on one device.

Across processes (one card or host per rank) the same merge runs over
``torch.distributed`` (``parallel/distributed.py``).

Not ported: the host fetch helper (``utils/transfer.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.query import query_rows
from quiver_tpu_torch.ops.distance import distance_pairs, inv_norms, norms_sq
from quiver_tpu_torch.ops.scan import MASKED_DIST, flat_scan_topk
from quiver_tpu_torch.types import DistanceType

#: a mesh: one device per shard, devices may repeat
Mesh = tuple
MeshLike = Union[None, int, Sequence]


def visible_cards() -> int:
    """The number of CUDA devices this process sees (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """One shard per device of ``devices`` (default: every visible card,
    the reference's ``make_mesh()``), the first ``n_devices`` of them.
    With no card and no list it raises: the CPU is a mesh device only when
    it is named. Asking for more shards than the list holds raises
    (``sharded.py:45-46``); to place several shards on one device, list it
    several times."""
    if devices is None:
        n_cards = visible_cards()
        if n_cards < 1:
            raise RuntimeError("no CUDA device is visible: name the mesh's devices "
                               "(e.g. ['cpu'])")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devs = tuple(torch.device(d) for d in devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return devs[:n]


def resolve_mesh(mesh: MeshLike, device) -> Mesh:
    """An engine's ``mesh`` argument as a device tuple, following the
    store's ``device`` type. Its devices are every visible card for a CUDA
    store (:func:`make_mesh`) and the store's device otherwise. None is one
    shard per such device; an int ``n`` is n shards round-robin over them
    (one per card on an n-card host; n shards together on a one-card host
    or the CPU); a sequence of devices is taken as it is."""
    if mesh is not None and not isinstance(mesh, int):
        devs = tuple(torch.device(d) for d in mesh)
        if not devs:
            raise ValueError("empty mesh")
        return devs
    if mesh is not None and mesh < 1:
        raise ValueError(f"mesh of {mesh} shards")
    device = torch.device(device)
    base = make_mesh() if device.type == "cuda" else (device,)
    return base if mesh is None else tuple(base[s % len(base)] for s in range(mesh))


def distinct(devices) -> list:
    """The distinct devices of ``devices``, in first-seen order."""
    return list(dict.fromkeys(torch.device(d) for d in devices))


@contextlib.contextmanager
def default_streams(devices):
    """Make each CUDA device's default stream current for the block: the
    stream every mirror write is queued on (as ``VectorStore`` syncs its
    view on one stream). Restores the caller's streams and device."""
    with contextlib.ExitStack() as stack:
        for dev in distinct(devices):
            if dev.type == "cuda":
                stack.enter_context(torch.cuda.stream(torch.cuda.default_stream(dev)))
        yield


def ready_on_current_streams(tensors) -> None:
    """Order each CUDA tensor's current stream after its device's default
    stream, where the tensor was written, and mark the tensor used by it,
    so a resync that replaces it cannot hand its memory to a new
    allocation while the caller's reads are queued."""
    for t in tensors:
        if t.device.type != "cuda":
            continue
        sync, cur = torch.cuda.default_stream(t.device), torch.cuda.current_stream(t.device)
        if cur != sync:
            cur.wait_stream(sync)
            t.record_stream(cur)


def sharded_exact_of(engine):
    """The :class:`ShardedExactIndex` an engine answers exactly with: the
    engine itself, its exact side (a hybrid) or its fallback (``_exact``);
    None for an engine over one device's view of the store."""
    for e in (engine, getattr(engine, "exact", None), getattr(engine, "_exact", None)):
        if isinstance(e, ShardedExactIndex):
            return e
    return None


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
    ``mask`` an optional bool[L] per shard. The queries go to every device
    first; then each shard runs the port's ``flat_scan_topk`` on its rows
    (the cards' scans are queued before any result is read) and local ids
    become global by the shard's row offset. Returns (dist f32[B, k], id
    i64[B, k]) on the first shard's device, -1 for empty."""
    L = shards[0][0].shape[0]
    kk = min(k, L)
    qs = {dev: queries.to(dev) for dev in distinct(sh[0].device for sh in shards)}
    out_d, out_i = [], []
    for s, (v, va, ns, inv) in enumerate(shards):
        d_loc, i_loc = flat_scan_topk(
            qs[v.device], v, va, None if mask is None else mask[s], ns, inv,
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
    on its own device for the candidates it owns (a local gather), the
    partial distances sum over the shards on the candidates' device (the
    ``psum``), and the adjusted top-k is taken there. The same formula as
    ``ops/scan.negative_rerank``. Returns (dist f32[B, k], id i64[B, k])."""
    metric = DistanceType.parse(metric)
    home = cand_dist.device
    B, R = cand_idx.shape
    L = shard_vectors[0].shape[0]
    devs = distinct(v.device for v in shard_vectors)
    cands = {dev: cand_idx.to(dev) for dev in devs}
    negs = {dev: negative.to(dev).float()[:, None, :] for dev in devs}
    parts = []
    for s, v in enumerate(shard_vectors):
        ci = cands[v.device]
        loc = ci - s * L
        mine = (ci >= 0) & (loc >= 0) & (loc < L)
        rows = v[loc.clamp(0, L - 1)].float()  # [B, R, d]
        neg = negs[v.device].expand_as(rows)
        part = distance_pairs(rows.reshape(B * R, -1), neg.reshape(B * R, -1), metric)
        parts.append(torch.where(mine, part.reshape(B, R), 0.0))
    d_neg = torch.zeros(B, R, device=home)
    for part in parts:
        d_neg += part.to(home)
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


class ShardedExactIndex:
    """The exact engine over a mesh (``sharded.py:202-326``).

    Shard s keeps a mirror of its rows ``[s*L, (s+1)*L)`` on ``mesh[s]``:
    (vectors f32[L, d], valid bool[L], norms_sq f32[L], inv_norms f32[L]),
    made at first use. A full resync (the first use, the store's growth, an
    overflow of its change feed) fills the mirrors from the store's host
    rows (``VectorStore.read_rows``); otherwise the rows the change feed
    (``changes_since``) names are scattered into their shards. The store's
    own device view is never made: the mirrors are the corpus's only device
    copy, and shards that share a device cost what the view would.
    Per-query (2-D) masks raise, as in the reference: a mask row per query
    would have to be split across shards per query.

    Mirror writes are queued on each card's default stream, and a caller on
    another stream waits for them (:func:`ready_on_current_streams`), as
    for the store's view. A lock covers the resync, so one engine may serve
    several threads (a hybrid's two sides, an IVF engine's staging clone).

    ``mirrors_of``: another exact engine over the same store and mesh whose
    mirrors this one reads instead of keeping its own (a sharded ANN
    engine's fallback inside a hybrid shares the hybrid's exact side), so
    the corpus stays on the devices once; the scan settings stay this
    engine's."""

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
        mirrors_of: Optional["ShardedExactIndex"] = None,
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"ShardedExactIndex compute_dtype={compute_dtype}: torch.float32 or torch.bfloat16"
            )
        self.store = store
        self.mesh = resolve_mesh(mesh, store.device)
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
        if mirrors_of is not None and (mirrors_of.store is not store
                                       or mirrors_of.mesh != self.mesh):
            raise ValueError("mirrors_of must be an engine over the same store and mesh")
        self._mirrors_of = mirrors_of
        self._lock = threading.RLock()
        self._mirrors: Optional[list] = None  # per shard (vectors, valid, ns, inv)
        self._cursor = None  # the store's change-feed cursor of the mirrors

    @property
    def size(self) -> int:
        return self.store.size

    def _upload(self, dev, vecs: np.ndarray, valid: np.ndarray) -> tuple:
        v = torch.from_numpy(vecs).to(dev)
        ns = norms_sq(v)
        return v, torch.from_numpy(valid).to(dev), ns, inv_norms(ns)

    def shards(self) -> list[tuple]:
        """Per-shard (vectors, valid, norms_sq, inv_norms) mirrors on their
        devices, brought up to the store's rows (class doc)."""
        if self._mirrors_of is not None:
            return self._mirrors_of.shards()
        with self._lock:
            cap, n = self.store.capacity, self.n_shards
            if cap % n != 0:
                raise ValueError(f"store capacity {cap} not divisible by mesh size {n}")
            L = cap // n
            # the cursor first: every write before it is in the rows read
            # below, and a write racing the read is replayed next time
            cursor, delta = self.store.changes_since(self._cursor)
            with default_streams(self.mesh):
                if delta is None or self._mirrors is None or len(self._mirrors[0][0]) != L:
                    self._mirrors = [
                        self._upload(dev, *self.store.read_rows(slice(s * L, (s + 1) * L)))
                        for s, dev in enumerate(self.mesh)
                    ]
                elif len(delta):
                    delta = delta[delta < cap]
                    vecs, valid = self.store.read_rows(delta)
                    owner = delta // L
                    for s in np.unique(owner):
                        pick = owner == s
                        dev = self.mesh[s]
                        idx = torch.from_numpy(delta[pick] - s * L).to(dev)
                        rows = self._upload(dev, vecs[pick], valid[pick])
                        for t, new in zip(self._mirrors[s], rows):
                            t.index_copy_(0, idx, new)
            self._cursor = cursor
            mirrors = self._mirrors
        ready_on_current_streams(t for sh in mirrors for t in sh)
        return mirrors

    def search_slots_device(self, queries: torch.Tensor, k: int, *, mask=None):
        """(dist f32[B, k], slot i64[B, k]) tensors on the first shard's
        device; ``mask`` an optional host bool[cap] corpus-wide mask."""
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
        q = query_rows(queries)
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
        device). The contract of ``ExactIndex.rerank_negative``: host
        arrays or tensors in, tensors on the first shard's device out."""
        dev = self.mesh[0]
        neg = torch.as_tensor(np.asarray(negative, np.float32), device=dev)
        if neg.dim() == 1:
            neg = neg[None, :].expand(q.shape[0], -1)
        return sharded_negative_rerank(
            torch.as_tensor(dist, device=dev), torch.as_tensor(idx, device=dev),
            [sh[0] for sh in self.shards()], neg,
            metric=self.store.metric, k=k, weight=weight,
        )
