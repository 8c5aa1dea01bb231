"""IVF (inverted-file) ops: k-means training + pruned batched query
(PyTorch port of ``quiver_tpu/ops/ivf_kernels.py``).

The corpus is partitioned by k-means into K clusters laid out as one dense
padded block tensor of residuals ``[K, d, Cmax]`` (bf16, or f32 for an
engine built at ``compute_dtype=float32``). A query batch
probes its top-P clusters; the (query, probe) pairs are sorted by cluster,
so each cluster block is read once per tile of pairs probing it, and the
candidate stage runs as ONE hand-written kernel (``ops/ivf_cuda.py::
block_topw``: grouped block scoring + windowed top-R). Winners re-enter in
f32 through the per-pair affine constant and either rescore exactly or
derive their distances from the scores.

Two candidate formulations of the reference go through ``block_topw``:
``"pairs"`` (W=32, top 2 per window; its per-pair top-R branch as one
window spanning the row) and ``"fused"`` (W=128, top 4). With f32 blocks
the two round the query as the reference does: pairs keeps it f32 (its
``ragged_dot`` casts both operands to the compute dtype), fused rounds it
to bf16 (the Pallas kernel's ``qtile.astype(bf16)``). The third,
``"einsum"`` (:func:`_einsum_candidates`), is XLA ops in the reference (a
batched GEMM over per-cluster query lists, gathers, max/argmax passes) and
torch ops here. The
probe GEMM, the pair sort, the Lloyd GEMM and every top-k stay torch ops,
as the reference leaves them to XLA.

Reference workarounds not ported, because their cause is absent here:

* ``lax.approx_max_k`` (``ivf_kernels.py:571,700,724,753,1008``) becomes the
  exact ``torch.topk``, so ``probe_approx`` is gone; the port's recall may
  be higher than the reference's, never lower. The packed windowed probe
  selection (``ivf_kernels.py:544-559``) is NOT an approx_max_k: it changes
  which probes win, and is ported as is.
* the fused path's SMEM scalar-prefetch bound on B*n_probe
  (``ivf_kernels.py:390-399``): the kernel loads its own pair indices.
* the fused path's ``Bc`` query chunking, non-pow2 batch padding and ``KG``
  cluster grouping (``ivf_kernels.py:934-990``): the kernel has one grid
  over all pairs and no per-cell overhead to amortize; ``fused_kg`` is
  accepted by the engine config and ignored.
* the regroup of window winners by inverse permutation
  (``ivf_kernels.py:673-690``): the kernel writes each pair's winners to its
  original row.
* paced Lloyd iterations for background maintenance
  (``ivf_kernels.py:111-124``).
"""

from __future__ import annotations

import numpy as np
import torch

from quiver_tpu_torch.ops.distance import distance_pairs
from quiver_tpu_torch.ops.ivf_cuda import (
    KEY_MIN,
    _from_key,
    _mask_key,
    _pack_lane,
    _to_key,
    block_topw,
    unpack_keys,
)
from quiver_tpu_torch.ops.scan import MASKED_DIST, NEG_BIG, require_ieee_f32
from quiver_tpu_torch.types import DistanceType

#: fused formulation: window width, winners per window, position bits
WIN, R_WIN, POS_BITS = 128, 4, 11

_EUCLID = (DistanceType.EUCLIDEAN, DistanceType.SQUARED_EUCLIDEAN)


# --------------------------------------------------------------------- train


def _lloyd_iters(x, centroids, valid, n_iters: int):
    """Lloyd's k-means on the device: assignment by row-blocked matmul
    argmax (blocks keep the [N, K] score matrix under 256 MB), update by
    ``index_add_``. Invalid rows park in an extra segment and never
    contribute. Empty clusters keep their previous centroid.

    ``x`` and ``valid`` may be lists of row parts in row order, each on its
    own device (a sharded engine's row mirrors): each part assigns and sums
    its rows where they live, and the partial sums and counts add up on the
    centroids' device (the reference's psum over the mesh). Returns the
    centroids and the assignment (i64, -1 for invalid rows; a CPU tensor
    when there are several parts)."""
    parts = list(zip(x, valid)) if isinstance(x, (list, tuple)) else [(x, valid)]
    home = centroids.device
    k, d = centroids.shape

    def assign_all(xp, c):
        n = xp.shape[0]
        bs = max(1, min(n, (1 << 26) // max(k, 1)))
        c_ns = torch.sum(c * c, dim=1)
        out = torch.empty(n, dtype=torch.int64, device=xp.device)
        for lo in range(0, n, bs):
            out[lo:lo + bs] = torch.argmax(
                2.0 * (xp[lo:lo + bs] @ c.T) - c_ns[None, :], dim=1
            )
        return out

    c = centroids
    for _ in range(n_iters):
        partial = []
        for xp, vp in parts:  # every part's work queued before any copy
            assign = torch.where(vp, assign_all(xp, c.to(xp.device)), k)  # park invalid rows
            partial.append((
                torch.zeros(k + 1, d, device=xp.device).index_add_(0, assign, xp),
                torch.bincount(assign, minlength=k + 1),
            ))
        sums = torch.zeros(k + 1, d, device=home)
        counts = torch.zeros(k + 1, dtype=torch.int64, device=home)
        for ps, pc in partial:
            sums += ps.to(home)
            counts += pc.to(home)
        counts = counts[:k].float()
        c = torch.where(
            counts[:, None] > 0, sums[:k] / torch.clamp(counts[:, None], min=1.0), c
        )
    out = [torch.where(vp, assign_all(xp, c.to(xp.device)), -1) for xp, vp in parts]
    return c, out[0] if len(out) == 1 else torch.cat([a.cpu() for a in out])


def train_kmeans(
    vectors: np.ndarray,
    valid: np.ndarray,
    k: int,
    *,
    n_iters: int = 10,
    seed: int = 0,
    vectors_dev: torch.Tensor,
    valid_dev: torch.Tensor,
):
    """K-means over the live rows. Returns (centroids f32[k, d],
    assign i64[n] with -1 for invalid rows), numpy. Lloyd runs on the
    device copy (``vectors_dev``, ``valid_dev``: the store's view, or a
    sharded engine's row mirrors as lists of parts, :func:`_lloyd_iters`),
    the host ``vectors`` serve the init and reseed gathers, which draw from
    the same numpy RNG sequence as the reference, so both packages start
    from the same centroids."""
    require_ieee_f32()
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(valid)
    if len(live) < k:
        raise ValueError(f"need at least k={k} live rows, have {len(live)}")
    init = vectors[rng.choice(live, size=k, replace=False)].astype(np.float32)
    home = (vectors_dev[0] if isinstance(vectors_dev, (list, tuple)) else vectors_dev).device
    cents, assign = _lloyd_iters(
        vectors_dev, torch.from_numpy(init).to(home), valid_dev, n_iters
    )
    cents = cents.cpu().numpy().copy()
    assign = assign.cpu().numpy().copy()
    # fix empty clusters: seed from random live rows, steal their membership
    counts = np.bincount(assign[assign >= 0], minlength=k)
    empty = np.flatnonzero(counts == 0)
    if len(empty):
        steal = rng.choice(live, size=len(empty), replace=False)
        cents[empty] = vectors[steal]
        assign[steal] = empty
    return cents, assign


def split_oversized(
    vectors: np.ndarray,
    cents: np.ndarray,
    assign: np.ndarray,
    cmax: int,
    *,
    seed: int = 0,
    target_fill: float = 0.75,
):
    """Ensure no cluster exceeds ``cmax`` rows by SPLITTING oversized
    clusters into extra local centroids (mini-Lloyd), instead of spilling
    their overflow rows into distant clusters (spill is a recall ceiling).
    Host numpy, copied from the reference. Returns ``(cents, assign)``
    with possibly more centroids."""
    rng = np.random.default_rng(seed)
    assign = assign.copy()
    cents = list(np.asarray(cents, np.float32))
    counts = np.bincount(assign[assign >= 0], minlength=len(cents))
    queue = [c for c in np.flatnonzero(counts > cmax)]
    while queue:
        c = queue.pop()
        rows = np.flatnonzero(assign == c)
        m = len(rows)
        if m <= cmax:
            continue
        x = vectors[rows].astype(np.float32)
        parts = max(2, int(np.ceil(m / (target_fill * cmax))))
        seeds = x[rng.choice(m, size=parts, replace=False)].copy()
        xns = np.sum(x * x, axis=1)
        a = np.zeros(m, np.int64)
        for _ in range(8):
            d = xns[:, None] - 2.0 * (x @ seeds.T)  # + const per part
            d += np.sum(seeds * seeds, axis=1)[None, :]
            a = d.argmin(axis=1)
            for j in range(parts):
                sel = a == j
                if sel.any():
                    seeds[j] = x[sel].mean(axis=0)
        part_counts = np.bincount(a, minlength=parts)
        if part_counts.max() > cmax and part_counts.max() >= m:
            # degenerate (e.g. identical rows): force an even split
            a = np.arange(m) % parts
            for j in range(parts):
                seeds[j] = x[a == j].mean(axis=0)
        # part 0 keeps the label; the rest become new centroids
        labels = [c] + [len(cents) + i for i in range(parts - 1)]
        cents[c] = seeds[0]
        cents.extend(seeds[1:])
        for j in range(1, parts):
            assign[rows[a == j]] = labels[j]
        for j in range(parts):
            if np.count_nonzero(a == j) > cmax:
                queue.append(labels[j])
    return np.asarray(cents, np.float32), assign


def balance_assignment(
    assign: np.ndarray,
    scores_fn,
    cmax: int,
    k: int,
):
    """Cap every cluster at ``cmax`` rows: overflow rows (farthest first)
    re-assign to their best cluster with room. Host numpy, copied from the
    reference. ``scores_fn(rows) -> [m, k]`` larger-is-better scores."""
    counts = np.bincount(assign[assign >= 0], minlength=k)
    over = [c for c in range(k) if counts[c] > cmax]
    if not over:
        return assign
    assign = assign.copy()
    for c in over:
        rows = np.flatnonzero(assign == c)
        s = scores_fn(rows)[:, c]
        keep = rows[np.argsort(-s)[:cmax]]
        spill = np.setdiff1d(rows, keep, assume_unique=False)
        assign[spill] = -2  # pending
    pend = np.flatnonzero(assign == -2)
    if len(pend):
        s = scores_fn(pend)  # [m, k]
        pref = np.argsort(-s, axis=1)
        room = cmax - np.bincount(assign[assign >= 0], minlength=k)
        for i, row in enumerate(pend):
            for c in pref[i]:
                if room[c] > 0 and np.isfinite(s[i, c]):
                    assign[row] = c
                    room[c] -= 1
                    break
            else:  # pragma: no cover - only if total capacity < live rows
                raise RuntimeError("IVF balance: no cluster has room")
    return assign


# --------------------------------------------------------------------- query


def ivf_query(
    q: torch.Tensor,  # f32[B, d]
    centroids: torch.Tensor,  # f32[K, d]
    cent_norms_sq: torch.Tensor,  # f32[K]
    blocks_t: torch.Tensor,  # bf16 or f32 [K, d, Cmax] residuals v - c_k
    block_slot: torch.Tensor,  # i32[K, Cmax] global store slot (-1 pad)
    block_rns: torch.Tensor,  # f32[K, Cmax] residual norms |v - c_k|^2
    block_inv_norms: torch.Tensor,  # f32[K, Cmax] 1/|v| (full vector)
    block_keep: torch.Tensor,  # bool[K, Cmax] occupied & live & facet mask
    store_vectors: torch.Tensor,  # f32[cap, d] for the exact rescore
    *,
    metric: DistanceType | str,
    k: int,
    n_probe: int,
    q_cap: int = 8,
    oversample: int = 3,
    probe_sel_approx: float | None = None,
    formulation: str = "pairs",
    seg_width: int | None = 32,
    rescore: bool = True,
):
    """Pruned batched search. Returns (dist f32[B, k], slot i64[B, k]),
    -1 / MASKED_DIST for empty entries.

    Stages: (1) probe — f32 centroid GEMM and top-P selection; (2) a stable
    sort of the (query, probe) pairs by cluster, as CSR offsets; (3) the
    candidate stage: through ``block_topw`` (``formulation`` "pairs" or
    "fused"), or per-cluster query lists of ``q_cap`` columns and one
    batched GEMM ("einsum": a cluster probed by more than ``q_cap``
    queries drops the overflow pairs); (4) the final top-k: exact f32
    rescore of the survivors (``rescore=True``) or distances derived from
    the stage scores. ``probe_sel_approx`` set selects the packed windowed
    probe selection (see :func:`_select_probes`)."""
    metric = DistanceType.parse(metric)
    B, d = q.shape
    K, _, Cmax = blocks_t.shape
    P = min(n_probe, K)

    # ---- 1. probe selection: f32 affine centroid scores, top-P
    c_dots, c_aff, probe, caff = probe_stage(
        q, centroids, cent_norms_sq, metric, P, probe_sel_approx
    )

    # ---- 2. sort (query, probe) pairs by cluster: CSR over sorted pairs
    flat_c = probe.reshape(B * P)
    order = torch.argsort(flat_c, stable=True).to(torch.int32)
    starts = torch.zeros(K + 1, dtype=torch.int32, device=q.device)
    starts[1:] = torch.cumsum(torch.bincount(flat_c, minlength=K), 0)

    # ---- 3. candidate stage
    if formulation == "fused":
        best_s, best_flat = _fused_candidates(
            q, c_dots, c_aff, probe, order, starts,
            blocks_t, block_rns, block_keep, centroids,
            metric=metric, k=k, oversample=oversample,
        )
    elif formulation == "pairs":
        best_s, best_flat = _pairs_candidates(
            q, centroids, c_dots, caff, probe, order, starts,
            blocks_t, block_rns, block_inv_norms, block_keep,
            metric=metric, k=k, oversample=oversample, seg_width=seg_width,
        )
    elif formulation == "einsum":
        order = order.long()
        best_s, best_flat = _einsum_candidates(
            q, centroids, c_dots, c_aff, order, flat_c[order], order // P, flat_c,
            blocks_t, block_rns, block_inv_norms, block_keep,
            metric=metric, k=k, q_cap=q_cap, oversample=oversample,
            seg_width=seg_width,
        )
    else:
        raise ValueError(f"unknown formulation {formulation!r}")

    # ---- 4. final top-k
    n_sur = best_s.shape[1]
    k_out = min(k, n_sur)
    bslot_flat = block_slot.reshape(-1)
    if rescore:
        best_slot = torch.where(
            best_s > NEG_BIG / 2, bslot_flat[best_flat].long(), -1
        )
        rows = store_vectors[best_slot.clamp_min(0)].float()
        qb = q[:, None, :].expand(B, n_sur, d).reshape(-1, d)
        dist = distance_pairs(qb, rows.reshape(-1, d), metric).reshape(B, n_sur)
        dist = torch.where(best_slot >= 0, dist, MASKED_DIST)
        dist, posn = torch.topk(dist, k_out, dim=1, largest=False)
        best_slot = torch.gather(best_slot, 1, posn)
        best_slot = torch.where(dist >= MASKED_DIST, -1, best_slot)
    else:
        # score-derived distances: rank by stage score, resolve slots only
        # for the k winners, rebuild the distance from the affine identity
        top_s, posn = torch.topk(best_s, k_out, dim=1)
        flat_k = torch.gather(best_flat, 1, posn)
        best_slot = torch.where(top_s > NEG_BIG / 2, bslot_flat[flat_k].long(), -1)
        dist = scores_to_distances(top_s, q, metric)
        dist = torch.where(best_slot >= 0, dist, MASKED_DIST)
    if k_out < k:
        pad = k - k_out
        dist = torch.nn.functional.pad(dist, (0, pad), value=MASKED_DIST)
        best_slot = torch.nn.functional.pad(best_slot, (0, pad), value=-1)
    return dist, best_slot


def scores_to_distances(top_s, q, metric):
    """Reconstruct output distances from affine stage scores (the
    score-derived ``rescore=False`` path). Cosine stage scores are q·v/|v|;
    the 1/|q| factor is restored here, clamped like distance_pairs."""
    metric = DistanceType.parse(metric)
    if metric == DistanceType.COSINE:
        qinv = torch.rsqrt(
            torch.clamp(torch.sum(q * q, dim=1, keepdim=True), min=1e-30)
        )
        return 1.0 - torch.clamp(top_s * qinv, -1.0, 1.0)
    if metric == DistanceType.DOT_PRODUCT:
        return 1.0 - top_s
    qns = torch.sum(q * q, dim=1, keepdim=True)
    d2 = torch.clamp(qns - top_s, min=0.0)
    if metric == DistanceType.EUCLIDEAN:
        return torch.sqrt(d2)
    return d2


def probe_stage(
    q, centroids, cent_norms_sq, metric, P: int, probe_sel_approx,
    cluster_live=None,
):
    """Stage 1 of the IVF query: metric-specific centroid scores + top-P
    probe selection. Returns ``(c_dots f32[B, K], c_aff f32[B, K],
    probe i64[B, P], caff f32[B, P] | None)``; ``caff`` is the per-pair f32
    constant of the affine identity (None for cosine)."""
    require_ieee_f32()
    metric = DistanceType.parse(metric)
    c_dots = q @ centroids.T  # f32[B, K], full f32
    c_aff = 2.0 * c_dots - cent_norms_sq[None, :]  # -|q-c|^2 + |q|^2
    if metric == DistanceType.COSINE:
        c_scores = c_dots * torch.rsqrt(torch.clamp(cent_norms_sq, min=1e-30))[None, :]
    elif metric == DistanceType.DOT_PRODUCT:
        c_scores = c_dots
    else:  # euclidean family probes by true centroid distance
        c_scores = c_aff
    if cluster_live is not None:
        c_scores = torch.where(cluster_live[None, :], c_scores, NEG_BIG)
    K = centroids.shape[0]
    probe, pscore = _select_probes(c_scores, P, K, probe_sel_approx)
    caff = None if metric == DistanceType.COSINE else pscore
    return c_dots, c_aff, probe, caff


def _select_probes(c_scores, P: int, K: int, probe_sel_approx):
    """Top-P probe selection over [B, K] centroid scores. Returns
    (probe i64[B, P], score f32[B, P]). Three regimes, as in the reference:

    * ``probe_sel_approx`` set, K >= 256 and nwin >= P: top-2 per 128-id
      window via packed keys, then an exact top-P over the window winners
      (a probe is lost only when 3+ of the true top-P share one window);
      the returned score is lane-quantized;
    * P <= 16: iterated argmax (exact);
    * else: exact top-k (the reference's approx_max_k becomes exact here).
    """
    B = c_scores.shape[0]
    nwin = (K + 127) // 128
    if probe_sel_approx is not None and K >= 256 and nwin >= P:
        LM = 127
        MK = torch.tensor(int(_mask_key(128)), dtype=torch.int32, device=c_scores.device)
        KP = nwin * 128
        cw = c_scores
        if KP != K:
            cw = torch.nn.functional.pad(cw, (0, KP - K), value=NEG_BIG)
        keyc = _pack_lane(cw, LM).reshape(B, nwin, 128)
        m1 = keyc.max(dim=2).values
        r2 = torch.where(keyc == m1[:, :, None], MK, keyc)
        m2 = r2.max(dim=2).values
        wins = torch.cat([m1, m2], dim=1)  # [B, 2*nwin]
        wkey, wsel = torch.topk(wins, P, dim=1)
        wid = torch.where(wsel >= nwin, wsel - nwin, wsel)
        probe = wid * 128 + (wkey & LM).long()
        return probe, _from_key(wkey & ~LM)
    if P <= 16:
        sm = c_scores.clone()
        rows = torch.arange(B, device=c_scores.device)
        cols = []
        for _ in range(P):
            a = torch.argmax(sm, dim=1)
            cols.append(a)
            sm[rows, a] = -torch.inf
        probe = torch.stack(cols, dim=1)
    else:
        probe = torch.topk(c_scores, P, dim=1).indices
    return probe, torch.gather(c_scores, 1, probe)


def _epilogue(metric, block_keep, block_rns, block_inv_norms, c_dots, probe, pair_dots=None):
    """block_topw epilogue operands of the pairs stage:
    (scale, sub_cent, col_add, row_add, col_mul). ``pair_dots`` f32[B, P],
    when given, is ``c_dots`` gathered at the probes already."""
    if metric == DistanceType.COSINE:
        # (dot + q·c) * (1/|v| masked) + mask bias; row_add per pair
        if pair_dots is None:
            pair_dots = torch.gather(c_dots, 1, probe)
        row_add = pair_dots.reshape(-1).contiguous()
        col_mul = torch.where(block_keep, block_inv_norms, 0.0)
        col_add = torch.where(block_keep, 0.0, NEG_BIG)
        return 1.0, False, col_add, row_add, col_mul
    if metric == DistanceType.DOT_PRODUCT:
        return 1.0, False, torch.where(block_keep, 0.0, NEG_BIG), None, None
    # -|q-v|^2 + |q|^2 = 2(q-c)·(v-c) - |v-c|^2 + (-|q-c|^2 + |q|^2)
    return 2.0, True, torch.where(block_keep, -block_rns, NEG_BIG), None, None


def _pairs_candidates(
    q, centroids, c_dots, caff, probe, order, starts,
    blocks_t, block_rns, block_inv_norms, block_keep,
    *, metric, k, oversample, seg_width, pair_dots=None,
):
    """Grouped candidate stage, windowed top-2 (``seg_width`` lanes):
    ``block_topw`` scores every pair, keeps the top 2 packed keys per
    window in the pair's original row and re-keys each winner with the
    per-pair constant ``caff`` (euclidean / dot — it cannot change
    within-pair ranking; the reference's f32 add after its regroup); then
    the survivor top-k and the flat block position rebuilt from (probe
    slot, window, lane).

    Returns ``(best_s f32[B, n_sur], best_flat i64[B, n_sur])`` where
    ``best_flat`` indexes the flattened [K * Cmax] block grid; masked
    entries score <= NEG_BIG (validity test ``> NEG_BIG / 2``).

    When the windowed reduce does not engage (``Cmax % W`` or
    ``Cmax // W < k``) the reference keeps a per-pair top-R; the port runs
    it through ``block_topw``'s row mode (one window spanning the row), whose
    packed keys quantize the score by ceil(log2(Cmax)) bits where the
    reference keeps the f32 score. The per-pair constant is added after the
    kernel here (it cannot change the ranking within a pair).

    ``order`` may be a TRUNCATED pair list (``ivf_kernels.py:615-623``): M
    <= B*P sorted pairs, the ones a shard scores
    (``parallel/sharded_ivf.py``), with ``starts`` the CSR over the
    shard's local cluster ids and ``blocks_t``, ``centroids``,
    ``block_*`` the shard's slice of them; ``probe`` and ``caff`` stay the
    full [B, P] in the global id space. A pair absent from ``order`` gets
    the masked sentinel in every lane (``block_topw``'s contract), so it
    never survives. ``best_flat`` is rebuilt from ``probe``, so it indexes
    the GLOBAL [K_global * Cmax] grid in both branches, and the
    reference's ``cluster_offset`` (which its per-pair branch adds to the
    sorted local ids) has nothing to do here. ``pair_dots`` (``c_dots``
    gathered at the probes; then ``c_dots`` may be None) spares a shard on
    another device the full [B, K] dots."""
    B, d = q.shape
    K, _, Cmax = blocks_t.shape
    P = probe.shape[1]
    BP = B * P
    scale, sub_cent, col_add, row_add, col_mul = _epilogue(
        metric, block_keep, block_rns, block_inv_norms, c_dots, probe, pair_dots
    )
    kw = dict(
        P=P, scale=scale, col_add=col_add, row_add=row_add, col_mul=col_mul,
        sub_cent=sub_cent,
        # the reference's ragged_dot casts the query to the blocks' dtype
        round_query=blocks_t.dtype == torch.bfloat16,
    )
    W = seg_width or 0
    if W >= 2 and (W & (W - 1)) == 0 and Cmax % W == 0 and Cmax // W >= k:
        S = Cmax // W
        LM = W - 1
        # i32[BP, 2S] in the reference's lane order (concat([m1 over
        # windows, m2 over windows])), rows in original pair order, caff
        # added to each winner in f32 by the kernel
        cand = block_topw(
            q, centroids, starts, order, blocks_t,
            W=W, R=2, pos_bits=W.bit_length() - 1, sentinel=_mask_key(W),
            win_add=None if caff is None else caff.reshape(BP).contiguous(), **kw,
        ).reshape(B, P * 2 * S)
        n_sur = min(k * oversample, P * 2 * S)
        # survivors: top-k on the f32 view of the keys (order matches;
        # lane bits ride along in the low mantissa)
        fbest, sel = torch.topk(_from_key(cand), n_sur, dim=1)
        best_key = _to_key(fbest)
        j_of = sel // (2 * S)
        w_of = (sel % (2 * S)) % S
        cl = torch.gather(probe, 1, j_of)
        best_flat = cl * Cmax + w_of * W + (best_key & LM).long()
        return _from_key(best_key & ~LM), best_flat

    # per-pair top-R: one window spanning the row, rows in original order
    R = min(Cmax, max(16, k))
    pos_bits = max(1, (Cmax - 1).bit_length())
    keys = block_topw(
        q, centroids, starts, order, blocks_t,
        W=Cmax, R=R, pos_bits=pos_bits, sentinel=KEY_MIN, **kw,
    )  # i32[BP, R]
    s_pair, pos, _ = unpack_keys(keys, pos_bits)
    if caff is not None:
        s_pair = s_pair + caff.reshape(BP)[:, None]
    cand_s = s_pair.reshape(B, P * R)
    cand_f = (probe.reshape(BP)[:, None] * Cmax + pos.long()).reshape(B, P * R)
    n_sur = min(k * oversample, P * R)
    best_s, sel = torch.topk(cand_s, n_sur, dim=1)
    return best_s, torch.gather(cand_f, 1, sel)


def _fused_candidates(
    q, c_dots, c_aff, probe, order, starts,
    blocks_t, block_rns, block_keep, centroids,
    *, metric, k, oversample,
):
    """The reference's fused candidate stage (``formulation="fused"``):
    ``block_topw`` with 128-lane windows, top 4 per window, 11 position
    bits (the in-block column) and the ``KEY_MIN`` sentinel; the per-pair
    affine constant is added after unpacking. Euclidean family and
    dot-product only. The reference pads each pair's winners to 128 lanes
    of ``KEY_MIN``; those lanes are invalid and never survive, so the port
    keeps the R*S real ones."""
    if metric not in (*_EUCLID, DistanceType.DOT_PRODUCT):
        raise ValueError(f"fused formulation does not support metric {metric}")
    B, d = q.shape
    K, _, Cmax = blocks_t.shape
    P = probe.shape[1]
    S = Cmax // WIN
    if metric in _EUCLID:
        col_add = torch.where(block_keep, -block_rns, NEG_BIG)
        scale, sub_cent = 2.0, True
        caff_mat = torch.gather(c_aff, 1, probe)  # [B, P]
    else:
        col_add = torch.where(block_keep, 0.0, NEG_BIG)
        scale, sub_cent = 1.0, False
        caff_mat = torch.gather(c_dots, 1, probe)
    acc = block_topw(
        q, centroids, starts, order, blocks_t, P=P, scale=scale,
        col_add=col_add, sub_cent=sub_cent,
        W=WIN, R=R_WIN, pos_bits=POS_BITS, sentinel=KEY_MIN,
    ).reshape(B, P, R_WIN * S)
    score, pos, valid = unpack_keys(acc, POS_BITS)
    scores = torch.where(valid, score + caff_mat[:, :, None], NEG_BIG)
    scores = scores.reshape(B, P * R_WIN * S)
    fpos = (probe[:, :, None] * Cmax + pos.long()).reshape(B, P * R_WIN * S)
    n_sur = min(k * oversample, P * R_WIN * S)
    best_s, sel = torch.topk(scores, n_sur, dim=1)
    return best_s, torch.gather(fpos, 1, sel)


def _einsum_candidates(
    q, centroids, c_dots, c_aff, order, sorted_c, b_of, flat_c,
    blocks_t, block_rns, block_inv_norms, block_keep,
    *, metric, k, q_cap, oversample, seg_width=None,
):
    """The reference's per-cluster query-list candidate stage
    (``formulation="einsum"``, ``ivf_kernels.py:762-896``), as torch ops:
    the pairs invert into ``qlist[K, q_cap]`` (a pair's column is its rank
    within its cluster's run of the stable pair sort; rank >= ``q_cap``
    drops), one batched GEMM scores every listed query against its
    cluster's block, and each pair's row returns to its query; then the
    windowed top-2 (``seg_width``) or, when the reference's own condition
    does not hold, one top-k over ``[B, P*Cmax]``.

    The GEMM runs in f32 with TF32 off: the reference multiplies in the
    compute dtype with f32 output, and a product of two bf16 values is
    exact in f32, so bf16 blocks and the bf16-rounded query residual are
    upcast, one chunk of clusters at a time. Scores are exact f32 with no
    lane bits. ``order``, ``sorted_c``, ``b_of`` and ``flat_c`` are i64.
    Returns ``(best_s, best_flat)`` like :func:`_pairs_candidates`."""
    require_ieee_f32()
    metric = DistanceType.parse(metric)
    B, d = q.shape
    K, _, Cmax = blocks_t.shape
    BP = b_of.shape[0]
    P = BP // B
    dev = q.device
    pos = torch.arange(BP, device=dev)
    is_start = torch.ones(BP, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_c[1:] != sorted_c[:-1]
    rank = pos - torch.cummax(torch.where(is_start, pos, 0), 0).values
    in_cap = rank < q_cap
    col = torch.where(in_cap, rank, q_cap)
    # no scatter mode="drop" in torch: column q_cap takes the dropped
    # pairs and is cut off
    qlist = torch.full((K, q_cap + 1), -1, dtype=torch.int64, device=dev)
    qlist[sorted_c, col] = b_of
    qlist = qlist[:, :q_cap]
    have_q = qlist >= 0
    qsel = qlist.clamp_min(0)
    # f32 per-(cluster, query) constants from the probe stage
    const = (c_aff if metric in _EUCLID else c_dots)[qsel, torch.arange(K, device=dev)[:, None]]

    scores = torch.empty(K, q_cap, Cmax, device=dev)
    step = max(1, (1 << 26) // (d * Cmax))  # f32 block copy <= 256 MiB
    for lo in range(0, K, step):
        hi = min(K, lo + step)
        qf = q[qsel[lo:hi]]  # f32[kc, q_cap, d]
        if metric in _EUCLID:
            qf = qf - centroids[lo:hi, None, :]  # query residual vs this cluster
        if blocks_t.dtype != torch.float32:
            qf = qf.to(blocks_t.dtype).float()
        s = scores[lo:hi]
        torch.bmm(qf, blocks_t[lo:hi].float(), out=s)
        if metric == DistanceType.COSINE:
            s.add_(const[lo:hi, :, None]).mul_(block_inv_norms[lo:hi, None, :])
        elif metric == DistanceType.DOT_PRODUCT:
            s.add_(const[lo:hi, :, None])
        else:
            # -|q-v|^2 + |q|^2 = 2(q-c)·(v-c) - |v-c|^2 + (-|q-c|^2 + |q|^2)
            s.mul_(2.0).sub_(block_rns[lo:hi, None, :]).add_(const[lo:hi, :, None])
        s.masked_fill_(~(block_keep[lo:hi, None, :] & have_q[lo:hi, :, None]), NEG_BIG)

    # each pair's score row back to its query: pair i reads
    # scores[flat_c[i], its column]; dropped pairs mask out
    inv = torch.empty_like(order)
    inv[order] = pos  # original pair -> sorted position
    col_orig = col.clamp_max(q_cap - 1)[inv]
    in_cap_orig = in_cap[inv]
    W = seg_width
    S = Cmax // W if W else 0
    if W and Cmax % W == 0 and S >= k and 2 * P * S >= k * oversample:
        # windowed top-2: two max/argmax passes over [B, P*S, W]; flat block
        # positions rebuilt from (cluster, window, lane)
        probe = flat_c.reshape(B, P)
        col_b = col_orig.reshape(B, P)
        rows = torch.empty(B, P, Cmax, device=dev)
        for j in range(P):  # per-probe regroup
            rows[:, j] = scores[probe[:, j], col_b[:, j]]
        del scores
        rows.masked_fill_(~in_cap_orig.reshape(B, P, 1), NEG_BIG)
        rows = rows.view(B, P * S, W)
        a1 = torch.argmax(rows, dim=2, keepdim=True)
        m1 = torch.gather(rows, 2, a1)
        rows.scatter_(2, a1, -torch.inf)
        a2 = torch.argmax(rows, dim=2, keepdim=True)
        m2 = torch.gather(rows, 2, a2)
        cand_s = torch.cat([m1, m2], dim=1).squeeze(2)  # [B, 2PS]
        base = probe.repeat_interleave(S, dim=1) * Cmax + (
            torch.arange(S, device=dev) * W).repeat(P)
        cand_f = torch.cat([base + a1.squeeze(2), base + a2.squeeze(2)], dim=1)
        n_sur = min(k * oversample, 2 * P * S)
    else:
        cand_s = scores[flat_c, col_orig]  # [BP, Cmax]
        del scores
        cand_s = cand_s.masked_fill_(~in_cap_orig[:, None], NEG_BIG).reshape(B, P * Cmax)
        cand_f = (flat_c[:, None] * Cmax + torch.arange(Cmax, device=dev)).reshape(B, P * Cmax)
        n_sur = min(k * oversample, P * Cmax)
    best_s, sel = torch.topk(cand_s, n_sur, dim=1)
    return best_s, torch.gather(cand_f, 1, sel)
