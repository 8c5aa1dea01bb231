"""Flat-scan top-k — the exact-search engine (PyTorch port of
``quiver_tpu/ops/scan.py``).

Each tile of the corpus is scored with one matmul, validity/facet masks
are fused in as masked scores, and a running top-k is merged per tile; the
[B, N] score matrix is materialized only while it fits the single-shot
budget. Winners are rescored exactly in f32.

``compute_dtype=torch.bfloat16`` is the reference's fast mode
(``scan.py:76-95``): the caller passes a bf16 copy of the corpus (or the
f32 corpus, rounded tile by tile, as the HNSW build does), the query is
rounded to bf16, and the product is taken with f32 sums
(``preferred_element_type=f32``): here a ``torch.matmul`` of the bf16
values held in f32, whose products are exact. The winners' rescore reads
the corpus it was given, as the reference's does (``scan.py:98-104``).
Every f32 product runs with TF32 off: the reference's ``precision``
("highest" on its oracle path) is what the port always does.

Also hosts the negative-example rerank pass.

Not ported: ``lax.approx_max_k`` (``scan.py:53-70``) — the port always takes
the exact ``torch.topk``, so a caller's ``approx_recall`` target is met by
exact top-k (recall 1.0 >= the target).
"""

from __future__ import annotations

import torch

from quiver_tpu_torch.ops.distance import (
    distance_pairs,
    inv_norms,
    norms_sq,
    pairwise_distance,
)
from quiver_tpu_torch.types import DistanceType

#: Distance used for masked-out / invalid slots (finite, so top-k
#: comparisons stay well-defined).
MASKED_DIST = 3.0e38
#: Score of masked-out entries in the larger-is-better score space.
NEG_BIG = -3.0e38

#: Score-matrix byte budget above which the scan tiles the corpus.
SINGLE_SHOT_BUDGET_BYTES = 1 << 30


def require_ieee_f32() -> None:
    """The exact contract needs true-f32 matmul products: refuse to run
    with TF32 enabled for CUDA matmuls (the reference forces
    ``precision="highest"`` for the same reason, ``exact.py:58-64``)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the exact and "
            "probe stages need full-f32 matmuls; turn TF32 off"
        )


def _merge_topk(best_dist, best_idx, tile_dist, tile_idx, k: int):
    """Merge a tile's distances into the running top-k (smallest-k)."""
    all_dist = torch.cat([best_dist, tile_dist], dim=1)
    all_idx = torch.cat([best_idx, tile_idx], dim=1)
    top, pos = torch.topk(all_dist, k, dim=1, largest=False)
    return top, torch.gather(all_idx, 1, pos)


def _affine_scores(q, v, metric, v_norms_sq, v_inv_norms, compute_dtype=torch.float32):
    """Monotonic larger-is-better scores: one matmul + one affine. Per-row
    constants and monotone transforms are dropped; true distances are
    reconstructed for the winners only. With a bf16 ``compute_dtype`` the
    query and ``v`` are rounded to bf16 (a no-op on the bf16 corpus copy)
    and the products of the bf16 values are summed in f32."""
    if compute_dtype != torch.float32:
        q = q.to(compute_dtype).float()
        v = v.to(compute_dtype)
    dots = q @ v.float().T
    if metric == DistanceType.COSINE:
        return dots * v_inv_norms[None, :]
    if metric == DistanceType.DOT_PRODUCT:
        return dots
    # euclidean family: d^2 = ||q||^2 + ||v||^2 - 2 q.v  ->  2 q.v - ||v||^2
    return 2.0 * dots - v_norms_sq[None, :]


def _rescore_winners(q, vectors, idx, metric):
    """Exact f32 distances for the selected rows (small [B, k] gather)."""
    B, k = idx.shape
    d = q.shape[1]
    rows = vectors[idx.clamp_min(0)].float()  # [B, k, d]
    qb = q[:, None, :].expand(B, k, d).reshape(-1, d)
    return distance_pairs(qb, rows.reshape(-1, d), metric).reshape(B, k)


def _sort_rescored(best_dist, best_idx, found, k):
    """Order rescored winners by true distance; empty entries -> -1."""
    best_dist = torch.where(found, best_dist, MASKED_DIST)
    best_dist, pos = torch.topk(best_dist, k, dim=1, largest=False)
    best_idx = torch.gather(best_idx, 1, pos)
    return best_dist, torch.where(best_dist >= MASKED_DIST, -1, best_idx)


def flat_scan_topk(
    q: torch.Tensor,
    vectors: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor | None,
    v_norms_sq: torch.Tensor,
    v_inv_norms: torch.Tensor,
    *,
    metric: DistanceType | str,
    k: int,
    tile: int = 8192,
    compute_dtype=torch.float32,
):
    """Exact top-k scan.

    Args:
      q: f32[B, d] query block.
      vectors: [cap, d] corpus, f32 or its bf16 copy (invalid rows are
        masked).
      valid: bool[cap] slot-occupancy mask.
      mask: optional bool[cap] or bool[B, cap] additional (facet) mask.
      v_norms_sq / v_inv_norms: f32[cap] precomputed row stats.
      k: result count; tile: corpus rows per tile of the tiled path.
      compute_dtype: torch.float32 or torch.bfloat16, the product's input
        dtype (see the module doc).

    Returns:
      (dist f32[B, k], idx i64[B, k]); empty entries have idx == -1 and
      dist == MASKED_DIST.
    """
    require_ieee_f32()
    metric = DistanceType.parse(metric)
    B = q.shape[0]
    cap = vectors.shape[0]
    k = min(k, cap)
    q = q.float()
    per_query_mask = mask is not None and mask.dim() == 2
    use_affine = metric != DistanceType.MANHATTAN

    def keep_of(lo, hi):
        keep = valid[None, lo:hi]
        if mask is not None:
            keep = keep & (mask[:, lo:hi] if per_query_mask else mask[None, lo:hi])
        return keep

    if B * cap * 4 <= SINGLE_SHOT_BUDGET_BYTES:
        if use_affine:
            score = _affine_scores(q, vectors, metric, v_norms_sq, v_inv_norms, compute_dtype)
            score = torch.where(keep_of(0, cap), score, NEG_BIG)
            best_score, best_idx = torch.topk(score, k, dim=1)
            best_dist = _rescore_winners(q, vectors, best_idx, metric)
            return _sort_rescored(best_dist, best_idx, best_score > NEG_BIG, k)
        dist = pairwise_distance(q, vectors, metric)
        dist = torch.where(keep_of(0, cap), dist, MASKED_DIST)
        best_dist, best_idx = torch.topk(dist, k, dim=1, largest=False)
        return best_dist, torch.where(best_dist >= MASKED_DIST, -1, best_idx)

    best_key = torch.full((B, k), MASKED_DIST, device=q.device)
    best_idx = torch.full((B, k), -1, dtype=torch.int64, device=q.device)
    for lo in range(0, cap, tile):
        hi = min(lo + tile, cap)
        if use_affine:
            # larger-is-better score; the carry merges on the NEGATED score
            key = -_affine_scores(
                q, vectors[lo:hi], metric, v_norms_sq[lo:hi], v_inv_norms[lo:hi],
                compute_dtype,
            )
        else:
            key = pairwise_distance(q, vectors[lo:hi], metric)
        key = torch.where(keep_of(lo, hi), key, MASKED_DIST)
        t_key, t_local = torch.topk(key, min(k, hi - lo), dim=1, largest=False)
        best_key, best_idx = _merge_topk(best_key, best_idx, t_key, t_local + lo, k)
    empty = best_key >= MASKED_DIST
    best_idx = torch.where(empty, -1, best_idx)
    if not use_affine:
        return best_key, best_idx
    best_dist = _rescore_winners(q, vectors, best_idx, metric)
    return _sort_rescored(best_dist, best_idx, ~empty, k)


def negative_rerank(
    cand_dist: torch.Tensor,
    cand_idx: torch.Tensor,
    vectors: torch.Tensor,
    negative: torch.Tensor,
    *,
    metric: DistanceType | str,
    k: int,
    weight: float = 0.5,
):
    """Rerank candidates away from a negative example:
    adjusted = d(query, v) - weight * d(negative, v); keep the k candidates
    with the smallest adjusted score, reporting their ORIGINAL query
    distance. Returns (dist f32[B, k], idx i64[B, k])."""
    metric = DistanceType.parse(metric)
    B, R = cand_dist.shape
    cand_vecs = vectors[cand_idx.clamp_min(0)].float()  # [B, R, d]
    neg = negative.float()[:, None, :].expand_as(cand_vecs)
    d_neg = distance_pairs(
        cand_vecs.reshape(B * R, -1), neg.reshape(B * R, -1), metric
    ).reshape(B, R)
    adjusted = torch.where(cand_idx >= 0, cand_dist - weight * d_neg, MASKED_DIST)
    k = min(k, R)
    top_adj, pos = torch.topk(adjusted, k, dim=1, largest=False)
    out_idx = torch.gather(cand_idx, 1, pos)
    out_dist = torch.gather(cand_dist, 1, pos)
    out_idx = torch.where(top_adj >= MASKED_DIST, -1, out_idx)
    out_dist = torch.where(out_idx >= 0, out_dist, MASKED_DIST)
    return out_dist, out_idx


def compute_row_stats(vectors: torch.Tensor):
    """(norms_sq, inv_norms) for a corpus matrix."""
    ns = norms_sq(vectors)
    return ns, inv_norms(ns)
