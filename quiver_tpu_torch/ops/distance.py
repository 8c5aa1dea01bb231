"""Batched distance functions (PyTorch port of ``quiver_tpu/ops/distance.py``).

One batched formulation serves every engine: distances are computed for a
whole query block against a whole vector tile at once, the dot-product family
through one f32 matmul and the Manhattan metric elementwise.

Semantics match the reference exactly:
  cosine    = 1 - cos_sim, zero-vector guard -> 1, sim clamped to [-1, 1]
  euclidean = sqrt(sum (a-b)^2)
  squared_euclidean
  dot_product = 1 - <a, b>
  manhattan = sum |a - b|
All "smaller is better"; score = 1 - distance.

Matmuls run in full f32: the port never turns TF32 on, which is what the
reference's ``precision="highest"`` asks of the TPU (``distance.py:77-82``).
The ``compute_dtype``/``precision`` knobs of the reference are not ported:
the exact path is f32 only here.
"""

from __future__ import annotations

import torch

from quiver_tpu_torch.types import DistanceType


def norms_sq(v: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, f32."""
    v = v.float()
    return torch.sum(v * v, dim=-1)


def inv_norms(v_norms_sq: torch.Tensor) -> torch.Tensor:
    """Row-wise 1/||v||, with 0 for zero vectors (cosine zero-guard)."""
    n = torch.sqrt(v_norms_sq)
    return torch.where(n > 0, 1.0 / torch.clamp(n, min=1e-30), 0.0)


def pairwise_distance(
    q: torch.Tensor,
    v: torch.Tensor,
    metric: DistanceType | str,
    *,
    v_norms_sq: torch.Tensor | None = None,
    v_inv_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """f32[B, N] distances between every query row and every vector row
    (smaller is better). ``v_norms_sq``/``v_inv_norms``: optional
    precomputed f32[N] row stats."""
    metric = DistanceType.parse(metric)
    q = q.float()
    v = v.float()
    if metric == DistanceType.MANHATTAN:
        return torch.cdist(q, v, p=1.0)
    if v_norms_sq is None:
        v_norms_sq = norms_sq(v)
    dots = q @ v.T
    if metric == DistanceType.DOT_PRODUCT:
        return 1.0 - dots
    if metric == DistanceType.COSINE:
        if v_inv_norms is None:
            v_inv_norms = inv_norms(v_norms_sq)
        q_inv = inv_norms(norms_sq(q))
        sim = torch.clamp(dots * q_inv[:, None] * v_inv_norms[None, :], -1.0, 1.0)
        # zero-vector guard: a zero q or v row yields sim == 0 -> distance 1
        return 1.0 - sim
    # euclidean family: ||q||^2 + ||v||^2 - 2 q.v, clamped >= 0
    d2 = torch.clamp(norms_sq(q)[:, None] + v_norms_sq[None, :] - 2.0 * dots, min=0.0)
    if metric == DistanceType.SQUARED_EUCLIDEAN:
        return d2
    return torch.sqrt(d2)


def distance_pairs(
    a: torch.Tensor, b: torch.Tensor, metric: DistanceType | str
) -> torch.Tensor:
    """Elementwise-paired distances d(a[i], b[i]) -> f32[B]."""
    metric = DistanceType.parse(metric)
    a = a.float()
    b = b.float()
    if metric == DistanceType.MANHATTAN:
        return torch.sum(torch.abs(a - b), dim=-1)
    if metric in (DistanceType.DOT_PRODUCT, DistanceType.COSINE):
        dots = torch.sum(a * b, dim=-1)
        if metric == DistanceType.DOT_PRODUCT:
            return 1.0 - dots
        sim = torch.clamp(
            dots * inv_norms(norms_sq(a)) * inv_norms(norms_sq(b)), -1.0, 1.0
        )
        return 1.0 - sim
    # euclidean family: the direct (a-b)^2 form — the affine
    # ||a||^2+||b||^2-2ab cancels catastrophically for near pairs, and this
    # pass gives the winners' TRUE distance
    diff = a - b
    d2 = torch.sum(diff * diff, dim=-1)
    if metric == DistanceType.SQUARED_EUCLIDEAN:
        return d2
    return torch.sqrt(d2)
