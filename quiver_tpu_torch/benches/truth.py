"""Tie-aware exact ground truth for recall measurement (a copy of
``benches/truth.py``; numpy only).

The synthetic clustered corpus has near-ties at the boundary rank: the f32
affine-score oracle flips rank 10 vs 11 for ~40% of queries (diagnosed
2026-08-16 — the 'recall ceiling' at ~0.95 was oracle error, not engine
error). Ground truth here is computed in f64 on host and recall counts a
returned row as a hit when its TRUE f64 distance is within the true k-th
distance (relative tolerance covers representation noise) — the standard
competition recall under ties.
"""

from __future__ import annotations

import numpy as np

REL_TOL = 1e-6


def exact_truth_f64(queries: np.ndarray, vectors: np.ndarray, k: int,
                    block: int = 131_072):
    """(idx i64[B,k], dist f64[B,k]) true smallest-k L2^2 per query."""
    q = queries.astype(np.float64)
    B = q.shape[0]
    best_d = np.full((B, k), np.inf)
    best_i = np.full((B, k), -1, np.int64)
    qns = np.sum(q * q, axis=1)[:, None]
    for s in range(0, vectors.shape[0], block):
        v = vectors[s : s + block].astype(np.float64)
        d = qns - 2.0 * (q @ v.T) + np.sum(v * v, axis=1)[None, :]
        m = d.shape[1]
        kk = min(k, m)
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        pd = np.take_along_axis(d, part, axis=1)
        all_d = np.concatenate([best_d, pd], axis=1)
        all_i = np.concatenate([best_i, part + s], axis=1)
        sel = np.argsort(all_d, axis=1)[:, :k]
        best_d = np.take_along_axis(all_d, sel, axis=1)
        best_i = np.take_along_axis(all_i, sel, axis=1)
    return best_i, best_d


def recall_with_ties(found_slots: np.ndarray, queries: np.ndarray,
                     vectors: np.ndarray, true_kth_dist: np.ndarray,
                     k: int) -> float:
    """Fraction of returned slots whose TRUE f64 distance <= the true k-th
    distance (+rel tol). found_slots i32[B, k'], -1 = empty (counts as miss).
    Capped at counting k hits per query."""
    B = found_slots.shape[0]
    hits = 0
    q = queries.astype(np.float64)
    for b in range(B):
        s = found_slots[b][found_slots[b] >= 0][:k]
        if len(s) == 0:
            continue
        v = vectors[s].astype(np.float64)
        d = np.sum((v - q[b][None, :]) ** 2, axis=1)
        thr = true_kth_dist[b] * (1 + REL_TOL) + 1e-12
        hits += min(int((d <= thr).sum()), k)
    return hits / (B * k)
