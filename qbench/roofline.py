"""The work of ``block_topw`` calls, counted from the inputs.

The kernel scores every (query, probed cluster) pair against the
cluster's rows and keeps windowed winners. What the inputs need, whatever
the program's padding or layout:

* bytes: the queries and the centroids read once, each probed cluster's
  real rows read once at the blocks' dtype, the winners' keys written once
  (4 bytes each: two per ``W``-row window of the cluster's real rows in
  pairs mode, R per pair in row mode);
* operations: 2 x (real rows of the probed cluster) x d per pair, at the
  bf16 tensor-core peak for bf16 blocks; for f32 blocks three TF32
  products each (3xTF32), at the TF32 peak.

The probe is the exact top-``n_probe`` of the centroids by the metric's
probe score, from the topology the engine exports (centroids and the
cluster of every row); it is worked out after the window, outside it.
"""

from __future__ import annotations

import numpy as np
import torch


def probe(queries: torch.Tensor, centroids: torch.Tensor, metric: str, P: int) -> torch.Tensor:
    """i64[B, P]: the P clusters each query probes."""
    dots = queries @ centroids.T
    ns = (centroids * centroids).sum(1)
    if metric == "cosine":
        score = dots * torch.rsqrt(ns.clamp_min(1e-30))[None, :]
    elif metric == "euclidean":
        score = 2.0 * dots - ns[None, :]
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.topk(score, P, dim=1).indices


def call_work(queries: np.ndarray, centroids: np.ndarray, sizes: np.ndarray, *, metric: str,
              n_probe: int, block_bytes: int, variant: tuple, device) -> tuple[float, float]:
    """(bytes, operations) of one call over ``queries`` f32[B, d], where
    ``sizes`` i64[K] counts each cluster's real rows and ``variant`` is
    ``(W, R)`` for windows of W rows or ``("row", R)`` for row mode."""
    B, d = queries.shape
    K = centroids.shape[0]
    P = min(n_probe, K)
    cents = torch.as_tensor(centroids, device=device, dtype=torch.float32)
    sz = torch.as_tensor(sizes, device=device, dtype=torch.int64)
    probed = probe(torch.as_tensor(queries, device=device), cents, metric, P)
    pairs = sz[probed]
    hit = torch.zeros(K, dtype=torch.bool, device=device)
    hit[probed.reshape(-1)] = True
    rows_read = int(sz[hit].sum())
    if variant[0] == "row":
        keys = pairs.numel() * int(variant[1])
    else:
        W, R = int(variant[0]), int(variant[1])
        keys = int((R * ((pairs + W - 1) // W)).sum())
    nbytes = 4.0 * (B * d + K * d + keys) + float(rows_read) * d * block_bytes
    flops = 2.0 * float(pairs.sum()) * d
    return nbytes, flops


def share(nbytes: float, flops: float, seconds: float, peaks: dict, kind: str) -> float:
    """Percent of ``seconds`` that the least time at the card's peaks
    takes: the larger of bytes over HBM bytes/s and operations over the
    ``kind`` peak ("bf16", or "tf32" for f32 blocks, three products each)."""
    ops_s = flops * (3 if kind == "tf32" else 1) / peaks[kind]
    return 100.0 * max(nbytes / peaks["hbm"], ops_s) / seconds
