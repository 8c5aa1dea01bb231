"""The host side every engine's ``search_slots`` shares: the query rows
in, and the under-fill supplement, which merges the exact scan's answer
into rows with fewer than k live entries (``hnsw.go:676-710``). It knows
no engine and opens no span; the caller's exact-scan callable does that.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from quiver_tpu_torch.ops.scan import MASKED_DIST


def query_rows(queries) -> np.ndarray:
    """The queries as f32[B, d] host rows; one query [d] is lifted to one
    row."""
    q = np.asarray(queries, np.float32)
    return q[None, :] if q.ndim == 1 else q


def merge_rows(d1, i1, d2, i2, k):
    """Merge two sorted candidate rows, dedup by id, keep k smallest."""
    seen = {}
    for d, i in list(zip(d1, i1)) + list(zip(d2, i2)):
        i = int(i)
        if i >= 0 and (i not in seen or d < seen[i]):
            seen[i] = float(d)
    items = sorted(seen.items(), key=lambda kv: kv[1])[:k]
    out_d = np.full(k, MASKED_DIST, np.float32)
    out_i = np.full(k, -1, np.int64)
    for j, (i, d) in enumerate(items):
        out_d[j] = d
        out_i[j] = i
    return out_d, out_i


def supplement(dist: np.ndarray, idx: np.ndarray, k: int, size: int,
               exact_scan: Callable[[int], tuple], fill: Optional[np.ndarray] = None):
    """The under-fill supplement of ``[B, <= k]`` result rows. A row is
    short below ``min(k, size)`` live entries, as ``fill`` counts them (on
    the device) or, when None, ``idx`` does. If any is, ``exact_scan(n_short)``
    returns the exact scan's ``(dist, idx)`` of the whole batch, and each
    short row, padded to k, is merged with it (:func:`merge_rows`). The
    inputs are not written. Returns (dist, idx, the short-row count); the
    rows are k wide where a row was short."""
    if fill is None:
        fill = (idx >= 0).sum(axis=1)
    short = np.flatnonzero(fill < min(k, size))
    if not len(short):
        return dist, idx, 0
    e_dist, e_idx = exact_scan(len(short))
    pad = ((0, 0), (0, k - dist.shape[1]))
    dist = np.pad(dist, pad, constant_values=MASKED_DIST)
    idx = np.pad(idx, pad, constant_values=-1)
    for b in short:
        dist[b], idx[b] = merge_rows(dist[b], idx[b], e_dist[b], e_idx[b], k)
    return dist, idx, len(short)
