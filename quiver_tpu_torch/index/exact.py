"""Exact (brute-force) index over a columnar store (PyTorch port of
``quiver_tpu/index/exact.py``).

Search is one f32 matmul scan with fused masking and top-k
(ops/scan.py); recall is 1.0 by construction. ``IVFIndex`` uses it for
small corpora, Manhattan, per-query masks and the under-fill supplement.

Not ported: the pow2 batch padding (``exact.py:110-125``), which exists only
to bound XLA's compiled shapes; the host fetch helper
(``utils/transfer.py``); and the approximate/bf16 scan modes
(``approx_recall``, ``compute_dtype``: ROADMAP.md queue 1, item 8) —
products here are always f32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.ops.scan import flat_scan_topk, negative_rerank


class ExactIndex:
    """Flat-scan index; shares the collection's VectorStore (no extra copy)."""

    name = "exact"

    def __init__(self, store: VectorStore):
        self.store = store

    @property
    def size(self) -> int:
        return self.store.size

    def search_slots(
        self,
        queries: np.ndarray,
        k: int,
        *,
        mask=None,
        negative: Optional[np.ndarray] = None,
        negative_weight: float = 0.5,
        exact: bool = False,  # engine-selection hint; this engine is exact
    ):
        """Batched top-k over slots.

        Args:
          queries: f32[B, d].
          k: result count (per query).
          mask: optional bool[cap] or bool[B, cap] facet mask (numpy or
            tensor).
          negative: optional f32[B, d] (or [d]) negative examples; the scan
            then over-retrieves max(2k, 30) and reranks by
            d_query - weight * d_negative.

        Returns:
          (dist f32[B, k], slots i64[B, k]) numpy arrays; empty slots are -1.
        """
        view = self.store.device_view()
        dev = self.store.device
        q_np = np.asarray(queries, dtype=np.float32)
        if q_np.ndim == 1:
            q_np = q_np[None, :]
        q = torch.from_numpy(np.ascontiguousarray(q_np)).to(dev)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask, bool), device=dev)
        retrieve_k = k if negative is None else max(2 * k, 30)
        retrieve_k = min(retrieve_k, view.capacity)
        dist, idx = flat_scan_topk(
            q, view.vectors, view.valid, mask, view.norms_sq, view.inv_norms,
            metric=self.store.metric, k=retrieve_k,
        )
        if negative is not None:
            neg = torch.as_tensor(np.asarray(negative, np.float32), device=dev)
            if neg.dim() == 1:
                neg = neg[None, :].expand(q.shape[0], -1)
            dist, idx = negative_rerank(
                dist, idx, view.vectors, neg, metric=self.store.metric,
                k=min(k, retrieve_k), weight=negative_weight,
            )
        return dist.cpu().numpy(), idx.cpu().numpy()
