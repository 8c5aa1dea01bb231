"""Exact (brute-force) index over a columnar store (PyTorch port of
``quiver_tpu/index/exact.py``).

Search is one matmul scan with fused masking and top-k (ops/scan.py);
recall is 1.0 by construction. The IVF and HNSW engines use it for what
they route to the exact scan, the under-fill supplement and the negative
rerank (:meth:`ExactIndex.rerank_negative`), the hybrid engine for its
exact side, and the collector as its oracle.

The reference's constructor keywords carry over: ``tile`` (corpus rows per
tile of the tiled scan), ``compute_dtype`` (``torch.bfloat16`` scans a
cached bf16 copy of the corpus, the reference's ``_corpus``,
``exact.py:70-76``), ``approx_recall`` and ``precision``. Two of them mean
less here: every f32 product runs with TF32 off, so ``precision`` "auto",
"highest" and None all give true f32; and ``approx_recall`` is met by exact
top-k (the reference's ``lax.approx_max_k`` has no counterpart the port
needs), so recall is 1.0 whatever the target.

Not ported: the pow2 batch padding (``exact.py:110-125``), which exists only
to bound XLA's compiled shapes, and the host fetch helper
(``utils/transfer.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.query import query_rows
from quiver_tpu_torch.ops.scan import flat_scan_topk, negative_rerank


class ExactIndex:
    """Flat-scan index; shares the collection's VectorStore (no extra copy
    in f32; a bf16 ``compute_dtype`` keeps one bf16 copy)."""

    name = "exact"

    def __init__(
        self,
        store: VectorStore,
        *,
        tile: int = 8192,
        compute_dtype=torch.float32,
        approx_recall: float | None = None,
        precision: str | None = "auto",
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"ExactIndex compute_dtype={compute_dtype}: torch.float32 or torch.bfloat16"
            )
        if tile < 1:
            raise ValueError(f"tile must be positive, got {tile}")
        if approx_recall is not None and not 0.0 < approx_recall <= 1.0:
            raise ValueError(f"approx_recall must be in (0, 1], got {approx_recall}")
        if precision not in ("auto", "highest", None):
            raise ValueError(
                f"precision={precision!r}: the port runs f32 products with TF32 "
                'off; use "auto", "highest" or None'
            )
        self.store = store
        self.tile = int(tile)
        self.compute_dtype = compute_dtype
        self.approx_recall = approx_recall
        # the reference's resolution, kept for inspection: "highest" on the
        # oracle path, None (DEFAULT) once the caller opted into bf16 or
        # approximation; either way the port's f32 products are true f32
        if precision == "auto":
            precision = (
                "highest"
                if compute_dtype == torch.float32 and approx_recall is None
                else None
            )
        self.precision = precision
        # bf16 corpus cache for the bf16 mode, keyed by the view's generation
        self._v16 = None
        self._v16_gen = -1

    def _corpus(self, view):
        if self.compute_dtype != torch.bfloat16:
            return view.vectors
        if self._v16 is None or self._v16_gen != view.generation:
            self._v16 = view.vectors.to(torch.bfloat16)
            self._v16_gen = view.generation
        return self._v16

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
        q = torch.from_numpy(np.ascontiguousarray(query_rows(queries))).to(dev)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask, bool), device=dev)
        retrieve_k = k if negative is None else max(2 * k, 30)
        retrieve_k = min(retrieve_k, view.capacity)
        dist, idx = flat_scan_topk(
            q, self._corpus(view), view.valid, mask, view.norms_sq, view.inv_norms,
            metric=self.store.metric, k=retrieve_k, tile=min(self.tile, view.capacity),
            compute_dtype=self.compute_dtype,
        )
        if negative is not None:
            dist, idx = self.rerank_negative(
                q, dist, idx, negative, negative_weight, min(k, retrieve_k)
            )
        return dist.cpu().numpy(), idx.cpu().numpy()

    def rerank_negative(self, q, dist, idx, negative, weight, k):
        """Negative-example rerank of retrieved candidates: the k with the
        smallest d_query - weight * d_negative, each with its query
        distance (``ops/scan.negative_rerank``). ``dist``/``idx`` are
        [B, R] candidates, host arrays or tensors; ``negative`` f32[B, d]
        or one [d] for every row. Returns (dist f32[B, k], slot i64[B, k])
        tensors on the store's device."""
        dev = self.store.device
        neg = torch.as_tensor(np.asarray(negative, np.float32), device=dev)
        if neg.dim() == 1:
            neg = neg[None, :].expand(q.shape[0], -1)
        return negative_rerank(
            torch.as_tensor(dist, device=dev), torch.as_tensor(idx, device=dev),
            self.store.device_view().vectors, neg, metric=self.store.metric, k=k,
            weight=weight,
        )

    def search(self, query, k: int, **kw):
        """Single-query convenience -> list[(id, distance)]
        (``exact.py:165-175``)."""
        dist, idx = self.search_slots(np.asarray(query, np.float32)[None, :], k, **kw)
        out = []
        for d, s in zip(dist[0], idx[0]):
            if s < 0:
                continue
            vid = self.store.id_of(int(s))
            if vid is not None:
                out.append((vid, float(d)))
        return out
