"""IVF-Flat engine — k-means partitioned corpus, block-pruned search
(PyTorch port of ``quiver_tpu/index/ivf.py``, its read path).

Score only the top-``n_probe`` clusters per query, as one grouped pass over
uniformly padded cluster blocks of residuals (``ops/ivf_kernels.py``), then
rescore the winners exactly in f32 or derive their distances from the
scores. Recall is a direct function of ``n_probe``.

Index state is plain tensors on the store's device, as in the reference
engine: centroids, the residual blocks ``[K, d, Cmax]`` in the engine's
``compute_dtype`` (bf16 by default; f32 where the database and the hybrid
engine build it, ``quiver_tpu/index/ivf.py:1963-1967``), the slot map,
residual norms, inverse norms and the keep mask. Deletes of the layout are
keep-bit tombstones (:meth:`_vacate_slots`); rows outside the blocks sit in
an exactly scanned overflow set that is merged into every answer.

The port has the build, the query, the n_probe tuner (``recall_target``,
:meth:`IVFIndex.tune_n_probe`), the engine's metrics, and the live index:

* the write path — :meth:`IVFIndex.on_insert` places each row at its
  nearest centroid's next free block position (rows past ``cmax`` spill to
  the exactly scanned overflow set; rows the centroids cannot represent go
  there through the ``insert_drift`` router), :meth:`IVFIndex.on_update`
  rewrites a row in place or moves it, :meth:`IVFIndex.on_delete` leaves a
  keep-bit tombstone. The block arrays are written in place by
  :func:`_scatter_blocks_dev`, from rows gathered out of the store's
  device copy (:meth:`IVFIndex._rows_dev`);
* the churn tiers (:meth:`IVFIndex._maybe_rebuild`): a re-layout on the
  trained centroids (:meth:`IVFIndex.refresh`, which escalates to
  :meth:`IVFIndex.build` when the centroids no longer fit the corpus) past
  ``rebuild_growth``, a retrain past ``retrain_growth`` or a drift-heavy
  overflow;
* background maintenance (``background_maintenance=True``): the tier runs
  on a thread into a staging clone built from a store snapshot, catches up
  with racing writes from the store's change feed, and is adopted under the
  engine lock. On a CUDA store the job's device work runs on a stream the
  engine owns (``_maint_stream``); queries and writes run on the caller's
  stream (the device's default stream, where the store syncs). At the swap
  the default stream waits for the job's last replay, and every adopted
  tensor is marked used by it (``record_stream``), so the caching
  allocator cannot give its memory to the next job while serving kernels
  are queued on it. A CPU store runs the same job on its thread with no
  stream. Serving from a stream of higher priority than the job's was
  measured and not kept: the job's host steps, not its kernels, hold
  queries back (``PERF.md``, PR 3).

``formulation="einsum"`` serves through per-cluster query lists of
``q_cap`` columns (:meth:`IVFIndex._q_cap`), whose overflow pairs drop as
the reference's do (``ops/ivf_kernels.py::_einsum_candidates``).

Placement hooks. Every point where the layout meets a device is a method
a sharded subclass overrides (``parallel/sharded_ivf.py``), as the
reference's ``_put_cent_dev`` / ``_put_block_arrays`` / ``_gather_source``
/ ``_layout_on_device`` are: :meth:`IVFIndex._put_cent_dev` (the
centroids), :meth:`IVFIndex._kmeans_source` (the rows Lloyd runs on),
:meth:`IVFIndex._layout_blocks` (the block arrays from the slot map),
:meth:`IVFIndex._rows_dev` (store rows by slot for the write path, the
refresh's assignment and the overflow scan), :meth:`IVFIndex._scatter_block_rows`,
:meth:`IVFIndex._keep_dev`, and the maintenance streams, one per CUDA
device the layout spans (:meth:`IVFIndex._cuda_devices`). On one device
they read the store's device view, as before.

Reference workarounds not ported, because their cause is absent here:

* the host fetch helpers (``utils/transfer.py``; ``ivf.py:1709,1751,1778``)
  — results come back with one ``.cpu()``;
* the XLA persistent compile cache (``quiver_tpu/__init__.py:30-59``);
* ``maint_pace_s`` pacing: ``_pace``, ``_layout_dev_paced`` and
  ``_layout_dev_chunk`` (``ivf.py:199-260,362-372,1244-1248``). Their cause
  is one TPU program holding the chip; here maintenance runs on its own
  CUDA stream and the layout is one torch pass (:func:`_layout_dev`). The
  field stays in :class:`IVFConfig` so configs carry across, and is
  ignored. So the reference's faults of pacing after the last chunk
  (``ivf.py:920,952,1294``) cannot occur here;
* ``_warm_staging`` (``ivf.py:1194-1218``) and the served-shape record it
  reads: it compiles the staging layout's XLA programs before the swap, and
  eager PyTorch compiles nothing;
* the pow2 padding with out-of-bounds ``mode="drop"`` rows of the write
  path, the keep-bit scatter and ``warmup`` (``ivf.py:1447-1458,
  1529-1544, 838-850``), of ``search_slots``' batch
  (``ivf.py:1684-1692``) and of the overflow scan (``ivf.py:1769-1776``):
  they exist for XLA's static shapes; the port scatters and scores exactly
  the batch's rows;
* ``fused_kg`` (``IVFConfig``): the CUDA kernel has no counterpart to the
  Pallas grid's cluster grouping and ignores it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.query import query_rows, supplement
from quiver_tpu_torch.ops.distance import pairwise_distance
from quiver_tpu_torch.ops.ivf_kernels import (
    POS_BITS,
    R_WIN,
    WIN,
    balance_assignment,
    ivf_query,
    split_oversized,
    train_kmeans,
)
from quiver_tpu_torch.ops.scan import MASKED_DIST
from quiver_tpu_torch.types import DistanceType
from quiver_tpu_torch.utils.profiling import trace_span

_log = logging.getLogger(__name__)

#: swap-time replay budget: deltas larger than this replay without the
#: engine lock first (catch-up loop), so the final locked replay — the only
#: write/query stall the swap imposes — stays small and bounded
_LOCKED_REPLAY_MAX = 8192

#: :meth:`IVFIndex.search_slots`' counters (``get_detailed_metrics()["search"]``)
_SEARCH_COUNTERS = ("calls", "queries", "exact_route_calls", "underfill_calls",
                    "underfill_rows", "overflow_merges", "fill_host_checks")


def _pow2(n: int, lo: int = 8, hi: int = 1 << 30) -> int:
    c = lo
    while c < n and c < hi:
        c *= 2
    return c


def _cmax_shape(want: float) -> int:
    """Block width: a multiple of 128 (whole 128-column kernel slabs);
    small corpora keep a pow2 below 128."""
    w = int(np.ceil(want))
    if w >= 128:
        return (w + 127) // 128 * 128
    return _pow2(w, lo=8)


def _layout_dev(block_slot, vectors, norms_sq, cents, dtype):
    """Block layout in one pass on the device: gather every placed row
    from the store's device copy and form the block arrays. Returns
    (blocks_t ``dtype``[K, d, Cmax], rns f32[K, Cmax], inv f32[K, Cmax],
    keep bool[K, Cmax], rsum f32[]): ``rsum`` is the sum of the placed
    rows' squared residuals (unoccupied positions add zero), the drift
    baseline's numerator."""
    keep = block_slot >= 0
    safe = block_slot.clamp_min(0).long()
    resid = torch.where(keep[..., None], vectors[safe] - cents[:, None, :], 0.0)
    rns = torch.sum(resid * resid, dim=2)
    ns = torch.where(keep, norms_sq[safe], 0.0)
    inv = torch.where(ns > 0, torch.rsqrt(torch.clamp(ns, min=1e-30)), 0.0)
    blocks_t = resid.transpose(1, 2).to(dtype).contiguous()
    return blocks_t, rns, inv, keep, torch.sum(rns)


def _affine_scores(v, cent, c_ns, live):
    """Nearest-centroid affine scores 2 v.c - |c|^2, reserved ids
    (``live`` False; None = all live) masked to -inf."""
    scores = 2.0 * (v @ cent.T) - c_ns[None, :]
    if live is not None:
        scores = torch.where(live[None, :], scores, -torch.inf)
    return scores


def _nearest_centroid(v, cent, c_ns, live):
    """(argmax, max) of :func:`_affine_scores`. |v - c*|^2 = |v|^2 - max,
    so the max doubles as a residual readout (the drift router and the
    refresh drift detector)."""
    scores = _affine_scores(v, cent, c_ns, live)
    best = torch.argmax(scores, dim=1)
    return best, scores.gather(1, best[:, None])[:, 0]


def _scatter_blocks_dev(
    blocks_t, block_ns, block_inv, block_slot,
    v, ns, cent, rows, pos, slots,
):
    """A write batch's block-array maintenance, in place: from the batch's
    rows ``v`` f32[m, d] and their squared norms ``ns``, form residuals and
    per-row stats, and scatter all four block arrays at (cluster ``rows``,
    position ``pos``), writing ``slots`` into the slot map. Index tensors
    are int64 on the blocks' device, one entry per row.

    ``blocks_t[rows, :, pos]`` is mixed advanced indexing on [K, d, Cmax]:
    the two index tensors are separated by a slice, so the indexed view is
    laid out [m, d] with the advanced dimension first (numpy's rule), and
    each row writes d values of the blocks' dtype at stride Cmax."""
    resid = v - cent[rows]
    rns = torch.sum(resid * resid, dim=1)
    inv = torch.where(ns > 0, torch.rsqrt(torch.clamp(ns, min=1e-30)), 0.0)
    blocks_t[rows, :, pos] = resid.to(blocks_t.dtype)
    block_ns[rows, pos] = rns
    block_inv[rows, pos] = inv
    block_slot[rows, pos] = slots.to(block_slot.dtype)


def _overflow_topk(q, slots, rows, rows_ns, *, metric, k):
    """Exactly score an overflow slot list (its rows f32[m, d] and their
    squared norms) against a query batch and keep the per-query top-k, on
    the device."""
    d = pairwise_distance(q, rows, metric, v_norms_sq=rows_ns)
    out_d, pos = torch.topk(d, min(k, slots.shape[0]), dim=1, largest=False)
    return out_d, torch.where(out_d >= MASKED_DIST, -1, slots[pos])


@dataclass
class IVFConfig:
    """Same fields and defaults as ``quiver_tpu.index.ivf.IVFConfig``, so
    configs carry across. Fields of parts not ported yet are kept and
    documented where they are read."""

    #: clusters; None = auto (pow2 nearest sqrt(N) at build time)
    n_clusters: Optional[int] = None
    #: clusters probed per query — THE recall/speed knob
    n_probe: int = 32
    #: per-cluster row capacity factor over the mean (oversized clusters split)
    cmax_factor: float = 1.25
    kmeans_iters: int = 10
    #: reference: recall target of approx_max_k; the port's top-k is exact
    #: and ignores it
    probe_approx: Optional[float] = 0.98
    #: set = packed windowed top-P probe selection (ops/ivf_kernels.py);
    #: None = exact
    probe_sel_approx: Optional[float] = 0.99
    #: survivors through the low-precision stage, as a multiple of k
    oversample: int = 4
    #: einsum formulation only: per-cluster query-list width over the mean
    #: pairs per cluster (overflow pairs drop)
    q_cap_factor: int = 4
    #: "auto" resolves to "pairs"; "fused" = the reference's fused stage
    #: shape (128-lane windows, top 4); "einsum" = per-cluster query lists
    #: and one batched GEMM
    formulation: str = "auto"
    #: window width of the pairs stage's top-2 reduce
    seg_width: Optional[int] = 32
    #: reference Pallas grid grouping; the CUDA kernel ignores it
    fused_kg: int = 4
    #: exact f32 re-rank of the survivors (True) vs score-derived distances
    rescore: bool = True
    #: below a quarter of this many rows the exact scan serves queries
    build_threshold: int = 8192
    #: re-layout (:meth:`IVFIndex.refresh`, existing centroids) when
    #: (inserts+updates+deletes since the layout) / built size exceeds this
    rebuild_growth: float = 0.3
    #: full retrain (k-means + split) when that ratio exceeds this
    retrain_growth: float = 1.0
    #: refresh escalates to a retrain when the corpus's mean squared
    #: residual exceeds this multiple of the at-build value
    refresh_drift: float = 2.0
    #: per-row drift router: a written row whose squared residual exceeds
    #: this multiple of the at-build mean goes to the exactly scanned
    #: overflow set instead of a block (None disables it)
    insert_drift: Optional[float] = 6.0
    #: churn maintenance goes straight to a retrain when drift-routed
    #: overflow exceeds this fraction of the built corpus
    drift_rebuild: float = 0.03
    #: run churn-triggered refresh/retrain in the background (a thread; on
    #: a CUDA store its device work runs on the engine's own stream);
    #: False runs the tier inline inside the triggering write call
    background_maintenance: bool = True
    #: reference: sleep between the maintenance job's TPU programs. Ignored
    #: here (the job runs on its own CUDA stream; module docstring); kept
    #: so configs carry across
    maint_pace_s: float = 0.05
    #: n_probe tuner: set = build() tunes n_probe to this recall@10
    recall_target: Optional[float] = None
    recall_sample: int = 1024
    recall_jitter: float = 0.1
    n_probe_max: int = 64
    seed: int = 42


class IVFIndex:
    """Inverted-file engine over a shared VectorStore, on the store's
    device."""

    name = "ivf"

    def __init__(
        self,
        store: VectorStore,
        *,
        config: Optional[IVFConfig] = None,
        compute_dtype=torch.bfloat16,
        **cfg_overrides,
    ):
        """``compute_dtype``: the residual blocks' dtype, ``torch.bfloat16``
        (the reference's default, ``ivf.py:420``) or ``torch.float32`` (what
        the database and the hybrid engine pass by default). bf16 blocks run
        the bf16 tensor-core kernel; f32 blocks the 3xTF32 one, which keeps
        the reference's f32 products to within f32 rounding."""
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(
                f"IVFIndex compute_dtype={compute_dtype}: torch.bfloat16 or torch.float32"
            )
        self.store = store
        self.device = store.device
        self.config = config or IVFConfig(**cfg_overrides)
        self.compute_dtype = compute_dtype
        self._exact = ExactIndex(store)
        #: bool[K] — False rows are reserved cluster ids (None = all live)
        self._cluster_live = None
        self._built = False
        self._centroids = None  # np f32[K, d]
        self._cent_dev = None  # (centroids, cent_norms_sq) on the device
        self._blocks_t = None  # compute_dtype[K, d, Cmax] residuals
        self._block_slot = None  # i32[K, Cmax]
        self._block_ns = None  # f32[K, Cmax] residual norms
        self._block_inv = None  # f32[K, Cmax] 1/|v| full-vector
        self._block_keep = None  # bool[K, Cmax] occupied & live
        self._keep_pending: list[tuple[int, int, bool]] = []  # lazy scatters
        self._fill = None  # np i64[K] next free position per cluster
        self._built_resid = None  # mean |v - c|^2 at layout (drift baseline)
        self._slot_pos = None  # np i64[cap, 2] slot -> (cluster, pos), -1
        self._overflow: set[int] = set()
        #: subset of _overflow routed there by the per-row drift router
        #: (config.insert_drift): refresh keeps them; only a retrain drains
        self._drift: set[int] = set()
        self._built_size = 0
        self._churn = 0
        self._cmax = None
        self._n_retrains = 0  # full k-means builds
        self._n_refreshes = 0  # re-layouts on existing centroids
        self._tuned_n_probe: Optional[int] = None  # recall_target tuner pick
        self._tuned_recall: Optional[float] = None  # its measured recall@k
        self._tuned_stderr: Optional[float] = None  # holdout sampling stderr
        self._last_rebuild_s = 0.0
        #: search_slots' counters since the last build (_SEARCH_COUNTERS)
        self._search_counts = dict.fromkeys(_SEARCH_COUNTERS, 0)
        self._counts_lock = threading.Lock()
        # --- background maintenance: the engine lock serializes writes,
        # layout swaps and the query path's host preamble; a staging clone
        # (same class, same store) builds the next layout off-thread and
        # _adopt() transplants it
        self._lock = threading.RLock()
        self._staging = False  # True on maintenance clones (inert triggers)
        self._layout_gen = 0  # bumps on every installed layout
        self._maint_thread: Optional[threading.Thread] = None
        self._maint_pending: Optional[str] = None
        self._maint_error: Optional[str] = None
        self._maint_swaps = 0
        self._maint_last_stall_s = 0.0
        #: the streams the maintenance job's device work runs on, one per
        #: CUDA device of the layout (:meth:`_cuda_devices`; created with
        #: the first job)
        self._maint_streams: dict = {}

    @property
    def size(self) -> int:
        return self.store.size

    @property
    def _maint_stream(self) -> Optional[torch.cuda.Stream]:
        """The maintenance stream of the engine's own device (None on the
        CPU or before the first job)."""
        return self._maint_streams.get(self.device)

    @property
    def n_clusters(self) -> Optional[int]:
        return None if self._centroids is None else len(self._centroids)

    # ---------------------------------------------------------------- build

    def _auto_k(self, n_live: int) -> int:
        want = int(np.sqrt(n_live))
        return max(8, min(_pow2(want), n_live // 8))

    def build(self, k: Optional[int] = None) -> None:
        """(Re)train k-means over live rows and lay out the block tensor;
        with ``config.recall_target`` set, then tune ``n_probe``."""
        with self._lock:
            with trace_span("ivf.build") as span:
                c = self.config
                valid = self.store._np_valid
                span.n = n_live = int(valid.sum())
                if n_live < 16:
                    return
                K = k or c.n_clusters or self._auto_k(n_live)
                K = min(K, n_live)
                vectors_dev, valid_dev = self._kmeans_source()
                cents, assign = train_kmeans(
                    self.store._np_vectors, valid, K, n_iters=c.kmeans_iters,
                    seed=c.seed, vectors_dev=vectors_dev, valid_dev=valid_dev,
                )
                # cap clusters by SPLITTING, never by spilling rows far away
                cmax = _cmax_shape(c.cmax_factor * max(n_live, 1) / K)
                cents, assign = split_oversized(
                    self.store._np_vectors, cents, np.asarray(assign, np.int64),
                    cmax, seed=c.seed,
                )
                # de-correlate cluster ids from space, so the windowed probe
                # selection's 128-id windows are a random partition of space
                perm = np.random.default_rng(c.seed + 1).permutation(len(cents))
                cents = cents[np.argsort(perm)]
                assign = np.where(assign >= 0, perm[assign], -1)
                cents, assign = self._prepare_clusters(cents, assign)
                self._centroids = cents
                self._cent_dev = self._put_cent_dev(cents)
                self._layout_from_assign(assign, len(cents), cmax=cmax)
                self._n_retrains += 1
                if c.recall_target is not None:
                    self.tune_n_probe()
            self._last_rebuild_s = span.seconds
            with self._counts_lock:
                self._search_counts = dict.fromkeys(_SEARCH_COUNTERS, 0)

    # --------------------------------------------------------- n_probe tuner

    def tune_n_probe(self, k: int = 10) -> Optional[int]:
        """Pick the smallest ``n_probe`` whose measured recall@``k`` on a
        held-out jittered sample meets ``config.recall_target``, and install
        it as the engine's serving value (``quiver_tpu/index/ivf.py:555-685``).

        Two passes. First a host estimate: the probe-inclusion recall curve
        (:meth:`_probe_inclusion_recall`), simulating the probe selection of
        ``ops/ivf_kernels._select_probes``. Then a measured check: real
        engine queries at the estimated pick against the exact oracle,
        escalating while short of target. Recall is tie-aware: a returned
        row counts when its true f64 distance is within the oracle's k-th
        (+rel tol). A pick is accepted on the holdout's mean minus one
        stderr; a step that buys less than half a stderr stops the walk
        (probe plateau); the cheapest passing pick is served; when none
        passes and rescore is off, the exact f32 rescore is tried as the
        second axis.

        The oracle is the engine's exact scan (f32, TF32 off) at depth
        max(4k, k+32), rescored in f64: the k-th of the rescored deeper set
        is the true k-th distance.

        Returns the chosen value, or None when the corpus is too small to
        tune meaningfully (the configured n_probe stands)."""
        with self._lock:
            target = self.config.recall_target
            if target is None or not self._built:
                return None
            rows = np.flatnonzero(self.store._np_valid)
            S = min(self.config.recall_sample, len(rows))
            if len(rows) < 32 * k or S < 32:
                return None
            rng = np.random.default_rng(self.config.seed + 7)
            sample = rng.choice(rows, size=S, replace=False)
            base = self.store._np_vectors[sample]
            q = (
                base
                + self.config.recall_jitter
                * base.std(axis=0, keepdims=True)
                * rng.standard_normal(base.shape)
            ).astype(np.float32)
            deep = min(max(4 * k, k + 32), len(rows))
            _, cand = self._exact.search_slots(q, deep)
            d_cand = self._host_dist_f64(q, cand)  # +inf for -1 slots
            order = np.argsort(d_cand, axis=1)
            d_sorted = np.take_along_axis(d_cand, order, axis=1)
            truth = np.take_along_axis(cand, order, axis=1)[:, :k]
            kth = d_sorted[:, k - 1]  # finite: len(rows) >= 32*k >= deep
            thr = kth * (1 + 1e-6) + 1e-12

            def tie_recall(got: np.ndarray) -> tuple[float, float]:
                """(mean, stderr) of per-query tie-aware recall@k."""
                d = self._host_dist_f64(q, got)
                ok = (got >= 0) & (d <= thr[:, None])
                per_q = np.minimum(ok.sum(axis=1), k) / k
                return float(per_q.mean()), float(per_q.std() / np.sqrt(len(per_q)))

            p_max = min(self.config.n_probe_max, self.n_clusters)
            est = self._probe_inclusion_recall(q, truth, p_max)
            # smallest P whose estimated inclusion meets target (inclusion
            # upper-bounds engine recall, so start here and verify up)
            picks = np.flatnonzero(est >= target)
            p = int(picks[0]) + 1 if len(picks) else p_max
            history: list[tuple[int, float, float]] = []
            while True:
                self.config.n_probe = p
                _, got = self.search_slots(q, k)
                hit, err = tie_recall(got)
                history.append((p, hit, err))
                if hit - err >= target or p >= p_max:
                    break
                if len(history) >= 2 and hit - history[-2][1] < max(0.5 * err, 1e-3):
                    break  # probe plateau: more probes will not reach target
                p = min(p_max, max(p + 1, int(np.ceil(p * 1.5))))
            ok = [t for t in history if t[1] - t[2] >= target]
            if ok:
                p, hit, err = min(ok, key=lambda t: t[0])
            else:
                best_hit = max(h for _, h, _ in history)
                p, hit, err = min(
                    (t for t in history if t[1] >= best_hit - 0.5 * t[2]),
                    key=lambda t: t[0],
                )
            if hit - err < target and not self.config.rescore:
                # second axis: exact f32 rescore of the survivors
                self.config.n_probe = p
                self.config.rescore = True
                _, got = self.search_slots(q, k)
                hit2, err2 = tie_recall(got)
                if hit2 - err2 >= target or hit2 - hit >= 0.005:
                    hit, err = hit2, err2
                else:
                    self.config.rescore = False
            self.config.n_probe = p
            self._tuned_n_probe = p
            self._tuned_recall = float(hit)
            self._tuned_stderr = float(err)
            return p

    @property
    def recall_shortfall(self) -> bool:
        """True when the tuner measured short of ``config.recall_target``
        by more than half a point (it escalated to ``n_probe_max`` or
        plateaued): the corpus geometry defeats IVF pruning."""
        t = self.config.recall_target
        return (
            t is not None
            and self._tuned_recall is not None
            and self._tuned_recall < t - 0.005
        )

    def _host_dist_f64(self, q: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """True f64 distances d(q[b], store[slots[b, j]]) -> f64[S, k] on
        the host, with the semantics of ``ops/distance`` (guards included);
        slots < 0 get +inf. The tuner's tie arbiter."""
        metric = self.store.metric
        v = self.store._np_vectors[np.maximum(slots, 0)].astype(np.float64)
        qq = q.astype(np.float64)[:, None, :]
        if metric == DistanceType.MANHATTAN:
            d = np.abs(qq - v).sum(axis=2)
        else:
            dots = (qq * v).sum(axis=2)
            if metric == DistanceType.DOT_PRODUCT:
                d = 1.0 - dots
            elif metric == DistanceType.COSINE:
                qn = np.sqrt((qq * qq).sum(axis=2))
                vn = np.sqrt((v * v).sum(axis=2))
                nz = (qn > 0) & (vn > 0)
                sim = np.where(nz, dots / np.maximum(qn * vn, 1e-30), 0.0)
                d = 1.0 - np.clip(sim, -1.0, 1.0)
            else:
                d2 = np.maximum(
                    (qq * qq).sum(axis=2) + (v * v).sum(axis=2) - 2.0 * dots, 0.0
                )
                d = d2 if metric == DistanceType.SQUARED_EUCLIDEAN else np.sqrt(d2)
        return np.where(slots >= 0, d, np.inf)

    def _probe_inclusion_recall(
        self, q: np.ndarray, truth: np.ndarray, p_max: int
    ) -> np.ndarray:
        """est[P-1] = mean fraction of true top-k rows reachable with P
        probes, for P in 1..p_max: host math that scores centroids the way
        ``ops/ivf_kernels.probe_stage`` does and simulates
        ``_select_probes``: top-2 per 128-id window ranked by score while
        ``probe_sel_approx`` is set, K >= 256 and nwin >= P, the exact
        ranking otherwise. Overflow rows count as found (the serving path
        scans them exactly).

        ``truth`` comes from the live store, which may have grown past the
        snapshot this layout was built on (a background build's staging
        clone shares the store while writes land): slots at or past
        ``len(self._slot_pos)`` are newer than the layout, the job's replay
        places them later, and they count as overflow rows (found), as
        unplaced rows do."""
        c = self.config
        cents = self._centroids
        K = len(cents)
        c_dots = q.astype(np.float32) @ cents.T
        c_ns = np.sum(cents.astype(np.float64) ** 2, axis=1).astype(np.float32)
        metric = self.store.metric
        if metric == DistanceType.COSINE:
            scores = c_dots / np.sqrt(np.maximum(c_ns, 1e-30))[None, :]
        elif metric == DistanceType.DOT_PRODUCT:
            scores = c_dots
        else:
            scores = 2.0 * c_dots - c_ns[None, :]
        if self._cluster_live is not None:
            scores = np.where(self._cluster_live[None, :], scores, -np.inf)
        S = len(q)
        nwin = (K + 127) // 128
        use_windowed = c.probe_sel_approx is not None and K >= 256
        if use_windowed:
            sw = np.full((S, nwin * 128), -np.inf, np.float32)
            sw[:, :K] = scores
            sw = sw.reshape(S, nwin, 128)
            # top-2 per 128-id window, window winners ranked by score: the
            # device selection's candidate pool
            top2 = np.argpartition(-sw, 1, axis=2)[:, :, :2]
            wins_s = np.take_along_axis(sw, top2, axis=2).reshape(S, -1)
            wins_i = (np.arange(nwin)[None, :, None] * 128 + top2).reshape(S, -1)
            order = np.argsort(-wins_s, axis=1, kind="stable")
            ranked_w = np.take_along_axis(wins_i, order, axis=1)
        order_e = np.argsort(-scores, axis=1, kind="stable")
        # cluster of each true top-k row; overflow/unplaced rows (cluster
        # -1) count as found, and so do slots newer than the layout
        known = (truth >= 0) & (truth < len(self._slot_pos))
        t_clust = np.where(
            known, self._slot_pos[np.where(known, truth, 0), 0],
            np.where(truth >= 0, -1, -2),
        )
        est = np.empty(p_max, np.float64)
        found = np.zeros(truth.shape, bool) | (t_clust == -1)
        found_e = found.copy()
        for P in range(1, p_max + 1):
            if use_windowed and nwin >= P:
                found |= ranked_w[:, P - 1][:, None] == t_clust
                est[P - 1] = found.mean()
            else:
                # the exact ranking: union over its prefix
                found_e |= (order_e[:, :P, None] == t_clust[:, None, :]).any(axis=1)
                est[P - 1] = (found_e | (t_clust == -1)).mean()
        return est

    # ------------------------------------------------------------ metrics

    def get_optimization_parameters(self) -> dict:
        return {
            "n_probe": self.config.n_probe,
            "n_clusters": self.n_clusters,
            "kmeans_iters": self.config.kmeans_iters,
        }

    def set_optimization_parameters(self, **params) -> None:
        if "n_probe" in params:
            p = int(params["n_probe"])
            if p <= 0:
                raise ValueError("n_probe must be positive")
            self.config.n_probe = p
        unknown = set(params) - {"n_probe"}
        if unknown:
            raise ValueError(f"immutable or unknown parameters: {sorted(unknown)}")

    def get_detailed_metrics(self) -> dict:
        """The reference's keys (``quiver_tpu/index/ivf.py:1809-1843``), and
        ``search``: :meth:`search_slots`' counters since the last build
        (calls, queries, calls routed whole to the exact scan, calls with
        under-filled rows and those rows, calls that merged the overflow
        set, calls whose under-fill test counted the rows on the host)."""
        with self._counts_lock:
            search = dict(self._search_counts)
        with self._lock:
            inflight = (
                self._maint_thread is not None and self._maint_thread.is_alive()
            )
            return {
                "size": self.size,
                "built": self._built,
                "n_clusters": self.n_clusters,
                "overflow": len(self._overflow),
                "drift_overflow": len(self._drift),
                "churn_since_build": self._churn,
                "retrains": self._n_retrains,
                "refreshes": self._n_refreshes,
                "last_retrain_s": round(self._last_rebuild_s, 3),
                "search": search,
                "tuned_n_probe": self._tuned_n_probe,
                "tuned_recall": (
                    None if self._tuned_recall is None else round(self._tuned_recall, 4)
                ),
                "tuned_recall_stderr": (
                    None if self._tuned_stderr is None else round(self._tuned_stderr, 4)
                ),
                "maintenance": {
                    "inflight": inflight,
                    "pending": self._maint_pending,
                    "swaps": self._maint_swaps,
                    "last_swap_stall_s": round(self._maint_last_stall_s, 4),
                    "error": self._maint_error,
                },
                "device_bytes": self.device_bytes(),
                "config": self.get_optimization_parameters(),
            }

    def _count(self, **counts: int) -> None:
        with self._counts_lock:
            for key, v in counts.items():
                self._search_counts[key] += v

    def device_bytes(self) -> dict:
        """Card footprint: the engine's own tensors (blocks, centroids,
        masks; the shared store excluded) and the store's device view."""
        from quiver_tpu_torch.utils.memory import device_bytes, store_device_bytes

        own = device_bytes(self, skip=(VectorStore,))
        st = store_device_bytes(self.store)
        n = max(self.store.size, 1)
        return {
            "engine": own,
            "store": st,
            "total": own + st,
            "per_vector": round((own + st) / n, 1),
        }

    def _prepare_clusters(self, cents, assign):
        """Hook: remap (centroids, assignment) into the engine's cluster id
        space before layout (identity on one device)."""
        self._cluster_live = None
        return cents, assign

    def _put_cent_dev(self, cents: np.ndarray):
        """Hook: (centroids f32[K, d], their squared norms) on the engine's
        device, for the probe and the write path's assignment."""
        cent = torch.from_numpy(np.ascontiguousarray(cents, np.float32)).to(self.device)
        return cent, torch.sum(cent * cent, dim=1)

    def _kmeans_source(self):
        """Hook: the device rows Lloyd's k-means runs on, as (vectors,
        valid): the store's view."""
        view = self.store.device_view()
        return view.vectors, view.valid

    def _rows_dev(self, slots_np: np.ndarray):
        """Hook: (vectors f32[m, d], norms_sq f32[m]) of store rows by slot,
        on the engine's device: gathered from the store's device copy
        (already synced by the store's writes), so only the slot indices
        upload."""
        view = self.store.device_view()
        idx = torch.from_numpy(np.ascontiguousarray(slots_np, np.int64)).to(self.device)
        return view.vectors[idx], view.norms_sq[idx]

    def _cuda_devices(self) -> list:
        """Hook: the CUDA devices the layout spans (a maintenance stream
        each)."""
        return [self.device] if self.device.type == "cuda" else []

    def _cent_tensors(self) -> list:
        """Hook: the centroid tensors on the devices (a staging clone
        shares them)."""
        return list(self._cent_dev or ())

    def _layout_tensors(self) -> list:
        """Hook: every device tensor of the serving layout (a maintenance
        swap marks them used by the serving streams)."""
        return [*self._cent_tensors(), self._blocks_t, self._block_slot, self._block_ns,
                self._block_inv, self._block_keep]

    def _live_dev(self) -> Optional[torch.Tensor]:
        """``_cluster_live`` on the device (None: every cluster is live)."""
        if self._cluster_live is None:
            return None
        return torch.as_tensor(np.asarray(self._cluster_live, bool), device=self.device)

    def _assign_scores(self, vectors: np.ndarray) -> np.ndarray:
        """Nearest-centroid affine scores for host rows (balance pass)."""
        v = torch.as_tensor(np.asarray(vectors, np.float32), device=self.device)
        return _affine_scores(v, *self._cent_dev, self._live_dev()).cpu().numpy()

    def _assign_nearest(self, vectors: np.ndarray, chunk: int = 1 << 16):
        """Nearest live-centroid id per host row, row-chunked so the
        [chunk, K] score tensor stays bounded."""
        cent, c_ns = self._cent_dev
        live = self._live_dev()
        out = np.empty(len(vectors), np.int64)
        for at in range(0, len(vectors), chunk):
            v = torch.as_tensor(
                np.asarray(vectors[at: at + chunk], np.float32), device=self.device
            )
            out[at: at + len(v)] = _nearest_centroid(v, cent, c_ns, live)[0].cpu().numpy()
        return out

    def _assign_nearest_slots(self, slots: np.ndarray, chunk: int = 1 << 16):
        """(nearest live-centroid id i64, winning affine score f32) for
        store rows by slot, in chunks of ``chunk`` rows (:meth:`_rows_dev`:
        on one device a full-corpus refresh uploads only slot indices)."""
        cent, c_ns = self._cent_dev
        live = self._live_dev()
        n = len(slots)
        out = np.empty(n, np.int64)
        scores = np.empty(n, np.float32)
        for at in range(0, n, chunk):
            sl = slots[at: at + chunk]
            a, sc = _nearest_centroid(self._rows_dev(sl)[0], cent, c_ns, live)
            out[at: at + len(sl)] = a.cpu().numpy()
            scores[at: at + len(sl)] = sc.cpu().numpy()
        return out, scores

    # ---------------------------------------------------------------- warmup

    def warmup(
        self,
        *,
        query_batches=(1, 256, 8192),
        write_batches=(256, 8192),
        k: int = 10,
    ) -> float:
        """Run the serving query once per batch size and the write path's
        device steps once per write batch size, leaving the layout
        untouched; returns wall seconds (synchronized on CUDA).

        There is no compile to warm: PyTorch runs eagerly. What the first
        call of each shape pays here is first use — cuBLAS handles and
        workspaces, the caching allocator's growth to the batch's working
        set — so the benches' per-batch write walls measure the write path.
        The write half assigns ``b`` rows (store row 0, repeated; a read)
        and scatters an empty batch."""
        t0 = time.perf_counter()
        with self._lock:
            if not self._built:
                return 0.0
            d = self.store.dim
            for b in query_batches:
                self.search_slots_device(
                    torch.zeros((int(b), d), device=self.device), k
                )
            empty = np.zeros(0, np.int64)
            for b in write_batches:
                self._assign_slots(np.zeros(int(b), np.int64))
                self._scatter_block_rows(empty, empty, empty)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # -------------------------------------------------------- churn tiers

    def refresh(self) -> None:
        """Re-layout every live row against the EXISTING centroids — no
        k-means retrain, no cluster split: one chunked nearest-centroid
        assignment plus the deterministic block layout. Absorbs the
        overflow set, tombstoned block positions and update fragmentation,
        and keeps the centroid set, cluster ids and cmax. Rows that land in
        a full cluster spill to their nearest cluster with room
        (``balance_assignment``); escalates to :meth:`build` when there is
        no room even with spill, when drift-routed rows exceed
        ``drift_rebuild`` of the corpus, when spill would exceed 2% of the
        rows, or when the mean squared residual exceeds ``refresh_drift``
        times the at-build value (``ivf.py:955-1033``)."""
        with self._lock:
            if not self._built or self._centroids is None:
                return self.build()
            rows = np.flatnonzero(self.store._np_valid)
            n_live = len(rows)
            if n_live < 16:
                self._built = False
                return
            K = len(self._centroids)
            cmax = int(self._cmax)
            n_live_clusters = (
                K if self._cluster_live is None else int(self._cluster_live.sum())
            )
            if n_live > n_live_clusters * cmax:
                return self.build()  # no room even with spill
            a, best_s = self._assign_nearest_slots(rows)
            vecs = self.store._np_vectors[rows]  # host-only drift stat
            # per-row drift router (the on_insert criterion): rows the
            # trained centroids cannot represent stay in overflow
            drift = self._drift_mask(vecs, best_s)
            if drift.sum() > self.config.drift_rebuild * n_live:
                return self.build()  # drift-heavy: only a retrain drains it
            drift_slots = rows[drift]
            if drift.any():
                rows, a, vecs = rows[~drift], a[~drift], vecs[~drift]
                best_s = best_s[~drift]
                n_live = len(rows)
                if n_live < 16:
                    return self.build()
            assign = np.full(self.store.capacity, -1, np.int64)
            assign[rows] = a
            counts = np.bincount(a, minlength=K)
            spill = int(np.maximum(counts - cmax, 0).sum())
            if spill > 0.02 * n_live:
                return self.build()  # heavy overflow: centroids are stale
            # drift detector: |v - c*|^2 = |v|^2 - best affine score
            vns = np.sum(vecs.astype(np.float64) ** 2, axis=1)
            resid_ms = float(np.mean(np.maximum(vns - best_s, 0.0)))
            if self._built_resid is not None and resid_ms > (
                self.config.refresh_drift * max(self._built_resid, 1e-12) + 1e-9
            ):
                return self.build()
            base = self._built_resid
            self._layout_from_assign(assign, K, cmax=cmax)
            # the drift baseline belongs to the TRAINED centroids:
            # successive refreshes must not ratchet it up
            self._built_resid = base
            if len(drift_slots):
                self._overflow.update(int(s) for s in drift_slots)
                self._drift.update(int(s) for s in drift_slots)
            self._n_refreshes += 1

    def _maybe_rebuild(self) -> None:
        if self._staging:
            return  # maintenance clones never recurse into maintenance
        c = self.config
        if not self._built:
            # the initial build is a bulk-load moment: synchronous
            if self.store.size >= c.build_threshold:
                self.build()
            return
        if not self._built_size:
            return
        ratio = self._churn / max(self._built_size, 1)
        if ratio > c.retrain_growth or len(self._drift) > c.drift_rebuild * self._built_size:
            kind = "build"
        elif (
            ratio > c.rebuild_growth
            # spill overflow is what a re-layout reclaims; drift rows do
            # not count toward the refresh trigger
            or (len(self._overflow) - len(self._drift)) > 0.05 * self._built_size
        ):
            kind = "refresh"
        else:
            return
        if not c.background_maintenance:
            (self.build if kind == "build" else self.refresh)()
            return
        self._submit_maintenance(kind)

    # ------------------------------------------------ background maintenance

    def _submit_maintenance(self, kind: str) -> None:
        """Queue a churn-triggered rebuild on the maintenance thread. One
        job runs at a time; a second trigger while one is in flight queues
        (a queued refresh upgrades to a retrain, never the reverse)."""
        with self._lock:
            if self._maint_thread is not None and self._maint_thread.is_alive():
                if kind == "build" or self._maint_pending == "build":
                    self._maint_pending = "build"
                else:
                    self._maint_pending = self._maint_pending or kind
                return
            for dev in self._cuda_devices():
                if dev not in self._maint_streams:
                    self._maint_streams[dev] = torch.cuda.Stream(device=dev)
            t = threading.Thread(
                target=self._maintenance_job, args=(kind,),
                name="ivf-maintenance", daemon=True,
            )
            self._maint_thread = t
            t.start()

    def wait_maintenance(self, timeout: Optional[float] = None) -> bool:
        """Block until no maintenance job runs or queues (True), or the
        timeout lapses (False). Benches and tests use it to make background
        rebuilds deterministic; serving code never needs it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                t = self._maint_thread
                if t is None and self._maint_pending is None:
                    return True
            if t is None:
                time.sleep(0.005)
            else:
                t.join(None if deadline is None else max(deadline - time.monotonic(), 0.0))
            if deadline is not None and time.monotonic() >= deadline:
                with self._lock:
                    return self._maint_thread is None and self._maint_pending is None

    def _maintenance_job(self, kind: str) -> None:
        ok = False
        try:
            with contextlib.ExitStack() as stack:
                for stream in self._maint_streams.values():
                    stack.enter_context(torch.cuda.stream(stream))
                try:
                    self._run_maintenance(kind)
                finally:
                    # the job ends when its device work ends
                    for stream in self._maint_streams.values():
                        stream.synchronize()
            ok = True
        except Exception as e:  # noqa: BLE001 — background thread boundary
            _log.exception("IVF background maintenance (%s) failed", kind)
            self._maint_error = repr(e)
        finally:
            # clear and re-evaluate under ONE lock acquisition, so a waiter
            # never observes (no thread, no pending) while a queued job is
            # owed a thread; triggers that fired during the job re-check
            # against the post-swap counters. On failure nothing
            # re-submits: churn was not reset, so the next write re-triggers.
            with self._lock:
                if ok:
                    self._maint_error = None
                self._maint_thread = None
                pending, self._maint_pending = self._maint_pending, None
                if pending is not None and ok:
                    self._maybe_rebuild()

    def _run_maintenance(self, kind: str) -> None:
        """Double-buffered rebuild: build the next layout into a staging
        clone from a store snapshot, catch up with writes that landed
        meanwhile from the store's change feed (without the engine lock
        while the delta is large), then take the lock for one final small
        replay and the field swap. Write calls stall only for that last
        replay (at most ``_LOCKED_REPLAY_MAX`` rows); queries keep serving
        the old layout, which also absorbed every write, throughout. A
        capacity growth (``changes_since`` returns None) restarts the job."""
        for _attempt in range(4):
            gen0 = self._layout_gen
            # the cursor first: every write before it is in the host
            # mirror, and the staging layout's first device_view() syncs it
            # on the store's stream and orders this stream after it
            cursor, _ = self.store.changes_since(None)
            eng = self._make_staging(kind)
            if kind == "build" or not eng._built:
                eng.build()
            else:
                eng.refresh()  # may escalate to build() internally
            if not eng._built:
                return  # corpus shrank below viability; exact path serves
            restart = False
            while True:
                cursor, delta = self.store.changes_since(cursor)
                if delta is None:
                    restart = True  # capacity growth / feed overflow
                    break
                if len(delta) > _LOCKED_REPLAY_MAX:
                    self._replay_into(eng, delta)
                    continue
                t0 = time.perf_counter()
                with self._lock:
                    if self._layout_gen != gen0:
                        return  # an explicit build/import superseded us
                    cursor, delta2 = self.store.changes_since(cursor)
                    if delta2 is None:
                        restart = True
                    else:
                        if len(delta2):
                            delta = np.union1d(delta, delta2)
                        self._replay_into(eng, delta)
                        self._adopt(eng)
                        self._maint_last_stall_s = time.perf_counter() - t0
                break
            if not restart:
                return

    #: layout fields transplanted wholesale at swap time
    _ADOPT_FIELDS = (
        "_centroids", "_cent_dev", "_cluster_live", "_blocks_t",
        "_block_slot", "_block_ns", "_block_inv", "_block_keep",
        "_keep_pending", "_fill", "_built_resid", "_slot_pos", "_overflow",
        "_drift", "_built", "_built_size", "_churn", "_cmax",
        "_tuned_n_probe", "_tuned_recall", "_tuned_stderr",
    )

    #: subclass layout fields a refresh's staging clone starts from and the
    #: swap installs with the layout (the sharded engine's cluster-ownership
    #: geometry, ``parallel/sharded_ivf.py``)
    _CLONE_EXTRA: tuple = ()

    def _clone_for_maintenance(self) -> "IVFIndex":
        """A fresh engine of the same class over the same store: the
        staging target of a background rebuild. Its config is a COPY: the
        tuner inside a staging build assigns ``config.n_probe``, and the
        tuned value installs at :meth:`_adopt`, atomically with the layout
        it was measured on."""
        return type(self)(
            self.store, config=dataclasses.replace(self.config),
            compute_dtype=self.compute_dtype,
        )

    def _make_staging(self, kind: str) -> "IVFIndex":
        eng = self._clone_for_maintenance()
        eng._staging = True
        if kind != "build":
            with self._lock:
                # refresh reuses the trained centroids and geometry; the
                # centroid tensors are never written in place, so the clone
                # shares them (block tensors are not shared: the write path
                # updates them in place)
                eng._centroids = self._centroids
                eng._cent_dev = self._cent_dev
                eng._cluster_live = self._cluster_live
                eng._cmax = self._cmax
                eng._built_resid = self._built_resid
                eng._built = self._built
                for f in self._CLONE_EXTRA:
                    setattr(eng, f, getattr(self, f))
            if self._maint_streams and eng._cent_dev is not None:
                # read on these streams: their memory must outlive its reads
                for t in eng._cent_tensors():
                    if t.device.type == "cuda":
                        t.record_stream(self._maint_streams[t.device])
        return eng

    def _replay_into(self, eng: "IVFIndex", slots: np.ndarray) -> None:
        """Bring a staging layout up to date with store mutations that
        landed after its snapshot: vacate every touched slot, then
        re-insert the live ones through the normal write path, in chunks of
        32,768 rows. Idempotent: a slot replayed here AND written by a
        racing writer after the swap resolves to one block entry
        (on_insert vacates first)."""
        slots = np.asarray(slots, np.int64)
        slots = slots[slots < eng.store.capacity]
        if not eng._built or not len(slots):
            return
        ch = 1 << 15
        for at in range(0, len(slots), ch):
            sl = slots[at: at + ch]
            vecs, valid = self.store.read_rows(sl)
            with eng._lock:
                eng._grow_maps()
                eng._vacate_slots(sl)
                if valid.any():
                    eng.on_insert(sl[valid], vecs[valid])

    def _adopt(self, eng: "IVFIndex") -> None:
        """Install a staging clone's layout as the serving layout (caller
        holds the engine lock). On each CUDA device of the layout the
        default stream — where queries, the write path and the store's syncs
        run — waits for everything the job enqueued so far on that device
        (its last replay included), and each adopted tensor is marked used
        by its device's default stream: the staging tensors were allocated
        on a maintenance stream, whose next job could otherwise be handed
        their memory while serving kernels are still queued on it."""
        for f in self._ADOPT_FIELDS + self._CLONE_EXTRA:
            setattr(self, f, getattr(eng, f))
        if self._maint_streams:
            for dev, stream in self._maint_streams.items():
                torch.cuda.default_stream(dev).wait_stream(stream)
            for t in self._layout_tensors():
                if t.device.type == "cuda":
                    t.record_stream(torch.cuda.default_stream(t.device))
        # the staging tuner ran against the staging config copy; its pick
        # takes effect here, with the layout it was measured on
        if eng._tuned_n_probe is not None:
            self.config.n_probe = eng.config.n_probe
            self.config.rescore = eng.config.rescore
        self._n_retrains += eng._n_retrains
        self._n_refreshes += eng._n_refreshes
        if eng._n_retrains or eng._n_refreshes:
            self._last_rebuild_s = eng._last_rebuild_s
        self._layout_gen += 1
        self._maint_swaps += 1

    # ------------------------------------------------------------- write API

    def on_insert(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        """Place store rows (already in the store, by slot) into the
        layout; before the first build, build once the store reaches
        ``build_threshold``."""
        slots = np.asarray(slots, np.int64)
        vectors = np.asarray(vectors, np.float32)
        with self._lock:
            if not self._built:
                self._maybe_rebuild()
                return
            self._grow_maps()
            # idempotent: re-inserting a slot the layout already holds (a
            # swap replay racing the writer) must not double-represent it
            pos0 = self._slot_pos[slots]
            if (pos0[:, 0] >= 0).any() or (
                self._overflow and not self._overflow.isdisjoint(int(s) for s in slots)
            ):
                self._vacate_slots(slots)
            # nearest centroid (one matmul); each row goes to its cluster's
            # next free position: sort by cluster, rank within the batch's
            # cluster runs, offset by the current fill
            assign, best_s = self._assign_slots(slots)
            n_in = len(slots)
            drift = self._drift_mask(vectors, best_s)
            if drift.any():
                ds = slots[drift]
                self._overflow.update(int(s) for s in ds)
                self._drift.update(int(s) for s in ds)
                slots, assign = slots[~drift], assign[~drift]
            cmax = int(self._cmax)
            order = np.argsort(assign, kind="stable")
            sorted_a = assign[order]
            n = len(order)
            if n:
                is_start = np.concatenate([[True], sorted_a[1:] != sorted_a[:-1]])
                start = np.maximum.accumulate(np.where(is_start, np.arange(n), 0))
                pos = self._fill[sorted_a] + (np.arange(n) - start)
                fits = pos < cmax
                app_rows = sorted_a[fits]
                app_pos = pos[fits]
                app_slots = slots[order][fits]
                self._fill += np.bincount(app_rows, minlength=len(self._fill))
                self._slot_pos[app_slots, 0] = app_rows
                self._slot_pos[app_slots, 1] = app_pos
                self._overflow.update(int(s) for s in slots[order][~fits])
                self._keep_pending.extend(
                    (int(a), int(p), True) for a, p in zip(app_rows, app_pos)
                )
                if len(app_rows):
                    self._scatter_block_rows(app_rows, app_pos, app_slots)
            self._churn += n_in
            self._maybe_rebuild()

    def on_update(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        """Re-place updated rows: a row whose nearest centroid is unchanged
        is rewritten in place; one that moved (or drifted past the
        centroids' reach) is vacated and inserted afresh."""
        slots = np.asarray(slots, np.int64)
        vectors = np.asarray(vectors, np.float32)
        with self._lock:
            if not self._built:
                return
            self._grow_maps()
            new_assign, best_s = self._assign_slots(slots)
            drift = self._drift_mask(vectors, best_s)
            pos = self._slot_pos[slots]
            known = pos[:, 0] >= 0
            stay = known & (pos[:, 0] == new_assign) & ~drift
            moved = ~stay
            if stay.any():
                self._scatter_block_rows(pos[stay, 0], pos[stay, 1], slots[stay])
            if moved.any():
                self._vacate_slots(slots[moved])
                self.on_insert(slots[moved], vectors[moved])
            self._churn += len(slots)
            self._maybe_rebuild()

    def on_delete(self, slots: np.ndarray) -> None:
        """Mark the rows' block positions dead and forget them: the store
        may reuse a slot for a fresh vector, and a slot-addressed validity
        mask alone would resurrect the stale block entry."""
        slots = np.asarray(slots, np.int64)
        with self._lock:
            if self._built:
                self._vacate_slots(slots)
            else:
                self._overflow.difference_update(int(s) for s in slots)
                self._drift.difference_update(int(s) for s in slots)
            self._churn += len(slots)
            self._maybe_rebuild()

    def _assign_slots(self, slots_np: np.ndarray):
        """(assign i64, best affine score f64) of the nearest live
        centroid for store rows by slot (:meth:`_rows_dev`): two small
        vectors download."""
        cent, c_ns = self._cent_dev
        a, sc = _nearest_centroid(self._rows_dev(slots_np)[0], cent, c_ns, self._live_dev())
        return a.cpu().numpy().astype(np.int64), sc.cpu().numpy().astype(np.float64)

    def _drift_mask(self, vectors: np.ndarray, best_s: np.ndarray) -> np.ndarray:
        """True for rows the trained centroids cannot represent: squared
        residual |v - c*|^2 = |v|^2 - best affine score above
        ``insert_drift`` x the at-build mean."""
        f = self.config.insert_drift
        if f is None or not self._built_resid or self._built_resid <= 0:
            return np.zeros(len(vectors), bool)
        vns = np.sum(vectors.astype(np.float64) ** 2, axis=1)
        resid = np.maximum(vns - best_s, 0.0)
        return resid > f * self._built_resid

    def _scatter_block_rows(self, rows_np, pos_np, slots_np) -> None:
        """Hook: scatter store rows (by slot) into the block arrays at
        (cluster, position), in place (:func:`_scatter_blocks_dev`): the
        rows come from :meth:`_rows_dev`, three int64 index vectors
        upload."""
        v, ns = self._rows_dev(slots_np)

        def idx(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)

        _scatter_blocks_dev(
            self._blocks_t, self._block_ns, self._block_inv, self._block_slot,
            v, ns, self._cent_dev[0],
            idx(rows_np), idx(pos_np), idx(slots_np),
        )

    def _grow_maps(self) -> None:
        cap = self.store.capacity
        if self._slot_pos is not None and len(self._slot_pos) < cap:
            extra = cap - len(self._slot_pos)
            self._slot_pos = np.concatenate(
                [self._slot_pos, np.full((extra, 2), -1, np.int64)]
            )

    # ------------------------------------------------------------ keep mask

    def _vacate_slots(self, slots: np.ndarray) -> None:
        """Remove slots from the block layout: keep-bit tombstones for the
        positions held (applied lazily by :meth:`_keep_dev`) plus map,
        overflow and drift resets. No-op for slots the layout does not
        hold. Vacated positions are reclaimed at the next re-layout, not
        reused in place. Caller holds the engine lock."""
        slots = np.asarray(slots, np.int64)
        pos = self._slot_pos[slots]
        known = pos[:, 0] >= 0
        if known.any():
            self._keep_pending.extend(
                (int(r), int(p), False) for r, p in pos[known]
            )
        self._slot_pos[slots] = -1
        self._overflow.difference_update(int(s) for s in slots)
        self._drift.difference_update(int(s) for s in slots)

    def _keep_dev(self):
        """Hook: apply pending keep-bit scatters (one scatter per query
        batch at most). Last write wins per position. Caller holds the
        engine lock."""
        if self._keep_pending:
            last = {(r, c): v for r, c, v in self._keep_pending}
            rows = torch.tensor([rc[0] for rc in last], dtype=torch.int64)
            cols = torch.tensor([rc[1] for rc in last], dtype=torch.int64)
            vals = torch.tensor(list(last.values()), dtype=torch.bool)
            self._block_keep.index_put_(
                (rows.to(self.device), cols.to(self.device)), vals.to(self.device)
            )
            self._keep_pending = []
        return self._block_keep

    # ---------------------------------------------------------------- query

    def _q_cap(self, B: int, P: int, K: int) -> int:
        # expected pairs per cluster = B*P/K, times a skew-headroom factor
        # (beyond the cap, overflow pairs drop — ivf_query docstring)
        f = self.config.q_cap_factor
        return _pow2(
            max(8, int(np.ceil(f * B * P / K))), lo=8, hi=min(1024, _pow2(B))
        )

    def search_slots_device(self, queries: torch.Tensor, k: int, *, mask=None):
        """Device serving path: f32[B, d] queries on the store's device in,
        (dist f32[B, k], slot i64[B, k]) tensors out. The overflow merge,
        under-fill supplement and negative rerank of :meth:`search_slots`
        are host-side layers on top of this. ``mask``: optional bool[cap]
        slot mask on the device. It runs on the caller's current stream."""
        with self._lock:
            if not self._built:
                raise RuntimeError("IVF index is not built")
            if queries.device != self.device:
                raise ValueError(
                    f"queries on {queries.device}, index on {self.device}"
                )
            dev = self.store.device_view()
            block_keep = self._keep_dev()
            if mask is not None:
                block_keep = block_keep & mask[self._block_slot.clamp_min(0).long()]
            cent, c_ns = self._cent_dev
            K = cent.shape[0]
            P = min(self.config.n_probe, K)
            form = self._resolve_formulation(k)
            return ivf_query(
                queries, cent, c_ns,
                self._blocks_t, self._block_slot, self._block_ns,
                self._block_inv, block_keep, dev.vectors,
                metric=self.store.metric, k=k, n_probe=P,
                q_cap=self._q_cap(queries.shape[0], P, K) if form == "einsum" else 8,
                oversample=self.config.oversample,
                probe_sel_approx=self.config.probe_sel_approx,
                formulation=form,
                seg_width=self.config.seg_width,
                rescore=self.config.rescore,
            )

    def _resolve_formulation(self, k: int) -> str:
        """"pairs" | "fused" | "einsum"; "auto" resolves to "pairs"."""
        form = self.config.formulation
        if form in ("auto", "pairs"):
            return "pairs"
        if form == "einsum":
            return form
        if form != "fused":
            raise ValueError(f"unknown formulation {form!r}")
        Cmax = int(self._cmax)
        S = Cmax // WIN
        if not (
            Cmax % WIN == 0 and R_WIN * S >= k and R_WIN * S <= 128
            and Cmax <= (1 << POS_BITS)
            and self.store.metric in (
                DistanceType.EUCLIDEAN, DistanceType.SQUARED_EUCLIDEAN,
                DistanceType.DOT_PRODUCT,
            )
        ):
            raise ValueError(
                "fused formulation unsupported here: needs euclidean/"
                "dot metric, Cmax % 128 == 0, 4*(Cmax//128) in "
                "[k, 128], Cmax <= 2048"
            )
        return "fused"

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
        """Batched top-k over slots: (dist f32[B, k], slots i64[B, k])
        numpy arrays, -1 for empty. Small corpora, Manhattan, per-query
        masks and ``exact=True`` go to the exact scan.

        Its phases are spans (``utils/profiling.trace_span``), one after
        the other under ``ivf.search``: ``ivf.copy_in`` (the queries and
        the mask to the device), ``ivf.query`` (the device path enqueued
        under the engine lock, with each row's live count where no merge
        or rerank follows), ``ivf.results`` (the wait for the device and
        the copies out), ``ivf.finish`` (the host's merges, the under-fill
        test and supplement); ``ivf.exact`` wherever the exact scan
        answers for the engine, ``n`` being the rows it answered."""
        with trace_span("ivf.search") as span:
            with trace_span("ivf.copy_in") as copy_in:
                q = query_rows(queries)
                span.n = copy_in.n = B = q.shape[0]
                per_query_mask = mask is not None and np.asarray(mask).ndim == 2
                routed = (
                    exact
                    or not self._built
                    or per_query_mask
                    or self.store.metric == DistanceType.MANHATTAN
                    or self.store.size < self.config.build_threshold // 4
                )
                if B and not routed:
                    q_dev = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
                    mask_dev = None if mask is None else torch.as_tensor(
                        np.asarray(mask, bool), device=self.device
                    )
            if B == 0:
                return np.zeros((0, k), np.float32), np.full((0, k), -1, np.int64)
            if routed:
                self._count(calls=1, queries=B, exact_route_calls=1)
                with trace_span("ivf.exact", B):
                    return self._exact.search_slots(
                        q, k, mask=mask, negative=negative,
                        negative_weight=negative_weight,
                    )
            retrieve_k = k if negative is None else min(max(2 * k, 30), self.store.size)
            with trace_span("ivf.query", B), self._lock:
                dist, idx = self.search_slots_device(q_dev, retrieve_k, mask=mask_dev)
                # snapshot the overflow set with the dispatch
                overflow = sorted(self._overflow) if self._overflow else None
                # each row's live entries, counted on the device where the
                # host keeps the device's rows (no merge or rerank rewrites
                # them): the under-fill test then reads B counts, not B*k
                # slots, and holds wherever a row's empty slots sit
                fill = (
                    None if overflow or negative is not None
                    else (idx[:, :k] >= 0).sum(1, dtype=torch.int32)
                )
            with trace_span("ivf.results", B):
                dist, idx = dist.cpu().numpy(), idx.cpu().numpy()
                if fill is not None:
                    fill = fill.cpu().numpy()
            with trace_span("ivf.finish", B):
                if overflow:
                    slot_keep = self.store._np_valid.copy()
                    if mask is not None:
                        slot_keep &= np.asarray(mask, bool)
                    dist, idx = self._merge_overflow(
                        q, dist, idx, slot_keep, retrieve_k, overflow
                    )
                if negative is not None:
                    dist, idx = self._exact.rerank_negative(
                        q, dist, idx, negative, negative_weight, k
                    )
                    dist, idx = dist.cpu().numpy(), idx.cpu().numpy()

                def exact_scan(n_short):
                    with trace_span("ivf.exact", n_short):
                        return self._exact.search_slots(
                            q, k, mask=mask, negative=negative,
                            negative_weight=negative_weight,
                        )

                # under-fill supplement: probed clusters may not hold k live rows
                host_fill = fill is None
                dist, idx, n_short = supplement(
                    dist[:, :k], idx[:, :k], k, self.store.size, exact_scan, fill
                )
            self._count(calls=1, queries=B, underfill_calls=int(n_short > 0),
                        underfill_rows=n_short, overflow_merges=int(bool(overflow)),
                        fill_host_checks=int(host_fill))
            return dist, idx

    def _merge_overflow(self, q, dist, idx, keep, k, overflow):
        """Exactly score the overflow rows (rows outside the block layout)
        and merge; ``overflow`` is the sorted slot list snapshotted at
        dispatch. Overflow slots are absent from the blocks, so the merge
        needs no dedup."""
        slots = np.asarray(overflow, np.int64)
        slots = slots[np.asarray(keep)[slots]]
        if not len(slots):
            return dist, idx
        W = dist.shape[1]
        d_o, i_o = _overflow_topk(
            torch.from_numpy(np.ascontiguousarray(q)).to(self.device),
            torch.from_numpy(slots).to(self.device),
            *self._rows_dev(slots), metric=self.store.metric, k=W,
        )
        cd = np.concatenate([dist, d_o.cpu().numpy()], axis=1)
        ci = np.concatenate([idx, i_o.cpu().numpy().astype(idx.dtype)], axis=1)
        order = np.argsort(cd, axis=1, kind="stable")[:, :W]
        return (
            np.take_along_axis(cd, order, axis=1),
            np.take_along_axis(ci, order, axis=1),
        )

    # ---------------------------------------------------------- persistence

    def export_topology(self) -> Optional[dict]:
        """Sidecar: centroids + assignment (slot-addressed), so a load
        skips k-means (the block layout is rebuilt deterministically).
        The reference engine's format, plus the n_probe tuner's pick when
        it ran (``tuned_n_probe``, ``tuned_rescore``, ``tuned_recall``,
        ``tuned_stderr``): a load skips the tuner too, and without them
        would serve at the configured n_probe. The reference ignores keys
        it does not read."""
        with self._lock:
            if not self._built:
                return None
            assign = np.full(self.store.capacity, -1, np.int64)
            live = self._slot_pos[:, 0] >= 0
            assign[live] = self._slot_pos[live, 0]
            out = {
                "format_version": np.int64(1),
                "kind": np.bytes_(b"ivf"),
                "centroids": self._centroids.copy(),
                "assign": assign,
                "cmax": np.int64(self._cmax),
            }
            if self._tuned_n_probe is not None:
                out["tuned_n_probe"] = np.int64(self._tuned_n_probe)
                out["tuned_rescore"] = np.bool_(self.config.rescore)
                out["tuned_recall"] = np.float64(self._tuned_recall)
                out["tuned_stderr"] = np.float64(self._tuned_stderr)
            return out

    def import_topology(self, data: dict, slot_remap: np.ndarray) -> None:
        """Install an exported topology (this engine's or the reference
        engine's): ``slot_remap`` maps the exporter's slots to this store's
        (-1 = gone); live rows the sidecar does not know go to their
        nearest centroid. An engine with a ``recall_target`` also takes
        the tuner's pick, when the sidecar holds one."""
        kind = data.get("kind")
        if kind is not None and bytes(kind) != b"ivf":
            return
        with self._lock:
            cents = np.asarray(data["centroids"], np.float32)
            K = len(cents)
            old_assign = np.asarray(data["assign"], np.int64)
            assign = np.full(self.store.capacity, -1, np.int64)
            old_slots = np.flatnonzero(old_assign >= 0)
            new_slots = slot_remap[old_slots]
            ok = new_slots >= 0
            assign[new_slots[ok]] = old_assign[old_slots[ok]]
            self._centroids = cents
            self._cent_dev = self._put_cent_dev(cents)
            valid = self.store._np_valid
            unknown = np.flatnonzero(valid & (assign < 0))
            if len(unknown):
                assign[unknown] = self._assign_nearest(self.store._np_vectors[unknown])
            cmax = data.get("cmax")
            self._layout_from_assign(assign, K, cmax=None if cmax is None else int(cmax))
            tuned = data.get("tuned_n_probe")
            if tuned is not None and self.config.recall_target is not None:
                self.config.n_probe = self._tuned_n_probe = int(tuned)
                self.config.rescore = bool(data["tuned_rescore"])
                self._tuned_recall = float(data["tuned_recall"])
                self._tuned_stderr = float(data["tuned_stderr"])

    def _layout_from_assign(
        self, assign: np.ndarray, K: int, cmax: Optional[int] = None
    ) -> None:
        c = self.config
        vectors = self.store._np_vectors
        n_live = int((assign >= 0).sum())
        if n_live == 0:
            self._built = False
            return
        if cmax is None:  # pre-split sidecars: derive from K (may spill)
            cmax = _cmax_shape(c.cmax_factor * max(n_live, 1) / K)
        counts = np.bincount(assign[assign >= 0], minlength=K)
        if counts.max(initial=0) > cmax:

            def scores_fn(rows):
                return self._assign_scores(vectors[rows])

            assign = balance_assignment(assign, scores_fn, cmax, K)
        block_slot = np.full((K, cmax), -1, np.int32)
        slot_pos = np.full((self.store.capacity, 2), -1, np.int64)
        order = np.argsort(assign, kind="stable")
        order = order[assign[order] >= 0]
        sorted_c = assign[order]
        fill = np.bincount(sorted_c, minlength=K)
        first = np.concatenate([[0], np.cumsum(fill)[:-1]])
        pos_in = np.arange(len(order)) - first[sorted_c]
        block_slot[sorted_c, pos_in] = order
        slot_pos[order, 0] = sorted_c
        slot_pos[order, 1] = pos_in
        rsum = self._layout_blocks(block_slot)
        # drift baseline: mean squared residual over the placed rows
        self._built_resid = rsum / max(n_live, 1)
        self._keep_pending = []
        self._fill = fill.astype(np.int64)
        self._slot_pos = slot_pos
        self._overflow = set()
        self._drift = set()
        self._built = True
        self._built_size = n_live
        self._churn = 0
        self._cmax = int(cmax)
        self._layout_gen += 1

    def _layout_blocks(self, block_slot: np.ndarray) -> float:
        """Hook: install the block arrays for the host slot map
        ``block_slot`` i32[K, cmax]; returns the placed rows' summed squared
        residual. The blocks hold RESIDUALS v - c_k, gathered from the
        store's device copy: only the slot map uploads."""
        view = self.store.device_view()
        slot_dev = torch.from_numpy(block_slot).to(self.device)
        (
            self._blocks_t, self._block_ns, self._block_inv, self._block_keep, rsum,
        ) = _layout_dev(
            slot_dev, view.vectors, view.norms_sq, self._cent_dev[0], self.compute_dtype
        )
        self._block_slot = slot_dev
        return float(rsum)
