"""Hybrid engine — adaptive exact vs ANN strategy selection.

Parity with the reference's ``pkg/hybrid`` (reference:
pkg/hybrid/hybrid_index.go, adaptive.go): one index that routes each query to
the brute-force exact scan or an ANN engine via an ε-greedy selector with a
learned exact-threshold. Differences by design:

* ONE shared VectorStore — the reference keeps three copies of every vector
  (exact map + HNSW node + hybrid map, hybrid_index.go:15-43);
* filtered (masked) queries always take the exact path, where the facet mask
  fuses into the scan for free — the reference brute-forces filtered queries
  anyway via searchK=Size();
* the selector's learned threshold is NOT reset on every write — the
  reference calls UpdateThresholds(count, dim) on each insert/delete which
  overwrites the learned value (adaptive.go:226-231, a quirk SURVEY.md §2.6
  says to drop while preserving the adaptive interface);
* the ANN side is selectable and defaults to the TPU-first IVF engine
  (``ann_backend="auto"``): where the reference routes among all its
  engines (adaptive.go:41-72), this hybrid routes exact | ivf | hnsw —
  exact for small/filtered corpora, IVF past the crossover (it beats the
  graph by orders of magnitude on batched QPS at equal recall on TPU,
  docs/BENCH_RESULTS.md), HNSW only when explicitly configured;
* per-strategy stats are labeled by the engine that actually ran
  ("exact" | "ivf" | "hnsw"), matching the reference's per-strategy stats
  (hybrid_index.go:383-469).

PyTorch port of ``quiver_tpu/index/hybrid.py``, with both ANN backends:
the IVF engine and the HNSW engine (``index/hnsw.py``). The default engines
are the port's ``ExactIndex`` and ``IVFIndex``, both at the hybrid's
``compute_dtype`` (f32 by default, so the IVF side keeps f32 blocks:
``ops/ivf_cuda.py``'s f32 kernel on the card); an ``hnsw_config`` or an
HNSW keyword resolves ``"auto"`` to the graph, built at the same dtype.

On the card, ``_search_mixed``'s two threads launch on the device's default
stream, as every query does: the exact scan's ``VectorStore.device_view()``
syncs under the store's lock, and the IVF and HNSW engines each hold their
own lock across their device path, so the two sub-batches need nothing
more. One change for
concurrent callers: the per-strategy counters are updated under a lock
(the reference's ``+=`` can lose counts between concurrent searches).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.query import query_rows

EXACT = "exact"
HNSW = "hnsw"
IVF = "ivf"


@dataclass
class AdaptiveConfig:
    """Defaults mirror the reference (pkg/hybrid/types.go:72-99)."""

    exploration_factor: float = 0.1
    initial_exact_threshold: int = 1000
    initial_dim_threshold: int = 100
    metrics_window_size: int = 1000
    adaptation_rate: float = 0.05
    adapt_every: int = 20  # adaptThresholds cadence (adaptive.go:75-105)
    min_samples: int = 10
    exact_threshold_floor: int = 100
    seed: int = 0


@dataclass
class QueryMetric:
    strategy: str
    latency_ms: float
    result_count: int
    corpus_size: int
    timestamp: float = field(default_factory=time.time)


class AdaptiveStrategySelector:
    """ε-greedy exact-vs-ANN selection with latency-driven threshold
    adaptation (reference AdaptiveStrategySelector, adaptive.go:41-174).
    ``ann_label`` names the ANN engine that serves the non-exact side
    ("ivf" or "hnsw") so recorded metrics and stats are truthful about
    which engine ran (reference per-strategy stats name the engine,
    hybrid_index.go:383-469)."""

    def __init__(
        self,
        config: Optional[AdaptiveConfig] = None,
        ann_label: str = HNSW,
    ):
        self.config = config or AdaptiveConfig()
        self.ann_label = ann_label
        self.exact_threshold = self.config.initial_exact_threshold
        self.dim_threshold = self.config.initial_dim_threshold
        self._rng = np.random.default_rng(self.config.seed)
        self._window: deque[QueryMetric] = deque(
            maxlen=self.config.metrics_window_size
        )
        self._since_adapt = 0
        self._lock = threading.Lock()

    def select_strategy(self, vector_count: int, dimension: int, k: int) -> str:
        """(reference SelectStrategy, adaptive.go:41-72)."""
        c = self.config
        if self._rng.random() < c.exploration_factor:
            return EXACT if self._rng.random() < 0.5 else self.ann_label
        if vector_count < self.exact_threshold:
            return EXACT
        if dimension > self.dim_threshold:
            return self.ann_label if k < 50 else EXACT
        return self.ann_label

    def select_strategy_batch(
        self, vector_count: int, dimension: int, k: int, n: int
    ) -> np.ndarray:
        """Per-query ε-greedy selection for a batch (reference BatchSearch
        picks a strategy per query, hybrid_index.go:702-795): every query
        draws its own exploration coin; non-explorers share the learned
        exploit choice. Returns an object array of strategy names."""
        c = self.config
        if vector_count < self.exact_threshold:
            base = EXACT
        elif dimension > self.dim_threshold:
            base = self.ann_label if k < 50 else EXACT
        else:
            base = self.ann_label
        explore = self._rng.random(n) < c.exploration_factor
        flip = self._rng.random(n) < 0.5
        return np.where(explore, np.where(flip, EXACT, self.ann_label), base)

    def record_query_metrics(self, m: QueryMetric) -> None:
        """(reference RecordQueryMetrics + adaptThresholds,
        adaptive.go:75-174)."""
        with self._lock:
            self._window.append(m)
            self._since_adapt += 1
            if (
                self._since_adapt >= self.config.adapt_every
                and len(self._window) >= self.config.min_samples
            ):
                self._since_adapt = 0
                self._adapt()

    def _adapt(self) -> None:
        c = self.config
        small = [m for m in self._window if m.corpus_size < self.exact_threshold * 2]
        exact = [m.latency_ms for m in small if m.strategy == EXACT]
        hnsw = [m.latency_ms for m in small if m.strategy == self.ann_label]
        if len(exact) < 3 or len(hnsw) < 3:
            return
        avg_exact = sum(exact) / len(exact)
        avg_hnsw = sum(hnsw) / len(hnsw)
        step = max(int(self.exact_threshold * c.adaptation_rate), 10)
        if avg_exact < avg_hnsw:
            self.exact_threshold += step
        else:
            self.exact_threshold = max(
                c.exact_threshold_floor, self.exact_threshold - step
            )

    def update_thresholds(self, exact: int, dim: int) -> None:
        """Manual override surface (reference UpdateThresholds,
        adaptive.go:226-231) — exposed but NOT wired into the write path."""
        self.exact_threshold = exact
        self.dim_threshold = dim

    def stats(self) -> dict:
        with self._lock:
            per = {EXACT: [], self.ann_label: []}
            for m in self._window:
                per.setdefault(m.strategy, []).append(m.latency_ms)
        return {
            "exact_threshold": self.exact_threshold,
            "dim_threshold": self.dim_threshold,
            "window": len(self._window),
            "avg_latency_ms": {
                s: (sum(v) / len(v) if v else None) for s, v in per.items()
            },
        }


class HybridIndex:
    """Dual-engine index over one shared store."""

    name = "hybrid"

    def __init__(
        self,
        store: VectorStore,
        *,
        hnsw_config=None,
        adaptive_config: Optional[AdaptiveConfig] = None,
        compute_dtype=torch.float32,
        exact_factory=None,
        ann_factory=None,
        ann_backend: str = "auto",
        ivf_config=None,
        **hnsw_overrides,
    ):
        """``exact_factory`` / ``ann_factory`` inject the two engines — the
        sharded hybrid passes mesh-backed variants; defaults are the
        single-chip ExactIndex plus the resolved ANN engine.

        ``ann_backend`` picks the ANN side:

        * "auto" (default): IVF — the TPU-first pruned-scan engine; at
          serving batch sizes it beats the graph by orders of magnitude
          on QPS at equal recall (index/ivf.py, docs/BENCH_RESULTS.md).
          An explicit ``hnsw_config`` or HNSW kwarg resolves auto to
          "hnsw" (the caller clearly wants the graph).
        * "ivf": force IVF.  * "hnsw": force the graph (reference
          parity — incremental pointer-graph semantics).

        Strategy labels and per-strategy stats name the engine that
        actually ran (reference hybrid_index.go:383-469)."""
        self.store = store
        self.exact = (
            exact_factory(store)
            if exact_factory is not None
            else ExactIndex(store, compute_dtype=compute_dtype)
        )
        if ann_backend == "auto":
            ann_backend = (
                "hnsw" if (hnsw_config is not None or hnsw_overrides)
                else "ivf"
            )
        self.ann_backend = ann_backend
        if ann_factory is not None:
            self.ann = ann_factory(store)
        elif ann_backend == "ivf":
            from quiver_tpu_torch.index.ivf import IVFIndex

            self.ann = IVFIndex(
                store, config=ivf_config, compute_dtype=compute_dtype
            )
        elif ann_backend == "hnsw":
            from quiver_tpu_torch.index.hnsw import HNSWIndex

            self.ann = HNSWIndex(
                store,
                config=hnsw_config,
                compute_dtype=compute_dtype,
                **hnsw_overrides,
            )
        else:
            raise ValueError(f"unknown ann_backend {ann_backend!r}")
        self.ann_label = getattr(self.ann, "name", HNSW) or HNSW
        if self.ann_label.startswith("sharded_"):
            self.ann_label = self.ann_label[len("sharded_"):]
        self.selector = AdaptiveStrategySelector(
            adaptive_config, ann_label=self.ann_label
        )
        self.last_strategy = EXACT
        self._per_strategy_counts = {EXACT: 0, self.ann_label: 0}
        self._counts_lock = threading.Lock()
        # Lazy graph construction: below the selector's exact threshold every
        # query routes to the exact scan anyway, so building the HNSW graph
        # (and paying its kernel compiles) is pure waste — buffer inserts and
        # build the graph only once the corpus could plausibly use it.
        self._graph_built = False
        self._pending: list = []
        #: serializes the buffer's hand-over to the graph: concurrent
        #: searches each force it, and an insert may append meanwhile
        self._pending_lock = threading.RLock()

    def _build_threshold(self) -> int:
        return max(self.selector.exact_threshold // 2, 256)

    def _ensure_graph(self, force: bool = False) -> None:
        with self._pending_lock:
            if self._pending and (
                force
                or self._graph_built
                or self.store.size >= self._build_threshold()
            ):
                pending, self._pending = self._pending, []
                slots = np.concatenate([s for s, _ in pending])
                vecs = np.concatenate([v for _, v in pending])
                self.ann.on_insert(slots, vecs)
                self._graph_built = True

    @property
    def size(self) -> int:
        return self.store.size

    # ---------------------------------------------------------------- write

    def on_insert(self, slots, vectors) -> None:
        with self._pending_lock:
            self._pending.append(
                (np.asarray(slots, np.int64), np.asarray(vectors, np.float32))
            )
            self._ensure_graph()

    def on_update(self, slots, vectors) -> None:
        slots = np.asarray(slots)
        if self._pending:
            pending_slots = set(
                int(s) for ps, _ in self._pending for s in ps
            )
            if all(int(s) in pending_slots for s in slots):
                # updated rows aren't in the graph yet; refresh the buffer
                for i, (ps, pv) in enumerate(self._pending):
                    sel = np.isin(ps, slots)
                    if sel.any():
                        order = {int(s): j for j, s in enumerate(slots)}
                        for row in np.flatnonzero(sel):
                            pv[row] = vectors[order[int(ps[row])]]
                return
        self._ensure_graph()
        if self._graph_built:
            self.ann.on_update(slots, vectors)

    def on_delete(self, slots) -> None:
        slots = np.asarray(slots)
        if self._pending:
            keep = []
            for ps, pv in self._pending:
                sel = ~np.isin(ps, slots)
                if sel.all():
                    keep.append((ps, pv))
                elif sel.any():
                    keep.append((ps[sel], pv[sel]))
            self._pending = keep
        if self._graph_built:
            self.ann.on_delete(slots)

    # ---------------------------------------------------------------- query

    def search_slots(
        self,
        queries,
        k: int,
        *,
        mask=None,
        negative=None,
        negative_weight: float = 0.5,
        exact: bool = False,
        strategy: Optional[str] = None,
    ):
        q = query_rows(queries)
        if strategy is None:
            if exact or mask is not None:
                strategy = EXACT
            elif getattr(self.ann, "recall_shortfall", False):
                # the ANN engine's recall-target tuner measured itself short
                # of target even at its probe ceiling (uniform / heavy-tail
                # corpora defeat IVF pruning — benches/bench_corpus_matrix.py);
                # serve exact rather than exploring a known-bad engine
                strategy = EXACT
            elif q.shape[0] > 1:
                # per-query strategy within the batch (reference
                # hybrid_index.go:702-795): exploration draws can send a
                # subset of the batch to the other engine
                per_q = self.selector.select_strategy_batch(
                    self.store.size, self.store.dim, k, q.shape[0]
                )
                uniq = set(per_q.tolist())
                if len(uniq) == 1:
                    strategy = per_q[0]
                else:
                    return self._search_mixed(
                        q, per_q, k, mask=mask, negative=negative,
                        negative_weight=negative_weight,
                    )
            else:
                strategy = self.selector.select_strategy(
                    self.store.size, self.store.dim, k
                )
        if strategy != EXACT:
            # a forced "hnsw"/"ivf"/"ann" all mean the ANN side; record the
            # engine that actually runs (truthful per-strategy stats)
            strategy = self.ann_label
        t0 = time.perf_counter()
        if strategy != EXACT:
            self._ensure_graph(force=True)  # exploration can pick ANN early
        engine = self.exact if strategy == EXACT else self.ann
        dist, slots = engine.search_slots(
            q, k, mask=mask, negative=negative, negative_weight=negative_weight
        )
        ms = (time.perf_counter() - t0) * 1e3
        self.last_strategy = strategy
        with self._counts_lock:
            self._per_strategy_counts[strategy] += 1
        self.selector.record_query_metrics(
            QueryMetric(
                strategy=strategy,
                latency_ms=ms / max(q.shape[0], 1),
                result_count=int((slots >= 0).sum()),
                corpus_size=self.store.size,
            )
        )
        return dist, slots

    def _search_mixed(self, q, per_q, k, **kw):
        """Run each strategy's sub-batch through its engine and stitch the
        rows back in request order; per-query metrics feed the selector the
        same way the per-goroutine path feeds the reference's.

        The two engine calls run on concurrent threads (the analogue of
        the reference's goroutine fan-out, hybrid_index.go:702-795): each
        call blocks on a device round trip, and those waits release the
        GIL, so a mixed batch costs ~one round trip instead of two."""
        from concurrent.futures import ThreadPoolExecutor

        self._ensure_graph(force=True)  # before fan-out: build is not
        # thread-safe against a concurrent exact scan of the same store

        plan = []
        for strat in (EXACT, self.ann_label):
            idx = np.flatnonzero(per_q == strat)
            if len(idx):
                engine = self.exact if strat == EXACT else self.ann
                plan.append((strat, idx, engine))

        def run(item):
            strat, idx, engine = item
            t0 = time.perf_counter()
            d, s = engine.search_slots(q[idx], k, **kw)
            return strat, idx, d, s, (time.perf_counter() - t0) * 1e3

        if len(plan) > 1:
            with ThreadPoolExecutor(max_workers=len(plan)) as pool:
                results = list(pool.map(run, plan))
        else:
            results = [run(plan[0])]

        out_d = out_s = None
        for strat, idx, d, s, ms in results:
            if out_d is None:
                out_d = np.empty((q.shape[0], d.shape[1]), d.dtype)
                out_s = np.empty((q.shape[0], s.shape[1]), s.dtype)
            out_d[idx] = d
            out_s[idx] = s
            self.last_strategy = strat
            with self._counts_lock:
                self._per_strategy_counts[strat] += len(idx)
            per_ms = ms / max(len(idx), 1)
            for row in range(len(idx)):
                self.selector.record_query_metrics(
                    QueryMetric(
                        strategy=strat,
                        latency_ms=per_ms,
                        result_count=int((s[row] >= 0).sum()),
                        corpus_size=self.store.size,
                    )
                )
        return out_d, out_s

    @property
    def hnsw(self):
        """Back-compat alias for the ANN engine (named when the graph was
        the only ANN side); prefer :attr:`ann`."""
        return self.ann

    #: query-time knobs of each ANN backend: a knob that belongs to the
    #: OTHER backend is a no-op on this hybrid (not an error) — callers
    #: tune ef_search on the reference-parity surface regardless of which
    #: engine the auto backend resolved to (adapter.go:175-190)
    _BACKEND_KNOBS = {
        "hnsw": {"ef_search", "visited", "query_dtype"},
        "ivf": {"n_probe"},
    }

    def get_optimization_parameters(self) -> dict:
        return self.ann.get_optimization_parameters()

    def set_optimization_parameters(self, **params) -> None:
        all_known = set().union(*self._BACKEND_KNOBS.values())
        unknown = set(params) - all_known
        if unknown:
            raise ValueError(
                "immutable or unknown parameters for any backend: "
                f"{sorted(unknown)}"
            )
        mine = {
            k: v for k, v in params.items()
            if k in self._BACKEND_KNOBS.get(self.ann_label, all_known)
        }
        if mine:
            self.ann.set_optimization_parameters(**mine)

    def get_detailed_metrics(self) -> dict:
        return {
            self.ann_label: self.ann.get_detailed_metrics(),
            "device_bytes": self.device_bytes(),
            **self.stats(),
        }

    def device_bytes(self) -> dict:
        """HBM footprint across the orchestrated engines: each engine's own
        buffers summed, the shared store's view counted once."""
        from quiver_tpu_torch.utils.memory import device_bytes, store_device_bytes

        own = sum(
            device_bytes(e, skip=(VectorStore,))
            for e in (self.exact, self.ann)
        )
        st = store_device_bytes(self.store)
        n = max(self.store.size, 1)
        return {
            "engine": own,
            "store": st,
            "total": own + st,
            "per_vector": round((own + st) / n, 1),
        }

    def export_topology(self):
        if not self._graph_built:
            return None
        return self.ann.export_topology()

    def import_topology(self, data, slot_remap) -> None:
        self._pending.clear()
        self.ann.import_topology(data, slot_remap)
        self._graph_built = True

    def stats(self) -> dict:
        with self._counts_lock:
            counts = dict(self._per_strategy_counts)
        return {
            "selector": self.selector.stats(),
            "per_strategy_queries": counts,
        }
