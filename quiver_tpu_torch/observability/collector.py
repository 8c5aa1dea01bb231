"""DB-level performance collector: QPS / latency / CPU / memory / recall.

Parity with the reference's ``metrics.Collector`` (reference:
pkg/metrics/collector.go:27-191) — with one upgrade: the reference's recall
gauge is plumbing that nothing ever sets (collector.go:111-117, SURVEY.md §6
"Recall: never measured"); here ``measure_recall`` actually computes it by
sampling stored vectors and comparing the engine's answers against the exact
oracle on the same store.

PyTorch port of ``quiver_tpu/observability/collector.py``; its oracle is
the port's ``ExactIndex`` (f32, TF32 off) on the collection's own store,
so on a card the recall is measured there.
"""

from __future__ import annotations

import resource
import time
from dataclasses import dataclass, field

import numpy as np

from quiver_tpu_torch.observability.metrics import global_metrics


@dataclass
class PerformanceMetrics:
    """(reference PerformanceMetrics, collector.go:27-40)."""

    avg_latency_ms: float = 0.0
    qps: float = 0.0
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    recall: float = 0.0
    timestamp: float = field(default_factory=time.time)


class Collector:
    """Aggregates process + DB health into one snapshot."""

    def __init__(self):
        self._last_cpu = self._cpu_seconds()
        self._last_wall = time.monotonic()
        self._avg_latency_ms = 0.0
        self._recall = 0.0

    @staticmethod
    def _cpu_seconds() -> float:
        r = resource.getrusage(resource.RUSAGE_SELF)
        return r.ru_utime + r.ru_stime

    @staticmethod
    def _memory_mb() -> float:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

    def record_latency(self, ms: float) -> None:
        # running average, matching the reference's (avg+x)/2 smoothing
        # (collector.go:138-149)
        self._avg_latency_ms = (
            ms if self._avg_latency_ms == 0 else (self._avg_latency_ms + ms) / 2
        )

    def cpu_percent(self) -> float:
        now_cpu, now_wall = self._cpu_seconds(), time.monotonic()
        dt = now_wall - self._last_wall
        pct = 100.0 * (now_cpu - self._last_cpu) / dt if dt > 0 else 0.0
        self._last_cpu, self._last_wall = now_cpu, now_wall
        return max(0.0, pct)

    def measure_recall(
        self, collection, k: int = 10, sample: int = 32, seed: int = 0
    ) -> float:
        """Measured recall@k of the collection's engine vs the exact oracle,
        using stored vectors (perturbation-free) as queries."""
        from quiver_tpu_torch.index.exact import ExactIndex
        from quiver_tpu_torch.parallel.sharded import sharded_exact_of

        store = collection.store
        if store.size == 0:
            return 0.0
        rng = np.random.default_rng(seed)
        live = store.live_slots()
        pick = rng.choice(live, size=min(sample, len(live)), replace=False)
        queries = np.stack([store.vector_of_slot(int(s)) for s in pick])
        # a sharded engine's own exact scan: ExactIndex would make the
        # store's whole device view
        oracle = sharded_exact_of(collection.engine) or ExactIndex(store)
        _, truth = oracle.search_slots(queries, k)
        _, got = collection.engine.search_slots(queries, k)
        hits = sum(
            len(
                {t for t in truth[b].tolist() if t >= 0}
                & {g for g in got[b].tolist() if g >= 0}
            )
            for b in range(len(pick))
        )
        self._recall = hits / (len(pick) * min(k, store.size))
        m = global_metrics()
        if m.enabled and hasattr(m, "recall"):
            m.recall.set(self._recall)
        return self._recall

    def snapshot(self) -> PerformanceMetrics:
        m = global_metrics()
        return PerformanceMetrics(
            avg_latency_ms=self._avg_latency_ms,
            qps=m.current_qps(),
            cpu_percent=self.cpu_percent(),
            memory_mb=self._memory_mb(),
            recall=self._recall,
        )
