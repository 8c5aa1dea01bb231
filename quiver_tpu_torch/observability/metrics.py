"""Metrics — Prometheus instruments + in-memory percentile rings.

Unifies the reference's two overlapping systems (SURVEY.md §5.5):
``pkg/observability/metrics.go`` (per-collection/per-stage histograms,
in-memory p50/p95/p99 rings) and ``pkg/metrics/collector.go`` (DB-level
QPS/CPU/mem/recall gauges) into one registry, keeping the reference's metric
names and stage taxonomy (filter/traversal/rerank) so dashboards port over.

Disabled by default and atomically toggleable, like the reference
(metrics.go:189-199). A copy of ``quiver_tpu/observability/metrics.py`` for
the PyTorch port (host code; the JAX package cannot be imported without
JAX).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Optional

try:
    from prometheus_client import (
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )

    _HAS_PROM = True
except ImportError:  # pragma: no cover - prometheus_client is baked in
    _HAS_PROM = False

# Buckets 0.1ms..1000ms in ms units (reference: metrics.go:60-67).
_BUCKETS_MS = (0.1, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000)

_RING_SIZE = 10_000  # last-N latency ring (reference: metrics.go:316-368)

STAGES = ("filter", "traversal", "rerank")


class _LatencyRing:
    def __init__(self, size: int = _RING_SIZE):
        self._buf: deque[float] = deque(maxlen=size)
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        with self._lock:
            self._buf.append(ms)

    def stats(self) -> dict:
        with self._lock:
            vals = sorted(self._buf)
        if not vals:
            return {"count": 0}
        n = len(vals)

        def pct(p):
            return vals[min(n - 1, int(p * n))]

        return {
            "count": n,
            "min_ms": vals[0],
            "max_ms": vals[-1],
            "avg_ms": sum(vals) / n,
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
            "p99_ms": pct(0.99),
        }


class Metrics:
    """Singleton metrics hub (reference GlobalMetrics, metrics.go:44-52)."""

    _instance: Optional["Metrics"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._enabled = False
        self._lock = threading.Lock()
        self._rings: dict[tuple[str, str], _LatencyRing] = defaultdict(_LatencyRing)
        self.registry = CollectorRegistry() if _HAS_PROM else None
        if _HAS_PROM:
            r = self.registry
            lab = ["collection"]
            self.search_latency = Histogram(
                "quiver_search_duration_ms", "Search latency (ms)", lab,
                buckets=_BUCKETS_MS, registry=r)
            self.insert_latency = Histogram(
                "quiver_insert_duration_ms", "Insert latency (ms)", lab,
                buckets=_BUCKETS_MS, registry=r)
            self.batch_latency = Histogram(
                "quiver_batch_duration_ms", "Batch op latency (ms)",
                ["collection", "operation"], buckets=_BUCKETS_MS, registry=r)
            self.stage_latency = Histogram(
                "quiver_search_stage_duration_ms",
                "Per-stage search latency (ms)", ["collection", "stage"],
                buckets=_BUCKETS_MS, registry=r)
            self.search_total = Counter(
                "quiver_search_total", "Total searches", lab, registry=r)
            self.insert_total = Counter(
                "quiver_insert_total", "Total inserts", lab, registry=r)
            self.delete_total = Counter(
                "quiver_delete_total", "Total deletes", lab, registry=r)
            self.error_total = Counter(
                "quiver_errors_total", "Total errors",
                ["collection", "operation"], registry=r)
            self.index_size = Gauge(
                "quiver_index_size", "Live vectors per index", lab, registry=r)
            self.index_size_bytes = Gauge(
                "quiver_index_size_bytes", "Approx index bytes", lab, registry=r)
            self.qps = Gauge("quiver_qps", "Queries per second", [], registry=r)
            self.recall = Gauge(
                "quiver_search_recall", "Measured recall", [], registry=r)
            self.optimization_score = Gauge(
                "quiver_optimization_score", "Auto-tuning score", [], registry=r)
        # QPS window
        self._query_times: deque[float] = deque(maxlen=4096)

    @classmethod
    def global_metrics(cls) -> "Metrics":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Metrics()
            return cls._instance

    @classmethod
    def reset_global(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    # ----------------------------------------------------------------- api

    def enable(self, on: bool = True) -> None:
        self._enabled = on

    @property
    def enabled(self) -> bool:
        return self._enabled

    def record_search(self, collection: str, ms: float,
                      stages: Optional[dict] = None) -> None:
        if not self._enabled:
            return
        self._rings[(collection, "search")].record(ms)
        now = time.time()
        with self._lock:
            self._query_times.append(now)
        if _HAS_PROM:
            self.search_latency.labels(collection).observe(ms)
            self.search_total.labels(collection).inc()
            if stages:
                for stage, sms in stages.items():
                    self.stage_latency.labels(collection, stage).observe(sms)
            self.qps.set(self.current_qps())

    def record_insert(self, collection: str, ms: float, n: int = 1) -> None:
        if not self._enabled:
            return
        self._rings[(collection, "insert")].record(ms)
        if _HAS_PROM:
            self.insert_latency.labels(collection).observe(ms)
            self.insert_total.labels(collection).inc(n)

    def record_delete(self, collection: str, n: int = 1) -> None:
        if not self._enabled:
            return
        if _HAS_PROM:
            self.delete_total.labels(collection).inc(n)

    def record_batch(self, collection: str, operation: str, ms: float) -> None:
        if not self._enabled:
            return
        self._rings[(collection, operation)].record(ms)
        if _HAS_PROM:
            self.batch_latency.labels(collection, operation).observe(ms)

    def record_error(self, collection: str, operation: str) -> None:
        if not self._enabled:
            return
        if _HAS_PROM:
            self.error_total.labels(collection, operation).inc()

    def set_index_size(self, collection: str, n: int, nbytes: int = 0) -> None:
        if not self._enabled:
            return
        if _HAS_PROM:
            self.index_size.labels(collection).set(n)
            if nbytes:
                self.index_size_bytes.labels(collection).set(nbytes)

    def current_qps(self, window_s: float = 10.0) -> float:
        now = time.time()
        with self._lock:  # appends race the iteration (server thread pool)
            snap = list(self._query_times)
        return sum(1 for t in snap if now - t <= window_s) / window_s

    def latency_stats(self, collection: str, op: str = "search") -> dict:
        return self._rings[(collection, op)].stats()

    def prometheus_text(self) -> bytes:
        if _HAS_PROM:
            return generate_latest(self.registry)
        return b""

    def summary(self) -> dict:
        """JSON-friendly snapshot (the /api/v1/metrics payload)."""
        out = {"qps": self.current_qps(), "collections": {}}
        for (coll, op), ring in list(self._rings.items()):
            out["collections"].setdefault(coll, {})[op] = ring.stats()
        return out


def global_metrics() -> Metrics:
    return Metrics.global_metrics()
