"""Host cost of one span of the port's tracer: ``trace_span`` opened and
closed in a loop, alone and nested under an open span (as the engine's
phases sit under ``ivf.search``), with no profiler running and the tracer's
log off, as the program runs by default; beside it, the same loop empty.

    python -m quiver_tpu_torch.benches.span_cost [N]

Prints one JSON line: ns a span each way, the loop's own ns, the ring's
bytes and capacity. Needs no card; run it on the host whose cost is asked.
"""

from __future__ import annotations

import json
import platform
import sys
import time

from quiver_tpu_torch.observability.logging import global_tracer
from quiver_tpu_torch.utils.profiling import trace_span


def _ns(fn, n: int) -> float:
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n * 1e9


def _empty(n: int) -> None:
    for _ in range(n):
        pass


def _flat(n: int) -> None:
    for _ in range(n):
        with trace_span("bench.span", 1):
            pass


def _nested(n: int) -> None:
    with trace_span("bench.outer", n):
        for _ in range(n):
            with trace_span("bench.span", 1):
                pass


def run(n: int = 1_000_000) -> dict:
    tracer = global_tracer()
    _flat(min(n, 10_000))  # warm up
    out = {"n": n, "loop_ns": _ns(_empty, n), "span_ns": _ns(_flat, n),
           "nested_span_ns": _ns(_nested, n), "ring_bytes": tracer.nbytes,
           "ring_spans": tracer.capacity, "host": platform.processor() or platform.machine(),
           "python": platform.python_version()}
    tracer.clear()
    return out


if __name__ == "__main__":
    print(json.dumps(run(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)))
