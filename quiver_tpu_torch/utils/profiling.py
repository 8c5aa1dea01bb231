"""Spans of the program's phases (PyTorch port of
``quiver_tpu/utils/profiling.py``).

``trace_span`` is the one way the port opens a span: on the global tracer
(``observability/logging.py``), whose ring keeps every span that ends. It
marks a ``torch.profiler.record_function`` range only while a profiler
runs, so a device trace shows the span beside the kernels it enqueued, and
builds its log line only when the tracer is enabled; otherwise it costs a
few attribute writes and one row of the ring.
"""

from __future__ import annotations

from quiver_tpu_torch.observability.logging import Span, global_tracer


def trace_span(name: str, n: int = 0, **fields) -> Span:
    """A span ``name`` covering ``n`` items (queries, rows), for a ``with``
    block: ``with trace_span("ivf.search", B) as span: ...``."""
    return Span(global_tracer(), name, n, fields)
