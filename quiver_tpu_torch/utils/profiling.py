"""Profiling helpers — trace annotations + wall-clock spans (PyTorch port of
``quiver_tpu/utils/profiling.py``).

``trace_span`` emits BOTH a ``torch.profiler.record_function`` range
(visible in the port's ``torch.profiler`` traces, beside the device
kernels it enqueued) and the host-side structured-log span, so stages line
up across host and device views. ``profile_to`` records a trace of CPU and,
where there is a card, CUDA activity into a directory.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

from quiver_tpu_torch.observability.logging import global_tracer


@contextlib.contextmanager
def trace_span(name: str, **fields) -> Iterator[None]:
    span = global_tracer().start_span(name).set(**fields)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        span.end()


@contextlib.contextmanager
def profile_to(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``logdir`` (a Chrome trace,
    ``trace.json``; open it in Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: Optional[str] = None):
    """Decorator form of trace_span."""

    def wrap(fn):
        label = name or fn.__qualname__

        def inner(*args, **kwargs):
            with trace_span(label):
                return fn(*args, **kwargs)

        inner.__name__ = fn.__name__
        inner.__qualname__ = fn.__qualname__
        return inner

    return wrap
