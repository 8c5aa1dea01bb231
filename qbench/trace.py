"""Spans, counters and the device trace of a traced run (``--trace 1``).

Spans and counters are taken by wrappers that the benchmark puts, at run
time, around methods of the program's objects (``Recorder.wrap``): the
program is not edited. A span is (name, start, end, thread, size) on the
host's monotonic clock, size being the requests or queries of the call.
The device trace is ``torch.profiler`` (CPU and CUDA activity) over a
steady slice of the window; its intervals are moved onto the host's clock
through a marker recorded at the slice's start.

A layer's reader (``layers/<metric>.py``) gets a :class:`Trace` and
returns its number, or None when it finds nothing to read.
"""

from __future__ import annotations

import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

MARK = "qbench.slice_mark"
#: device operations that are not kernels
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class Trace:
    """What a traced run recorded, for the layer readers."""

    spans: list = field(default_factory=list)  # (name, t0, t1, thread id, size)
    window: tuple = (0.0, 0.0)
    slice: tuple | None = None  # host-clock bounds of the profiled slice
    device: list = field(default_factory=list)  # (name, t0, t1) inside the slice
    #: per kernel family ("block_topw", "block_topw_f32"): the work of its
    #: calls in the slice, {"bytes", "flops", "peak"}
    work: dict = field(default_factory=dict)
    peaks: dict | None = None
    #: names of the program's own CUDA kernels (``csrc/``)
    port_kernels: frozenset = frozenset()
    #: the system under test (``qbench/system.py``), still alive while the
    #: readers run, for a reader of the program's own counters
    system: object = None


class Recorder:
    """Takes spans when ``on``; a no-op otherwise."""

    def __init__(self, on: bool):
        self.on = on
        self.spans: list = []
        #: per-call records a reader or the roofline needs after the window
        self.calls: dict = defaultdict(list)
        self.in_slice = False
        self._prof = None
        self._mark = None
        self.slice = None
        #: a callable read at the slice's start and stop (a program
        #: counter), its two readings in ``snaps``
        self.watch = None
        self.snaps: list = []

    def wrap(self, obj, attr: str, name: str, size=None, record=None) -> None:
        """Replace ``obj.attr`` (a bound method) by one that records a span
        ``name`` around each call, with ``size(args, kwargs)`` (requests or
        queries in the call) beside it; ``record(args, kwargs, result)``
        returns a value kept in ``calls[name]`` while the slice runs."""
        if not self.on:
            return
        inner = getattr(obj, attr)
        spans, calls, ident = self.spans, self.calls, threading.get_ident

        def traced(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = inner(*args, **kwargs)
            finally:
                n = size(args, kwargs) if size is not None else None
                spans.append((name, t0, time.perf_counter(), ident(), n))
            if record is not None and self.in_slice:
                calls[name].append(record(args, kwargs, out))
            return out

        setattr(obj, attr, traced)

    def span(self, name: str, t0: float, t1: float, size=None) -> None:
        if self.on:
            self.spans.append((name, t0, t1, threading.get_ident(), size))

    # ----------------------------------------------------------- the slice

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm_up(self) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start (seconds, with the device's tracing) falls outside the
        window."""
        import torch
        from torch.profiler import profile

        if self.on:
            with profile(activities=self._activities()):
                torch.zeros(8).add_(1)

    def start_slice(self) -> None:
        import torch
        from torch.profiler import profile

        if not self.on or self._prof is not None:
            return
        self._prof = profile(activities=self._activities())
        self._prof.start()
        a = time.perf_counter()
        with torch.profiler.record_function(MARK):
            b = time.perf_counter()
        self._mark = (a + b) / 2
        self.slice = (a, None)
        self.in_slice = True
        if self.watch is not None:
            self.snaps.append(self.watch())

    def stop_slice(self) -> None:
        import torch

        if self._prof is None or self.slice[1] is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.slice = (self.slice[0], time.perf_counter())
        self.in_slice = False
        if self.watch is not None:
            self.snaps.append(self.watch())
        self._prof.stop()

    def events(self) -> list:
        """The slice's device operations as (name, t0, t1) on the host's
        clock; read after the window (parsing takes a while)."""
        from torch.autograd import DeviceType

        if self._prof is None:
            return []
        events = self._prof.events()
        mark = next((e for e in events if e.name == MARK), None)
        if mark is None:
            return []
        off = self._mark - mark.time_range.start / 1e6
        return [(e.name, e.time_range.start / 1e6 + off, e.time_range.end / 1e6 + off)
                for e in events if e.device_type == DeviceType.CUDA]


# ------------------------------------------------------------- arithmetic


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of ``intervals``."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """(start, end) of the stretches of [lo, hi] no interval covers."""
    out, end = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def kernels(t: Trace) -> list:
    return [e for e in t.device if not is_copy(e[0])]


def matches(name: str, names) -> bool:
    """Whether device op ``name`` is one of the kernels ``names`` (whole
    identifiers, so ``gather_queries`` does not match ``gather_queries_f32``)."""
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])", name)
               for k in names)


def spans_named(t: Trace, name: str, lo: float | None = None, hi: float | None = None):
    """Spans ``name`` that started in [lo, hi]; by default those of the
    window outside the profiled slice, which the profiler slows."""
    if lo is None and hi is None:
        a, b = t.slice or (0.0, 0.0)
        return [s for s in t.spans if s[0] == name and t.window[0] <= s[1] < t.window[1]
                and not (s[1] < b and s[2] > a)]
    return [s for s in t.spans if s[0] == name and lo <= s[1] < hi]


def innermost(spans, when: float) -> str:
    """Name of the span open at ``when`` that started last, "none" if no
    span is open."""
    best = None
    for name, a, b, *_ in spans:
        if a <= when < b and (best is None or a > best[1]):
            best = (name, a)
    return best[0] if best else "none"


def breakdown(t: Trace, top: int = 10) -> dict | None:
    """The device operations that took most time in the slice, by name,
    and the slice's longest idle stretches, each with the innermost span
    open on the host at its middle."""
    if t.slice is None or not t.device:
        return None
    by_name = defaultdict(float)
    for name, a, b in t.device:
        by_name[short(name)] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = t.slice
    idle = sorted(gaps([(a, b) for _, a, b in t.device], lo, hi), key=lambda g: g[0] - g[1])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[innermost(t.spans, (a + b) / 2), b - a] for a, b in idle[:top]]}


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 96 letters."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    if "(" in name and not name.startswith(COPY_PREFIXES):
        name = name[:name.index("(")]
    return name[:96]


def port_kernel_names(csrc: Path) -> frozenset:
    """The ``__global__`` function names of the program's CUDA sources."""
    pat = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")
    names = set()
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(pat.findall(src.read_text()))
    return frozenset(names)


# ---------------------------------------------------------------- readers


def in_slice(t: Trace, name: str) -> list:
    """Spans ``name`` that started inside the profiled slice."""
    return [] if t.slice is None else spans_named(t, name, *t.slice)


def busy_s(t: Trace) -> float:
    """Seconds of the slice in which some operation ran on the device."""
    return union_s([(a, b) for _, a, b in t.device], *t.slice) if t.slice else 0.0


def idle_share(t: Trace) -> float | None:
    """Percent of the slice in which nothing ran on the device."""
    if t.slice is None or not t.device:
        return None
    return 100.0 * (1.0 - busy_s(t) / (t.slice[1] - t.slice[0]))


def kernel_s(t: Trace, names) -> float:
    """Device seconds of the kernels ``names`` in the slice."""
    return sum(b - a for n, a, b in kernels(t) if matches(n, names))


def roofline(t: Trace, family: str, names) -> float | None:
    """Percent of the kernels' time in the slice that their work, counted
    from the inputs (``qbench/roofline.py``), needs at the card's peaks."""
    from qbench.roofline import share

    w = t.work.get(family)
    secs = kernel_s(t, names)
    if not w or secs <= 0 or t.peaks is None:
        return None
    return share(w["bytes"], w["flops"], secs, t.peaks, w["peak"])
