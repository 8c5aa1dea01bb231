"""Spans the program records itself, for the layer readers that read them.

The port's tracer (``quiver_tpu_torch/observability/logging.py``) keeps
every span that ends in a ring of fixed size, on ``time.perf_counter()``,
the clock the device trace is mapped onto (``qbench/trace.py``), so a span
sits beside the kernels with no offset. The IVF engine's spans
(``index/ivf.py``): ``ivf.search`` per ``search_slots`` call, with its
phases ``ivf.copy_in``, ``ivf.query``, ``ivf.results``, ``ivf.finish``
beneath it one after the other; ``ivf.exact`` where the exact scan answers
for the engine, ``n`` its rows; ``ivf.build``. A program without the ring
gives nothing to read: every function here then returns None.
"""

from __future__ import annotations

import bisect

import numpy as np

from qbench.trace import Trace

SEARCH = "ivf.search"


def ring(names) -> dict | None:
    """The program's spans named ``names`` (columns ``id``, ``parent``,
    ``root``, ``start``, ``end``, ``thread``, ``n``, ``name``), or None
    where the program keeps no ring."""
    from quiver_tpu_torch.observability.logging import global_tracer

    read = getattr(global_tracer(), "spans", None)
    return None if read is None else read(names=list(names))


def _window(t: Trace, cols: dict) -> np.ndarray:
    return (cols["start"] >= t.window[0]) & (cols["start"] < t.window[1])


def _outside_slice(t: Trace, cols: dict) -> np.ndarray:
    """Started in the window and not overlapping the profiled slice, which
    the profiler slows (as ``trace.spans_named`` selects)."""
    a, b = t.slice or (0.0, 0.0)
    return _window(t, cols) & ~((cols["start"] < b) & (cols["end"] > a))


def phase_ms(t: Trace, phase: str) -> float | None:
    """Mean ms of ``phase`` a ``search_slots`` call, over the calls of the
    window outside the profiled slice."""
    cols = ring([SEARCH, phase])
    if cols is None:
        return None
    calls = cols["id"][(cols["name"] == SEARCH) & _outside_slice(t, cols)]
    mine = (cols["name"] == phase) & np.isin(cols["parent"], calls)
    if not mine.any():
        return None
    return 1e3 * float((cols["end"] - cols["start"])[mine].sum()) / len(calls)


class Busy:
    """The union of intervals, merged once, for the covered length of any
    stretch (``trace.union_s`` sorts every interval again for each one,
    and a slice holds tens of thousands of device operations)."""

    def __init__(self, intervals):
        merged = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.before = np.concatenate([[0.0], np.cumsum([b - a for a, b in merged])])

    def covered(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] inside the union."""
        i = bisect.bisect_right(self.ends, lo)  # first interval ending after lo
        j = bisect.bisect_left(self.starts, hi) - 1  # last starting before hi
        if hi <= lo or i > j:
            return 0.0
        total = self.before[j + 1] - self.before[i]
        return float(total - max(0.0, lo - self.starts[i]) - max(0.0, self.ends[j] - hi))


def starved_ms(t: Trace) -> float | None:
    """Mean ms a ``search_slots`` call of the profiled slice in which
    nothing of ``t.device`` runs while the call is inside ``ivf.search``
    but outside its ``ivf.results`` (the wait for the device and the copies
    out): the card waiting on the engine's host work."""
    if t.slice is None or not t.device:
        return None
    cols = ring([SEARCH, "ivf.results"])
    if cols is None:
        return None
    lo, hi = t.slice
    started = (cols["start"] >= lo) & (cols["start"] < hi)
    calls = np.flatnonzero((cols["name"] == SEARCH) & started)
    if not len(calls):
        return None
    busy = Busy((a, b) for _, a, b in t.device)
    results = {}
    for i in np.flatnonzero(cols["name"] == "ivf.results"):
        results.setdefault(int(cols["parent"][i]), []).append((cols["start"][i], cols["end"][i]))
    idle = 0.0
    for i in calls:
        a, b = cols["start"][i], min(cols["end"][i], hi)
        idle += (b - a) - busy.covered(a, b)
        for ra, rb in results.get(int(cols["id"][i]), ()):
            ra, rb = max(ra, a), min(rb, b)
            idle -= max(0.0, rb - ra) - busy.covered(ra, rb)
    return 1e3 * idle / len(calls)


def exact_share(t: Trace) -> float | None:
    """Percent of the window's ``search_slots`` queries that the exact scan
    answered (``ivf.exact`` rows over ``ivf.search`` queries)."""
    cols = ring([SEARCH, "ivf.exact"])
    if cols is None:
        return None
    win = _window(t, cols)
    searches = (cols["name"] == SEARCH) & win
    if not searches.any():
        return None
    rows = cols["n"][(cols["name"] == "ivf.exact") & win].sum()
    return 100.0 * float(rows) / max(int(cols["n"][searches].sum()), 1)


def build_s(t: Trace) -> float | None:
    """Seconds of the engine's builds that ended before the window (set-up):
    the ``ivf.build`` spans, each counted once where builds nest."""
    cols = ring(["ivf.build"])
    if cols is None:
        return None
    done = (cols["end"] < t.window[0]) & ~np.isin(cols["parent"], cols["id"])
    if not done.any():
        return None
    return float((cols["end"] - cols["start"])[done].sum())
