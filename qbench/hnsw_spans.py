"""The HNSW engine's own spans (``quiver_tpu_torch/index/hnsw.py``), for
the ``layers/hnsw.*`` readers, read from the port's tracer ring as
``program_spans.py`` reads the IVF engine's.

``hnsw.search`` per ``search_slots`` call, with its phases beneath it one
after the other: ``hnsw.copy_in``, ``hnsw.descent``, ``hnsw.beam`` (``n``
the beam's loop iterations), ``hnsw.results`` (``n`` the beam's useful
work: each query's iterations while it was active, summed), ``hnsw.finish``.
``hnsw.build`` per ``on_insert``, with ``hnsw.build.scan``,
``hnsw.build.select`` and ``hnsw.build.connect`` beneath it for each round
and level. A program without these spans gives nothing to read: every
function here then returns None.
"""

from __future__ import annotations

import numpy as np

from qbench.program_spans import ring
from qbench.trace import Trace

SEARCH = "hnsw.search"
BUILD = "hnsw.build"


def _calls(t: Trace, cols: dict, *, in_slice: bool) -> np.ndarray:
    """Ids of the ``hnsw.search`` calls that started in the profiled slice,
    or else of those that started in the window and do not overlap the
    slice (which the profiler slows)."""
    start, end = cols["start"], cols["end"]
    if in_slice:
        if t.slice is None:
            return cols["id"][:0]
        lo, hi = t.slice
        keep = (start >= lo) & (start < hi)
    else:
        a, b = t.slice or (0.0, 0.0)
        keep = (start >= t.window[0]) & (start < t.window[1]) & ~((start < b) & (end > a))
    return cols["id"][(cols["name"] == SEARCH) & keep]


def _phase(t: Trace, phase: str, *, in_slice: bool = False):
    """(calls, the ``phase`` spans of those calls) or None where the ring
    has no such call or no such phase."""
    cols = ring([SEARCH, phase])
    if cols is None:
        return None
    calls = _calls(t, cols, in_slice=in_slice)
    mine = (cols["name"] == phase) & np.isin(cols["parent"], calls)
    if not mine.any():
        return None
    return calls, {c: a[mine] for c, a in cols.items()}


def phase_ms(t: Trace, phase: str) -> float | None:
    """Mean ms of ``phase`` a ``search_slots`` call, over the calls of the
    window outside the profiled slice."""
    got = _phase(t, phase)
    if got is None:
        return None
    calls, spans = got
    return 1e3 * float((spans["end"] - spans["start"]).sum()) / len(calls)


def phase_n(t: Trace, phase: str, *, in_slice: bool = False) -> tuple[int, int] | None:
    """(calls, the sum of the ``n`` of their ``phase`` spans): over the
    calls of the profiled slice, or of the window outside it."""
    got = _phase(t, phase, in_slice=in_slice)
    if got is None:
        return None
    calls, spans = got
    return len(calls), int(spans["n"].astype(np.int64).sum())


def build_s(t: Trace, name: str = BUILD) -> float | None:
    """Seconds of the spans ``name`` that ended before the window (set-up);
    of ``hnsw.build`` those that no other ``hnsw.build`` holds."""
    cols = ring([name])
    if cols is None:
        return None
    done = cols["end"] < t.window[0]
    if name == BUILD:
        done &= ~np.isin(cols["parent"], cols["id"])
    if not done.any():
        return None
    return float((cols["end"] - cols["start"])[done].sum())
