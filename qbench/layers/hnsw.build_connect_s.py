"""Seconds of the build's connects: the program's ``hnsw.build.connect``
spans (``connect_level``: forward rows, reverse edges and the overflow
rows' re-selection; each ends in a wait for the card) that ended before
the window."""

from qbench.hnsw_spans import build_s
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return build_s(t, "hnsw.build.connect")
