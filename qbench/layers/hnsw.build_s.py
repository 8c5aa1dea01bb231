"""Seconds of set-up in the engine's own build: the program's
``hnsw.build`` spans (``HNSWIndex.on_insert``: every round's level
sampling, candidate scan, selection and connect) that ended before the
window."""

from qbench.hnsw_spans import build_s
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return build_s(t)
