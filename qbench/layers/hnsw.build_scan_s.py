"""Seconds of the build's exact candidate scans: the program's
``hnsw.build.scan`` spans (``flat_scan_topk`` over each level's members,
``ef_construction``-deep; each ends in a wait for the card) that ended
before the window."""

from qbench.hnsw_spans import build_s
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return build_s(t, "hnsw.build.scan")
