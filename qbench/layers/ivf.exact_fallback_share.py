"""Percent of the window's ``search_slots`` queries answered by the exact
scan: rows of the program's ``ivf.exact`` spans (a call routed there whole,
or the under-fill supplement) over the queries of its ``ivf.search``
spans."""

from qbench.program_spans import exact_share
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return exact_share(t)
