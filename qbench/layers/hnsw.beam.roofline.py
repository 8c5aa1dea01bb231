"""The layer-0 beam's share of its HBM bound: the least time of its useful
work at the card's HBM peak over the device time of the profiled slice's
kernels (no copies).

The useful work of the slice's calls is the ``n`` of their ``hnsw.results``
spans (``index/hnsw.py``): each query's beam iterations while it was
active, summed on the card. An iteration reads ``expand`` adjacency rows of
``m0`` int32 ids and the ``expand * m0`` neighbour rows of ``d`` float32
values they name: ``4 * expand * m0 * (d + 1)`` bytes. ``d``, ``m0`` and
``expand`` come from the system (``systems/hnsw.py``). The slice's kernels
also hold the upper layers' descent, a few percent of a call; no kernel of
the beam is written by hand yet, and a later one is measured against the
same work."""

from qbench.hnsw_spans import phase_n
from qbench.trace import Trace, kernels


def read(t: Trace) -> float | None:
    got = phase_n(t, "hnsw.results", in_slice=True)
    if got is None or t.peaks is None or t.system is None:
        return None
    info = t.system.info
    secs = sum(b - a for _, a, b in kernels(t))
    if secs <= 0:
        return None
    nbytes = got[1] * 4.0 * info["expand"] * info["m0"] * (info["d"] + 1)
    return 100.0 * nbytes / t.peaks["hbm"] / secs
