"""Mean ms a ``search_slots`` call spends in the greedy descent through the
upper layers: the program's ``hnsw.descent`` span (``index/hnsw.py``: the
engine lock, the store's device view, the device graph and every
``greedy_descent`` loop, which reads the card every four steps), over the
window outside the profiled slice."""

from qbench.hnsw_spans import phase_ms
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return phase_ms(t, "hnsw.descent")
