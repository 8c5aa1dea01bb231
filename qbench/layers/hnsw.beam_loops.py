"""Loop iterations of the layer-0 beam a ``search_slots`` call: the ``n``
of the program's ``hnsw.beam`` spans, over the window's calls outside the
profiled slice. Each loop iteration is some forty torch launches, so this
counts the beam's host launches and waits."""

from qbench.hnsw_spans import phase_n
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    got = phase_n(t, "hnsw.beam")
    return None if got is None else got[1] / got[0]
