"""Mean ms a ``search_slots`` call spends in the layer-0 beam: the
program's ``hnsw.beam`` span (``ops/hnsw_kernels.py::beam_search``, whose
loop reads the card every eight iterations, so the span holds nearly all
of the beam's device time), over the window outside the profiled slice."""

from qbench.hnsw_spans import phase_ms
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return phase_ms(t, "hnsw.beam")
