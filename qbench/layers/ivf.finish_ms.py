"""Mean ms a ``search_slots`` call spends on the host after its results
are back: the program's ``ivf.finish`` span (``index/ivf.py``: the
overflow merge, the negative rerank, the under-fill check and supplement),
over the window outside the profiled slice."""

from qbench.program_spans import phase_ms
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return phase_ms(t, "ivf.finish")
