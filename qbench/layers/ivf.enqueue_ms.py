"""Mean ms a ``search_slots`` call spends enqueuing the device path: the
program's ``ivf.query`` span (``index/ivf.py``: the engine lock, the
store's device view, the keep-bit scatter and every launch of
``ivf_query``), over the window outside the profiled slice."""

from qbench.program_spans import phase_ms
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return phase_ms(t, "ivf.query")
