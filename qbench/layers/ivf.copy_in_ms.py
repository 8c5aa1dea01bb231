"""Mean ms a ``search_slots`` call spends handing the queries to the card:
the program's ``ivf.copy_in`` span (``index/ivf.py``: the host arrays made
contiguous f32 and copied to the device, pageable here), over the window
outside the profiled slice."""

from qbench.program_spans import phase_ms
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return phase_ms(t, "ivf.copy_in")
