"""Mean ms a ``search_slots`` call spends getting its results back: the
program's ``ivf.results`` span (``index/ivf.py``: the wait for the device
to finish, then both copies out to numpy), over the window outside the
profiled slice."""

from qbench.program_spans import phase_ms
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return phase_ms(t, "ivf.results")
