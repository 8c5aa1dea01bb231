"""Mean ms a ``search_slots`` call of the profiled slice in which the card
runs nothing while the call is inside the program's ``ivf.search`` span but
outside its ``ivf.results`` (the wait and the copies out): the card waiting
on the engine's own host work."""

from qbench.program_spans import starved_ms
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return starved_ms(t)
