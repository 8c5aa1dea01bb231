"""Share of the profiled slice in which no kernel, copy or set ran on the
card: 1 - (union of the device's intervals) / the slice."""

from qbench.trace import Trace, idle_share


def read(t: Trace) -> float | None:
    return idle_share(t)
