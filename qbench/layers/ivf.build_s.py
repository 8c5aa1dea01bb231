"""Seconds of set-up in the engine's own builds: the program's
``ivf.build`` spans (k-means, split, layout, the n_probe tuner) that ended
before the window."""

from qbench.program_spans import build_s
from qbench.trace import Trace


def read(t: Trace) -> float | None:
    return build_s(t)
