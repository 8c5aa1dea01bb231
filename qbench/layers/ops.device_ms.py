"""Device ms per engine ``search_slots`` call in the kernels that are not
the program's own CUDA kernels (``csrc/``): the torch ops of the query
(``ops/ivf_kernels.py``, ``ops/scan.py``), by kernel name in the slice's
trace."""

from qbench.trace import Trace, in_slice, kernels, matches


def read(t: Trace) -> float | None:
    calls = in_slice(t, "engine.search_slots")
    if not calls or not t.device:
        return None
    secs = sum(b - a for n, a, b in kernels(t) if not matches(n, t.port_kernels))
    return 1e3 * secs / len(calls)
