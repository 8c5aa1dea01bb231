"""Mean host wall of one engine ``search_slots`` call (``index/ivf.py``)
over the window: numpy queries in, numpy results out,
so it ends with the device-to-host copy."""

from qbench.trace import Trace, spans_named


def read(t: Trace) -> float | None:
    calls = spans_named(t, "engine.search_slots")
    return 1e3 * sum(b - a for _, a, b, *_ in calls) / len(calls) if calls else None
