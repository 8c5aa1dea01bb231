"""What an entry gets and what it hands back.

An entry (``entries/<name>.py``) drives the system under test with one
traffic mix for ``seconds``: ``pool_size(traffic)`` says how many queries
it needs made, ``run(ctx)`` warms up, runs the measured window and returns
a :class:`Window`. In a traced run it starts the profiler's slice at
``SLICE_AT`` of the window for ``slice_seconds``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from qbench.reference.judge import Answers

#: the profiled slice starts at this share of the window
SLICE_AT = 0.3


def slice_seconds(seconds: float) -> float:
    return min(2.0, 0.4 * seconds)


class Slicer:
    """Starts the traced run's profiled slice once ``SLICE_AT`` of the
    window has passed and stops it ``slice_seconds`` after it started
    (starting the profiler can take a while); a closed loop ticks it
    between calls."""

    def __init__(self, ctx: "Context"):
        self.rec = ctx.rec
        self.on = ctx.trace
        self.at = SLICE_AT * ctx.seconds
        self.length = slice_seconds(ctx.seconds)
        self.began = None

    def tick(self, elapsed: float) -> None:
        if not self.on:
            return
        if self.began is None:
            if elapsed >= self.at:
                self.rec.start_slice()
                self.began = time.perf_counter()
        elif time.perf_counter() - self.began >= self.length:
            self.rec.stop_slice()


@dataclass
class Context:
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    system: Any
    #: f32[m, d] on the host: the queries the benchmark made
    queries: Any
    rec: Any
    device: Any


@dataclass
class Window:
    t0: float
    t1: float
    attempted: int
    failed: int
    #: end-to-end numbers this entry measures, by metric name
    metrics: dict
    #: the judged queries, f32[J, d], and the answers given to them
    judged: np.ndarray
    answers: Answers
    #: numbers for the run's log (not compared, not in the result)
    notes: dict = field(default_factory=dict)


def host_batches(queries, batch: int, count: int) -> list:
    """``count`` host arrays of ``batch`` queries each, cut from the
    benchmark's queries into pageable memory of their own, as a caller
    hands them over."""
    return [queries[i * batch:(i + 1) * batch].clone().numpy() for i in range(count)]


def judge_rows(rng: np.random.Generator, size: int, count: int) -> np.ndarray:
    """``count`` distinct sorted positions of ``size``."""
    return np.sort(rng.choice(size, min(count, size), replace=False))


def answers_of(ids: np.ndarray, dists: np.ndarray, query: np.ndarray, k: int) -> Answers:
    """Answers from host arrays of one call's judged rows, padded to k."""
    ids = np.asarray(ids, np.int64)
    dists = np.asarray(dists, np.float64)
    if ids.shape[1] < k:
        pad = k - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        dists = np.pad(dists, ((0, 0), (0, pad)), constant_values=np.nan)
    return Answers(np.asarray(query, np.int64), ids[:, :k], dists[:, :k],
                   np.zeros(len(query), bool))


def call_notes(walls: list) -> dict:
    """Calls made and their wall ms at the 10th, 50th and 90th percentile
    and the slowest, for the run's log."""
    w = np.sort(np.asarray(walls)) * 1e3
    pick = lambda q: float(w[min(len(w) - 1, int(q * len(w)))])  # noqa: E731
    return {"calls": len(w), "call_ms": [pick(0.1), pick(0.5), pick(0.9), float(w[-1])]}


def closed_loop(ctx: Context, rows: list, judged: np.ndarray, call) -> Window:
    """One closed-loop caller: ``call(b)`` sends pool batch ``b`` (the
    pool's batches in turn) and returns (ids, distances) of its judged
    ``rows[b]``. ``warm_calls`` calls warm up, then calls run until
    ``ctx.seconds`` have passed; ``qps`` is the queries answered over the
    window, from the first call's start to the last call's end."""
    tr, rec = ctx.traffic, ctx.rec
    nb, size = len(rows), tr["batch"]
    base = np.cumsum([0] + [len(r) for r in rows])[:-1]
    for i in range(tr["warm_calls"]):
        call(i % nb)
    slicer = Slicer(ctx)
    parts, walls = [], []
    t0 = t = time.perf_counter()
    while t - t0 < ctx.seconds:
        slicer.tick(t - t0)
        b = len(walls) % nb
        a = time.perf_counter()
        ids, dists = call(b)
        parts.append(answers_of(ids, dists, base[b] + np.arange(len(rows[b])), tr["k"]))
        t = time.perf_counter()
        rec.span("harness.call", a, t, size)
        walls.append(t - a)
    rec.stop_slice()
    return Window(t0=t0, t1=t, attempted=len(walls) * size, failed=0,
                  metrics={"qps": len(walls) * size / (t - t0)}, judged=judged,
                  answers=Answers.concat(parts, tr["k"]), notes=call_notes(walls))
