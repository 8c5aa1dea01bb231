"""The readers of the program's own spans (``qbench/program_spans.py``,
``layers/ivf.*.py``) on spans written at chosen times into a fresh ring of
the port's tracer and on chosen device intervals: each of the seven
metrics, the profiled slice left out of the phase means and alone read by
the starved time, and None on an empty ring and on a program without one.
Then a traced run of each cell at CPU sizes reports the program's metrics.
"""

from __future__ import annotations

import pytest
import torch

from qbench import manifest
from qbench.run import run_cell
from qbench.tests import small
from qbench.trace import Trace
from quiver_tpu_torch.observability import logging as tlog

PHASE_METRICS = {"ivf.copy_in_ms": "ivf.copy_in", "ivf.enqueue_ms": "ivf.query",
                 "ivf.results_ms": "ivf.results", "ivf.finish_ms": "ivf.finish"}
METRICS = [*PHASE_METRICS, "ivf.device_starved_ms", "ivf.exact_fallback_share", "ivf.build_s"]
WINDOW, SLICE = (100.0, 200.0), (140.0, 160.0)


def read(metric: str, t: Trace):
    return manifest.layer_reader(metric).read(t)


class Clock:
    """The spans' clock, set by hand."""

    now = 0.0

    def __call__(self) -> float:
        return self.now


@pytest.fixture
def ring(monkeypatch):
    """(tracer, clock): a fresh global tracer on a hand-set clock."""
    tracer, clock = tlog.Tracer(capacity=1024), Clock()
    monkeypatch.setattr(tlog, "_global_tracer", tracer)
    monkeypatch.setattr(tlog, "_clock", clock)
    return tracer, clock


def call(ring, t0: float, phases, n: int = 4) -> float:
    """One ``search_slots`` call from ``t0``: ``ivf.search`` around the
    phases ``(name, seconds[, rows])`` back to back; returns its end."""
    tracer, clock = ring
    clock.now = t = t0
    with tracer.span("ivf.search", n):
        for name, secs, *rows in phases:
            clock.now = t
            with tracer.span(name, rows[0] if rows else n):
                clock.now = t = t + secs
    return t


def steady(copy_in=0.001, query=0.002, results=0.003, finish=0.0005):
    return [("ivf.copy_in", copy_in), ("ivf.query", query), ("ivf.results", results),
            ("ivf.finish", finish)]


def trace(device=()) -> Trace:
    return Trace(window=WINDOW, slice=SLICE, device=list(device))


def test_phase_means_leave_the_profiled_slice_out(ring):
    for t0 in (101.0, 111.0, 121.0):
        call(ring, t0, steady())
    call(ring, 145.0, steady(9.0, 9.0, 9.0, 9.0))  # in the slice: slowed, left out
    call(ring, 139.0, steady(0.5, 0.5, 0.5, 0.5))  # ends inside the slice: left out
    call(ring, 50.0, steady(7.0, 7.0, 7.0, 7.0))  # before the window
    t = trace()
    want = {"ivf.copy_in_ms": 1.0, "ivf.enqueue_ms": 2.0, "ivf.results_ms": 3.0,
            "ivf.finish_ms": 0.5}
    for metric, ms in want.items():
        assert read(metric, t) == pytest.approx(ms)


def test_starved_time_reads_the_slice_alone(ring):
    # a call from 145: copy_in 145-146, query 146-148, results 148-151,
    # finish 151-151.5; the card busy 145.5-147 and 148-150 (inside
    # results): starved 0.5 + 1 + 0.5 = 2 s of the call's 6.5
    call(ring, 145.0, steady(1.0, 2.0, 3.0, 0.5))
    call(ring, 101.0, steady(5.0, 5.0, 5.0, 5.0))  # outside the slice
    dev = [("k1", 145.5, 146.5), ("k2", 146.2, 147.0), ("Memcpy DtoH", 148.0, 150.0)]
    assert read("ivf.device_starved_ms", trace(dev)) == pytest.approx(2000.0)
    # a second call from 158 runs past the slice's end (160): counted to it
    call(ring, 158.0, steady(1.0, 2.0, 3.0, 0.5))
    dev.append(("k3", 158.5, 159.0))
    assert read("ivf.device_starved_ms", trace(dev)) == pytest.approx((2000.0 + 1500.0) / 2)
    assert read("ivf.device_starved_ms", trace()) is None  # no device trace


def test_starved_time_is_within_the_slice_idle_time(ring):
    for i in range(8):
        call(ring, 141.0 + 2 * i, steady(0.1, 0.2, 0.3, 0.05))
    dev = [(f"k{i}", 141.15 + 2 * i, 141.35 + 2 * i) for i in range(8)]
    t = trace(dev)
    starved = read("ivf.device_starved_ms", t)
    idle = (SLICE[1] - SLICE[0]) - sum(b - a for _, a, b in dev)
    assert 0 < starved * 8 / 1e3 <= idle
    assert starved == pytest.approx(1e3 * (0.65 - 0.3 - 0.15))  # device 0.15 s outside results


def test_the_exact_share_counts_rows_over_queries(ring):
    call(ring, 101.0, steady(), n=100)
    call(ring, 111.0, [("ivf.copy_in", 0.001), ("ivf.exact", 0.01)], n=50)
    call(ring, 121.0, [*steady()[:3], ("ivf.finish", 0.01)], n=50)
    tracer, clock = ring
    # an under-fill supplement of 5 rows inside the last call's finish
    call(ring, 131.0, [("ivf.copy_in", 0.001), ("ivf.finish", 0.0)], n=50)
    clock.now = 131.5
    with tracer.span("ivf.exact", 5):
        clock.now = 131.6
    call(ring, 20.0, [("ivf.exact", 0.01)], n=1000)  # before the window
    assert read("ivf.exact_fallback_share", trace()) == pytest.approx(100 * 55 / 250)


def test_the_exact_share_is_zero_without_fallbacks(ring):
    call(ring, 101.0, steady())
    assert read("ivf.exact_fallback_share", trace()) == 0.0


def test_build_seconds_sum_the_builds_before_the_window(ring):
    tracer, clock = ring
    clock.now = 10.0
    with tracer.span("ivf.build", 1000):
        call(ring, 12.0, steady())  # the tuner's search, nested
        clock.now = 14.0
        with tracer.span("ivf.build", 1000):  # a build within a build
            clock.now = 15.0
        clock.now = 16.0
    clock.now = 30.0
    with tracer.span("ivf.build", 1000):
        clock.now = 31.5
    clock.now = 150.0
    with tracer.span("ivf.build", 1000):  # a rebuild in the window
        clock.now = 155.0
    assert read("ivf.build_s", trace()) == pytest.approx(6.0 + 1.5)


@pytest.mark.parametrize("metric", METRICS)
def test_an_empty_ring_reads_none(ring, metric):
    assert read(metric, trace([("k", 141.0, 142.0)])) is None
    call(ring, 10.0, steady())  # before the window only
    ring[0].clear()
    assert read(metric, trace([("k", 141.0, 142.0)])) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_the_ring_reads_none(monkeypatch, metric):
    monkeypatch.setattr(tlog, "_global_tracer", object())
    assert read(metric, trace([("k", 141.0, 142.0)])) is None


def test_the_new_metrics_are_in_the_manifest():
    m = {x["name"]: x for x in manifest.load()["per_layer"]}
    for name in METRICS:
        assert m[name]["source"] in ("program_span", "program_counter")
        assert m[name]["moves"] == ("setup_s" if name == "ivf.build_s" else "qps")
        assert m[name]["workloads"] == ["sift1m-ivf-bf16.batch64k", "sift1m-ivf-bf16.k100"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.copy(tmp_path_factory.mktemp("small"))


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_a_traced_run_reports_the_program_metrics(root, cell):
    """At CPU sizes the program's spans are read (some k=100 rows of the
    small copy's clusters under-fill, so the exact share is not 0 there);
    the starved time needs a device trace, which a CPU run has not."""
    tlog.global_tracer().clear()
    out = run_cell(manifest.cell(cell, root), 2**31 + 77, small.SECONDS, True,
                   torch.device("cpu"), root=root)
    got = out["metrics"]
    assert set(METRICS) - set(got) == {"ivf.device_starved_ms"}
    assert 0.0 <= got["ivf.exact_fallback_share"]["value"] < 100.0
    assert got["ivf.build_s"]["value"] > 0
    phases = sum(got[m]["value"] for m in PHASE_METRICS)
    assert 0 < phases <= got["engine.call_ms"]["value"]
