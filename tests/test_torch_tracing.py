"""The port's span ring (``observability/logging.py::Tracer``) and the
spans and counters of the IVF engine (``index/ivf.py``).

The ring: parent and root ids of nested spans, two threads' spans kept
apart, the wrap-around and its ``dropped`` count, an ``n`` past 32 bits,
the ends of a span against ``time.perf_counter()`` read inside it, the
start filter. The engine: one ``search_slots`` call is an ``ivf.search``
span with its four phases in order beneath it, one root for all; the
exact scan's spans (routed whole, or the under-fill supplement) carry the
rows they answered and move ``get_detailed_metrics()["search"]``;
``build`` is an ``ivf.build`` span that ``last_retrain_s`` reads; under a
profiler the phases are ``torch.profiler`` ranges.
"""

import threading
import time

import numpy as np
import pytest
import torch

from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
from quiver_tpu_torch.benches import span_cost
from quiver_tpu_torch.observability import logging as tlog

PHASES = ["ivf.copy_in", "ivf.query", "ivf.results", "ivf.finish"]


@pytest.fixture
def tracer(monkeypatch):
    """A fresh global tracer, so other tests' spans stay out of the ring."""
    t = tlog.Tracer()
    monkeypatch.setattr(tlog, "_global_tracer", t)
    return t


def rows(spans: dict) -> list:
    """The ring's columns as one dict per span."""
    keys = list(spans)
    return [dict(zip(keys, vals)) for vals in zip(*(spans[k] for k in keys))]


def by_name(spans: dict, name: str) -> list:
    return [r for r in rows(spans) if r["name"] == name]


def test_spans_nest_with_parent_and_root_ids():
    t = tlog.Tracer(capacity=64)
    with t.span("a", 1) as a:
        with t.span("b", 2) as b:
            with t.span("c", 3) as c:
                pass
        with t.span("d") as d:
            pass
    with t.span("e") as e:
        pass
    got = {r["name"]: r for r in rows(t.spans())}
    assert list(t.spans()["name"]) == ["c", "b", "d", "a", "e"]  # the order they ended
    assert [got[x]["id"] for x in "abcde"] == [s.span_id for s in (a, b, c, d, e)]
    assert got["a"]["parent"] == -1 and got["e"]["parent"] == -1
    assert got["b"]["parent"] == a.span_id and got["d"]["parent"] == a.span_id
    assert got["c"]["parent"] == b.span_id
    assert {got[x]["root"] for x in "abcd"} == {a.span_id} and got["e"]["root"] == e.span_id
    assert [got[x]["n"] for x in "abcde"] == [1, 2, 3, 0, 0]
    assert len(set(t.spans()["thread"])) == 1


def test_two_threads_spans_are_kept_apart():
    t = tlog.Tracer(capacity=512)
    start = threading.Barrier(2)

    def work(tag):
        start.wait(timeout=30)
        for i in range(50):
            with t.span(f"{tag}.outer", i):
                with t.span(f"{tag}.inner", i):
                    time.sleep(0)

    threads = [threading.Thread(target=work, args=(tag,)) for tag in ("x", "y")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    spans = t.spans()
    assert len(spans["id"]) == 200 and t.dropped == 0
    threads_of = {}
    for tag in ("x", "y"):
        outer = {r["id"]: r for r in by_name(spans, f"{tag}.outer")}
        inner = by_name(spans, f"{tag}.inner")
        assert len(outer) == len(inner) == 50
        for r in inner:
            parent = outer[r["parent"]]
            assert r["root"] == parent["id"] == parent["root"]
            assert r["n"] == parent["n"] and r["thread"] == parent["thread"]
        threads_of[tag] = {r["thread"] for r in outer.values()}
        assert len(threads_of[tag]) == 1
    assert threads_of["x"] != threads_of["y"]


def test_the_ring_wraps_and_counts_what_it_dropped():
    t = tlog.Tracer(capacity=64)
    for i in range(100):
        with t.span("s", i):
            pass
    spans = t.spans()
    assert list(spans["n"]) == list(range(36, 100)) and t.dropped == 36
    assert t.nbytes == 64 * 60
    t.clear()
    assert len(t.spans()["id"]) == 0 and t.dropped == 0
    with t.span("after"):
        pass
    assert list(t.spans()["name"]) == ["after"]
    g = tlog.global_tracer()
    assert g.capacity == 131_072 and g.nbytes <= 8_000_000


def test_an_n_past_32_bits_is_kept_as_the_largest():
    """The ring's ``n`` column is 32 bits: a larger count (an HNSW call's
    beam work at millions of queries) is kept as ``N_MAX``, not raised."""
    t = tlog.Tracer(capacity=8)
    for n in (tlog.N_MAX, tlog.N_MAX + 1, 10**12):
        with t.span("big", n):
            pass
    assert list(t.spans()["n"]) == [tlog.N_MAX] * 3


def test_a_span_brackets_the_clock_read_inside_it():
    t = tlog.Tracer(capacity=64)
    with t.span("x") as s:
        inside = [time.perf_counter() for _ in range(3)]
    (r,) = rows(t.spans(["x"]))
    assert r["start"] <= inside[0] <= inside[-1] <= r["end"]
    assert s.seconds == pytest.approx(r["end"] - r["start"])
    assert len(t.spans(lo=r["start"], hi=r["start"])["id"]) == 1
    assert len(t.spans(lo=np.nextafter(r["start"], np.inf))["id"]) == 0
    assert len(t.spans(["y"])["id"]) == 0


# ------------------------------------------------------------- the engine

D = 16


def engine(n: int, *, k_clusters: int, n_probe: int, threshold: int = 256,
           **cfg) -> tuple[IVFIndex, np.ndarray]:
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(k_clusters, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, k_clusters, n)]
            + 0.2 * rng.normal(size=(n, D))).astype(np.float32)
    store = VectorStore(dim=D, metric="euclidean", capacity=n, device="cpu")
    store.add_batch([f"v{i}" for i in range(n)], vecs)
    eng = IVFIndex(store, config=IVFConfig(n_clusters=k_clusters, n_probe=n_probe,
                                           build_threshold=threshold, **cfg))
    eng.build()
    queries = (vecs[:37] + 0.05 * rng.normal(size=(37, D))).astype(np.float32)
    return eng, queries


def test_search_is_one_root_with_its_four_phases_in_order(tracer):
    eng, q = engine(2048, k_clusters=16, n_probe=2)
    tracer.clear()
    eng.search_slots(q, 5)
    spans = tracer.spans()
    (search,) = by_name(spans, "ivf.search")
    assert search["n"] == 37 and search["parent"] == -1 and search["root"] == search["id"]
    phases = sorted((r for r in rows(spans) if r["name"] in PHASES), key=lambda r: r["start"])
    assert [r["name"] for r in phases] == PHASES
    assert all(r["parent"] == search["id"] and r["root"] == search["id"] for r in phases)
    assert all(r["n"] == 37 for r in phases)
    assert search["start"] <= phases[0]["start"] and phases[-1]["end"] <= search["end"]
    assert all(a["end"] <= b["start"] for a, b in zip(phases, phases[1:]))
    assert not by_name(spans, "ivf.exact")
    assert eng.get_detailed_metrics()["search"] == dict(
        calls=1, queries=37, exact_route_calls=0, underfill_calls=0, underfill_rows=0,
        overflow_merges=0, fill_host_checks=0)


def test_build_is_a_span_that_last_retrain_reads(tracer):
    eng, q = engine(2048, k_clusters=16, n_probe=1, recall_target=0.9, recall_sample=64)
    spans = tracer.spans()
    (build,) = by_name(spans, "ivf.build")
    assert build["n"] == 2048 and build["parent"] == -1
    tuned = by_name(spans, "ivf.search")
    assert tuned and all(r["parent"] == build["id"] and r["root"] == build["id"] for r in tuned)
    m = eng.get_detailed_metrics()
    assert m["last_retrain_s"] == round(build["end"] - build["start"], 3)
    assert m["search"]["calls"] == 0  # the tuner's searches are the build's


def test_the_exact_scan_spans_carry_the_rows_it_answered(tracer):
    eng, q = engine(2048, k_clusters=16, n_probe=2)
    tracer.clear()
    eng.search_slots(q[:9], 5, exact=True)
    spans = tracer.spans()
    (search,) = by_name(spans, "ivf.search")
    (ex,) = by_name(spans, "ivf.exact")
    assert ex["n"] == 9 and ex["parent"] == search["id"]
    assert [r["name"] for r in rows(spans)] == ["ivf.copy_in", "ivf.exact", "ivf.search"]
    assert eng.get_detailed_metrics()["search"]["exact_route_calls"] == 1

    # 300 rows in 32 clusters: one probed cluster never holds k=20 rows
    tiny, tq = engine(300, k_clusters=32, n_probe=1, threshold=64)
    tracer.clear()
    dist, slots = tiny.search_slots(tq, 20)
    assert (slots >= 0).all()
    spans = tracer.spans()
    (finish,) = by_name(spans, "ivf.finish")
    (ex,) = by_name(spans, "ivf.exact")
    assert ex["n"] == 37 and ex["parent"] == finish["id"]
    assert tiny.get_detailed_metrics()["search"] == dict(
        calls=1, queries=37, exact_route_calls=0, underfill_calls=1, underfill_rows=37,
        overflow_merges=0, fill_host_checks=0)


def test_the_overflow_merge_is_counted(tracer):
    eng, q = engine(2048, k_clusters=16, n_probe=2)
    moved = np.arange(0, 8)
    eng._vacate_slots(moved)
    eng._overflow.update(int(s) for s in moved)
    eng.search_slots(q, 5)
    assert eng.get_detailed_metrics()["search"]["overflow_merges"] == 1


def test_the_phases_are_profiler_ranges(tracer):
    eng, q = engine(2048, k_clusters=16, n_probe=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.search_slots(q, 5)
    assert {"ivf.search", *PHASES} <= {e.name for e in prof.events()}


def test_the_span_cost_bench_runs(tracer):
    out = span_cost.run(2000)
    assert out["ring_bytes"] == tracer.nbytes and out["span_ns"] > 0
    assert len(tracer.spans()["id"]) == 0
