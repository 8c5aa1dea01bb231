"""The port's HNSW search held to the plain reference
(``qbench/reference/hnsw.py``) and to the exact top-k
(``qbench/reference/exact.py``), and the engine's spans and counters, on
the CPU at small sizes with seeded random data.

* ``beam_search`` (ring and bitmap visited sets, expand 1 and 4, ef 8 and
  40) and
  ``greedy_descent`` against the reference on the same k-NN graph (holes,
  tombstones, a permuted row map): distances to rtol 1e-5 and atol 5e-5,
  ids equal except where the reference's distances of the swapped entries
  differ by less (the port computes in float32, through |q|^2 + |v|^2 -
  2 q.v: at squared norms near 20, as here, its rounding reaches 1e-5 in a
  distance of 0.4), and each query's active iterations equal to the
  reference's steps;
* a built engine's ``search_slots`` against the reference's whole search on
  the engine's own graph, and against the exact top-k through the
  benchmark's judge (recall, distances of the returned ids, bad answers);
* the spans under ``hnsw.search`` and ``hnsw.build``, in order and nested;
  ``get_detailed_metrics()["search"]``; the useful-work counter equal to
  ``beam_search(stats=)["iters"].sum()``; the results bit-identical to the
  programs run without counters.
"""

import numpy as np
import pytest
import torch

from qbench.reference import exact, judge
from qbench.reference import hnsw as ref
from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index import hnsw as hnsw_mod
from quiver_tpu_torch.index.hnsw import HNSWIndex
from quiver_tpu_torch.observability import logging as tlog
from quiver_tpu_torch.ops import hnsw_kernels as tk
from quiver_tpu_torch.ops.scan import MASKED_DIST

REL, ATOL = 1e-5, 5e-5
PHASES = ["hnsw.copy_in", "hnsw.descent", "hnsw.beam", "hnsw.results", "hnsw.finish"]
STAGES = ["hnsw.build.scan", "hnsw.build.select", "hnsw.build.connect"]


@pytest.fixture
def tracer(monkeypatch):
    """A fresh global tracer, so other tests' spans stay out of the ring."""
    t = tlog.Tracer()
    monkeypatch.setattr(tlog, "_global_tracer", t)
    return t


def rows(spans: dict) -> list:
    keys = list(spans)
    return [dict(zip(keys, vals)) for vals in zip(*(spans[k] for k in keys))]


def by_name(spans: dict, name: str) -> list:
    return [r for r in rows(spans) if r["name"] == name]


def blobs(n: int, d: int, rng, centers: int = 12, spread: float = 0.4) -> np.ndarray:
    c = rng.normal(size=(centers, d))
    return (c[rng.integers(0, centers, n)] + spread * rng.normal(size=(n, d))).astype(np.float32)


def knn_adj(vecs: np.ndarray, deg: int, rng, holes: float = 0.05) -> np.ndarray:
    """Row i: the ``deg`` nearest other rows of row i, a share knocked out."""
    v = vecs.astype(np.float64)
    d2 = (v * v).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2 * v @ v.T
    np.fill_diagonal(d2, np.inf)
    adj = np.argsort(d2, axis=1, kind="stable")[:, :deg]
    adj[rng.random(adj.shape) < holes] = -1
    return adj


def layer0_case(n=500, d=16, deg=32, seed=0):
    """(vectors, valid, adj i32[rows, deg] in permuted row order, pos_map,
    rng) as torch tensors: 5% of the slots tombstoned."""
    rng = np.random.default_rng(seed)
    vecs = blobs(n, d, rng)
    perm = rng.permutation(n)  # row r holds slot perm[r]
    pos_map = np.empty(n, np.int64)
    pos_map[perm] = np.arange(n)
    adj = knn_adj(vecs, deg, rng)[perm].astype(np.int32)
    valid = rng.random(n) >= 0.05
    return (torch.from_numpy(vecs), torch.from_numpy(valid), torch.from_numpy(adj),
            torch.from_numpy(pos_map), rng)


def assert_matches_reference(dt, it, want_d, want_i):
    """The port's (dist, ids) rows against the reference's: the same empty
    places, distances within the tolerance, ids equal except at near-ties."""
    dt, it = np.asarray(dt, np.float64), np.asarray(it)
    dr, ir = np.asarray(want_d, np.float64), np.asarray(want_i)
    assert it.shape == ir.shape
    np.testing.assert_array_equal(it < 0, ir < 0)
    np.testing.assert_array_equal(dt >= MASKED_DIST, ir < 0)
    live = ir >= 0
    np.testing.assert_allclose(dt[live], dr[live], rtol=REL, atol=ATOL)
    for b, j in zip(*np.nonzero(it != ir)):
        gap = np.abs(dr[b] - dr[b, j])
        gap[j] = np.inf
        assert (gap <= REL * abs(dr[b, j]) + ATOL).any(), (b, j, it[b], ir[b], dr[b])


@pytest.mark.parametrize("visited", ["ring", "bitmap"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("ef", [8, 40])
def test_beam_search_matches_the_plain_reference(visited, expand, ef):
    """Beams of 32 and 96 entries at expand 1 and of 128 at expand 4."""
    vecs, valid, adj, pos_map, rng = layer0_case(seed=7 + expand)
    B = 16
    q = torch.from_numpy(
        (vecs.numpy()[rng.integers(0, len(vecs), B)] + 0.3 * rng.normal(size=(B, 16)))
        .astype(np.float32))
    entries = torch.from_numpy(rng.integers(0, len(vecs), B))
    entries[0] = -1  # no entry: an empty answer
    entries[1] = int(np.flatnonzero(~valid.numpy())[0])  # a tombstoned entry: empty too
    max_iters = int(1.5 * ef) + 8
    stats = {}
    dt, it = tk.beam_search(q, entries, vecs, valid, adj, pos_map, metric="euclidean", ef=ef,
                            max_iters=max_iters, expand=expand, visited=visited, stats=stats)
    want = [ref.beam(q[b], int(entries[b]), vecs, valid, adj, pos_map, metric="euclidean",
                     ef=ef, max_iters=max_iters, expand=expand, visited=visited)
            for b in range(B)]
    assert (it[:2] == -1).all()
    assert_matches_reference(dt, it, [w[0] for w in want], [w[1] for w in want])
    assert stats["iters"].tolist() == [w[2] for w in want]
    assert int(stats["iters"].sum()) == sum(w[2] for w in want)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_greedy_descent_matches_the_plain_reference(metric):
    vecs, valid, _, _, rng = layer0_case(seed=11)
    n = len(vecs)
    members = np.sort(rng.choice(np.flatnonzero(valid.numpy()), 150, replace=False))
    sub = knn_adj(vecs.numpy()[members], 16, rng)
    adj = torch.from_numpy(np.where(sub >= 0, members[np.maximum(sub, 0)], -1).astype(np.int32))
    pos_map = np.full(n, -1, np.int64)
    pos_map[members] = np.arange(len(members))
    pos_map = torch.from_numpy(pos_map)
    B = 24
    q = torch.from_numpy(rng.normal(size=(B, vecs.shape[1])).astype(np.float32))
    entries = torch.from_numpy(rng.choice(members, B))
    dt, it = tk.greedy_descent(q, entries, vecs, valid, adj, pos_map, metric=metric)
    want = [ref.greedy(q[b], int(entries[b]), vecs, valid, adj, pos_map, metric=metric)
            for b in range(B)]
    assert_matches_reference(dt[:, None], it[:, None], [[w[0]] for w in want],
                             [[w[1]] for w in want])


def engine(n=1500, d=16, seed=0, **cfg):
    """(index, its corpus, queries near it): a CPU store fed by the
    engine's write hook, three build rounds."""
    rng = np.random.default_rng(seed)
    vecs = blobs(n, d, rng, centers=20)
    store = VectorStore(dim=d, metric="euclidean", capacity=n, device="cpu")
    slots = store.add_batch([f"v{i}" for i in range(n)], vecs)
    idx = HNSWIndex(store, build_batch=512, ef_search=48, **cfg)
    idx.on_insert(slots, vecs)
    queries = (vecs[rng.integers(0, n, 48)] + 0.1 * rng.normal(size=(48, d))).astype(np.float32)
    return idx, vecs, queries


def device_graph(idx):
    """The engine's graph as the reference takes it: the upper layers top
    first, layer 0, the vectors and the valid mask."""
    layers, adj0, pos0 = idx._device_graph()
    view = idx.store.device_view()
    return layers, (adj0, pos0), view.vectors, view.valid


@pytest.mark.parametrize("visited", ["ring", "bitmap"])
def test_search_slots_matches_the_reference_search_on_its_graph(visited):
    idx, _, q = engine(visited=visited)
    assert idx.current_max_level >= 1
    k, ef = 10, idx.config.ef_search
    dist, slots = idx.search_slots(q, k)
    upper, layer0, vecs, valid = device_graph(idx)
    want = [ref.search(torch.from_numpy(q[b]), idx.entry_point, upper, layer0, vecs, valid,
                       metric="euclidean", ef=ef, k=k, visited=visited) for b in range(len(q))]
    assert_matches_reference(dist, slots, [w[0] for w in want], [w[1] for w in want])


def test_search_slots_against_the_exact_top_k():
    idx, vecs, q = engine(seed=3)
    k = 10
    dist, slots = idx.search_slots(q, k)
    ans = judge.Answers(np.arange(len(q)), slots, dist.astype(np.float64), np.zeros(len(q), bool))
    nums = judge.numbers(torch.from_numpy(vecs), torch.from_numpy(q), ans, k, "euclidean")
    assert nums["recall"] >= 0.95 and nums["bad_answers"] == 0
    assert nums["dist_gap_max"] < 1e-5  # f32 distances of the ids they name
    ids, _ = exact.topk(torch.from_numpy(vecs), torch.from_numpy(q), k, "euclidean")
    assert (slots[:, 0] == ids[:, 0].numpy()).mean() >= 0.95


def test_search_is_one_root_with_its_five_phases_in_order(tracer):
    idx, _, q = engine()
    tracer.clear()
    idx.search_slots(q, 10)
    spans = tracer.spans()
    (search,) = by_name(spans, "hnsw.search")
    assert search["n"] == len(q) and search["parent"] == -1
    phases = sorted((r for r in rows(spans) if r["name"] in PHASES), key=lambda r: r["start"])
    assert [r["name"] for r in phases] == PHASES
    assert all(r["parent"] == search["id"] and r["root"] == search["id"] for r in phases)
    assert search["start"] <= phases[0]["start"] and phases[-1]["end"] <= search["end"]
    assert all(a["end"] <= b["start"] for a, b in zip(phases, phases[1:]))
    assert not by_name(spans, "hnsw.exact")
    m = idx.get_detailed_metrics()["search"]
    beam, results = phases[2], phases[3]
    assert beam["n"] == m["beam_loops"] > 0 and results["n"] == m["beam_iters"] > 0
    assert m["descent_steps"] >= len(q) * idx.current_max_level  # >= 1 a query and layer
    assert m == dict(calls=1, queries=len(q), exact_route_calls=0, underfill_calls=0,
                     underfill_rows=0, beam_loops=beam["n"], beam_iters=results["n"],
                     descent_steps=m["descent_steps"])


def test_the_exact_scan_spans_carry_the_rows_it_answered(tracer, monkeypatch):
    idx, _, q = engine()
    tracer.clear()
    idx.search_slots(q[:5], 10, exact=True)
    spans = tracer.spans()
    (search,) = by_name(spans, "hnsw.search")
    (ex,) = by_name(spans, "hnsw.exact")
    assert ex["n"] == 5 and ex["parent"] == search["id"]
    assert [r["name"] for r in rows(spans)] == ["hnsw.copy_in", "hnsw.exact", "hnsw.search"]

    # two rows' beams come back short: the supplement answers them
    real = hnsw_mod.beam_search

    def short_beam(*args, **kw):
        bd, bi = real(*args, **kw)
        bd[:2, 3:], bi[:2, 3:] = MASKED_DIST, -1
        return bd, bi

    monkeypatch.setattr(hnsw_mod, "beam_search", short_beam)
    tracer.clear()
    dist, slots = idx.search_slots(q, 10)
    assert (slots >= 0).all()
    spans = tracer.spans()
    (finish,) = by_name(spans, "hnsw.finish")
    (ex,) = by_name(spans, "hnsw.exact")
    assert ex["n"] == 2 and ex["parent"] == finish["id"]
    m = idx.get_detailed_metrics()["search"]
    assert (m["calls"], m["exact_route_calls"], m["underfill_calls"], m["underfill_rows"]) == (
        2, 1, 1, 2)


def test_build_is_one_span_over_each_round_and_levels_stages(tracer):
    idx, _, _ = engine()
    spans = tracer.spans()
    (build,) = by_name(spans, "hnsw.build")
    assert build["n"] == 1500 and build["parent"] == -1
    stages = sorted((r for r in rows(spans) if r["name"] in STAGES), key=lambda r: r["start"])
    assert stages and len(stages) % 3 == 0
    assert [r["name"] for r in stages] == STAGES * (len(stages) // 3)
    assert all(r["parent"] == build["id"] for r in stages)
    assert all(a["end"] <= b["start"] for a, b in zip(stages, stages[1:]))
    assert build["start"] <= stages[0]["start"] and stages[-1]["end"] <= build["end"]
    # three rounds of 512, 512 and 476 rows: each ends on level 0 with all
    # of them (the first round is the bootstrap's exact k-NN graph)
    scans = [r["n"] for r in stages if r["name"] == "hnsw.build.scan"]
    assert [n for n in scans if n > 256] == [512, 512, 476]


def test_the_counters_and_results_are_those_of_the_programs_alone():
    """The useful-work counter is ``beam_search``'s ``iters`` summed, the
    descent's is ``descend``'s ``descent_steps`` summed, and the results
    are bit-identical to the descent and the beam run with no counter."""
    idx, _, q = engine(seed=5)
    k = 10
    dist, slots = idx.search_slots(q, k)
    upper, (adj0, pos0), vecs, valid = device_graph(idx)
    qd = torch.from_numpy(q)
    entries = torch.full((len(q),), idx.entry_point, dtype=torch.int64)
    for adj, pos in upper:
        _, entries = tk.greedy_descent(qd, entries, vecs, valid, adj, pos, metric="euclidean")
    kw = dict(metric="euclidean", ef=idx.config.ef_search,
              max_iters=int(1.5 * idx.config.ef_search) + 8, visited=idx.config.visited)
    bd, bi = tk.beam_search(qd, entries, vecs, valid, adj0, pos0, **kw)
    assert np.array_equal(dist, bd[:, :k].numpy()) and np.array_equal(slots, bi[:, :k].numpy())
    stats = {}
    tk.beam_search(qd, entries, vecs, valid, adj0, pos0, stats=stats, **kw)
    tk.descend(qd, torch.full((len(q),), idx.entry_point, dtype=torch.int64), vecs, valid, upper,
               metric="euclidean", stats=stats)
    m = idx.get_detailed_metrics()["search"]
    assert m["beam_iters"] == int(stats["iters"].sum()) and m["beam_loops"] == stats["loops"]
    assert m["descent_steps"] == int(stats["descent_steps"].sum()) > 0
