"""The port's HNSW programs (``quiver_tpu_torch/ops/hnsw_kernels.py``)
against the JAX package's (``quiver_tpu/ops/hnsw_kernels.py``) on the CPU.

The same numpy arrays, made from a seed, go through both functions:

* ``beam_search`` (ring and bitmap visited sets; expand 1 and 4; degree 32
  and the non-power-of-two 48, whose candidate block pads) over a k-NN
  graph with holes, tombstones and a permuted row map; ``greedy_descent``
  on an upper layer; ``select_neighbors`` with ``keep_pruned`` on and off:
  distances to rtol=1e-5, and ids equal except where the JAX distances of
  the swapped entries differ by under 1e-5 relative (the port merges with
  a stable sort where the reference runs bitonic networks, and sums in
  another order);
* ``beam_search`` on CPU tensors at every metric (bf16 products in one
  case) with the kernel library's build and load patched to raise: the
  plain version answers, the JAX package's answer within the same
  tolerances, no kernel launch counted (the kernel's own tests run on a
  card, in ``test_torch_cuda.py``);
* ``descend``'s step counter on a chain graph of integer distances (a
  walk of known length, an entry of -1, a query that never moves, the cap
  of 32 steps a layer), with no kernel touched on CPU tensors; and
  ``search_slots`` adding those steps to its ``descent_steps`` counter;
* ``connect_level`` on a batch whose reverse edges overflow full rows in
  several chunks and spill past ``e_budget``: the adjacency, fill counts,
  spill count and changed-row mask are equal. Its inputs have no
  near-ties: the test asserts that every two distances from one point to
  two others differ by more than 1e-5 relative, some hundred times f32's
  rounding of these distances (d=8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import hnsw_kernels as jk
from quiver_tpu_torch.ops import hnsw_kernels as tk
from quiver_tpu_torch.ops.scan import MASKED_DIST

REL = 1e-5


def assert_ids_agree(it, ij, dj, rel=REL):
    """ids equal position by position, except where the reference's row
    holds another entry within ``rel`` of the differing one's distance."""
    it, ij, dj = np.asarray(it), np.asarray(ij), np.asarray(dj, np.float64)
    assert it.shape == ij.shape
    for b, j in zip(*np.nonzero(it != ij)):
        gap = np.abs(dj[b] - dj[b, j])
        gap[j] = np.inf
        assert (gap <= rel * max(abs(dj[b, j]), 1e-30)).any(), (b, j, it[b], ij[b], dj[b])


def assert_dists_close(dt, dj):
    dt, dj = np.asarray(dt), np.asarray(dj)
    np.testing.assert_array_equal(dt >= MASKED_DIST, dj >= MASKED_DIST)
    live = dj < MASKED_DIST
    np.testing.assert_allclose(dt[live], dj[live], rtol=REL, atol=1e-6)


def knn_graph(vecs, deg, rng, *, holes=0.05):
    """The ``deg`` nearest other rows of each row (f64), a share of the
    entries knocked out to -1."""
    v = vecs.astype(np.float64)
    d2 = (v * v).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2 * v @ v.T
    np.fill_diagonal(d2, np.inf)
    adj = np.argsort(d2, axis=1, kind="stable")[:, :deg].astype(np.int32)
    adj[rng.random(adj.shape) < holes] = -1
    return adj


def graph_case(n=600, d=16, deg=32, seed=0, metric="euclidean"):
    """(vectors, valid, adj, pos_map) of a layer-0 graph: rows in a
    permuted order, 5% of the nodes tombstoned."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d))
    vecs = (centers[rng.integers(0, 12, n)] + 0.4 * rng.normal(size=(n, d))).astype(np.float32)
    adj_by_slot = knn_graph(vecs, deg, rng)
    perm = rng.permutation(n)  # row r holds slot perm[r]
    pos_map = np.empty(n, np.int32)
    pos_map[perm] = np.arange(n, dtype=np.int32)
    adj = adj_by_slot[perm]
    valid = rng.random(n) >= 0.05
    return vecs, valid, adj, pos_map, rng


def both(fn_j, fn_t, jargs, targs, **kw):
    out_j = fn_j(*[jnp.asarray(a) for a in jargs], **kw)
    out_t = fn_t(*[torch.from_numpy(np.ascontiguousarray(a)) for a in targs], **kw)
    return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]


@pytest.mark.parametrize("visited", ["ring", "bitmap"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("deg", [32, 48])
def test_beam_search_matches_jax(visited, expand, deg):
    vecs, valid, adj, pos_map, rng = graph_case(deg=deg, seed=deg + expand)
    B, ef = 24, 40
    q = (vecs[rng.integers(0, len(vecs), B)] + 0.3 * rng.normal(size=(B, vecs.shape[1]))
         ).astype(np.float32)
    entries = rng.integers(0, len(vecs), B).astype(np.int32)
    entries[0] = -1  # no entry: an empty answer
    entries[1] = int(np.flatnonzero(~valid)[0])  # a tombstoned entry: empty too
    kw = dict(metric="euclidean", ef=ef, max_iters=int(1.5 * ef) + 8, expand=expand,
              visited=visited)
    (dj, ij), (dt, it) = both(
        jk.beam_search, tk.beam_search,
        (q, entries, vecs, valid, adj, pos_map),
        (q, entries.astype(np.int64), vecs, valid, adj, pos_map.astype(np.int64)), **kw)
    assert dt.shape == (B, ef) and it.dtype == np.int64
    assert (it[:2] == -1).all() and (ij[:2] == -1).all()
    assert (np.diff(dt, axis=1) >= 0).all()
    assert_dists_close(dt, dj)
    assert_ids_agree(it, ij, dj)


@pytest.mark.parametrize("metric,visited,compute", [
    ("euclidean", "bitmap", "float32"), ("squared_euclidean", "ring", "float32"),
    ("dot_product", "ring", "float32"), ("cosine", "ring", "bfloat16"),
    ("manhattan", "ring", "float32"), ("cosine", "bitmap", "float32"),
])
def test_beam_search_on_cpu_never_touches_the_kernel(monkeypatch, metric, visited, compute):
    """CPU tensors run the plain version whatever the metric, visited set
    and compute dtype: the kernel library is neither built nor loaded (both
    patched to raise), no launch is counted, the answer is the JAX
    package's, and ``stats`` counts as the plain loop always has (each
    query's active iterations, the loop's iterations checked every
    BEAM_CHECK_EVERY), with each query's accepted candidates beside them
    (at most a block an active iteration)."""
    from quiver_tpu_torch import _build
    from quiver_tpu_torch.ops import hnsw_cuda

    def refuse(*_a, **_k):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    hnsw_cuda.reset_launch_counts()
    vecs, valid, adj, pos_map, rng = graph_case(seed=7, metric=metric)
    B, ef = 16, 32
    q = (vecs[rng.integers(0, len(vecs), B)] + 0.3 * rng.normal(size=(B, vecs.shape[1]))
         ).astype(np.float32)
    entries = rng.integers(0, len(vecs), B)
    entries[0] = -1
    kw = dict(metric=metric, ef=ef, max_iters=int(1.5 * ef) + 8, visited=visited)
    dj, ij = (np.asarray(x) for x in jk.beam_search(
        *[jnp.asarray(a) for a in (q, entries.astype(np.int32), vecs, valid, adj, pos_map)],
        compute_dtype=getattr(jnp, compute), **kw))
    stats = {}
    dt, it = tk.beam_search(
        *[torch.from_numpy(np.ascontiguousarray(a))
          for a in (q, entries, vecs, valid, adj, pos_map.astype(np.int64))],
        compute_dtype=getattr(torch, compute), stats=stats, **kw)
    assert hnsw_cuda.launch_counts["hnsw_beam"] == 0
    assert (it[0] == -1).all() and (np.diff(dt.numpy(), axis=1) >= 0).all()
    assert_dists_close(dt, dj)
    assert_ids_agree(it, ij, dj)
    loops, iters = stats["loops"], stats["iters"]
    assert iters.shape == (B,) and iters.dtype == torch.int64 and int(iters[0]) == 0
    assert int(iters.max()) < loops <= kw["max_iters"]
    assert loops % tk.BEAM_CHECK_EVERY == 0 or loops == kw["max_iters"]
    accepted, block = stats["accepted"], tk.beam_sizes(ef, adj.shape[1], 4)[0]
    assert accepted.shape == (B,) and int(accepted[0]) == 0 and int(accepted.max()) > 0
    assert bool((accepted <= iters * block).all())


def test_beam_search_chunks_and_stats_do_not_change_results(monkeypatch):
    """Row chunks and the done test every few iterations give the answer of
    one chunk tested every iteration; ``stats`` counts each query's active
    iterations."""
    vecs, valid, adj, pos_map, rng = graph_case(seed=3)
    B, ef = 20, 32
    q = torch.from_numpy(vecs[:B] + 0.2)
    args = (q, torch.from_numpy(rng.integers(0, 600, B)), torch.from_numpy(vecs),
            torch.from_numpy(valid), torch.from_numpy(adj), torch.from_numpy(pos_map.astype(np.int64)))
    kw = dict(metric="euclidean", ef=ef, max_iters=56)
    stats = {}
    monkeypatch.setattr(tk, "BEAM_CHECK_EVERY", 1)
    d1, i1 = tk.beam_search(*args, stats=stats, **kw)
    monkeypatch.setattr(tk, "BEAM_CHECK_EVERY", 16)
    block, _, beam_len, ring_len = tk.beam_sizes(ef, adj.shape[1], 4)
    monkeypatch.setattr(tk, "BEAM_CHUNK_BYTES", 7 * block * (4 * 16 + ring_len + beam_len + block))
    d2, i2 = tk.beam_search(*args, **kw)  # chunks of 7 rows
    torch.testing.assert_close(d2, d1, rtol=0, atol=0)
    assert torch.equal(i2, i1)
    assert stats["iters"].shape == (B,) and 0 < int(stats["iters"].max()) <= stats["loops"] <= 56


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_greedy_descent_matches_jax(metric):
    vecs, valid, _, _, rng = graph_case(seed=11)
    n = len(vecs)
    members = np.sort(rng.choice(n, 150, replace=False)).astype(np.int32)
    sub = knn_graph(vecs[members], 16, rng)
    adj = np.where(sub >= 0, members[np.maximum(sub, 0)], -1).astype(np.int32)
    pos_map = np.full(n, -1, np.int32)
    pos_map[members] = np.arange(len(members), dtype=np.int32)
    B = 32
    q = rng.normal(size=(B, vecs.shape[1])).astype(np.float32)
    entries = np.full(B, members[valid[members]][0], np.int32)
    (dj, ij), (dt, it) = both(
        jk.greedy_descent, tk.greedy_descent,
        (q, entries, vecs, valid, adj, pos_map),
        (q, entries.astype(np.int64), vecs, valid, adj, pos_map.astype(np.int64)),
        metric=metric)
    np.testing.assert_allclose(dt, dj, rtol=REL)
    assert_ids_agree(it[:, None], ij[:, None], dj[:, None])
    assert (it >= 0).all()


def chain_layers(n=100):
    """Nodes 0..n-1 on a line (node i at (i, 0)) and two layers, each an
    (adj, pos_map) pair: ``"tens"`` holds the multiples of 10, each linked
    to the next one up and down the line; ``"ones"`` holds every node,
    linked to i + 1 and i - 1. Every distance is an exact integer."""
    vecs = np.zeros((n, 2), np.float32)
    vecs[:, 0] = np.arange(n)

    def layer(step):
        members = np.arange(0, n, step)
        adj = np.stack([members + step, members - step], 1)
        adj[(adj < 0) | (adj >= n)] = -1
        pos_map = np.full(n, -1, np.int64)
        pos_map[members] = np.arange(len(members))
        return torch.from_numpy(adj.astype(np.int32)), torch.from_numpy(pos_map)

    return torch.from_numpy(vecs), {"tens": layer(10), "ones": layer(1)}


#: (query's place on the line, entry, layers top first, the steps, the
#: layer-0 entry). A step counts where the query began it still moving,
#: the one that found no better neighbour included: 0 -> 40 is 4 moves and
#: a step, 40 -> 37 3 moves and a step
DESCENT_CHAINS = {
    "a walk of known length": (37, 0, ("tens", "ones"), 5 + 4, 37),
    "an entry of -1 walks from slot 0's row": (37, -1, ("tens", "ones"), 5 + 4, 37),
    "a query that never moves counts 1 a layer": (0, 0, ("tens", "ones"), 1 + 1, 0),
    "the cap of 32 steps a layer": (99, 0, ("ones", "ones"), 32 + 32, 64),
}


@pytest.mark.parametrize("case", list(DESCENT_CHAINS))
def test_descend_counts_each_querys_steps(monkeypatch, case):
    """``descend(stats=)`` on the chain: each query's steps summed over the
    layers, the same ids as without a counter, and no kernel touched on
    CPU tensors (the library's build and load patched to raise)."""
    from quiver_tpu_torch import _build
    from quiver_tpu_torch.ops import hnsw_cuda

    def refuse(*_a, **_k):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    hnsw_cuda.reset_launch_counts()
    x, entry, names, want_steps, want_id = DESCENT_CHAINS[case]
    vecs, layers = chain_layers()
    q = torch.tensor([[float(x), 0.0]] * 2)
    entries = torch.tensor([entry, entry])
    valid = torch.ones(len(vecs), dtype=torch.bool)
    chain = [layers[name] for name in names]
    stats = {}
    got = tk.descend(q, entries, vecs, valid, chain, metric="euclidean", stats=stats)
    assert got.tolist() == [want_id] * 2
    assert stats["descent_steps"].dtype == torch.int64
    assert stats["descent_steps"].tolist() == [want_steps] * 2
    assert torch.equal(tk.descend(q, entries, vecs, valid, chain, metric="euclidean"), got)
    assert hnsw_cuda.launch_counts["hnsw_descent"] == 0


def test_search_slots_adds_the_descents_steps_to_its_counter():
    """Each ``search_slots`` adds the steps of its descent (``descend``'s
    counter over the same queries and graph, summed) to
    ``get_detailed_metrics()["search"]["descent_steps"]``."""
    from quiver_tpu_torch.core.store import VectorStore
    from quiver_tpu_torch.index.hnsw import HNSWIndex

    vecs, _, _, _, rng = graph_case(n=1200, seed=13)
    store = VectorStore(dim=vecs.shape[1], metric="euclidean", capacity=len(vecs), device="cpu")
    idx = HNSWIndex(store, build_batch=512, ef_search=32)
    idx.on_insert(store.add_batch([f"v{i}" for i in range(len(vecs))], vecs), vecs)
    assert idx.current_max_level >= 1
    view = idx.store.device_view()
    layers, _, _ = idx._device_graph()
    total = 0
    for seed in (1, 2):
        q = (vecs[rng.integers(0, len(vecs), 24)] + 0.2 * rng.normal(size=(24, vecs.shape[1]))
             ).astype(np.float32)
        stats = {}
        tk.descend(torch.from_numpy(q), torch.full((24,), idx.entry_point), view.vectors,
                   view.valid, layers, metric="euclidean", stats=stats)
        steps = int(stats["descent_steps"].sum())
        assert steps >= 24 * len(layers)  # at least one step a query and layer
        idx.search_slots(q, 10)
        total += steps
        assert idx.get_detailed_metrics()["search"]["descent_steps"] == total


@pytest.mark.parametrize("keep_pruned", [True, False])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_select_neighbors_matches_jax(keep_pruned, metric):
    rng = np.random.default_rng(5)
    n, d, B, C, m = 300, 16, 24, 40, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cand = np.stack([rng.choice(n, C, replace=False) for _ in range(B)]).astype(np.int32)
    cand[rng.random(cand.shape) < 0.1] = -1
    dist = np.asarray(jk._batched_distance(jnp.asarray(q), jnp.asarray(vecs[np.maximum(cand, 0)]),
                                           metric, jnp.float32))
    dist = np.where(cand >= 0, dist, MASKED_DIST).astype(np.float32)
    dist_t = tk._batched_distance(torch.from_numpy(q), torch.from_numpy(vecs[np.maximum(cand, 0)]),
                                  metric).numpy()
    np.testing.assert_allclose(np.where(cand >= 0, dist_t, MASKED_DIST), dist, rtol=REL)
    kw = dict(metric=metric, m=m, keep_pruned=keep_pruned)
    (ij, dj), (it, dt) = both(jk.select_neighbors, tk.select_neighbors,
                              (q, cand, dist, vecs), (q, cand.astype(np.int64), dist, vecs), **kw)
    assert it.shape == (B, m)
    assert_dists_close(dt, dj)
    assert_ids_agree(it, ij, dj)
    full = (it >= 0).sum(1)
    assert (full == m).all() if keep_pruned else (full <= m).all()


def min_relative_gap(vecs):
    """The smallest relative difference between two distances from one row
    to two others (f64): every comparison ``connect_level`` makes is one."""
    v = vecs.astype(np.float64)
    d = np.sqrt(np.maximum((v * v).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2 * v @ v.T, 0))
    worst = np.inf
    for r in range(len(v)):
        row = np.sort(np.delete(d[r], r))
        worst = min(worst, float(np.min(np.diff(row) / row[1:])))
    return worst


def draw_without_near_ties(rng, n, d, rel):
    """``n`` normal rows, each new draw kept only if every distance it adds
    is more than ``rel`` (relative) from every other distance of the two
    rows it joins."""
    rows = []
    while len(rows) < n:
        x = rng.normal(size=d)
        if rows:
            v = np.asarray(rows)
            dx = np.sqrt(((v - x) ** 2).sum(1))
            if len(rows) > 1 and np.min(np.diff(np.sort(dx)) / np.sort(dx)[1:]) <= rel:
                continue
            d_old = np.sqrt(((v[:, None, :] - v[None, :, :]) ** 2).sum(-1))
            np.fill_diagonal(d_old, np.nan)
            if (np.abs(d_old - dx[:, None]) <= rel * dx[:, None]).any():
                continue
        rows.append(x)
    return np.asarray(rows, np.float32)


def test_connect_level_matches_jax_exactly():
    """Forward rows, reverse edges into rows with room, overflow rows in
    several ``u_budget`` chunks, spills past ``e_budget``: the same
    adjacency, fill, spill and changed rows."""
    rng = np.random.default_rng(2)
    n, d, deg = 110, 8, 8
    vecs = draw_without_near_ties(rng, n, d, 2 * REL)
    assert min_relative_gap(vecs) > REL
    old, new = np.arange(80), np.arange(80, 110)
    rows_cap = 128
    perm = rng.permutation(n)  # rows in a permuted order
    pos_map = np.full(n, -1, np.int32)
    pos_map[perm] = np.arange(n, dtype=np.int32)
    adj = np.full((rows_cap, deg), -1, np.int32)
    fill = np.zeros(rows_cap, np.int32)
    nn = knn_graph(vecs[old], deg, rng, holes=0.0)
    for s in old:  # most rows full; a few with room
        k = deg if s % 5 else 5
        adj[pos_map[s], :k] = old[nn[s, :k]]
        fill[pos_map[s]] = k
    # the new nodes select among their nearest old nodes (no mutual pairs:
    # test_connect_level_never_repeats_an_id holds those)
    v = vecs.astype(np.float64)
    d2 = ((v[new][:, None, :] - v[None, old, :]) ** 2).sum(-1)
    sel = old[np.argsort(d2, axis=1, kind="stable")[:, :deg]].astype(np.int32)
    sel[rng.random(sel.shape) < 0.1] = -1
    slots = new.astype(np.int32).copy()
    slots[-1] = -1  # a pad row
    connect = np.ones(len(new), bool)
    connect[3] = False
    kw = dict(metric="euclidean", u_budget=8, e_budget=2)
    adj_in, fill_in = adj.copy(), fill.copy()
    aj, fj, sj = jk.connect_level(
        jnp.asarray(adj), jnp.asarray(fill), jnp.asarray(pos_map), jnp.asarray(vecs),
        jnp.asarray(slots), jnp.asarray(connect), jnp.asarray(sel), **kw)
    at, ft, st, ct = tk.connect_level(
        torch.from_numpy(adj), torch.from_numpy(fill), torch.from_numpy(pos_map.astype(np.int64)),
        torch.from_numpy(vecs), torch.from_numpy(slots.astype(np.int64)),
        torch.from_numpy(connect), torch.from_numpy(sel.astype(np.int64)), **kw)
    aj, fj, sj = np.asarray(aj), np.asarray(fj), int(sj)
    assert sj > 0, "the case must spill"
    overflowed = (aj != adj).any(1) & (fill == deg)
    assert overflowed.sum() > 2 * kw["u_budget"], "the case must fill several chunks"
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_array_equal(ft.numpy(), fj)
    assert int(st) == sj
    np.testing.assert_array_equal(ct.numpy(), (aj != adj).any(1))
    # the inputs (shared with the tensors passed) were not written
    np.testing.assert_array_equal(adj, adj_in)
    np.testing.assert_array_equal(fill, fill_in)


def test_connect_level_never_repeats_an_id():
    """Two new nodes that select each other into rows with room: the
    reference appends each one's reverse edge into the other's row, which
    already holds it (an id twice in a row); the port drops that edge."""
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(12, 4)).astype(np.float32)
    deg, rows_cap = 6, 16
    pos_map = np.arange(12, dtype=np.int32)
    adj = np.full((rows_cap, deg), -1, np.int32)
    fill = np.zeros(rows_cap, np.int32)
    adj[:10, :2] = (np.arange(10)[:, None] + [1, 2]) % 10  # old rows with room
    fill[:10] = 2
    slots = np.array([10, 11], np.int32)
    sel = np.array([[11, 0, -1, -1, -1, -1], [10, 1, -1, -1, -1, -1]], np.int32)
    kw = dict(metric="euclidean", u_budget=8, e_budget=4)
    aj, fj, _ = jk.connect_level(jnp.asarray(adj), jnp.asarray(fill), jnp.asarray(pos_map),
                                 jnp.asarray(vecs), jnp.asarray(slots),
                                 jnp.ones(2, bool), jnp.asarray(sel), **kw)
    at, ft, _, _ = tk.connect_level(torch.from_numpy(adj), torch.from_numpy(fill),
                                    torch.from_numpy(pos_map.astype(np.int64)),
                                    torch.from_numpy(vecs), torch.from_numpy(slots.astype(np.int64)),
                                    torch.ones(2, dtype=torch.bool),
                                    torch.from_numpy(sel.astype(np.int64)), **kw)
    aj, at = np.asarray(aj), at.numpy()
    assert list(aj[10, :3]) == [11, 0, 11] and list(aj[11, :3]) == [10, 1, 10]  # the fault
    assert list(at[10, :3]) == [11, 0, -1] and list(at[11, :3]) == [10, 1, -1]
    np.testing.assert_array_equal(ft.numpy()[10:12], [2, 2])
    # the old rows' reverse edges land as in the reference
    np.testing.assert_array_equal(at[:10], aj[:10])
    np.testing.assert_array_equal(ft.numpy()[:10], np.asarray(fj)[:10])
