"""The port's HNSW engine (``quiver_tpu_torch/index/hnsw.py``) on the CPU.

Part one runs the scenarios of tests/test_hnsw.py against the port: recall
against the exact scan, the bitmap visited set, deletes and the
entry-point re-election, reproducible builds, incremental inserts, the
exact delegation (small stores, masks), the negative rerank, updates, the
row space that churn grows and compaction shrinks, and the topology import
into an index that already served. Their sizes stay at n <= 800 (the
reference runs two of them at 1,200 and 3,000 rows).

Part two holds the port to the JAX package on the same seeded rows:

* the same graph (the JAX build's ``export_topology()`` imported into the
  port): searches at ef in {50, 100} return the same ids, except where the
  JAX distances of swapped entries differ by under 1e-5 relative, and the
  distances agree to rtol=1e-5;
* the same seed (n=600, d=32, ``build_batch=256``): both packages give
  every node the same level and pick the same entry point, at least 95% of
  the adjacency rows of all layers are identical (the port's construction
  scan is exact where the reference's is ``approx_max_k``, which is exact
  on the CPU; f32 summation order and the reference's repeated ids in
  small upper layers, which the port does not copy, separate them), and
  the port's recall@10 is within 0.02 of the reference's;
* the mutated-row feed a mirror drains after an insert batch names the
  same rows in both.
"""

import numpy as np
import pytest
import torch

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.index.hnsw import HNSWIndex as JHNSW
from quiver_tpu_torch.convert import hnsw_from_topology
from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index import make_engine, resolve_engine_config
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex

from tests.test_torch_hnsw_kernels import assert_ids_agree

D = 32


def build(n=600, d=D, metric="euclidean", seed=0, **cfg):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store = VectorStore(dim=d, metric=metric, device="cpu")
    cfg.setdefault("build_batch", 256)
    idx = HNSWIndex(store, **cfg)
    slots = store.add_batch([f"v{i}" for i in range(n)], vecs)
    idx.on_insert(slots, vecs)
    return store, idx, vecs


def recall_at_k(idx, exact, queries, k=10):
    _, approx = idx.search_slots(queries, k)
    _, truth = exact.search_slots(queries, k)
    return float(np.mean([len(set(approx[b]) & set(truth[b])) / k for b in range(len(queries))]))


# ------------------------------------------- the scenarios of test_hnsw.py


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_recall_against_oracle(metric):
    store, idx, vecs = build(metric=metric)
    queries = np.random.default_rng(1).normal(size=(16, D)).astype(np.float32)
    r = recall_at_k(idx, ExactIndex(store), queries)
    assert r >= 0.9, f"recall {r} too low for {metric}"


def test_visited_bitmap_mode():
    store, idx, vecs = build(n=800)
    exact = ExactIndex(store)
    queries = np.random.default_rng(2).normal(size=(16, D)).astype(np.float32)
    r_ring = recall_at_k(idx, exact, queries)
    idx.set_optimization_parameters(visited="bitmap")
    assert idx.get_optimization_parameters()["visited"] == "bitmap"
    r_bitmap = recall_at_k(idx, exact, queries)
    assert r_bitmap >= 0.9 and r_bitmap >= r_ring - 0.05
    d, i = idx.search_slots(vecs[:8], k=5)
    assert (i[:, 0] == np.arange(8)).all()
    live = d[0][i[0] >= 0]
    assert (np.diff(live) >= -1e-6).all()
    with pytest.raises(ValueError):
        idx.set_optimization_parameters(visited="nope")


def test_insert_then_search_self_recall():
    store, idx, vecs = build(n=300)
    _, slots = idx.search_slots(vecs[:50], k=1)
    assert sum(store.id_of(int(slots[i, 0])) == f"v{i}" for i in range(50)) >= 48


def test_results_sorted_and_k_capped():
    store, idx, _ = build(n=100)
    q = np.random.default_rng(2).normal(size=(1, D)).astype(np.float32)
    dist, slots = idx.search_slots(q, k=150)
    live = dist[0][slots[0] >= 0]
    assert np.all(np.diff(live) >= -1e-5)
    assert (slots[0] >= 0).sum() == 100


def test_delete_removes_from_results():
    store, idx, vecs = build(n=200)
    target = [store.slot_of(f"v{i}") for i in range(5)]
    store.delete_batch([f"v{i}" for i in range(5)])
    idx.on_delete(np.asarray(target))
    _, slots = idx.search_slots(vecs[:5], k=10)
    for b in range(5):
        ids = {store.id_of(int(s)) for s in slots[b] if s >= 0}
        assert f"v{b}" not in ids and len(ids) == 10


def test_delete_entry_point_reelects():
    store, idx, vecs = build(n=150)
    ep = idx.entry_point
    store.delete(store.id_of(ep))
    idx.on_delete(np.asarray([ep]))
    assert idx.entry_point != ep
    _, slots = idx.search_slots(vecs[:3], k=5)
    assert (slots >= 0).all()


def test_delete_all_then_search():
    store, idx, vecs = build(n=120)
    all_slots = [store.slot_of(f"v{i}") for i in range(120)]
    store.delete_batch([f"v{i}" for i in range(120)])
    idx.on_delete(np.asarray(all_slots))
    _, slots = idx.search_slots(vecs[:2], k=5)
    assert (slots < 0).all()


def test_reproducible_builds():
    _, idx1, _ = build(n=200, seed=3)
    _, idx2, _ = build(n=200, seed=3)
    np.testing.assert_array_equal(idx1.layer0.adj, idx2.layer0.adj)
    assert idx1.entry_point == idx2.entry_point
    assert idx1.current_max_level == idx2.current_max_level


def test_incremental_inserts_match_quality():
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(500, D)).astype(np.float32)
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    idx = HNSWIndex(store, build_batch=128)
    for i in range(0, 500, 100):
        slots = store.add_batch([f"v{j}" for j in range(i, i + 100)], vecs[i:i + 100])
        idx.on_insert(slots, vecs[i:i + 100])
    queries = rng.normal(size=(16, D)).astype(np.float32)
    assert recall_at_k(idx, ExactIndex(store), queries) >= 0.85


def test_small_graph_delegates_to_exact():
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    idx = HNSWIndex(store)
    vecs = np.random.default_rng(0).normal(size=(10, D)).astype(np.float32)
    idx.on_insert(store.add_batch([f"v{i}" for i in range(10)], vecs), vecs)
    _, got = idx.search_slots(vecs[:3], k=3)
    _, want = ExactIndex(store).search_slots(vecs[:3], k=3)
    np.testing.assert_array_equal(got, want)


def test_mask_delegates_to_exact():
    store, idx, vecs = build(n=100)
    mask = np.zeros(store.capacity, bool)
    mask[[store.slot_of(f"v{i}") for i in (3, 7, 11)]] = True
    _, slots = idx.search_slots(vecs[:2], k=5, mask=mask)
    for b in range(2):
        assert {store.id_of(int(s)) for s in slots[b] if s >= 0} == {"v3", "v7", "v11"}


def test_negative_example_on_graph():
    store, idx, vecs = build(n=200)
    _, slots = idx.search_slots(vecs[:2], k=5, negative=vecs[1][None].repeat(2, 0),
                                negative_weight=2.0)
    assert (slots >= 0).all()


def test_update_reinserts():
    store, idx, vecs = build(n=150)
    slot = store.slot_of("v7")
    newv = np.full(D, 42.0, np.float32)
    store.update_batch(["v7"], [newv])
    idx.on_update(np.asarray([slot]), newv[None])
    _, slots = idx.search_slots(newv[None], k=1)
    assert store.id_of(int(slots[0, 0])) == "v7"


def test_config_defaults_match_reference():
    c = HNSWConfig()
    assert (c.m, c.m0, c.ef_construction, c.ef_search, c.max_level) == (16, 32, 200, 100, 16)


def test_select_neighbors_keep_pruned_fills_degree():
    """keep_pruned back-fills occluded candidates: diversity decides the
    order, not the edge count."""
    from quiver_tpu_torch.ops.hnsw_kernels import select_neighbors

    rng = np.random.default_rng(0)
    d = 8
    clump = 0.01 * rng.normal(size=(6, d)).astype(np.float32)
    far = np.stack([np.full(d, 5.0), np.full(d, -5.0)]).astype(np.float32)
    vectors = torch.from_numpy(np.concatenate([clump, far]).astype(np.float32))
    q = torch.zeros((1, d))
    ids = torch.arange(8)[None, :]
    dist = torch.linalg.norm(vectors - q[0], dim=1)[None, :]
    kept_i, kept_d = select_neighbors(q, ids, dist, vectors, metric="euclidean", m=6,
                                      keep_pruned=True)
    pruned_i, _ = select_neighbors(q, ids, dist, vectors, metric="euclidean", m=6,
                                   keep_pruned=False)
    n_kept, n_pruned = int((kept_i[0] >= 0).sum()), int((pruned_i[0] >= 0).sum())
    assert n_kept == 6 and n_pruned < n_kept
    lead = set(pruned_i[0][pruned_i[0] >= 0].tolist())
    assert lead <= set(kept_i[0].tolist())
    true_d = torch.linalg.norm(vectors[kept_i[0]] - q[0], dim=1)
    torch.testing.assert_close(kept_d[0], true_d, rtol=1e-5, atol=1e-5)


def test_ef_changes_beam_behavior():
    """A larger ef explores at least as much."""
    store, idx, vecs = build(n=800, seed=3)
    q = (vecs[:64] + 0.15 * np.random.default_rng(9).normal(size=(64, D))).astype(np.float32)
    _, truth = ExactIndex(store).search_slots(q, 10)
    recs = []
    for ef in (16, 64, 256):
        idx.set_optimization_parameters(ef_search=ef)
        _, got = idx.search_slots(q, 10)
        recs.append(np.mean([len(set(got[b]) & set(truth[b])) / 10 for b in range(64)]))
    assert recs[-1] >= recs[0] - 1e-9 and recs[-1] >= 0.9


def churn(idx, store, rng, ids, cur, rounds, size):
    for _ in range(rounds):
        pick = rng.choice(len(ids), size=size, replace=False)
        fresh = rng.normal(size=(size, D)).astype(np.float32)
        sl = np.asarray([store.slot_of(ids[p]) for p in pick])
        store.update_batch([ids[p] for p in pick], fresh)
        idx.on_update(sl, fresh)
        cur[pick] = fresh
        yield


def test_update_churn_grows_row_space_past_capacity():
    rng = np.random.default_rng(3)
    n = 600
    store = VectorStore(dim=D, metric="euclidean", capacity=n, device="cpu")  # -> 1024
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    idx = HNSWIndex(store, build_batch=256)
    idx.on_insert(store.add_batch([f"v{i}" for i in range(n)], vecs), vecs)
    ids = [f"v{i}" for i in range(n)]
    cur = vecs.copy()
    for _ in churn(idx, store, rng, ids, cur, 4, 128):
        pass
    assert len(idx.layer0.nodes) > store.capacity
    _, got = idx.search_slots(cur, k=1)
    assert (got[:, 0] == np.asarray([store.slot_of(i) for i in ids])).mean() >= 0.95


def test_import_topology_into_used_index_refreshes_pos():
    store1, idx1, vecs = build(n=300)
    data = idx1.export_topology()
    n = 300
    store2 = VectorStore(dim=D, metric="euclidean", device="cpu")
    order = np.arange(n)[::-1]
    slots2 = store2.add_batch([f"v{i}" for i in order], vecs[order])
    idx2 = HNSWIndex(store2, build_batch=256)
    idx2.on_insert(slots2, vecs[order])
    idx2.search_slots(vecs[:8], k=5)  # device caches in use
    remap = np.full(store1.capacity, -1, np.int64)
    for i in range(n):
        remap[store1.slot_of(f"v{i}")] = store2.slot_of(f"v{i}")
    idx2.import_topology(data, remap)
    _, got = idx2.search_slots(vecs[:64], k=1)
    assert (got[:, 0] == np.asarray([store2.slot_of(f"v{i}") for i in range(64)])).mean() >= 0.95


def test_churn_compaction_rebuilds_row_space():
    rng = np.random.default_rng(5)
    n = 600
    store = VectorStore(dim=D, metric="euclidean", capacity=n, device="cpu")
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    idx = HNSWIndex(store, build_batch=512, compact_growth=3.0)
    idx.on_insert(store.add_batch([f"v{i}" for i in range(n)], vecs), vecs)
    ids = [f"v{i}" for i in range(n)]
    cur = vecs.copy()
    for _ in churn(idx, store, rng, ids, cur, 8, 512):
        if idx.get_detailed_metrics()["compactions"]:
            break
    assert idx.get_detailed_metrics()["compactions"] >= 1
    assert len(idx.layer0.nodes) <= 3.0 * n
    _, got = idx.search_slots(cur[:256], k=1)
    assert (got[:, 0] == np.asarray([store.slot_of(i) for i in ids[:256]])).mean() >= 0.95


# --------------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def jax_built():
    """A JAX-package build and the same rows in a port store (same slots)."""
    n = 600
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    js = JStore(dim=D, metric="euclidean")
    jx = JHNSW(js, build_batch=256)
    slots = js.add_batch(ids, vecs)
    jx.on_insert(slots, vecs)
    ts = VectorStore(dim=D, metric="euclidean", device="cpu")
    np.testing.assert_array_equal(ts.add_batch(ids, vecs), slots)
    queries = (vecs[rng.integers(0, n, 32)] + 0.3 * rng.normal(size=(32, D))).astype(np.float32)
    return js, jx, ts, vecs, slots, queries


@pytest.mark.parametrize("ef", [50, 100])
def test_same_graph_searches_match_jax(jax_built, ef):
    """The JAX graph imported into the port: the same ids and distances."""
    _, jx, ts, _, _, queries = jax_built
    tx = hnsw_from_topology(ts, jx.export_topology(), build_batch=256, ef_search=ef)
    assert tx.entry_point == jx.entry_point and tx.current_max_level == jx.current_max_level
    np.testing.assert_array_equal(tx.layer0.adj, jx.layer0.adj)
    jx.set_optimization_parameters(ef_search=ef)
    dj, ij = jx.search_slots(queries, 10)
    dt, it = tx.search_slots(queries, 10)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    assert_ids_agree(it, ij, dj)


def test_same_seed_builds_match_jax(jax_built):
    js, jx, ts, vecs, slots, queries = jax_built
    tx = HNSWIndex(ts, build_batch=256)
    tx.on_insert(slots, vecs)
    np.testing.assert_array_equal(tx.node_level, jx.node_level)
    assert tx.entry_point == jx.entry_point and tx.current_max_level == jx.current_max_level
    assert len(tx.layers) == len(jx.layers)
    same = rows = 0
    for lt, lj in zip([tx.layer0] + tx.layers, [jx.layer0] + jx.layers):
        np.testing.assert_array_equal(lt.nodes, lj.nodes)
        same += int((lt.adj == lj.adj).all(axis=1).sum())
        rows += len(lt.nodes)
    assert same >= 0.95 * rows, (same, rows)
    jx.set_optimization_parameters(ef_search=100)
    exact = ExactIndex(ts)
    r_t, r_j = recall_at_k(tx, exact, queries), recall_at_k(jx, exact, queries)
    assert r_t >= r_j - 0.02, (r_t, r_j)


def test_dirty_rows_after_an_insert_batch_match_jax():
    """A mirror that drains after one more insert batch sees the same
    mutated rows in both packages (forward rows and the rows reverse edges
    rewrote)."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(400, D)).astype(np.float32)
    ids = [f"v{i}" for i in range(400)]
    drained = []
    for Store, Index, kw in ((JStore, JHNSW, {}), (VectorStore, HNSWIndex, {"device": "cpu"})):
        store = Store(dim=D, metric="euclidean", **kw)
        idx = Index(store, build_batch=256)
        idx.on_insert(store.add_batch(ids[:256], vecs[:256]), vecs[:256])
        assert idx.layer0.drain_dirty_rows() is None  # first drain: full mirror
        idx.on_insert(store.add_batch(ids[256:], vecs[256:]), vecs[256:])
        drained.append(idx.layer0.drain_dirty_rows())
    np.testing.assert_array_equal(drained[1], drained[0])
    assert len(drained[1]) > 144  # the new rows and old rows their edges reached


def test_registry_and_config_resolution():
    """``make_engine("hnsw")`` builds the engine; the ``hnsw`` namespace
    resolves to its config, for the engine and for a hybrid."""
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    cfg = resolve_engine_config("hnsw", {"hnsw": {"m": 8, "ef_search": 32}})
    eng = make_engine("hnsw", store, **cfg)
    assert isinstance(eng, HNSWIndex) and eng.config.m == 8 and eng.config.ef_search == 32
    out = resolve_engine_config("hybrid", {"hnsw": {"m0": 48}})
    assert out["ann_backend"] == "hnsw" and out["hnsw_config"].m0 == 48
    with pytest.raises(ValueError):
        resolve_engine_config("hnsw", {"bogus": 1})
    assert make_engine("sharded_hnsw", store, mesh=2).name == "sharded_hnsw"


def test_device_bytes_count_the_adjacency():
    store, idx, _ = build(n=300)
    idx.search_slots(np.zeros((1, D), np.float32), 5)
    own = idx.device_bytes()["engine"]
    adj = sum(l._adj_dev.untyped_storage().nbytes() for l in [idx.layer0] + idx.layers)
    assert own >= adj > 0
    assert idx.get_detailed_metrics()["device_bytes"]["engine"] == own
