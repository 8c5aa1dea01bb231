"""The port's sharded exact and HNSW engines (``quiver_tpu_torch/parallel/``)
at 8 shards on the CPU, held to the JAX package on the 8-device CPU mesh
that ``tests/conftest.py`` provides, with the scenarios of
tests/test_sharded.py.

The same seeded numpy rows go into both packages' stores (same slots).

* Exact: the port's 8 shards return the ids of the reference's 8-device
  mesh (and of the port's single-device ``ExactIndex``) up to swaps of
  entries whose distances differ by under 1e-5 relative, and distances
  within 1e-5 relative.
* HNSW: as in tests/test_torch_hnsw.py, one graph in both packages (the
  port's sidecar imported by the JAX engine, whose own 8-device build
  takes ~30 s here), searched by both: ids agree up to swaps within 1e-5
  relative, distances to rtol 1e-5. The port's batched search over the
  concatenated subgraphs equals its one-call-per-shard search exactly.

Test names differ from the reference's: ``tests/conftest.py`` marks slow
by base name.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.parallel.sharded import ShardedExactIndex as JShardedExact
from quiver_tpu.parallel.sharded import make_mesh as jmake_mesh
from quiver_tpu.parallel.sharded_graph import ShardedHNSWIndex as JShardedHNSW
from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index import make_engine, resolve_engine_config
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.parallel.sharded import (
    ShardedExactIndex,
    make_mesh,
    merge_topk,
    resolve_mesh,
    sharded_exact_of,
)
from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex

from tests.test_torch_hnsw_kernels import assert_dists_close, assert_ids_agree
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 24
N_SHARDS = 8


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return jmake_mesh(8)


def stores(n=3000, metric="cosine", seed=0):
    """(port store, JAX store, rows): the same rows in both, same slots."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    st = VectorStore(dim=D, metric=metric, device="cpu")
    js = JStore(dim=D, metric=metric)
    assert np.array_equal(st.add_batch(ids, vecs), js.add_batch(ids, vecs))
    return st, js, vecs


def agree(got, want):
    (dt, it), (dj, ij) = got, want
    assert_ids_agree(it, ij, dj)
    assert_dists_close(dt, dj)


# ------------------------------------------------------------------ exact


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product", "manhattan"])
def test_port_sharded_exact_equals_reference_mesh(jmesh, metric):
    st, js, _ = stores(metric=metric)
    q = np.random.default_rng(1).normal(size=(6, D)).astype(np.float32)
    got = ShardedExactIndex(st, N_SHARDS).search_slots(q, k=10)
    agree(got, JShardedExact(js, jmesh).search_slots(q, k=10))
    agree(got, ExactIndex(st).search_slots(q, k=10))


def test_port_sharded_exact_mask_across_shards(jmesh):
    st, js, vecs = stores()
    allowed = [st.slot_of(f"v{i}") for i in (5, 900, 2500)]  # three shards
    mask = np.zeros(st.capacity, bool)
    mask[allowed] = True
    dt, it = ShardedExactIndex(st, N_SHARDS).search_slots(vecs[:2], k=10, mask=mask)
    dj, ij = JShardedExact(js, jmesh).search_slots(vecs[:2], k=10, mask=mask)
    for b in range(2):
        assert {int(s) for s in it[b] if s >= 0} == set(allowed)
    agree((dt[:, :3], it[:, :3]), (dj[:, :3], ij[:, :3]))
    with pytest.raises(ValueError, match="corpus-wide"):
        ShardedExactIndex(st, N_SHARDS).search_slots(vecs[:2], 5, mask=np.ones((2, st.capacity), bool))


def test_port_sharded_exact_negative_rerank(jmesh):
    st, js, vecs = stores(n=500)
    q, neg = vecs[:3], vecs[10:13]
    got = ShardedExactIndex(st, N_SHARDS).search_slots(q, k=5, negative=neg, negative_weight=1.0)
    want = JShardedExact(js, jmesh).search_slots(q, k=5, negative=neg, negative_weight=1.0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], ExactIndex(st).search_slots(
        q, k=5, negative=neg, negative_weight=1.0)[1])


def test_port_sharded_exact_follows_writes():
    st, _, vecs = stores(n=1200)
    eng = ShardedExactIndex(st, N_SHARDS)
    _, s = eng.search_slots(vecs[:1], k=1)
    assert st.id_of(int(s[0, 0])) == "v0"
    st.delete_batch(["v0"])
    _, s = eng.search_slots(vecs[:1], k=1)  # the store's incremental sync
    assert st.id_of(int(s[0, 0])) != "v0"
    new = vecs[:4] + 0.001
    slots = st.add_batch([f"n{j}" for j in range(4)], new)
    _, s = eng.search_slots(new, k=1)
    np.testing.assert_array_equal(s[:, 0], slots)
    # growth past the capacity: the store resyncs, the shards re-slice
    more = np.random.default_rng(4).normal(size=(st.capacity, D)).astype(np.float32)
    grown = st.add_batch([f"g{j}" for j in range(len(more))], more)
    _, s = eng.search_slots(more[:3], k=1)
    np.testing.assert_array_equal(s[:, 0], grown[:3])


def test_port_mesh_rules():
    with pytest.raises(ValueError, match="devices"):
        make_mesh(99, devices=["cpu"])
    assert make_mesh(3, devices=["cpu"] * 4) == (torch.device("cpu"),) * 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()  # no card here, and the CPU is never picked on its own
    assert resolve_mesh(None, "cpu") == (torch.device("cpu"),)
    assert resolve_mesh(4, "cpu") == (torch.device("cpu"),) * 4
    assert resolve_mesh(["cpu", "cpu"], "cuda") == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        resolve_mesh(0, "cpu")
    st, _, _ = stores(n=100)
    with pytest.raises(ValueError, match="divisible"):
        ShardedExactIndex(st, 3).search_slots(np.zeros((1, D), np.float32), 1)


@pytest.mark.parametrize("kind", ["sharded_exact", "sharded_ivf", "sharded_hnsw", "sharded_hybrid"])
def test_port_sharded_engines_keep_shards_on_the_store_device(kind):
    """One placement rule for every sharded engine: shard s lives on
    ``mesh[s]``, on the store's device or not. A mesh of two distinct
    devices is accepted, and the exact shards' mirrors are placed on them
    (``tests/test_torch_sharded_placement.py`` holds each kind's tensors)."""
    st, _, _ = stores(n=100)
    eng = make_engine(kind, st, mesh=["cpu", "meta"])
    exact = sharded_exact_of(eng)
    assert exact.mesh == (torch.device("cpu"), torch.device("meta"))
    assert [sh[0].device.type for sh in exact.shards()] == ["cpu", "meta"]


def test_port_merge_keeps_lower_shard_first_on_ties():
    d = [torch.tensor([[1.0, 2.0]]), torch.tensor([[1.0, 3e38]]), torch.tensor([[0.5, 1.0]])]
    i = [torch.tensor([[0, 1]]), torch.tensor([[10, -1]]), torch.tensor([[20, 21]])]
    out_d, out_i = merge_topk(d, i, 5)
    assert out_i.tolist() == [[20, 0, 10, 21, 1]]
    out_d, out_i = merge_topk(d, i, 6)
    assert out_i[0, -1] == -1


def test_port_collection_and_db_with_sharded_engines(tmp_path):
    from quiver_tpu_torch.core.collection import Collection
    from quiver_tpu_torch.core.db import DB, DBOptions
    from quiver_tpu_torch.types import Filter, SearchRequest

    c = Collection("dist", D, "euclidean", device="cpu",
                   engine_factory=lambda store: ShardedExactIndex(store, N_SHARDS))
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(600, D)).astype(np.float32)
    c.add_batch([f"x{i}" for i in range(600)], vecs, [{"p": i % 3} for i in range(600)])
    resp = c.search(SearchRequest(vector=vecs[7], top_k=3, filters=[Filter("p", "=", 1)]))
    assert all(int(r.id[1:]) % 3 == 1 for r in resp.results)
    assert resp.results[0].id == "x7"
    for kind, n in (("sharded_exact", 300), ("sharded_hybrid", 1500), ("sharded_hnsw", 600)):
        db = DB(DBOptions(storage_path=str(tmp_path / kind), flush_interval_s=0, device="cpu",
                          default_engine=kind, engine_config={"mesh": N_SHARDS}))
        coll = db.create_collection("s", D, "euclidean")
        rows = rng.normal(size=(n, D)).astype(np.float32)
        coll.add_batch([f"v{i}" for i in range(n)], rows)
        assert coll.search(SearchRequest(vector=rows[9], top_k=3)).results[0].id == "v9"
        assert coll.engine.name == ("hybrid" if kind == "sharded_hybrid" else kind)
        db.close()


def test_port_registry_builds_every_sharded_kind():
    st, _, _ = stores(n=200)
    assert make_engine("sharded_exact", st, mesh=4).n_shards == 4
    assert make_engine("sharded_ivf", st, mesh=4).name == "sharded_ivf"
    assert make_engine("sharded_hnsw", st, mesh=2).n == 2
    h = make_engine("sharded_hybrid", st, mesh=4, n_probe=5)
    assert h.ann.name == "sharded_ivf" and h.ann.config.n_probe == 5
    assert h.exact.name == "sharded_exact" and h.exact.n_shards == 4
    g = make_engine("sharded_hybrid", st, mesh=2, ef_search=32)
    assert g.ann.name == "sharded_hnsw" and g.ann.config.ef_search == 32
    with pytest.raises(ValueError):
        make_engine("sharded_hybrid", st, mesh=2, bogus_knob=1)
    cfg = resolve_engine_config("sharded_hybrid", {"hnsw": {"m0": 48}})
    assert cfg["ann_backend"] == "hnsw" and cfg["hnsw_config"].m0 == 48
    g = make_engine("sharded_hybrid", st, mesh=2, **cfg)
    assert g.ann.name == "sharded_hnsw" and g.ann.config.m0 == 48
    assert resolve_engine_config("sharded_ivf", {"ivf": {"n_probe": 3}})["config"].n_probe == 3


def test_port_device_bytes_per_device():
    from quiver_tpu_torch.utils.memory import (
        _per_chip_nbytes,
        device_bytes,
        device_bytes_by_device,
        store_device_bytes,
    )

    st, _, _ = stores(n=512)
    eng = ShardedExactIndex(st, N_SHARDS)
    eng.search_slots(np.zeros((1, D), np.float32), 1)
    # the mirrors are the only device copy: the store's view is never made,
    # and the 8 mirrors hold what the view would
    assert store_device_bytes(st) == 0
    view_bytes = st.capacity * (4 * D + 1 + 4 + 4)
    assert device_bytes(eng, skip=(VectorStore,)) == view_bytes  # shards share the CPU
    assert device_bytes_by_device(eng, skip=(VectorStore,)) == {"cpu": view_bytes}
    assert _per_chip_nbytes({"cuda:0": 100, "cuda:1": 100}) == 100
    assert _per_chip_nbytes({}) == 0


# ------------------------------------------------------------------- HNSW


def graph(n=1200, metric="euclidean", seed=3, mesh=N_SHARDS, **cfg):
    st, js, vecs = stores(n=n, metric=metric, seed=seed)
    eng = ShardedHNSWIndex(st, mesh, ef_search=64, build_batch=512, **cfg)
    eng.on_insert(np.arange(n), vecs)
    return st, js, vecs, eng


@pytest.fixture(scope="module")
def built():
    return graph()


def test_port_sharded_hnsw_same_graph_as_reference(jmesh, built):
    """The port's 8 subgraphs imported by the JAX engine: both searches
    agree up to tie swaps."""
    st, js, vecs, eng = built
    jeng = JShardedHNSW(js, jmesh, ef_search=64, build_batch=512)
    jeng.import_topology(eng.export_topology(), np.arange(js.capacity))
    rng = np.random.default_rng(7)
    q = (vecs[:32] + 0.3 * rng.normal(size=(32, D))).astype(np.float32)
    agree(eng.search_slots(q, k=10), jeng.search_slots(q, k=10))


def test_port_sharded_hnsw_recall_and_self_hits(built):
    st, _, vecs, eng = built
    d, i = eng.search_slots(vecs[:64], k=1)
    assert (i[:, 0] == np.arange(64)).mean() >= 0.98
    np.testing.assert_allclose(d[i[:, 0] == np.arange(64), 0], 0.0, atol=5e-3)
    rng = np.random.default_rng(7)
    q = (rng.normal(size=(32, D)) * 0.3 + vecs[:32]).astype(np.float32)
    _, oi = ExactIndex(st).search_slots(q, 10)
    gd, gi = eng.search_slots(q, 10)
    assert np.mean([len(set(gi[b]) & set(oi[b])) / 10 for b in range(32)]) >= 0.9
    for b in range(32):
        assert (np.diff(gd[b][gi[b] >= 0]) >= -1e-6).all()
    sizes = [s.size for s in eng._sub_stores]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("visited", ["ring", "bitmap"])
def test_port_sharded_hnsw_batched_equals_per_shard(built, visited):
    st, _, vecs, eng = built
    eng.set_optimization_parameters(visited=visited)
    try:
        q = torch.from_numpy(vecs[:64] + 0.05)
        for ef in (16, 64):
            bd, bi = eng.search_device(q, ef, 10, batched=True)
            pd, pi = eng.search_device(q, ef, 10, batched=False)
            assert torch.equal(bi, pi) and torch.equal(bd, pd)
    finally:
        eng.set_optimization_parameters(visited="ring")


def test_port_sharded_hnsw_delete_underfill_mask_negative():
    st, _, vecs, eng = graph(n=300)
    _, i = eng.search_slots(vecs[0], k=2)
    victim = int(i[0, 0])
    st.delete_batch([st.id_of(victim)])
    eng.on_delete(np.asarray([victim]))
    assert victim not in set(eng.search_slots(vecs[0], k=5)[1][0].tolist())
    _, i3 = eng.search_slots(vecs[0], k=299)  # the under-fill supplement
    assert (i3[0] >= 0).sum() == 299
    mask = np.zeros(st.capacity, bool)
    mask[:100] = True
    _, i = eng.search_slots(vecs[1:5], k=5, mask=mask)
    assert (i[i >= 0] < 100).all()
    _, i0 = eng.search_slots(vecs[1:9], k=5)
    _, i_neg = eng.search_slots(vecs[1:9], k=5, negative=vecs[1:9], negative_weight=5.0)
    assert (i_neg[:, 0] != i0[:, 0]).any()


def test_port_sharded_hnsw_search_while_inserting():
    """Searches on one thread while another inserts through a Collection
    (whose searches take no write lock). A search issued in the middle of
    a write (after the rows reached a sub-store, before its subgraph took
    them) waits for the write to end; searches racing a run of inserts
    never raise and answer with rows that exist; the end state answers as
    a stack made afresh."""
    from quiver_tpu_torch.core.collection import Collection
    from quiver_tpu_torch.types import SearchRequest

    rng = np.random.default_rng(21)
    n0, n_add, batch = 300, 240, 8
    vecs = rng.normal(size=(n0 + n_add + batch, D)).astype(np.float32)
    c = Collection("g", D, "euclidean", device="cpu", engine_factory=lambda s: ShardedHNSWIndex(
        s, 4, ef_search=32, build_batch=64, m=4, m0=8, level_prob=0.5))
    c.add_batch([f"v{i}" for i in range(n0)], vecs[:n0])
    eng = c.engine
    reqs = [SearchRequest(vector=v, top_k=5) for v in vecs[:6]]
    errors, answers = [], []

    def search():
        try:
            answers.append(c.search_batch(reqs))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def check(resps):
        for r in resps:
            assert r.results and all(int(it.id[1:]) < len(vecs) for it in r.results)

    # 1. one search issued mid-write
    sub, real, waited = eng._subs[1], eng._subs[1].on_insert, []

    def mid_write(local, v):
        t = threading.Thread(target=search)
        t.start()
        t.join(timeout=0.5)
        waited.append(t)
        real(local, v)

    sub.on_insert = mid_write
    try:
        at = n0 + n_add
        c.add_batch([f"v{i}" for i in range(at, at + batch)], vecs[at:at + batch])
    finally:
        del sub.on_insert
    (t,) = waited
    assert t.is_alive(), "a search ran in the middle of a write"
    t.join(timeout=60)
    assert not errors, errors
    check(answers[0])

    # 2. searches racing a run of inserts
    done = threading.Event()

    def writer():
        try:
            for at in range(n0, n0 + n_add, batch):
                c.add_batch([f"v{i}" for i in range(at, at + batch)], vecs[at:at + batch])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            done.set()

    def reader():
        while not done.is_set() and not errors:
            search()

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    for resps in answers:
        check(resps)
    assert sum(s.size for s in eng._sub_stores) == len(vecs)
    q = vecs[-16:]
    d_inc, i_inc = eng.search_slots(q, k=5)
    eng._stacked = eng._stack_sig = None
    d_full, i_full = eng.search_slots(q, k=5)
    np.testing.assert_array_equal(i_inc, i_full)
    np.testing.assert_array_equal(d_inc, d_full)


def test_port_sharded_hnsw_stack_follows_writes():
    """After writes and after a sub-index rebuild the cached stack is
    rebuilt, and answers as a stack made from scratch."""
    st, _, vecs, eng = graph(n=1200)
    eng.search_slots(vecs[:4], k=3)
    rng = np.random.default_rng(13)
    new = (vecs[100:116] + 0.01 * rng.normal(size=(16, D))).astype(np.float32)
    slots = st.add_batch([f"y{j}" for j in range(16)], new)
    eng.on_insert(slots, new)
    _, i = eng.search_slots(new, k=1)
    assert (i[:, 0] == slots).mean() >= 0.9
    st.delete_batch(["y0"])
    eng.on_delete(np.asarray([slots[0]]))
    assert eng.search_slots(new[:1], k=1)[1][0, 0] != slots[0]
    eng._subs[0].rebuild()
    q = np.concatenate([new[:4], vecs[:12]])
    d_inc, i_inc = eng.search_slots(q, k=8)
    eng._stacked = eng._stack_sig = None
    d_full, i_full = eng.search_slots(q, k=8)
    np.testing.assert_array_equal(i_inc, i_full)
    np.testing.assert_array_equal(d_inc, d_full)


def test_port_sharded_hnsw_topology_roundtrip_and_mismatch(built):
    st, _, vecs, eng = built
    data = eng.export_topology()
    assert bytes(data["kind"]) == b"sharded_hnsw"
    eng2 = ShardedHNSWIndex(st, N_SHARDS, ef_search=64, build_batch=512)
    eng2.import_topology(data, np.arange(st.capacity))
    d1, i1 = eng.search_slots(vecs[:16], k=5)
    d2, i2 = eng2.search_slots(vecs[:16], k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)
    bad = dict(data, n_shards=np.int64(4))
    eng3 = ShardedHNSWIndex(st, N_SHARDS, ef_search=64, build_batch=512)
    eng3.import_topology(bad, np.arange(st.capacity))
    assert all(sub.entry_point < 0 for sub in eng3._subs)
    assert (eng3.search_slots(vecs[:4], k=1)[1][:, 0] == np.arange(4)).all()  # exact fallback


def test_port_dryrun_pipeline_step():
    from quiver_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(N_SHARDS, device="cpu")
    assert out["self_hits"] == 1.0 and out["graph_self_hits"] >= 0.99
