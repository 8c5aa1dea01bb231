"""The port's hybrid engine (its IVF backend) against the JAX package's, on
the CPU.

The scenarios of tests/test_hybrid.py that do not need the HNSW engine run
through both packages on the same seeded numpy rows and queries: the
selector's decisions (both draw from ``np.random.default_rng(seed)``, so
each query's exploration coin is the same), routing, per-strategy counts,
writes, the knob surface, and results. For results the port's IVF side
imports the JAX engine's topology (``export_topology`` /
``import_topology``, the route the database takes on reload), so both lay
out the same f32 blocks; the queries then agree in distances to rtol/atol
1e-4 (f32 products in both; only the summation order differs) and in ids
wherever the reference's distances are separated from the k-th by more
than that (``assert_topk_agree``).

The HNSW backend runs through both packages too (:class:`Both` with
``hnsw``): the port's graph imports the JAX build's topology, so both
search the same graph, and ids and distances are held as above.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from quiver_tpu.core.collection import Collection as JCollection
from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.index import hybrid as jh
from quiver_tpu.index import make_engine as j_make_engine
from quiver_tpu.index import resolve_engine_config as j_resolve
from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.index.ivf import IVFIndex as JIVF
from quiver_tpu_torch import Collection
from quiver_tpu_torch.core.store import VectorStore as TStore
from quiver_tpu_torch.index import hybrid as th
from quiver_tpu_torch.index import make_engine, resolve_engine_config
from quiver_tpu_torch.index.hnsw import HNSWConfig as THConfig
from quiver_tpu_torch.index.hnsw import HNSWIndex as THNSW
from quiver_tpu_torch.index.ivf import IVFConfig as TConfig
from quiver_tpu_torch.index.ivf import IVFIndex as TIVF

from tests.test_torch_store_exact import assert_topk_agree

D = 16
TOL = 1e-4


def assert_same_stats(st, sj):
    """Engine stats agree in every field but the measured latencies."""
    assert st["per_strategy_queries"] == sj["per_strategy_queries"]
    sel_t, sel_j = dict(st["selector"]), dict(sj["selector"])
    lat_t, lat_j = sel_t.pop("avg_latency_ms"), sel_j.pop("avg_latency_ms")
    assert sel_t == sel_j and set(lat_t) == set(lat_j)
    assert all((lat_t[s] is None) == (lat_j[s] is None) for s in lat_t)


def no_explore(mod, **kw):
    kw.setdefault("exploration_factor", 0.0)
    return mod.AdaptiveConfig(**kw)


class Both:
    """A JAX and a port hybrid over the same rows; the port's IVF side
    holds the JAX engine's topology once the JAX one has built."""

    def __init__(self, n=300, d=D, *, seed=0, adaptive=None, ivf=None, metric="euclidean",
                 hnsw=None):
        rng = np.random.default_rng(seed)
        self.vecs = rng.normal(size=(n, d)).astype(np.float32)
        ivf = {"build_threshold": 256, "n_probe": 8, **(ivf or {})}
        adaptive = dict(adaptive or {"exploration_factor": 0.0})
        self.js = JStore(dim=d, metric=metric, capacity=n)
        self.ts = TStore(dim=d, metric=metric, capacity=n, device="cpu")
        # the ANN side: IVF, or the graph with ``hnsw``'s keywords
        j_ann = {"ivf_config": JConfig(**ivf)} if hnsw is None else dict(hnsw)
        t_ann = {"ivf_config": TConfig(**ivf)} if hnsw is None else dict(hnsw)
        self.j = jh.HybridIndex(self.js, adaptive_config=jh.AdaptiveConfig(**adaptive), **j_ann)
        self.t = th.HybridIndex(self.ts, adaptive_config=th.AdaptiveConfig(**adaptive), **t_ann)
        ids = [f"v{i}" for i in range(n)]
        js_slots = self.js.add_batch(ids, self.vecs)
        ts_slots = self.ts.add_batch(ids, self.vecs)
        np.testing.assert_array_equal(js_slots, ts_slots)
        self.j.on_insert(js_slots, self.vecs)
        topo = self.j.export_topology()
        if topo is not None:
            self.t.import_topology(topo, np.arange(self.ts.capacity))
        else:
            self.t.on_insert(ts_slots, self.vecs)

    def search(self, q, k, **kw):
        """The same search on both; results held to each other."""
        dj, ij = self.j.search_slots(q, k, **kw)
        dt, it = self.t.search_slots(q, k, **kw)
        assert_topk_agree(dt, it, dj, ij, rtol=TOL, atol=TOL)
        assert self.t.last_strategy == self.j.last_strategy
        assert self.t.stats()["per_strategy_queries"] == self.j.stats()["per_strategy_queries"]
        return dt, it


# ------------------------------------------------------------ the selector


@pytest.mark.parametrize("count,dim,k", [(500, 64, 10), (100_000, 64, 10),
                                         (100_000, 512, 64), (100_000, 512, 10)])
def test_selector_decisions_match_jax(count, dim, k):
    sj = jh.AdaptiveStrategySelector(no_explore(jh), ann_label="ivf")
    st = th.AdaptiveStrategySelector(no_explore(th), ann_label="ivf")
    assert st.select_strategy(count, dim, k) == sj.select_strategy(count, dim, k)
    want = jh.EXACT if count < 1000 or (dim > 100 and k >= 50) else "ivf"
    assert st.select_strategy(count, dim, k) == want


def test_selector_exploration_draws_match_jax():
    sj = jh.AdaptiveStrategySelector(jh.AdaptiveConfig(exploration_factor=0.3, seed=7), "ivf")
    st = th.AdaptiveStrategySelector(th.AdaptiveConfig(exploration_factor=0.3, seed=7), "ivf")
    for _ in range(20):
        assert st.select_strategy(10, 8, 5) == sj.select_strategy(10, 8, 5)
    np.testing.assert_array_equal(st.select_strategy_batch(5000, 8, 5, 64),
                                  sj.select_strategy_batch(5000, 8, 5, 64))
    assert {st.select_strategy(10, 8, 5) for _ in range(50)} == {jh.EXACT, "ivf"}


def test_selector_threshold_adaptation_matches_jax():
    cfg = dict(exploration_factor=0.0, adapt_every=20, min_samples=10)
    for fast, slow in ((1.0, 5.0), (5.0, 1.0)):
        sj = jh.AdaptiveStrategySelector(jh.AdaptiveConfig(**cfg), "ivf")
        st = th.AdaptiveStrategySelector(th.AdaptiveConfig(**cfg), "ivf")
        t0 = st.exact_threshold
        for i in range(400):
            strat = jh.EXACT if i % 2 == 0 else "ivf"
            lat = fast if strat == jh.EXACT else slow
            sj.record_query_metrics(jh.QueryMetric(strat, lat, 10, corpus_size=800))
            st.record_query_metrics(th.QueryMetric(strat, lat, 10, corpus_size=800))
        assert st.exact_threshold == sj.exact_threshold
        assert (st.exact_threshold > t0) == (fast < slow)
        assert st.exact_threshold >= 100
        assert_same_stats({"per_strategy_queries": {}, "selector": st.stats()},
                          {"per_strategy_queries": {}, "selector": sj.stats()})


# ------------------------------------------------------------- the engine


def test_mixed_batch_per_query_strategies_match_jax():
    """Full exploration: every query draws its own engine, the stitched
    batch returns each query's own row, and both packages route alike."""
    b = Both(n=400, adaptive={"exploration_factor": 1.0, "seed": 3})
    _, slots = b.search(b.vecs[:64], 3)
    assert (slots[:, 0] == np.arange(64)).mean() >= 0.95
    counts = b.t._per_strategy_counts
    assert counts[jh.EXACT] > 0 and counts["ivf"] > 0
    assert counts[jh.EXACT] + counts["ivf"] == 64
    assert len(b.t.selector._window) == len(b.j.selector._window) == 64


def test_uniform_batch_when_not_exploring():
    b = Both(n=200, adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 1000})
    b.search(b.vecs[:16], 2)
    assert b.t._per_strategy_counts["ivf"] == 0


@pytest.mark.parametrize("threshold,want", [(1000, "exact"), (10, "ivf")])
def test_routing_by_corpus_size_matches_jax(threshold, want):
    b = Both(n=300, adaptive={"exploration_factor": 0.0, "initial_exact_threshold": threshold})
    _, slots = b.search(b.vecs[:2], 5)
    assert b.t.last_strategy == want
    assert b.ts.id_of(int(slots[0, 0])) == "v0"


def test_forced_and_masked_queries_route_exact():
    b = Both(n=300, adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 10})
    b.search(b.vecs[:1], 5, exact=True)
    assert b.t.last_strategy == jh.EXACT
    mask = np.zeros(b.ts.capacity, bool)
    mask[b.ts.slot_of("v9")] = True
    dj, ij = b.j.search_slots(b.vecs[:1], 3, mask=mask)
    dt, it = b.t.search_slots(b.vecs[:1], 3, mask=mask)
    assert b.t.last_strategy == b.j.last_strategy == jh.EXACT
    assert b.ts.id_of(int(it[0, 0])) == "v9"
    assert_topk_agree(dt, it, dj, ij, rtol=TOL, atol=TOL)


def test_both_strategies_agree_on_top1():
    b = Both(n=400)
    _, e = b.search(b.vecs[:8], 1, strategy=jh.EXACT)
    _, h = b.search(b.vecs[:8], 1, strategy="ivf")
    assert (e[:, 0] == h[:, 0]).mean() >= 0.9


def test_writes_reach_the_ivf_side():
    b = Both(n=300, adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 10})
    assert b.t._graph_built and b.t.ann._built
    for store, idx in ((b.js, b.j), (b.ts, b.t)):
        slot = store.slot_of("v3")
        store.delete("v3")
        idx.on_delete(np.asarray([slot]))
        moved = np.full((1, D), 5.0, np.float32)
        store.update_batch(["v4"], moved)
        idx.on_update(np.asarray([store.slot_of("v4")]), moved)
    _, slots = b.search(b.vecs[3][None], 10, strategy="ivf")
    assert "v3" not in {b.ts.id_of(int(s)) for s in slots[0] if s >= 0}
    _, slots = b.search(np.full((1, D), 5.0, np.float32), 1, strategy="ivf")
    assert b.ts.id_of(int(slots[0, 0])) == "v4"


def test_pending_buffer_before_the_ivf_side_builds():
    """Below the hybrid's build threshold inserts are buffered; updates and
    deletes of buffered rows edit the buffer, as in the reference."""
    b = Both(n=100)
    assert not b.t._graph_built and not b.j._graph_built
    for store, idx in ((b.js, b.j), (b.ts, b.t)):
        store.delete_batch(["v1", "v2"])
        idx.on_delete(np.asarray([1, 2]))
        idx.on_update(np.asarray([5]), np.full((1, D), 3.0, np.float32))
    for (js, jv), (ts, tv) in zip(b.j._pending, b.t._pending):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tv, jv)
    assert 1 not in b.t._pending[0][0] and np.all(b.t._pending[0][1][3] == 3.0)  # slot 5


def test_stats_and_knob_surface_match_jax():
    b = Both(n=300)
    b.search(b.vecs[:1], 3)
    st, sj = b.t.stats(), b.j.stats()
    assert_same_stats(st, sj)
    assert st["selector"]["exact_threshold"] > 0
    assert b.t.get_optimization_parameters() == b.j.get_optimization_parameters()
    for idx in (b.j, b.t):
        idx.set_optimization_parameters(ef_search=64)  # the graph's knob: no-op
        idx.set_optimization_parameters(n_probe=4)
        with pytest.raises(ValueError, match="immutable or unknown"):
            idx.set_optimization_parameters(bogus=1)
    assert b.t.get_optimization_parameters()["n_probe"] == 4
    dm = b.t.get_detailed_metrics()
    assert set(dm) == set(b.j.get_detailed_metrics())
    assert dm["ivf"]["size"] == 300 and set(dm["device_bytes"]) == {
        "engine", "store", "total", "per_vector"}


def test_ivf_backend_routes_and_matches_exact():
    """ann_backend="ivf" at high n_probe agrees with the exact side
    (test_hybrid_ivf_backend_routes_and_matches_exact), in both packages."""
    rng = np.random.default_rng(11)
    n, dim, k = 4096, 32, 10
    b = Both(n=n, d=dim, seed=11, ivf={"n_probe": 32, "build_threshold": 512},
             adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 100})
    q = (b.vecs[:16] + 0.05 * rng.normal(size=(16, dim))).astype(np.float32)
    _, s = b.search(q, k)
    assert b.t.last_strategy == "ivf"
    _, se = b.t.exact.search_slots(q, k)
    assert np.mean([len(set(s[i]) & set(se[i])) / k for i in range(16)]) >= 0.9


def test_default_backend_is_ivf_with_f32_blocks():
    """The out-of-box hybrid serves the IVF engine at the hybrid's f32
    compute dtype, as the reference's (f32 residual blocks)."""
    b = Both(n=2048, d=32, seed=5, ivf={"n_probe": 16, "build_threshold": 512},
             adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 100})
    assert b.t.ann_backend == b.j.ann_backend == "ivf" and isinstance(b.t.ann, TIVF)
    assert b.t.ann.compute_dtype == torch.float32 and b.t.ann._blocks_t.dtype == torch.float32
    assert np.asarray(b.j.ann._blocks_t).dtype == np.float32
    _, s = b.search(b.vecs[:8], 5)
    assert b.t.last_strategy == "ivf" and (s[:, 0] == np.arange(8)).mean() >= 0.8


def near(q):
    """Queries a little off their rows: at a stored row the affine f32
    distance is cancellation noise (~1e-3), which neither package computes
    alike."""
    return (q + 0.01 * np.random.default_rng(8).normal(size=q.shape)).astype(np.float32)


def test_hnsw_backend_raises():
    """The graph backend: ``ann_backend="hnsw"``, an HNSW keyword or an
    ``hnsw_config`` build it (the ``hnsw`` namespace of a JSON config too,
    as in the reference); it routes and answers as the reference's on the
    same graph. An unknown backend still raises."""
    ts = TStore(dim=D, metric="euclidean", device="cpu")
    for kw in ({"ann_backend": "hnsw"}, {"build_batch": 128}, {"hnsw_config": THConfig(m=8)}):
        idx = th.HybridIndex(ts, **kw)
        assert idx.ann_backend == "hnsw" and isinstance(idx.ann, THNSW) and idx.ann_label == "hnsw"
    out, ref = resolve_engine_config("hybrid", {"hnsw": {"m": 8}}), j_resolve("hybrid", {"hnsw": {"m": 8}})
    assert out["ann_backend"] == ref["ann_backend"] == "hnsw"
    assert vars(out["hnsw_config"]) == vars(ref["hnsw_config"])
    assert th.HybridIndex(ts, **out).ann.config.m == 8
    b = Both(n=300, hnsw={"build_batch": 256},
             adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 10})
    _, slots = b.search(near(b.vecs[:8]), 5)
    assert b.t.last_strategy == "hnsw" and (slots[:, 0] == np.arange(8)).all()
    with pytest.raises(ValueError, match="unknown ann_backend"):
        th.HybridIndex(ts, ann_backend="bogus")


def test_large_corpus_selects_hnsw():
    """The selector's default ANN label is the graph's, in both packages."""
    sj, st = jh.AdaptiveStrategySelector(no_explore(jh)), th.AdaptiveStrategySelector(no_explore(th))
    for count, dim, k in ((100_000, 64, 10), (100_000, 512, 10), (500, 64, 10)):
        assert st.select_strategy(count, dim, k) == sj.select_strategy(count, dim, k)
    assert st.select_strategy(100_000, 64, 10) == th.HNSW == "hnsw"


def test_hybrid_large_routes_hnsw():
    b = Both(n=300, hnsw={"build_batch": 256},
             adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 10})
    _, slots = b.search(near(b.vecs[:2]), 5)
    assert b.t.last_strategy == th.HNSW
    assert b.ts.id_of(int(slots[0, 0])) == "v0"


def test_writes_propagate_to_graph():
    b = Both(n=300, hnsw={"build_batch": 256},
             adaptive={"exploration_factor": 0.0, "initial_exact_threshold": 10})
    for store, idx in ((b.js, b.j), (b.ts, b.t)):
        slot = store.slot_of("v3")
        store.delete("v3")
        idx.on_delete(np.asarray([slot]))
    _, slots = b.search(near(b.vecs[3][None]), 10, strategy=th.HNSW)
    assert "v3" not in {b.ts.id_of(int(s)) for s in slots[0] if s >= 0}


def test_recall_shortfall_routes_to_exact():
    """An IVF engine whose tuner measured itself short of target is bypassed
    (test_recall_shortfall_routes_to_exact), both packages."""
    rng = np.random.default_rng(11)
    n, dim, k = 4096, 32, 5
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    out = []
    for Store, mod, Config, IVF, kw in ((JStore, jh, JConfig, JIVF, {}),
                                        (TStore, th, TConfig, TIVF, {"device": "cpu"})):
        store = Store(dim=dim, metric="euclidean", capacity=n, **kw)
        store.add_batch([f"v{i}" for i in range(n)], vecs)
        eng = IVF(store, config=Config(n_probe=1, n_probe_max=2, recall_target=0.99,
                                       build_threshold=512))
        eng.build()
        assert eng.recall_shortfall
        idx = mod.HybridIndex(store, adaptive_config=no_explore(mod, initial_exact_threshold=100),
                              ann_factory=lambda s, e=eng: e)
        idx._graph_built = True
        out.append(idx.search_slots(vecs[:16], k))
        assert idx.last_strategy == jh.EXACT
        assert (out[-1][1][:, 0] == np.arange(16)).all()
        eng._tuned_recall = 1.0
        idx.search_slots(vecs[:16], k)
        assert idx.last_strategy == "ivf"
    assert_topk_agree(out[1][0], out[1][1], out[0][0], out[0][1], rtol=TOL, atol=TOL)


def test_fluent_strategy_and_stats_through_collections():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    ids = [f"v{i}" for i in range(50)]
    jc = JCollection("fl", 8, "euclidean",
                     engine_factory=lambda s: jh.HybridIndex(s, adaptive_config=no_explore(jh)))
    tc = Collection("fl", 8, "euclidean", device="cpu",
                    engine_factory=lambda s: th.HybridIndex(s, adaptive_config=no_explore(th)))
    resps = []
    for c in (jc, tc):
        c.add_batch(ids, vecs)
        resps.append(c.fluent_search(vecs[0]).with_k(3).with_strategy("exact")
                     .include_stats().execute())
        with pytest.raises(ValueError, match="unknown strategy"):
            c.fluent_search(vecs[0]).with_strategy("bogus").execute()
    rj, rt = resps
    assert [i.id for i in rt.results] == [i.id for i in rj.results] and rt.results[0].id == "v0"
    np.testing.assert_allclose([i.distance for i in rt.results],
                               [i.distance for i in rj.results], rtol=TOL, atol=TOL)
    assert rt.metadata.strategy == rj.metadata.strategy == "exact"
    assert_same_stats(rt.metadata.engine_stats, rj.metadata.engine_stats)


def test_registry_builds_the_hybrid_like_jax():
    """make_engine("hybrid") and the hybrid's namespaced JSON config, as
    the database passes them (ivf and adaptive blocks; flat keys refused)."""
    cfg = {"ivf": {"n_probe": 4, "build_threshold": 64}, "adaptive": {"exploration_factor": 0.0}}
    rt, rj = resolve_engine_config("hybrid", cfg), j_resolve("hybrid", cfg)
    assert set(rt) == set(rj) == {"ivf_config", "adaptive_config"}
    assert rt["ivf_config"].n_probe == rj["ivf_config"].n_probe == 4
    assert rt["adaptive_config"].exploration_factor == 0.0
    for resolve in (resolve_engine_config, j_resolve):
        with pytest.raises(ValueError, match="namespaced"):
            resolve("hybrid", {"n_probe": 4})
        with pytest.raises(ValueError, match="invalid engine_config"):
            resolve("hybrid", {"ivf": {"bogus": 1}})
    ts = TStore(dim=D, metric="euclidean", device="cpu")
    js = JStore(dim=D, metric="euclidean")
    t = make_engine("hybrid", ts, compute_dtype=torch.float32, **rt)
    j = j_make_engine("hybrid", js, **rj)
    assert t.name == j.name == "hybrid" and t.ann_label == j.ann_label == "ivf"
    assert t.ann.config.n_probe == 4 and t.ann.compute_dtype == torch.float32


def test_mixed_batches_under_concurrent_writes():
    """Mixed batches fan out to two threads each (exact and IVF sub-batches);
    six searching threads and one inserting thread share the engine with a
    short switch interval. Every answer's top-1 is its query's own row,
    every row inserted during the run is found after it, and no
    per-strategy count is lost."""
    rng = np.random.default_rng(21)
    d = 16
    base = rng.normal(size=(2000, d)).astype(np.float32)
    ts = TStore(dim=d, metric="euclidean", capacity=4096, device="cpu")
    idx = th.HybridIndex(ts, ivf_config=TConfig(n_probe=16, build_threshold=512,
                                                background_maintenance=False),
                         adaptive_config=th.AdaptiveConfig(exploration_factor=1.0, seed=1))
    idx.on_insert(ts.add_batch([f"v{i}" for i in range(2000)], base), base)
    extra = rng.normal(size=(400, d)).astype(np.float32)
    errors = []

    def searcher(seed):
        try:
            r = np.random.default_rng(seed)
            for _ in range(15):
                pick = r.integers(0, 2000, 32)
                _, slots = idx.search_slots(base[pick], 3)
                assert np.mean(slots[:, 0] == pick) >= 0.95
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def writer():
        try:
            for at in range(0, 400, 40):
                idx.on_insert(ts.add_batch([f"x{i}" for i in range(at, at + 40)],
                                           extra[at:at + 40]), extra[at:at + 40])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=searcher, args=(s,)) for s in range(6)]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    _, slots = idx.search_slots(extra, 1, strategy="ivf")
    assert np.mean([ts.id_of(int(s)) == f"x{i}" for i, s in enumerate(slots[:, 0])]) >= 0.99
    assert sum(idx.stats()["per_strategy_queries"].values()) == 6 * 15 * 32 + 1
