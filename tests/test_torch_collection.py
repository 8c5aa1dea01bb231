"""The port's ``Collection`` against the JAX package's, on the CPU.

The same rows and requests go through both packages' ``Collection``: with
the exact engine (the cases of tests/test_collection.py, each run through
both), and with the IVF engine, the port's collection built from the JAX
collection's state by ``convert.collection_from_snapshot`` (its rows, and
its engine's topology with the snapshot's slot remap). Responses agree in
ids (wherever the reference's distances are separated from the k-th by
more than the tolerance), distances to rtol/atol 1e-4, metadata, vectors,
``total_count`` and ``index_size``; the original cases' own assertions
hold on the port.
"""

import numpy as np
import pytest
import torch

from quiver_tpu import types as jtypes
from quiver_tpu.core.collection import Collection as JCollection
from quiver_tpu.facets import filters as jflt
from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.index.ivf import IVFIndex as JIVF
from quiver_tpu_torch import Collection, IVFConfig, IVFIndex, make_engine
from quiver_tpu_torch import types as ttypes
from quiver_tpu_torch.convert import collection_from_snapshot
from quiver_tpu_torch.facets import filters as tflt

from tests.test_torch_store_exact import assert_topk_agree

D = 8
TOL = 1e-4


class Both:
    """A JAX and a port collection fed the same calls."""

    def __init__(self, jc, tc):
        self.jc, self.tc = jc, tc

    @classmethod
    def new(cls, name="test", dim=D, metric="euclidean", **kw):
        return cls(JCollection(name, dim, metric, **kw),
                   Collection(name, dim, metric, device="cpu", **kw))

    def call(self, method, *args, **kw):
        """The same call on both; the port's result."""
        j = getattr(self.jc, method)(*args, **kw)
        t = getattr(self.tc, method)(*args, **kw)
        if method in ("delete", "delete_batch"):
            assert t == j
        return t

    def search(self, reqs):
        """``search_batch`` on both (requests built per package from
        (vector, top_k, filters, options, negative) specs); responses held
        to each other."""
        out = []
        for types in (jtypes, ttypes):
            built = [types.SearchRequest(
                vector=v, top_k=k,
                filters=[types.Filter(*f) for f in filters],
                options=types.SearchOptions(**opts),
                negative_example=neg,
            ) for v, k, filters, opts, neg in reqs]
            coll = self.jc if types is jtypes else self.tc
            out.append(coll.search_batch(built))
        for rj, rt in zip(*out):
            assert_responses_agree(rj, rt)
        return out[1]


def assert_items_agree(items_j, items_t):
    ids_j, ids_t = [i.id for i in items_j], [i.id for i in items_t]
    dj = np.asarray([[i.distance for i in items_j]], np.float32).reshape(1, -1)
    dt = np.asarray([[i.distance for i in items_t]], np.float32).reshape(1, -1)
    assert dj.shape == dt.shape, (ids_j, ids_t)
    if dj.size:
        code = {vid: n for n, vid in enumerate(dict.fromkeys(ids_j + ids_t))}
        assert_topk_agree(dt, np.asarray([[code[v] for v in ids_t]]), dj,
                          np.asarray([[code[v] for v in ids_j]]), rtol=TOL, atol=TOL)
    by_id = {i.id: i for i in items_j}
    for it in items_t:
        if it.id in by_id:
            assert it.metadata == by_id[it.id].metadata
            if by_id[it.id].vector is not None:
                np.testing.assert_array_equal(it.vector, by_id[it.id].vector)


def assert_responses_agree(rj, rt):
    assert_items_agree(rj.results, rt.results)
    assert rt.metadata.total_count == rj.metadata.total_count == len(rt.results)
    assert rt.metadata.index_size == rj.metadata.index_size
    assert rt.metadata.index_name == rj.metadata.index_name
    assert rt.metadata.strategy == rj.metadata.strategy


def req(v, k=10, filters=(), neg=None, **opts):
    return (np.asarray(v, np.float32), k, list(filters), opts, neg)


def make(n=40, metric="euclidean", **kw):
    """tests/test_collection.py's collection, in both packages."""
    rng = np.random.default_rng(0)
    b = Both.new("test", D, metric, **kw)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    mds = [{"category": "even" if i % 2 == 0 else "odd", "value": i,
            "tags": ["low" if i < n // 2 else "high"]} for i in range(n)]
    b.call("add_batch", [f"v{i}" for i in range(n)], vecs, mds)
    return b, vecs


def jitter(v, seed=0, scale=0.05):
    return (v + scale * np.random.default_rng(seed).normal(size=v.shape)).astype(np.float32)


# ------------------------------------------- tests/test_collection.py's cases


def test_basic_search_pipeline():
    b, vecs = make()
    (r,) = b.search([req(jitter(vecs[5]), 3)])
    assert r.results[0].id == "v5"
    assert r.results[0].score == pytest.approx(1.0 - r.results[0].distance)
    assert r.metadata.index_size == 40 and r.metadata.total_count == 3
    assert r.metadata.search_time_ms > 0


def test_include_vectors_and_metadata():
    b, vecs = make()
    (r,) = b.search([req(jitter(vecs[3]), 1, include_vectors=True, include_metadata=True)])
    np.testing.assert_allclose(r.results[0].vector, vecs[3], rtol=1e-6)
    assert r.results[0].metadata["category"] == "odd"


def test_device_compiled_filter_is_the_true_filtered_topk():
    b, vecs = make()
    q = jitter(vecs[0])
    (r,) = b.search([req(q, 5, [("category", "=", "even")], include_metadata=True)])
    assert len(r.results) == 5 and all(i.metadata["category"] == "even" for i in r.results)
    (full,) = b.search([req(q, 40, include_metadata=True)])
    want = [i.id for i in full.results if i.metadata["category"] == "even"][:5]
    assert [i.id for i in r.results] == want


def test_host_fallback_filter():
    b, vecs = make()
    (r,) = b.search([req(jitter(vecs[0]), 40, [("category", ">", "e")])])
    assert len(r.results) == 40
    (r,) = b.search([req(jitter(vecs[0]), 40, [("category", ">", "f")])])
    assert len(r.results) == 20 and all(int(i.id[1:]) % 2 == 1 for i in r.results)


def test_numeric_range_filters():
    b, vecs = make()
    (r,) = b.search([req(jitter(vecs[0]), 40, [("value", ">=", 10), ("value", "<", 20)])])
    assert sorted(int(i.id[1:]) for i in r.results) == list(range(10, 20))


def test_filter_no_matches():
    b, vecs = make()
    (r,) = b.search([req(jitter(vecs[0]), 5, [("category", "=", "nope")])])
    assert r.results == []


def test_search_with_facets():
    b, vecs = make()
    q = jitter(vecs[0])
    for k, spec in ((5, ("EqualityFilter", ("category", "EVEN"), {})),
                    (3, ("SetFilter", ("tags", ["high"]), {})),
                    (50, ("RangeFilter", ("value",), {"min": 35}))):
        cls, args, kw = spec
        items_j = b.jc.search_with_facets(q, k, [getattr(jflt, cls)(*args, **kw)])
        items_t = b.tc.search_with_facets(q, k, [getattr(tflt, cls)(*args, **kw)])
        assert_items_agree(items_j, items_t)
    assert sorted(int(i.id[1:]) for i in items_t) == list(range(35, 40))


def test_facets_scan_past_initial_window():
    b = Both.new("far", D, "euclidean")
    near = np.zeros((30, D), np.float32) + np.arange(30, dtype=np.float32)[:, None] * 0.01
    far = np.full((5, D), 100.0, np.float32) + np.arange(5, dtype=np.float32)[:, None]
    b.call("add_batch", [f"near{i}" for i in range(30)], near, [{"kind": "a"}] * 30)
    b.call("add_batch", [f"far{i}" for i in range(5)], far, [{"kind": "b"}] * 5)
    q = np.full(D, 0.5, np.float32)
    items_j = b.jc.search_with_facets(q, 5, [jflt.EqualityFilter("kind", "b")])
    items_t = b.tc.search_with_facets(q, 5, [tflt.EqualityFilter("kind", "b")])
    assert_items_agree(items_j, items_t)
    assert sorted(i.id for i in items_t) == [f"far{i}" for i in range(5)]


def fluent(coll, v, chain):
    f = coll.fluent_search(v)
    for name, *args in chain:
        f = getattr(f, name)(*args)
    return f.execute()


@pytest.mark.parametrize("chain", [
    [("with_k", 5), ("filter", "category", "even"), ("include_metadata",)],
    [("with_k", 40), ("filter_greater_than", "value", 5), ("filter_less_than", "value", 10)],
    [("with_k", 40), ("filter_in", "value", [3, 5, 7])],
    [("with_k", 40), ("filter_not_equals", "category", "even")],
    [("with_k", 5), ("with_negative_weight", 1.5), ("use_exact_search",)],
    [("with_k", 3), ("with_strategy", "exact"), ("include_vectors",)],
], ids=["filter", "range", "in", "not_equals", "negative_weight", "strategy"])
def test_fluent_search(chain):
    b, vecs = make()
    q = jitter(vecs[0])
    rj, rt = fluent(b.jc, q, chain), fluent(b.tc, q, chain)
    assert_responses_agree(rj, rt)
    assert rt.results


def test_fluent_negative_example():
    b, vecs = make()
    chain = [("with_k", 5), ("with_negative_example", vecs[1]), ("with_negative_weight", 1.5)]
    rj, rt = fluent(b.jc, jitter(vecs[0]), chain), fluent(b.tc, jitter(vecs[0]), chain)
    assert_responses_agree(rj, rt)
    assert len(rt.results) == 5


def test_fluent_fail_fast():
    b, _ = make()
    for coll in (b.jc, b.tc):
        with pytest.raises(ValueError, match="dimension"):
            coll.fluent_search(np.ones(3, np.float32)).execute()
        with pytest.raises(ValueError, match="positive"):
            coll.fluent_search(np.ones(D, np.float32)).with_k(0).execute()
        with pytest.raises(ValueError, match="field"):
            coll.fluent_search(np.ones(D, np.float32)).filter("", 1).execute()
        with pytest.raises(ValueError, match="strategy"):
            coll.fluent_search(np.ones(D, np.float32)).with_strategy("bogus").execute()


def test_batched_search_mixed_groups():
    b, vecs = make()
    q = [jitter(vecs[i], i) for i in range(4)]
    rs = b.search([req(q[0], 3), req(q[1], 3), req(q[2], 7, [("category", "=", "even")]),
                   req(q[3], 3), req(q[0], 4, neg=vecs[1])])
    assert [len(r.results) for r in rs] == [3, 3, 7, 3, 4]
    assert [rs[i].results[0].id for i in (0, 1, 3)] == ["v0", "v1", "v3"]
    (solo,) = b.search([req(q[2], 7, [("category", "=", "even")])])
    assert [i.id for i in rs[2].results] == [i.id for i in solo.results]


def test_update_and_delete_through_collection():
    b, vecs = make()
    target = np.full(D, 50.0, np.float32)
    b.call("update", "v5", vector=target, metadata={"category": "updated"})
    (r,) = b.search([req(jitter(target), 1, include_metadata=True)])
    assert r.results[0].id == "v5" and r.results[0].metadata["category"] == "updated"
    items = b.tc.search_with_facets(vecs[0], 40, [tflt.EqualityFilter("category", "updated")])
    assert [i.id for i in items] == ["v5"]
    b.call("update_batch", ["v6", "v7"], None, [{"category": "meta-only"}, None])
    (r,) = b.search([req(jitter(vecs[6]), 2, [("category", "=", "meta-only")])])
    assert [i.id for i in r.results] == ["v6"]
    assert b.call("delete", "v5")
    assert b.call("delete_batch", ["v8", "nope", "v9"]) == 2
    assert b.tc.size == b.jc.size == 37
    (r,) = b.search([req(jitter(target), 40)])
    assert not {"v5", "v8", "v9"} & {i.id for i in r.results}
    rj, rt = b.jc.get("v6"), b.tc.get("v6")
    assert rt.metadata == rj.metadata == {"category": "meta-only"}
    np.testing.assert_array_equal(rt.values, rj.values)


def test_empty_collection_search():
    b = Both.new("empty", D)
    (r,) = b.search([req(np.ones(D), 5)])
    assert r.results == [] and r.metadata.index_size == 0


def test_validation_errors_match_jax():
    b, vecs = make()
    for coll, types in ((b.jc, jtypes), (b.tc, ttypes)):
        with pytest.raises(ValueError, match="dimension"):
            coll.search(types.SearchRequest(vector=np.ones(3, np.float32), top_k=5))
        with pytest.raises(ValueError):
            coll.add("bad", np.ones(3, np.float32))
        with pytest.raises(ValueError, match="positive"):
            coll.search(types.SearchRequest(vector=vecs[0], top_k=0))
        with pytest.raises(ValueError, match="JSON object"):
            coll.add("x", np.ones(D, np.float32), metadata="not-a-dict")
        with pytest.raises(ValueError, match="already exists"):
            coll.add("v1", np.ones(D, np.float32))
        with pytest.raises(ValueError, match="name"):
            type(coll)("", D, device="cpu") if coll is b.tc else type(coll)("", D)


def test_auto_facet_backfill():
    b = Both.new("bf", D, "euclidean")
    b.call("add", "a", np.zeros(D, np.float32), {"old": 1})
    b.call("add", "b", np.ones(D, np.float32), {"old": 2, "new_field": "x"})
    (r,) = b.search([req(np.full(D, 0.1, np.float32), 5, [("new_field", "=", "x")])])
    assert [i.id for i in r.results] == ["b"]
    assert b.tc.get_facet_fields() == b.jc.get_facet_fields()
    b.call("set_facet_fields", ["old"])
    assert b.tc.get_facet_fields() == b.jc.get_facet_fields() == ["old"]


def test_stats():
    b, _ = make()
    sj, st = b.jc.stats(), b.tc.stats()
    for f in ("name", "dimension", "metric", "vector_count", "capacity", "facet_fields", "index"):
        assert getattr(st, f) == getattr(sj, f), f
    assert st.index == "exact" and "category" in st.facet_fields


def test_port_collection_options():
    with pytest.raises(TypeError, match="device"):
        Collection("c", D)  # the device is explicit
    # compute_dtype reaches the default exact engine, as in the reference
    bf = Collection("c", D, device="cpu", compute_dtype=torch.bfloat16)
    assert bf.engine.name == "exact" and bf.engine.compute_dtype == torch.bfloat16
    c = Collection("c", D, device="cpu", engine_factory=lambda s: make_engine("exact", s))
    assert c.wal is None and c.engine.name == "exact"
    with pytest.raises(ValueError, match="unknown index engine"):
        make_engine("bogus", c.store)
    with pytest.raises(ValueError, match="invalid config"):
        make_engine("ivf", c.store, not_a_field=1)


# ------------------------------------------------- the IVF engine, converted


IVF_CFG = dict(n_clusters=32, n_probe=4, build_threshold=256, probe_approx=None,
               background_maintenance=False)


@pytest.fixture(scope="module")
def ivf_source():
    """A JAX collection over the tests' IVF corpus (n=8192, d=32) with
    {cat, price} metadata, its engine built by its first add_batch."""
    from tests.test_torch_ivf_index import corpus

    vecs, queries = corpus()
    rng = np.random.default_rng(5)
    mds = [{"cat": int(c), "price": float(p)}
           for c, p in zip(rng.integers(0, 10, len(vecs)), rng.random(len(vecs)) * 100)]
    jc = JCollection("ivf", vecs.shape[1], "euclidean",
                     engine_factory=lambda s: JIVF(s, config=JConfig(**IVF_CFG)))
    jc.add_batch([f"v{i}" for i in range(len(vecs))], vecs, mds)
    assert jc.engine._built
    return jc, vecs, queries


def converted(jc):
    return collection_from_snapshot(
        jc.store.snapshot(), name=jc.name, metric="euclidean",
        facet_fields=jc.get_facet_fields(), topology=jc.engine.export_topology(),
        snapshot_slots=jc.store.live_slots(),
        engine_factory=lambda s: IVFIndex(s, config=IVFConfig(**IVF_CFG)), device="cpu")


def test_ivf_collection_from_snapshot_matches_jax(ivf_source):
    jc, vecs, queries = ivf_source
    tc = converted(jc)
    assert tc.size == jc.size and tc.engine.name == "ivf" and tc.engine._n_retrains == 0
    np.testing.assert_array_equal(tc.engine._block_slot.numpy(), np.asarray(jc.engine._block_slot))
    np.testing.assert_array_equal(tc.engine._slot_pos, jc.engine._slot_pos)
    np.testing.assert_array_equal(tc.store.live_slots(), jc.store.live_slots())
    b = Both(jc, tc)
    forms = [(), [("cat", "=", 3)], [("price", ">", 25.0), ("price", "<", 75.0)]]
    for filters in forms:
        rs = b.search([req(q, 10, filters, include_metadata=True) for q in queries])
        for r in rs:
            for f, op, v in filters:
                for it in r.results:
                    assert {"=": it.metadata[f] == v, ">": it.metadata[f] > v,
                            "<": it.metadata[f] < v}[op]
    assert tc.stats().index == jc.stats().index == "ivf"


def test_ivf_collection_writes_match_jax(ivf_source):
    """Updates (new vectors and cat) and deletes through both converted
    collections: the updated rows are found at their new vectors with
    their new cat, the cat filter follows, deleted ids never return."""
    jc0, vecs, queries = ivf_source
    b = Both(JCollection("ivf", vecs.shape[1], "euclidean",
                         engine_factory=lambda s: JIVF(s, config=JConfig(**IVF_CFG))),
             converted(jc0))
    ids, rows, mds = jc0.store.snapshot()
    b.jc.load_rows(ids, rows, mds)
    b.jc.engine.import_topology(jc0.engine.export_topology(), np.arange(b.jc.store.capacity))
    from tests.test_torch_ivf_writes import blob_rows

    upd = [f"v{i}" for i in range(100, 164)]
    new = blob_rows(64, seed=77)
    new_cat = [{"cat": 11, "price": 1.0}] * 64
    b.call("update_batch", upd, new, new_cat)
    gone = [f"v{i}" for i in range(200, 264)]
    assert b.call("delete_batch", gone) == 64
    rs = b.search([req(jitter(v), 10, include_metadata=True) for v in new])
    assert np.mean([r.results[0].id == u for r, u in zip(rs, upd)]) >= 0.95
    assert all(r.results[0].metadata["cat"] == 11 for r, u in zip(rs, upd) if r.results[0].id == u)
    rs = b.search([req(jitter(v), 10, [("cat", "=", 11)]) for v in new])
    assert all({i.id for i in r.results} <= set(upd) for r in rs)
    rs = b.search([req(q, 10) for q in queries])
    assert not set(gone) & {i.id for r in rs for i in r.results}
