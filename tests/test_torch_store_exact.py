"""quiver_tpu_torch's store, flat scan and exact index against quiver_tpu.

Seeded numpy inputs go through both packages. Tolerances: distances at
rtol/atol 1e-5 (f32 products in both — the JAX side at
``precision="highest"`` — only the summation order differs); result ids
agree wherever the reference's distances are separated by more than that
tolerance from the k-th (ties may resolve either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.core import store as jstore
from quiver_tpu.index.exact import ExactIndex as JExactIndex
from quiver_tpu.ops import scan as jscan
from quiver_tpu_torch.core import store as tstore
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.ops import scan as tscan

RTOL = ATOL = 1e-5
METRICS = ["cosine", "euclidean", "squared_euclidean", "dot_product", "manhattan"]


def assert_topk_agree(d_got, i_got, d_want, i_want, *, rtol=RTOL, atol=ATOL):
    """Per-position distances agree within rtol/atol; the id sets agree on
    every entry the reference places strictly inside its k-th distance
    (more than the tolerance away from it)."""
    d_got, d_want = np.asarray(d_got), np.asarray(d_want)
    i_got, i_want = np.asarray(i_got), np.asarray(i_want)
    assert d_got.shape == d_want.shape and i_got.shape == i_want.shape
    np.testing.assert_allclose(d_got, d_want, rtol=rtol, atol=atol)
    for b in range(d_want.shape[0]):
        kth = d_want[b, -1]
        tol = atol + rtol * abs(kth)
        inside_w = {int(i) for i, d in zip(i_want[b], d_want[b]) if d < kth - tol}
        inside_g = {int(i) for i, d in zip(i_got[b], d_got[b]) if d < kth - tol}
        assert inside_w <= set(i_got[b].tolist()), (b, inside_w, i_got[b])
        assert inside_g <= set(i_want[b].tolist()), (b, inside_g, i_want[b])


def _stores(metric, n=300, d=16, seed=0, deleted=(3, 50, 51)):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[7] = 0.0  # a zero row (cosine guard)
    js = jstore.VectorStore(dim=d, metric=metric)
    ts = tstore.VectorStore(dim=d, metric=metric, device="cpu")
    ids = [f"v{i}" for i in range(n)]
    for s in (js, ts):
        s.add_batch(ids, vecs)
        s.delete_batch([ids[i] for i in deleted])
    return js, ts, vecs


def test_capacity_ladder_matches_jax():
    for n in [0, 1, 767, 768, 769, 1024, 1025, 1536, 1537, 3000, 100_000, 1_000_000]:
        assert tstore._next_cap(n) == jstore._next_cap(n), n


def test_store_growth_and_slots_match_jax():
    rng = np.random.default_rng(1)
    js = jstore.VectorStore(dim=8, metric="euclidean")
    ts = tstore.VectorStore(dim=8, metric="euclidean", device="cpu")
    for step, n in enumerate([500, 600, 900, 1500]):
        vecs = rng.normal(size=(n, 8)).astype(np.float32)
        ids = [f"s{step}_{i}" for i in range(n)]
        np.testing.assert_array_equal(js.add_batch(ids, vecs), ts.add_batch(ids, vecs))
        assert js.capacity == ts.capacity and js.size == ts.size
    gone = [f"s1_{i}" for i in range(0, 600, 7)]
    assert js.delete_batch(gone) == ts.delete_batch(gone)
    vecs = rng.normal(size=(40, 8)).astype(np.float32)
    ids = [f"r{i}" for i in range(40)]
    # freed slots are reused in the same order
    np.testing.assert_array_equal(js.add_batch(ids, vecs), ts.add_batch(ids, vecs))
    with pytest.raises(ValueError):
        ts.add_batch(["r0"], vecs[:1])
    np.testing.assert_array_equal(
        ts._np_vectors[ts._id_to_slot["r3"]], js.get("r3").values)


def test_device_view_contents_track_mutations():
    rng = np.random.default_rng(2)
    js = jstore.VectorStore(dim=12, metric="cosine")
    ts = tstore.VectorStore(dim=12, metric="cosine", device="cpu")

    def check():
        jv, tv = js.device_view(), ts.device_view()
        assert jv.capacity == tv.capacity
        np.testing.assert_array_equal(tv.vectors.numpy(), np.asarray(jv.vectors))
        np.testing.assert_array_equal(tv.valid.numpy(), np.asarray(jv.valid))
        np.testing.assert_allclose(tv.norms_sq.numpy(), np.asarray(jv.norms_sq), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tv.inv_norms.numpy(), np.asarray(jv.inv_norms), rtol=RTOL, atol=ATOL)
        assert tv.vectors.device.type == "cpu" and tv.vectors.dtype == torch.float32

    vecs = rng.normal(size=(200, 12)).astype(np.float32)
    ids = [f"v{i}" for i in range(200)]
    for s in (js, ts):
        s.add_batch(ids, vecs)
    check()  # full resync
    view = ts.device_view()
    new = rng.normal(size=(5, 12)).astype(np.float32)
    for s in (js, ts):
        s.delete_batch(ids[100:103])
        s.add_batch([f"x{i}" for i in range(5)], new)  # reuses freed slots
    check()  # incremental scatter
    assert ts.device_view().vectors is view.vectors  # updated in place


def test_cuda_store_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstore.VectorStore(dim=4, device="cuda")


def _scan_inputs(metric, mask_kind, seed=3):
    rng = np.random.default_rng(seed)
    cap, d, B = 512, 16, 6
    vecs = rng.normal(size=(cap, d)).astype(np.float32)
    vecs[11] = 0.0
    valid = rng.random(cap) > 0.1
    q = rng.normal(size=(B, d)).astype(np.float32)
    if mask_kind == "none":
        mask = None
    elif mask_kind == "corpus":
        mask = rng.random(cap) > 0.3
    else:
        mask = rng.random((B, cap)) > 0.3
    return q, vecs, valid, mask


@pytest.mark.parametrize("mask_kind", ["none", "corpus", "per_query"])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_scan_topk_matches_jax(metric, mask_kind):
    q, vecs, valid, mask = _scan_inputs(metric, mask_kind)
    ns = np.sum(vecs * vecs, axis=1)
    inv = np.where(ns > 0, 1.0 / np.sqrt(np.maximum(ns, 1e-30)), 0.0).astype(np.float32)
    dj, ij = jscan.flat_scan_topk(
        jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(valid),
        None if mask is None else jnp.asarray(mask), jnp.asarray(ns),
        jnp.asarray(inv), metric=metric, k=10, tile=128, precision="highest",
    )
    dt, it = tscan.flat_scan_topk(
        torch.from_numpy(q), torch.from_numpy(vecs), torch.from_numpy(valid),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(ns), torch.from_numpy(inv), metric=metric, k=10, tile=128,
    )
    assert_topk_agree(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij))
    keep = valid[None, :] if mask is None else valid[None, :] & (mask if mask.ndim == 2 else mask[None, :])
    for b in range(q.shape[0]):
        assert all(keep[b % keep.shape[0], s] for s in it[b].tolist() if s >= 0)


@pytest.mark.parametrize("metric", METRICS)
def test_flat_scan_tiled_path_matches_jax(metric, monkeypatch):
    """The tiled running-merge path (forced by a tiny single-shot budget)
    gives the reference's answers."""
    monkeypatch.setattr(tscan, "SINGLE_SHOT_BUDGET_BYTES", 1024)
    q, vecs, valid, mask = _scan_inputs(metric, "corpus", seed=4)
    ns = np.sum(vecs * vecs, axis=1)
    inv = np.where(ns > 0, 1.0 / np.sqrt(np.maximum(ns, 1e-30)), 0.0).astype(np.float32)
    dj, ij = jscan.flat_scan_topk(
        jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(valid), jnp.asarray(mask),
        jnp.asarray(ns), jnp.asarray(inv), metric=metric, k=7, precision="highest",
    )
    dt, it = tscan.flat_scan_topk(
        torch.from_numpy(q), torch.from_numpy(vecs), torch.from_numpy(valid),
        torch.from_numpy(mask), torch.from_numpy(ns), torch.from_numpy(inv),
        metric=metric, k=7, tile=100,
    )
    assert_topk_agree(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij))


@pytest.mark.parametrize("metric", METRICS)
def test_exact_index_search_slots_matches_jax(metric):
    js, ts, vecs = _stores(metric)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    mask = rng.random(ts.capacity) > 0.2
    for kw in ({}, {"mask": mask}):
        dj, ij = JExactIndex(js).search_slots(q, 10, **kw)
        dt, it = ExactIndex(ts).search_slots(q, 10, **kw)
        assert dt.dtype == np.float32 and it.shape == (9, 10)
        assert_topk_agree(dt, it, dj, ij)
        assert not {3, 50, 51} & set(it.ravel().tolist())  # deleted rows


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_exact_index_negative_rerank_matches_jax(metric):
    js, ts, vecs = _stores(metric, seed=6)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    neg = rng.normal(size=(4, 16)).astype(np.float32)
    dj, ij = JExactIndex(js).search_slots(q, 5, negative=neg, negative_weight=0.7)
    dt, it = ExactIndex(ts).search_slots(q, 5, negative=neg, negative_weight=0.7)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_negative_rerank_matches_jax(metric):
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    idx = rng.integers(0, 64, size=(3, 12)).astype(np.int32)
    idx[1, 4] = -1  # empty candidate
    dist = np.sort(rng.random((3, 12)).astype(np.float32), axis=1)
    neg = rng.normal(size=(3, 8)).astype(np.float32)
    dj, ij = jscan.negative_rerank(
        jnp.asarray(dist), jnp.asarray(idx), jnp.asarray(vecs), jnp.asarray(neg),
        metric=metric, k=5, weight=0.4,
    )
    dt, it = tscan.negative_rerank(
        torch.from_numpy(dist), torch.from_numpy(idx).long(), torch.from_numpy(vecs),
        torch.from_numpy(neg), metric=metric, k=5, weight=0.4,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL, atol=ATOL)


def test_row_stats_and_tf32_guard():
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(10, 4)).astype(np.float32))
    ns, inv = tscan.compute_row_stats(x)
    np.testing.assert_allclose(inv.numpy(), 1.0 / np.sqrt(ns.numpy()), rtol=RTOL)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            tscan.require_ieee_f32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    tscan.require_ieee_f32()


# ------------------------------------------- the exact engine's keywords (F3)


def test_exact_index_constructor_keywords_match_jax():
    """The reference's constructions (tests/test_store_exact.py:93,175) and
    the registry's: tile, compute_dtype, approx_recall, precision; the
    precision resolves as the reference's does."""
    from quiver_tpu.index import make_engine as j_make_engine
    from quiver_tpu_torch.index import make_engine, resolve_engine_config

    js, ts, _ = _stores("euclidean")
    for jkw, tkw in (({}, {}), ({"tile": 1024}, {"tile": 1024}),
                     ({"compute_dtype": jnp.float32}, {"compute_dtype": torch.float32}),
                     ({"compute_dtype": jnp.bfloat16}, {"compute_dtype": torch.bfloat16}),
                     ({"approx_recall": 0.95}, {"approx_recall": 0.95}),
                     ({"precision": "highest"}, {"precision": "highest"}),
                     ({"precision": None}, {"precision": None})):
        j, t = JExactIndex(js, **jkw), ExactIndex(ts, **tkw)
        assert (t.tile, t.approx_recall, t.precision) == (j.tile, j.approx_recall, j.precision)
        assert t.compute_dtype == tkw.get("compute_dtype", torch.float32)
        assert make_engine("exact", ts, **tkw).precision == j_make_engine("exact", js, **jkw).precision
    assert make_engine("exact", ts, **resolve_engine_config("exact", {"tile": 1024})).tile == 1024
    for bad in ({"compute_dtype": torch.float16}, {"tile": 0}, {"approx_recall": 1.5},
                {"precision": "high"}):
        with pytest.raises(ValueError):
            make_engine("exact", ts, **bad)


def test_capacity_growth_with_a_small_tile_matches_jax():
    """tile=1024 over a store grown past it (test_capacity_growth_preserves_data):
    the tiled scan finds each row, as the reference's does."""
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(3000, 8)).astype(np.float32)
    js = jstore.VectorStore(dim=8, metric="euclidean", capacity=1024)
    ts = tstore.VectorStore(dim=8, metric="euclidean", capacity=1024, device="cpu")
    for s in (js, ts):
        s.add_batch([f"a{i}" for i in range(3000)], vecs)
    assert ts.capacity == js.capacity >= 3000
    q = vecs[:4] + 0.01
    dj, ij = JExactIndex(js, tile=1024).search_slots(q, 5)
    dt, it = ExactIndex(ts, tile=1024).search_slots(q, 5)
    assert_topk_agree(dt, it, dj, ij)
    assert [ts.id_of(int(s)) for s in it[:, 0]] == [f"a{i}" for i in range(4)]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "manhattan"])
def test_bf16_corpus_scan_matches_jax(metric):
    """compute_dtype=bf16 scans a cached bf16 copy of the corpus (bf16
    query, f32 sums) and rescores the winners against it, as the
    reference's _corpus mode does: the same answers within the tolerance;
    recall@10 >= 0.9 against the f32 oracle (test_bfloat16_fast_path_recall);
    the copy follows the store's writes."""
    js, ts, _ = _stores(metric, n=500, d=64, seed=7, deleted=())
    rng = np.random.default_rng(8)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    dj, ij = JExactIndex(js, compute_dtype=jnp.bfloat16).search_slots(q, 10)
    t16 = ExactIndex(ts, compute_dtype=torch.bfloat16)
    dt, it = t16.search_slots(q, 10)
    assert_topk_agree(dt, it, dj, ij)
    _, s32 = ExactIndex(ts).search_slots(q, 10)
    assert np.mean([len(set(s32[b]) & set(it[b])) / 10 for b in range(8)]) >= 0.9
    assert t16._v16.dtype == torch.bfloat16
    target = np.full(64, 3.0, np.float32)
    ts.update_batch(["v9"], [target])
    assert t16.search(target, 1)[0][0] == "v9"  # the cache was rebuilt


def test_approx_recall_is_served_by_exact_topk():
    js, ts, _ = _stores("euclidean")
    q = np.random.default_rng(4).normal(size=(5, 16)).astype(np.float32)
    da, ia = ExactIndex(ts, approx_recall=0.9).search_slots(q, 10)
    de, ie = ExactIndex(ts).search_slots(q, 10)
    np.testing.assert_array_equal(ia, ie)
    np.testing.assert_array_equal(da, de)


# ------------------------------------------------- ExactIndex.search (F4)


def test_single_query_search_matches_jax():
    """search(query, k) -> [(id, distance)], the reference's cases
    (tests/test_store_exact.py:58-124): sorted, k capped at the size,
    deletes and updates honored, an empty store."""
    js, ts, vecs = _stores("euclidean", n=20, deleted=())
    j, t = JExactIndex(js), ExactIndex(ts)

    def agree(vec, k):
        rj, rt = j.search(vec, k), t.search(vec, k)
        assert [i for i, _ in rt] == [i for i, _ in rj]
        np.testing.assert_allclose([d for _, d in rt], [d for _, d in rj], rtol=RTOL, atol=ATOL)
        return rt

    res = agree(np.ones(16, np.float32), 30)
    assert len(res) == 20 and [d for _, d in res] == sorted(d for _, d in res)
    for s in (js, ts):
        assert s.delete("v3") and not s.delete("v3")
    res = agree(vecs[3], 20)
    assert "v3" not in [i for i, _ in res] and len(res) == 19
    target = np.full(16, 9.0, np.float32)
    for s in (js, ts):
        s.update_batch(["v2"], [target])
    res = agree(target, 1)
    assert res[0][0] == "v2" and res[0][1] == pytest.approx(0.0, abs=1e-4)
    empty = tstore.VectorStore(dim=4, device="cpu")
    assert ExactIndex(empty).search(np.ones(4, np.float32), k=5) == []
