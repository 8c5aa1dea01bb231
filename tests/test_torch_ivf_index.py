"""The slice end to end: ``quiver_tpu_torch`` VectorStore + IVFIndex against
``quiver_tpu``'s, at n=8192, d=32 (64 Gaussian blobs, 64 jittered queries).

A JAX ``IVFIndex`` is built once; its exported topology is imported into a
fresh engine of each package, so both serve the same block layout. Then:
``search_slots`` agrees (exact-rescore distances at rtol/atol 1e-4, ids
wherever separated from the k-th; score-derived distances within the
quantization bound of tests/test_torch_ivf_query.py), including the
overflow merge, the under-fill supplement and the negative rerank; the
port's own ``build()`` from the same seed reaches the JAX build's tie-aware
recall@10 within 0.01; ``formulation="einsum"`` serves as the reference's
does, and every engine kind of the registry builds.
"""

import numpy as np
import pytest
import torch

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.index.ivf import IVFIndex as JIVF
from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore

from tests.test_torch_store_exact import assert_topk_agree

N, D, KTOP = 8192, 32, 10
CFG = dict(n_clusters=32, n_probe=4, build_threshold=256, probe_approx=None)


def corpus(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 64, N)] + 0.25 * rng.normal(size=(N, D))).astype(np.float32)
    queries = (vecs[:64] + 0.1 * rng.normal(size=(64, D))).astype(np.float32)
    return vecs, queries


@pytest.fixture(scope="module")
def jax_topology():
    vecs, queries = corpus()
    store = JStore(dim=D, metric="euclidean", capacity=N)
    store.add_batch([f"v{i}" for i in range(N)], vecs)
    eng = JIVF(store, config=JConfig(**CFG))
    eng.build()
    return vecs, queries, eng.export_topology()


def engines(jax_topology, metric="euclidean", **cfg):
    """A JAX and a port engine, both importing the same topology."""
    vecs, _, topo = jax_topology
    ids = [f"v{i}" for i in range(N)]
    js = JStore(dim=D, metric=metric, capacity=N)
    ts = VectorStore(dim=D, metric=metric, capacity=N, device="cpu")
    js.add_batch(ids, vecs)
    ts.add_batch(ids, vecs)
    je = JIVF(js, config=JConfig(**dict(CFG, **cfg)))
    te = IVFIndex(ts, config=IVFConfig(**dict(CFG, **cfg)))
    remap = np.arange(js.capacity)
    je.import_topology(topo, remap)
    te.import_topology(topo, remap)
    return je, te


def agree(got, want, rescore=True):
    (dt, it), (dj, ij) = got, want
    assert dt.shape == dj.shape and it.shape == ij.shape
    if rescore:
        assert_topk_agree(dt, it, dj, ij, rtol=1e-4, atol=1e-4)
    else:
        # score-derived L2 distances: compare d^2 within two 5-bit quanta
        # of the score (|q|^2 scale) plus 8 f32 ulps of it
        assert_topk_agree(dt ** 2, it, dj ** 2, ij, rtol=0.0, atol=2e-3)


def tie_recall(slots, queries, vecs, k=KTOP):
    d_all = ((queries[:, None, :].astype(np.float64) - vecs[None].astype(np.float64)) ** 2).sum(2)
    kth = np.sort(d_all, axis=1)[:, k - 1]
    d_got = np.take_along_axis(d_all, np.maximum(slots, 0), axis=1)
    return float(np.mean((d_got <= kth[:, None] * (1 + 1e-6)) & (slots >= 0)))


def test_imported_layout_is_identical(jax_topology):
    je, te = engines(jax_topology)
    np.testing.assert_array_equal(te._block_slot.numpy(), np.asarray(je._block_slot))
    np.testing.assert_array_equal(
        te._blocks_t.view(torch.int16).numpy(), np.asarray(je._blocks_t).view(np.int16))
    np.testing.assert_array_equal(te._block_keep.numpy(), np.asarray(je._block_keep))
    np.testing.assert_allclose(te._block_ns.numpy(), np.asarray(je._block_ns), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te._block_inv.numpy(), np.asarray(je._block_inv), rtol=1e-5)
    assert te._cmax == je._cmax and te.n_clusters == je.n_clusters
    np.testing.assert_array_equal(te._slot_pos, je._slot_pos)


@pytest.mark.parametrize("formulation", ["pairs", "fused", "einsum"])
@pytest.mark.parametrize("rescore", [True, False])
def test_search_slots_matches_jax(jax_topology, formulation, rescore):
    _, queries, _ = jax_topology
    je, te = engines(jax_topology, formulation=formulation, rescore=rescore)
    agree(te.search_slots(queries, KTOP), je.search_slots(queries, KTOP), rescore)


def test_overflow_merge_matches_jax(jax_topology):
    """Rows moved out of the blocks into the exactly scanned overflow set
    are found again through the merge, identically in both packages."""
    vecs, queries, _ = jax_topology
    je, te = engines(jax_topology)
    moved = np.arange(0, 64, 2)  # half of the queries' own source rows
    for eng in (je, te):
        eng._vacate_slots(moved)
        eng._overflow.update(int(s) for s in moved)
    dt, it = te.search_slots(queries, KTOP)
    agree((dt, it), je.search_slots(queries, KTOP))
    assert np.mean(it[moved, 0] == moved) >= 0.9  # served from overflow


def test_underfill_supplement_matches_jax(jax_topology):
    """A corpus-wide mask that leaves the probed clusters short of k live
    rows: the exact supplement fills the rows, identically."""
    vecs, queries, _ = jax_topology
    je, te = engines(jax_topology)
    mask = np.random.default_rng(3).random(je.store.capacity) < 0.004
    dt, it = te.search_slots(queries, KTOP, mask=mask)
    dj, ij = je.search_slots(queries, KTOP, mask=mask)
    assert (it >= 0).sum(1).min() == KTOP  # filled to k
    agree((dt, it), (dj, ij))
    assert mask[it].all()


def test_negative_rerank_through_search_matches_jax(jax_topology):
    vecs, queries, _ = jax_topology
    je, te = engines(jax_topology)
    neg = vecs[100:164]
    dt, it = te.search_slots(queries, KTOP, negative=neg, negative_weight=0.3)
    dj, ij = je.search_slots(queries, KTOP, negative=neg, negative_weight=0.3)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layer", ["overflow", "supplement", "negative"])
def test_einsum_search_layers_match_jax(jax_topology, layer):
    """search_slots' host layers over formulation="einsum": the overflow
    merge, the under-fill supplement and the negative rerank, as the three
    tests above run them over pairs."""
    vecs, queries, _ = jax_topology
    je, te = engines(jax_topology, formulation="einsum")
    kw = {}
    if layer == "overflow":
        moved = np.arange(0, 64, 2)
        for eng in (je, te):
            eng._vacate_slots(moved)
            eng._overflow.update(int(s) for s in moved)
    elif layer == "supplement":
        kw["mask"] = np.random.default_rng(3).random(je.store.capacity) < 0.004
    else:
        kw.update(negative=vecs[100:164], negative_weight=0.3)
    dt, it = te.search_slots(queries, KTOP, **kw)
    agree((dt, it), je.search_slots(queries, KTOP, **kw))
    if layer == "overflow":
        assert np.mean(it[moved, 0] == moved) >= 0.9  # served from overflow
    elif layer == "supplement":
        assert (it >= 0).sum(1).min() == KTOP and kw["mask"][it].all()


def test_exact_routes_match_jax(jax_topology):
    """Small corpora and Manhattan go to the exact scan in both packages;
    an empty batch returns empty arrays."""
    vecs, queries, _ = jax_topology
    for metric, n in (("euclidean", 40), ("manhattan", 2000)):
        js = JStore(dim=D, metric=metric)
        ts = VectorStore(dim=D, metric=metric, device="cpu")
        for s in (js, ts):
            s.add_batch([f"v{i}" for i in range(n)], vecs[:n])
        je = JIVF(js, config=JConfig(**CFG))
        te = IVFIndex(ts, config=IVFConfig(**CFG))
        agree(te.search_slots(queries[:8], 5), je.search_slots(queries[:8], 5))
    d, i = te.search_slots(np.zeros((0, D), np.float32), 5)
    assert d.shape == (0, 5) and i.shape == (0, 5)


def test_port_build_reaches_jax_recall(jax_topology):
    """The port's own k-means build (same seed, same numpy draws) serves the
    same recall as the JAX build within 0.01."""
    vecs, queries, topo = jax_topology
    je, _ = engines(jax_topology)
    ts = VectorStore(dim=D, metric="euclidean", capacity=N, device="cpu")
    ts.add_batch([f"v{i}" for i in range(N)], vecs)
    te = IVFIndex(ts, config=IVFConfig(**CFG))
    te.build()
    assert te.n_clusters == len(topo["centroids"])
    r_t = tie_recall(te.search_slots(queries, KTOP)[1], queries, vecs)
    r_j = tie_recall(je.search_slots(queries, KTOP)[1], queries, vecs)
    assert r_t >= r_j - 0.01, (r_t, r_j)
    # the port's topology round-trips through both packages
    exported = te.export_topology()
    js2 = JStore(dim=D, metric="euclidean", capacity=N)
    js2.add_batch([f"v{i}" for i in range(N)], vecs)
    je2 = JIVF(js2, config=JConfig(**CFG))
    je2.import_topology(exported, np.arange(js2.capacity))
    agree(te.search_slots(queries, KTOP), je2.search_slots(queries, KTOP))


def test_unported_parts_raise(jax_topology):
    from quiver_tpu_torch.index import make_engine, resolve_engine_config
    from quiver_tpu_torch.ops.ivf_kernels import probe_stage

    _, queries, _ = jax_topology
    je, te = engines(jax_topology, formulation="einsum")
    # einsum is ported: held to the reference, at a q_cap that drops pairs
    je.config.q_cap_factor = te.config.q_cap_factor = 1
    cent, c_ns = te._cent_dev
    probe = probe_stage(torch.from_numpy(queries), cent, c_ns, te.store.metric, 4,
                        te.config.probe_sel_approx)[2]
    assert torch.bincount(probe.reshape(-1)).max() > te._q_cap(len(queries), 4, te.n_clusters)
    agree(te.search_slots(queries, KTOP), je.search_slots(queries, KTOP))
    # the sharded kinds are ported too: each builds and resolves its config
    for kind in ("sharded_exact", "sharded_hnsw", "sharded_ivf", "sharded_hybrid"):
        assert make_engine(kind, te.store).name in (kind, "hybrid")
        assert resolve_engine_config(kind, {}) == {}
    # the graph engine and the hybrid with either backend are ported
    assert make_engine("hnsw", te.store).name == "hnsw"
    assert make_engine("hybrid", te.store).ann_backend == "ivf"
    assert make_engine("hybrid", te.store, ann_backend="hnsw").ann.name == "hnsw"


def test_fused_and_device_checks(jax_topology):
    _, queries, _ = jax_topology
    je, te = engines(jax_topology, metric="cosine", formulation="fused")
    with pytest.raises(ValueError, match="fused formulation unsupported"):
        te.search_slots(queries, KTOP)
    te.config.formulation = "pairs"
    with pytest.raises(ValueError, match="queries on meta"):
        te.search_slots_device(torch.empty(4, D, device="meta"), KTOP)
    unbuilt = IVFIndex(te.store, config=IVFConfig(**CFG))
    with pytest.raises(RuntimeError, match="not built"):
        unbuilt.search_slots_device(torch.from_numpy(queries), KTOP)
