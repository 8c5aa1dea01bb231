"""The engines' shared query path (``index/query.py``) and the exact
engine's negative rerank, on the CPU at small sizes with seeded data.

* ``supplement`` on arrays: with no short row it returns its input and
  never scans; short rows are padded to k and merged, and the input arrays
  are not written;
* the graph engines (HNSW, and sharded HNSW on two CPU shards) with their
  device path cut short: rows with holes, and rows narrower than k, come
  back as the merge of the rows padded to k with the exact scan's, row for
  row and bit for bit, every row full (the IVF engine's cases are in
  ``test_torch_ivf_fill.py``);
* ``ExactIndex.rerank_negative`` bit for bit against the IVF engine's
  former host path on the same candidates (numpy in, the negative
  broadcast on the host, numpy out), from host arrays and from tensors.
"""

import numpy as np
import pytest
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index import hnsw as hnsw_mod
from quiver_tpu_torch.index import query as query_mod
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.hnsw import HNSWIndex
from quiver_tpu_torch.ops.scan import MASKED_DIST, negative_rerank
from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex

from tests.torch_threads import one_torch_thread  # noqa: F401

D, K = 16, 10


def corpus(n, metric="euclidean", seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    store = VectorStore(dim=D, metric=metric, capacity=n, device="cpu")
    store.add_batch([f"v{i}" for i in range(n)], vecs)
    q = (vecs[:12] + 0.1 * rng.normal(size=(12, D))).astype(np.float32)
    return store, vecs, q


def test_supplement_pads_merges_and_leaves_its_input():
    dist = np.array([[0.1, 0.2, 0.3], [0.5, MASKED_DIST, MASKED_DIST]], np.float32)
    idx = np.array([[4, 7, 9], [2, -1, -1]], np.int64)
    e_dist = np.array([[0.1, 0.2, 0.25, 0.3], [0.4, 0.5, 0.6, 0.7]], np.float32)
    e_idx = np.array([[4, 7, 8, 9], [3, 2, 5, 6]], np.int64)
    d0, i0 = dist.copy(), idx.copy()
    scans = []

    def exact_scan(n_short):
        scans.append(n_short)
        return e_dist, e_idx

    # every row full at k = 3: the input comes back, no scan
    d, i, n = query_mod.supplement(dist[:1], idx[:1], 3, 100, exact_scan)
    assert n == 0 and scans == []
    np.testing.assert_array_equal(d, dist[:1])
    np.testing.assert_array_equal(i, idx[:1])
    # k = 4: both rows are narrower than k, so both are short
    d, i, n = query_mod.supplement(dist, idx, 4, 100, exact_scan)
    assert n == 2 and scans == [2] and d.shape == i.shape == (2, 4)
    np.testing.assert_array_equal(i, [[4, 7, 8, 9], [3, 2, 5, 6]])
    np.testing.assert_array_equal(d, e_dist[[0, 1]])
    # a fill count made elsewhere decides, and a store of 2 rows wants 2
    d, i, n = query_mod.supplement(dist, idx, 3, 2, exact_scan, fill=np.array([3, 1]))
    assert n == 1 and scans == [2, 1]
    np.testing.assert_array_equal(i, [[4, 7, 9], [3, 2, 5]])
    np.testing.assert_array_equal(dist, d0)
    np.testing.assert_array_equal(idx, i0)


def cut(case, bd, bi):
    """A device result cut short: two rows with holes past column 3, or
    every row narrower than k."""
    if case.endswith("narrow"):
        return bd[:, :K - 4], bi[:, :K - 4]
    bd, bi = bd.clone(), bi.clone()
    bd[:2, 3:], bi[:2, 3:] = MASKED_DIST, -1
    return bd, bi


@pytest.mark.parametrize("case", ["hnsw-holes", "hnsw-narrow", "sharded-hnsw-holes",
                                  "sharded-hnsw-narrow"])
def test_graph_engines_supplement_cut_rows(case, monkeypatch):
    store, vecs, q = corpus(400)
    if case.startswith("sharded"):
        eng = ShardedHNSWIndex(store, 2, ef_search=32, build_batch=256)
        eng.on_insert(np.arange(400), vecs)
        real = eng.search_device
        monkeypatch.setattr(eng, "search_device", lambda *a, **kw: cut(case, *real(*a, **kw)))
        device = lambda: eng.search_device(torch.from_numpy(q), 32, K)  # noqa: E731
    else:
        eng = HNSWIndex(store, ef_search=32, build_batch=256)
        eng.on_insert(np.arange(400), vecs)
        real = hnsw_mod.beam_search
        monkeypatch.setattr(hnsw_mod, "beam_search", lambda *a, **kw: cut(case, *real(*a, **kw)))
        device = lambda: eng.search_device(torch.from_numpy(q), 32)  # noqa: E731
    bd, bi = device()
    want_d, want_i = bd[:, :K].numpy(), bi[:, :K].numpy()
    short = np.flatnonzero((want_i >= 0).sum(axis=1) < K)
    assert len(short) == (2 if case.endswith("holes") else len(q))
    e_dist, e_idx = eng._exact.search_slots(q, K)
    pad = ((0, 0), (0, K - want_d.shape[1]))
    want_d = np.pad(want_d, pad, constant_values=MASKED_DIST)
    want_i = np.pad(want_i, pad, constant_values=-1)
    for b in short:
        want_d[b], want_i[b] = query_mod.merge_rows(want_d[b], want_i[b], e_dist[b], e_idx[b], K)

    dist, idx = eng.search_slots(q, K)
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_array_equal(dist, want_d)
    assert (idx >= 0).all()


def former_ivf_rerank(store, q, dist, idx, negative, weight, k):
    """The IVF engine's negative rerank as it was written in the engine:
    numpy candidates to the device, the negative broadcast on the host."""
    dev = store.device
    neg = np.asarray(negative, np.float32)
    if neg.ndim == 1:
        neg = np.broadcast_to(neg[None, :], q.shape)
    d2, i2 = negative_rerank(
        torch.as_tensor(dist, device=dev), torch.as_tensor(idx, device=dev),
        store.device_view().vectors, torch.as_tensor(np.ascontiguousarray(neg), device=dev),
        metric=store.metric, k=k, weight=weight,
    )
    return d2.cpu().numpy(), i2.cpu().numpy()


@pytest.mark.parametrize("inputs", ["numpy", "tensor"])
@pytest.mark.parametrize("negative", ["one", "per-row"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product", "manhattan"])
def test_exact_rerank_negative_matches_the_former_ivf_path(metric, negative, inputs):
    store, vecs, q = corpus(300, metric, seed=5)
    eng = ExactIndex(store)
    dist, idx = eng.search_slots(q, 30)
    dist[1, 20:], idx[1, 20:] = MASKED_DIST, -1  # a row with empty candidates
    neg = vecs[100] if negative == "one" else vecs[100:112]
    want_d, want_i = former_ivf_rerank(store, q, dist, idx, neg, 0.3, K)
    if inputs == "tensor":
        dist, idx = torch.from_numpy(dist), torch.from_numpy(idx)
    d, i = eng.rerank_negative(q, dist, idx, neg, 0.3, K)
    assert isinstance(d, torch.Tensor) and d.device == store.device
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(d.numpy(), want_d)
