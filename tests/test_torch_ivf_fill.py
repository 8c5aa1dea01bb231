"""The IVF engine's under-fill test from a per-row fill count made on the
device (``IVFIndex.search_slots``).

Where no overflow merge and no negative rerank rewrite the device's rows,
the engine counts each row's live entries beside the query and the host
reads B counts; otherwise it counts them on the host from the final rows
(``get_detailed_metrics()["search"]["fill_host_checks"]``). Every case
here holds ``search_slots`` to :func:`host_path`, the engine's path with
the host's count on the same engine state: the same short rows, row for
row, and the same ``(dist, slots)`` arrays, over the pairs stage (windowed
and row mode), fused, einsum, rescore on and off, f32 blocks, a slot mask,
tombstoned rows, a corpus whose probed clusters leave rows short, query
rows holding NaN and inf, overflow rows, a negative, and two shards.
"""

import numpy as np
import pytest
import torch

from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
from quiver_tpu_torch.index import query as query_mod
from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

from tests.torch_threads import one_torch_thread  # noqa: F401

D = 32
CFG = dict(n_clusters=16, n_probe=2, build_threshold=256, probe_approx=None,
           background_maintenance=False)


def corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 64, n)] + 0.25 * rng.normal(size=(n, D))).astype(np.float32)
    queries = (vecs[:48] + 0.1 * rng.normal(size=(48, D))).astype(np.float32)
    return vecs, queries


def engine(n=8192, sharded=False, compute_dtype=torch.bfloat16, **cfg):
    vecs, queries = corpus(n)
    store = VectorStore(dim=D, metric="euclidean", capacity=n, device="cpu")
    slots = store.add_batch([f"v{i}" for i in range(n)], vecs)
    config = IVFConfig(**{**CFG, **cfg})
    if sharded:
        eng = ShardedIVFIndex(store, 2, config=config)
        eng.on_insert(slots, vecs)
    else:
        eng = IVFIndex(store, config=config, compute_dtype=compute_dtype)
        eng.build()
    return eng, queries


def host_path(eng, q, k, mask=None, negative=None, negative_weight=0.5):
    """``search_slots``' device path and host layers with the under-fill
    test counted on the host from the final rows: (dist, slots, the short
    rows, each short row as the device path left it)."""
    retrieve_k = k if negative is None else min(max(2 * k, 30), eng.store.size)
    mask_dev = None if mask is None else torch.as_tensor(mask, device=eng.device)
    dist, idx = eng.search_slots_device(
        torch.from_numpy(q).to(eng.device), retrieve_k, mask=mask_dev
    )
    dist, idx = dist.cpu().numpy(), idx.cpu().numpy()
    if eng._overflow:
        keep = eng.store._np_valid.copy()
        if mask is not None:
            keep &= mask
        dist, idx = eng._merge_overflow(q, dist, idx, keep, retrieve_k,
                                        sorted(eng._overflow))
    if negative is not None:
        dist, idx = eng._exact.rerank_negative(q, dist, idx, negative, negative_weight, k)
        dist, idx = dist.cpu().numpy(), idx.cpu().numpy()
    dist, idx = dist[:, :k], idx[:, :k]
    short = np.flatnonzero((idx >= 0).sum(axis=1) < min(k, eng.store.size))
    before = idx[short].copy()
    if len(short):
        e_dist, e_idx = eng._exact.search_slots(
            q, k, mask=mask, negative=negative, negative_weight=negative_weight
        )
        dist, idx = dist.copy(), idx.copy()
        for b in short:
            dist[b], idx[b] = query_mod.merge_rows(dist[b], idx[b], e_dist[b], e_idx[b], k)
    return dist, idx, short, before


def prepare(case):
    """(engine, queries, k, search_slots' keywords, host-checked?) of a case."""
    k, kw, host = 10, {}, False
    if case in ("rescore-off", "fused", "fused-rescore-off", "einsum", "einsum-rescore-off"):
        form = case.split("-")[0] if case != "rescore-off" else "pairs"
        eng, q = engine(formulation=form, rescore=not case.endswith("rescore-off"))
    elif case == "row-mode":
        eng, q = engine()
        k = 100
        assert eng._cmax // eng.config.seg_width < k  # one window spans the row
    elif case == "f32-blocks":
        eng, q = engine(compute_dtype=torch.float32)
    elif case == "f32-row-mode":
        eng, q = engine(compute_dtype=torch.float32)
        k = 100
    elif case == "slot-mask":
        eng, q = engine()
        kw["mask"] = np.random.default_rng(3).random(eng.store.capacity) < 0.004
    elif case == "tombstones":
        eng, q = engine()
        gone = np.random.default_rng(4).choice(eng.store.size, 400, replace=False)
        eng.store.delete_batch([f"v{i}" for i in gone])
        eng.on_delete(gone)
    elif case == "underfilled":
        # 300 rows in 32 clusters, one probed: no probed cluster holds k=20
        eng, q = engine(300, n_clusters=32, n_probe=1, build_threshold=64)
        k = 20
    elif case.startswith("nan-inf-queries"):
        eng, q = engine(rescore=not case.endswith("rescore-off"))
        q[3, 5] = np.nan
        q[7] = np.nan
        q[11, 0] = np.inf
        q[13, 2] = -np.inf
    elif case == "overflow":
        eng, q = engine()
        moved = np.arange(0, 48, 2)
        eng._vacate_slots(moved)
        eng._overflow.update(int(s) for s in moved)
        host = True
    elif case == "negative":
        eng, q = engine()
        kw.update(negative=corpus(8192)[0][100:148], negative_weight=0.3)
        host = True
    elif case == "sharded":
        eng, q = engine(5000, sharded=True, rescore=False)
    else:  # "pairs"
        eng, q = engine()
        assert eng._cmax // eng.config.seg_width >= k  # the windowed reduce
    return eng, q, k, kw, host


CASES = ["pairs", "row-mode", "rescore-off", "fused", "fused-rescore-off", "einsum",
         "einsum-rescore-off", "f32-blocks", "f32-row-mode", "slot-mask", "tombstones",
         "underfilled", "nan-inf-queries", "nan-inf-queries-rescore-off", "overflow",
         "negative", "sharded"]


@pytest.mark.parametrize("case", CASES)
def test_search_slots_matches_the_host_count(case, monkeypatch):
    eng, q, k, kw, host = prepare(case)
    want_d, want_i, want_short, want_before = host_path(eng, q, k, **kw)
    merged = []  # the rows the supplement merged, as the device path left them

    def spy(d1, i1, d2, i2, k_):
        merged.append(i1.copy())
        return merge(d1, i1, d2, i2, k_)

    merge = query_mod.merge_rows
    monkeypatch.setattr(query_mod, "merge_rows", spy)
    before = dict(eng.get_detailed_metrics()["search"])
    dist, idx = eng.search_slots(q, k, **kw)
    after = eng.get_detailed_metrics()["search"]

    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_array_equal(dist, want_d)
    np.testing.assert_array_equal(np.reshape(merged, (-1, k)), want_before)
    assert after["underfill_rows"] - before["underfill_rows"] == len(want_short)
    assert after["fill_host_checks"] - before["fill_host_checks"] == int(host)
    assert after["calls"] - before["calls"] == 1
    if case in ("slot-mask", "underfilled"):
        assert len(want_short) and (idx >= 0).sum(1).min() == k  # the supplement ran
    if case == "nan-inf-queries-rescore-off":
        # score-derived distances: torch.topk puts a NaN score first, so
        # row 13's empty slots come before its live ones
        assert (np.diff((want_before >= 0).astype(int), axis=1) > 0).any()
