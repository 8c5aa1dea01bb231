"""The IVF write path and churn tiers of ``quiver_tpu_torch`` against
``quiver_tpu``'s, on the CPU.

Both engines start from one JAX topology (the ``jax_topology`` fixture of
tests/test_torch_ivf_index.py: n=8192, d=32, 64 blobs, 32 requested
clusters) with ``background_maintenance=False``, and the same
insert/update/delete/refresh/retrain sequence runs through both. After each
step (:func:`assert_same`):

* ``_slot_pos``, ``_fill``, ``_overflow``, ``_drift``, ``_churn``,
  ``_built_size`` and the retrain/refresh counts are equal;
* ``_block_slot`` and ``_keep_dev()`` are equal;
* ``_blocks_t`` is within one bf16 ulp (same bits in practice: both round
  the same f32 residual to nearest even);
* ``_block_ns``, ``_block_inv`` and ``_built_resid`` agree to rel 1e-5 (f32
  sums in another order);
* search results agree by the ``agree`` rule of test_torch_ivf_index.py.

Assignments would flip on f32 near-ties, so every test's rows keep a top-2
centroid score gap of at least 1e-3 (:func:`assert_gaps`, checked at each
step). The cases mirror tests/test_ivf.py:92-188, 205-298, 491-521 and
626-648, and the repairs of the port's engine (constructor overrides,
``name``/``size``, the layout state, the metrics' counters).
"""

import numpy as np
import pytest
import torch

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.index.ivf import IVFIndex as JIVF
from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
from quiver_tpu_torch.index import make_engine

from tests.test_torch_ivf_index import CFG, D, KTOP, N, agree, corpus, jax_topology  # noqa: F401

GAP = 1e-3
SERIAL = dict(background_maintenance=False)


class Pair:
    """A JAX and a port store + engine over the same rows, both importing
    one JAX topology; writes go through both."""

    def __init__(self, topo, vecs, **cfg):
        ids = [f"v{i}" for i in range(N)]
        self.js = JStore(dim=D, metric="euclidean", capacity=N)
        self.ts = VectorStore(dim=D, metric="euclidean", capacity=N, device="cpu")
        self.js.add_batch(ids, vecs)
        self.ts.add_batch(ids, vecs)
        full = dict(CFG, **SERIAL, **cfg)
        self.je = JIVF(self.js, config=JConfig(**full))
        self.te = IVFIndex(self.ts, config=IVFConfig(**full))
        remap = np.arange(self.js.capacity)
        self.je.import_topology(topo, remap)
        self.te.import_topology(topo, remap)

    def insert(self, ids, vecs):
        sj = self.js.add_batch(ids, vecs)
        st = self.ts.add_batch(ids, vecs)
        np.testing.assert_array_equal(sj, st)
        self.je.on_insert(sj, vecs)
        self.te.on_insert(st, vecs)
        return np.asarray(st)

    def update(self, ids, vecs):
        self.js.update_batch(ids, vecs)
        self.ts.update_batch(ids, vecs)
        slots = np.asarray([self.ts.slot_of(i) for i in ids])
        self.je.on_update(slots, vecs)
        self.te.on_update(slots, vecs)
        return slots

    def delete(self, ids):
        slots = np.asarray([self.ts.slot_of(i) for i in ids])
        assert self.js.delete_batch(ids) == self.ts.delete_batch(ids)
        self.je.on_delete(slots)
        self.te.on_delete(slots)
        return slots

    def search(self, q, k=KTOP, **kw):
        """Both engines' results, held to the ``agree`` rule. Queries must
        not sit on stored rows: a distance near 0 is f32 cancellation noise
        (|q|^2 + |v|^2 - 2 q.v), which differs by summation order."""
        got = self.te.search_slots(q, k, **kw)
        agree(got, self.je.search_slots(q, k, **kw))
        return got


def assert_gaps(te):
    """Every live row's best centroid score beats its second by >= GAP."""
    live = np.flatnonzero(te.store._np_valid)
    v = te.store._np_vectors[live].astype(np.float64)
    c = te._centroids.astype(np.float64)
    s = np.sort(2.0 * v @ c.T - (c * c).sum(1), axis=1)
    gap = s[:, -1] - s[:, -2]
    assert gap.min() >= GAP, (gap.min(), live[np.argmin(gap)])


def assert_same(p: Pair):
    je, te = p.je, p.te
    assert te._built == je._built
    if te._built:
        assert_gaps(te)
    np.testing.assert_array_equal(te._slot_pos, je._slot_pos)
    np.testing.assert_array_equal(te._fill, je._fill)
    assert te._overflow == je._overflow and te._drift == je._drift
    assert (te._churn, te._built_size) == (je._churn, je._built_size)
    assert (te._n_retrains, te._n_refreshes) == (je._n_retrains, je._n_refreshes)
    assert te._cmax == je._cmax and te.n_clusters == je.n_clusters
    np.testing.assert_array_equal(te._centroids, je._centroids)
    np.testing.assert_array_equal(te._block_slot.numpy(), np.asarray(je._block_slot))
    np.testing.assert_array_equal(te._keep_dev().numpy(), np.asarray(je._keep_dev()))
    bt = te._blocks_t.view(torch.int16).numpy().astype(np.int32)
    bj = np.asarray(je._blocks_t).view(np.int16).astype(np.int32)
    assert np.abs(bt - bj).max() <= 1  # one bf16 ulp
    np.testing.assert_allclose(te._block_ns.numpy(), np.asarray(je._block_ns), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(te._block_inv.numpy(), np.asarray(je._block_inv), rtol=1e-5)
    np.testing.assert_allclose(te._built_resid, je._built_resid, rtol=1e-5)


def blob_rows(n, seed, scale=0.25):
    """In-distribution rows: the fixture corpus' 64 blob centers, fresh
    noise."""
    centers = np.random.default_rng(0).normal(size=(64, D)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return (centers[rng.integers(0, 64, n)] + scale * rng.normal(size=(n, D))).astype(np.float32)


def near(point, n, seed, scale=0.001):
    rng = np.random.default_rng(seed)
    return (point[None, :] + scale * rng.normal(size=(n, D))).astype(np.float32)


def jitter(q, seed=0, scale=0.05):
    return (q + scale * np.random.default_rng(seed).normal(size=q.shape)).astype(np.float32)


@pytest.fixture
def pair(jax_topology):
    vecs, _, topo = jax_topology
    return Pair(topo, vecs)


def make_pair(jax_topology, **cfg):
    vecs, _, topo = jax_topology
    return Pair(topo, vecs, **cfg)


# ------------------------------------------------------------ the repairs


def test_constructor_takes_config_overrides():
    ts = VectorStore(dim=D, metric="euclidean", device="cpu")
    eng = IVFIndex(ts, n_probe=8, rebuild_growth=0.5, compute_dtype=torch.bfloat16)
    assert eng.config.n_probe == 8 and eng.config.rebuild_growth == 0.5
    assert make_engine("ivf", ts, n_probe=5).config.n_probe == 5
    # f32 blocks (the database's default dtype) are taken; other dtypes raise
    assert IVFIndex(ts, compute_dtype=torch.float32).compute_dtype == torch.float32
    assert make_engine("ivf", ts, compute_dtype=torch.float32).compute_dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        IVFIndex(ts, compute_dtype=torch.float16)


def test_engines_have_name_and_size(jax_topology):
    from quiver_tpu_torch import ExactIndex
    from quiver_tpu.index.exact import ExactIndex as JExact

    p = make_pair(jax_topology)
    assert (p.te.name, p.te.size) == (p.je.name, p.je.size) == ("ivf", N)
    assert (ExactIndex(p.ts).name, ExactIndex(p.ts).size) == (JExact(p.js).name, N)


def test_import_carries_the_layout_state(pair):
    assert_same(pair)
    assert pair.te._built_size == N and pair.te._layout_gen == 1


def test_metrics_report_the_counters(jax_topology):
    p = make_pair(jax_topology, rebuild_growth=0.05)
    vecs = jax_topology[0]
    p.insert([f"d{i}" for i in range(4)], (vecs[:4] + 6.0).astype(np.float32))  # drifted
    p.insert([f"n{i}" for i in range(300)], blob_rows(300, seed=3))
    p.delete([f"v{i}" for i in range(50)])
    mt, mj = p.te.get_detailed_metrics(), p.je.get_detailed_metrics()
    for key in ("overflow", "drift_overflow", "churn_since_build", "retrains", "refreshes"):
        assert mt[key] == mj[key], key
    assert mt["drift_overflow"] == 4 and mt["churn_since_build"] == 354
    assert mt["maintenance"] == mj["maintenance"]
    p.insert([f"m{i}" for i in range(200)], blob_rows(200, seed=4))  # churn > 0.05: refresh
    mt, mj = p.te.get_detailed_metrics(), p.je.get_detailed_metrics()
    assert mt["refreshes"] == mj["refreshes"] == 1 and mt["churn_since_build"] == 0
    assert_same(p)


# ------------------------------------------------------ the write sequence


def test_write_sequence_matches_jax(jax_topology):
    vecs, queries, _ = jax_topology
    p = make_pair(jax_topology)
    new = blob_rows(600, seed=11)
    p.insert([f"n{i}" for i in range(600)], new)
    assert_same(p)
    p.search(queries)
    moved = blob_rows(200, seed=12)  # rows to other blobs: most change cluster
    p.update([f"v{i}" for i in range(1000, 1200)], moved)
    assert_same(p)
    p.delete([f"v{i}" for i in range(2000, 2300)] + [f"n{i}" for i in range(50)])
    assert_same(p)
    p.search(np.concatenate([queries, jitter(new[100:132]), jitter(moved[:32])]))
    p.te.refresh()
    p.je.refresh()
    assert_same(p)
    assert p.te._n_refreshes == 1 and p.te._churn == 0 and not p.te._overflow
    p.search(np.concatenate([queries, jitter(moved[:32], 1)]))


def test_delete_is_query_time_mask(pair):
    vecs = pair.ts._np_vectors
    _, i = pair.search(vecs[:1], 2)
    victim = pair.ts.id_of(int(i[0, 0]))
    pair.delete([victim])
    assert_same(pair)
    _, i2 = pair.search(vecs[:1], 5)
    assert int(i[0, 0]) not in i2[0].tolist()


def test_incremental_insert_appends(pair):
    new = blob_rows(50, seed=9)
    slots = pair.insert([f"n{i}" for i in range(50)], new)
    assert_same(pair)
    _, i = pair.search(new[:16], 1)
    assert np.mean(i[:, 0] == slots[:16]) >= 0.9


def test_overflow_spill_and_merge(jax_topology):
    vecs, queries, _ = jax_topology
    p = make_pair(jax_topology, rescore=True, n_probe=64, rebuild_growth=10.0)
    target = int(p.te._slot_pos[0, 0])
    room = p.te._cmax - int(p.te._fill[target])
    new = near(vecs[0], room + 40, seed=1)
    slots = p.insert([f"o{i}" for i in range(len(new))], new)
    assert_same(p)
    assert len(p.te._overflow) >= 40
    _, i = p.te.search_slots(new[:8], 1)  # near-duplicates: ids only
    assert set(i[:, 0].tolist()) <= set(slots.tolist()) | {0}
    got = p.search(jitter(vecs[:1]), 40)[1][0]
    assert set(got.tolist()) & set(slots.tolist())
    p.search(np.concatenate([queries[:16], jitter(new[-16:])]))


def test_slot_reuse_leaves_no_stale_entry(pair):
    vecs = pair.ts._np_vectors[:N].copy()
    victim = pair.ts.slot_of("v10")
    pair.delete(["v10"])
    fresh = blob_rows(1, seed=5)
    (slot,) = pair.insert(["fresh"], fresh)
    assert slot == victim
    assert_same(pair)
    d, i = pair.te.search_slots(fresh, 3)
    assert i[0, 0] == victim and d[0, 0] < 1e-2
    pair.search(jitter(fresh))
    _, i2 = pair.search(jitter(vecs[10:11]), 10)
    got = [int(s) for s in i2[0] if s >= 0]
    assert len(got) == len(set(got)) and victim not in got


def test_update_in_place_and_moved(pair):
    stay = pair.ts._np_vectors[[5, 6]] + 0.001  # same cluster: rewritten in place
    pos = pair.te._slot_pos[[5, 6]].copy()
    pair.update(["v5", "v6"], stay)
    assert_same(pair)
    np.testing.assert_array_equal(pair.te._slot_pos[[5, 6]], pos)
    far = blob_rows(1, seed=21)  # another blob: moves cluster
    pair.update(["v7"], far)
    assert_same(pair)
    _, i = pair.search(jitter(far), 1)
    assert pair.ts.id_of(int(i[0, 0])) == "v7"


def test_update_past_the_centroids_goes_to_drift_overflow(pair):
    far = (pair.ts._np_vectors[100] + 10.0)[None, :].astype(np.float32)
    pair.update(["v5"], far)
    assert_same(pair)
    assert pair.te._drift == {pair.ts.slot_of("v5")}
    # |q| ~ 57 here: a query within 1 of the row keeps cancellation noise
    # of the affine distance under the tolerance
    _, i = pair.search(jitter(far, scale=1.0), 1)
    assert pair.ts.id_of(int(i[0, 0])) == "v5"


def test_fused_mask(pair):
    mask = np.zeros(pair.ts.capacity, bool)
    mask[:50] = True
    _, i = pair.search(jitter(pair.ts._np_vectors[:4]), 5, mask=mask)
    assert (i[i >= 0] < 50).all()


def test_skewed_batch_placement(pair):
    te = pair.te
    cmax = te._cmax
    target = int(np.argmax(te._fill))
    n_new = cmax - int(te._fill[target]) + 7
    rng = np.random.default_rng(3)
    new = (te._centroids[target][None, :] + 0.01 * rng.normal(size=(n_new, D))).astype(np.float32)
    fill0 = te._fill.copy()
    slots = pair.insert([f"sk{j}" for j in range(n_new)], new)
    assert_same(pair)
    placed = te._slot_pos[slots]
    ok = placed[:, 0] >= 0
    assert len({(int(r), int(c)) for r, c in placed[ok]}) == int(ok.sum())
    np.testing.assert_array_equal(
        te._fill - fill0, np.bincount(placed[ok, 0], minlength=len(te._fill)))
    assert len(te._overflow) >= n_new - int(ok.sum())
    _, i = pair.te.search_slots(new, 1)  # near-duplicates: ids only
    assert np.mean(i[:, 0] == slots) >= 0.95
    pair.search(jitter(new[:16]))


def test_warmup_is_stateless(pair):
    te = pair.te
    before = (te._block_slot.clone(), te._keep_dev().clone(), te._blocks_t.clone(),
              te._fill.copy(), te._slot_pos.copy(), te._churn)
    assert te.warmup(query_batches=(1, 64), write_batches=(64,)) >= 0.0
    after = (te._block_slot, te._keep_dev(), te._blocks_t, te._fill, te._slot_pos, te._churn)
    for b, a in zip(before, after):
        if isinstance(b, torch.Tensor):
            assert torch.equal(b, a)
        else:
            np.testing.assert_array_equal(b, a)
    assert_same(pair)


# ------------------------------------------------------------ churn tiers


def test_churn_triggers_refresh(jax_topology):
    p = make_pair(jax_topology, rebuild_growth=0.1)
    p.insert([f"r{i}" for i in range(900)], blob_rows(900, seed=11))
    assert p.te._n_refreshes == 1 and p.te._churn == 0 and p.te._built_size == N + 900
    assert_same(p)


def test_refresh_absorbs_overflow_without_retrain(jax_topology):
    vecs = jax_topology[0]
    p = make_pair(jax_topology, rebuild_growth=10.0, retrain_growth=20.0)
    target = int(p.te._slot_pos[0, 0])
    new = near(vecs[0], p.te._cmax - int(p.te._fill[target]) + 16, seed=1)
    slots = p.insert([f"o{i}" for i in range(len(new))], new)
    assert p.te._overflow
    cents = p.te._centroids.copy()
    p.te.refresh()
    p.je.refresh()
    assert_same(p)
    assert not p.te._overflow and p.te._churn == 0 and p.te._n_retrains == 0
    np.testing.assert_array_equal(p.te._centroids, cents)
    p.te.set_optimization_parameters(n_probe=p.te.n_clusters)
    p.je.set_optimization_parameters(n_probe=p.je.n_clusters)
    _, i = p.search(vecs[:1], len(new) + 8)
    assert set(slots.tolist()) <= set(i[0].tolist())
    bs = p.te._block_slot.numpy()
    flat = bs[bs >= 0]
    assert len(flat) == len(np.unique(flat)) == p.ts.size


def test_churn_policy_refresh_then_retrain(jax_topology):
    p = make_pair(jax_topology, rebuild_growth=0.05, retrain_growth=0.2)
    more = blob_rows(2500, seed=13)
    cents = p.te._centroids.copy()
    p.insert([f"a{i}" for i in range(500)], more[:500])  # 0.06: refresh tier
    assert (p.te._n_refreshes, p.te._n_retrains) == (1, 0)
    np.testing.assert_array_equal(p.te._centroids, cents)
    assert_same(p)
    p.insert([f"b{i}" for i in range(2000)], more[500:])  # 2000/8692 > 0.2: retrain
    assert p.te._n_retrains == 1 and p.te._built_size == N + 2500 and p.te._churn == 0
    assert_same(p)
    p.search(jitter(more[:32]))


def test_refresh_escalates_when_centroids_are_stale(jax_topology):
    p = make_pair(jax_topology, rebuild_growth=10.0, retrain_growth=20.0, insert_drift=None)
    # a new blob far from every centroid. Seed 9 keeps the retrained
    # centroids' score gaps above GAP and both packages' Lloyd iterations
    # on the same path (other seeds reach near-ties inside the blob, where
    # f32 summation order decides)
    rng = np.random.default_rng(9)
    blob = (7.0 + 0.5 * rng.normal(size=(900, D))).astype(np.float32)
    slots = p.insert([f"f{i}" for i in range(len(blob))], blob)  # spill: refresh -> build
    assert p.te._n_retrains == 1
    assert_same(p)
    _, i = p.te.search_slots(blob[:16], 1)
    assert np.mean(i[:, 0] == slots[:16]) >= 0.9
    p.search(jitter(blob[:16]))
