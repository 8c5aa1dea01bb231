"""The n_probe tuner of the port against ``quiver_tpu``'s, on the CPU.

A JAX ``IVFIndex`` is built without a target; its exported topology is
imported into a JAX engine and a port engine that carry the target, so
both tune over the same block layout. The tuner samples its held-out
queries with numpy from ``seed + 7``, so both draw identical queries from
identical stores; any difference in the pick comes from the engines.
``probe_approx=None`` gives the JAX side the port's exact top-k.

Tolerances: ``_host_dist_f64`` is the same numpy arithmetic on the same
rows (equal bit for bit); the probe-inclusion curves agree within 1e-12;
the tuners install the same ``n_probe``, the same ``rescore`` and the same
``recall_shortfall``, and their holdout recalls agree within 0.01 (bf16
block scoring sums in another order in the two packages).
"""

import numpy as np
import pytest

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.index.ivf import IVFIndex as JIVF
from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
from quiver_tpu_torch.index.exact import ExactIndex

from tests.test_ivf import D, clustered

METRICS = ["euclidean", "squared_euclidean", "cosine", "dot_product", "manhattan"]


def near_dup_corpus():
    """The near-duplicate corpus of tests/test_ivf.py:696-703."""
    rng = np.random.default_rng(0)
    n_base = 3000
    centers = rng.normal(size=(40, D)).astype(np.float32)
    base = (centers[rng.integers(0, 40, n_base)]
            + 0.15 * rng.normal(size=(n_base, D))).astype(np.float32)
    dups = (base[rng.integers(0, n_base, 3000)]
            + 1e-4 * rng.normal(size=(3000, D))).astype(np.float32)
    return np.concatenate([base, dups]).astype(np.float32)


#: the three tuner corpora of tests/test_ivf.py:593-717
CASES = {
    "meets_target": (lambda: clustered(5000),
                     dict(n_probe=1, recall_target=0.95, n_probe_max=32)),
    "unreachable_target": (lambda: clustered(2000),
                           dict(n_probe=1, recall_target=1.01, n_probe_max=4)),
    "near_dup_rescore": (near_dup_corpus,
                         dict(n_probe=1, rescore=False, recall_target=0.98, n_probe_max=32)),
}
BASE = dict(build_threshold=256, probe_approx=None)


def engine_pair(vecs, metric="euclidean", **cfg):
    """(jax engine, port engine) over identical stores and one imported
    JAX topology, built by a JAX engine of the same config without the
    target."""
    ids = [f"v{i}" for i in range(len(vecs))]
    js = JStore(dim=vecs.shape[1], metric=metric, capacity=len(vecs))
    js.add_batch(ids, vecs)
    src = JIVF(js, config=JConfig(**{**BASE, **cfg, "recall_target": None}))
    src.build()
    topo = src.export_topology()
    ts = VectorStore(dim=vecs.shape[1], metric=metric, capacity=len(vecs), device="cpu")
    ts.add_batch(ids, vecs)
    je = JIVF(js, config=JConfig(**dict(BASE, **cfg)))
    te = IVFIndex(ts, config=IVFConfig(**dict(BASE, **cfg)))
    remap = np.arange(js.capacity)
    je.import_topology(topo, remap)
    te.import_topology(topo, remap)
    return je, te


@pytest.mark.parametrize("metric", METRICS)
def test_host_dist_f64_equal(metric):
    vecs = clustered(600)
    vecs[5] = 0.0  # a zero row: the cosine guard
    ids = [f"v{i}" for i in range(len(vecs))]
    js = JStore(dim=D, metric=metric)
    ts = VectorStore(dim=D, metric=metric, device="cpu")
    js.add_batch(ids, vecs)
    ts.add_batch(ids, vecs)
    rng = np.random.default_rng(4)
    q = (vecs[:40] + 0.1 * rng.normal(size=(40, D))).astype(np.float32)
    q[3] = 0.0
    slots = rng.integers(-1, len(vecs), (40, 12))
    slots[:, 0] = 5
    got = IVFIndex(ts)._host_dist_f64(q, slots)
    want = JIVF(js)._host_dist_f64(q, slots)
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[slots < 0]).all() and np.isfinite(got[slots >= 0]).all()


@pytest.mark.parametrize("n_clusters", [32, 256])
def test_probe_inclusion_recall_matches_jax(n_clusters):
    """K=32 takes the exact ranking; K=256 the windowed top-2 selection for
    P <= nwin = 2 and the exact ranking past it."""
    vecs = clustered(8192)
    je, te = engine_pair(vecs, n_clusters=n_clusters, n_probe=4)
    assert te.n_clusters >= n_clusters  # split_oversized may add clusters
    rng = np.random.default_rng(9)
    q = (vecs[:256] + 0.1 * rng.normal(size=(256, D))).astype(np.float32)
    _, truth = ExactIndex(te.store).search_slots(q, 10)
    # a few rows outside the blocks: the overflow counts as found
    for eng in (je, te):
        eng._vacate_slots(truth[:8, 0])
        eng._overflow.update(int(s) for s in truth[:8, 0])
    est_t = te._probe_inclusion_recall(q, truth, 16)
    est_j = je._probe_inclusion_recall(q, truth, 16)
    np.testing.assert_allclose(est_t, est_j, rtol=0, atol=1e-12)
    assert (np.diff(est_t) >= -1e-12).all() and est_t[-1] > est_t[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tune_n_probe_matches_jax(case):
    make, cfg = CASES[case]
    je, te = engine_pair(make(), **cfg)
    p_j, p_t = je.tune_n_probe(), te.tune_n_probe()
    assert p_t is not None and p_t == p_j
    assert te.config.n_probe == je.config.n_probe == p_t
    assert te.config.rescore == je.config.rescore
    assert te.recall_shortfall == je.recall_shortfall
    assert abs(te._tuned_recall - je._tuned_recall) <= 0.01
    assert te._tuned_stderr >= 0
    m = te.get_detailed_metrics()
    assert m["tuned_n_probe"] == p_t and m["config"]["n_probe"] == p_t
    if case == "meets_target":
        assert te._tuned_recall - te._tuned_stderr >= 0.95 and not te.recall_shortfall
    elif case == "unreachable_target":
        assert p_t == min(4, te.n_clusters) and te.recall_shortfall
    else:
        assert te.config.rescore and te._tuned_recall >= 0.98 and p_t < 32


def test_port_build_meets_target_on_fresh_queries():
    """The port's own build() with a recall_target tunes n_probe, and fresh
    jittered queries meet the target within the reference test's margin
    (tests/test_ivf.py:605-609)."""
    vecs = clustered(5000)
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    eng = IVFIndex(store, config=IVFConfig(
        n_probe=1, build_threshold=256, recall_target=0.95, n_probe_max=32))
    eng.build()
    m = eng.get_detailed_metrics()
    assert m["retrains"] == 1 and m["last_retrain_s"] > 0
    assert m["tuned_n_probe"] == eng.config.n_probe > 1
    assert m["tuned_recall"] >= 0.95
    rng = np.random.default_rng(99)
    q = (vecs[100:164] + 0.1 * vecs.std(axis=0, keepdims=True)
         * rng.standard_normal((64, D))).astype(np.float32)
    _, truth = ExactIndex(store).search_slots(q, 10)
    _, got = eng.search_slots(q, 10)
    kth = eng._host_dist_f64(q, truth)[:, -1]
    d_got = eng._host_dist_f64(q, got)
    assert np.mean(d_got <= kth[:, None] * (1 + 1e-6) + 1e-12) >= 0.93


def test_tuner_skips_small_corpora():
    vecs = clustered(200)
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    eng = IVFIndex(store, config=IVFConfig(n_probe=2, build_threshold=16, recall_target=0.95))
    eng.build()
    assert eng.tune_n_probe() is None and eng.config.n_probe == 2
    assert not eng.recall_shortfall


def test_tune_n_probe_over_einsum_matches_jax():
    """The tuner's measured check runs through the configured formulation:
    over einsum (q_cap drops included) both packages pick the same n_probe."""
    make, cfg = CASES["meets_target"]
    je, te = engine_pair(make(), formulation="einsum", q_cap_factor=1, **cfg)
    p_j, p_t = je.tune_n_probe(), te.tune_n_probe()
    assert p_t is not None and p_t == p_j and te.config.formulation == "einsum"
    assert te.recall_shortfall == je.recall_shortfall
    assert abs(te._tuned_recall - je._tuned_recall) <= 0.01
