"""The port's sharded IVF engine (``quiver_tpu_torch/parallel/sharded_ivf.py``)
at 8 shards on the CPU, held to the JAX package's on the 8-device CPU mesh
(``tests/conftest.py``), with the scenarios of tests/test_sharded_ivf.py.

Both packages get the same seeded clustered rows. The JAX engine builds
(``probe_approx=None``, so its top-k is exact as the port's is) and its
topology sidecar goes into the port's engine, so both serve one layout:

* the layout: cluster ownership (``cluster_live``, ``k_local``), every
  row's cluster and block position, and the invariants of the reserved
  ids, exactly;
* the query: on the same arrays, the per-shard pair loads (``max_load``)
  exactly, and the answers' recall@10 against the exact oracle within
  0.01 of the reference's (bf16 products summed in another order move
  near-tied entries);
* a port build of its own: recall within 0.02 of the single-device port
  engine's and >= 0.9, as the reference holds its own.

``_m_pairs`` (which decides which pairs drop) is held to the reference's
on a grid. Test names differ from the reference's: ``tests/conftest.py``
marks slow by base name.
"""

import jax
import numpy as np
import pytest
import torch

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.parallel.sharded import make_mesh as jmake_mesh
from quiver_tpu.parallel.sharded_ivf import ShardedIVFIndex as JShardedIVF
from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index import make_engine
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex
from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex, sharded_ivf_query

from tests.torch_threads import one_torch_thread  # noqa: F401

D = 32
N_SHARDS = 8
CFG = dict(n_probe=8, build_threshold=256, rescore=False)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return jmake_mesh(8)


def clustered(n, n_centers=40, seed=0, scale=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, D)).astype(np.float32)
    which = rng.integers(0, n_centers, n)
    return (centers[which] + scale * rng.normal(size=(n, D))).astype(np.float32)


def make(n=5000, metric="euclidean", mesh=N_SHARDS, vecs=None, **cfg):
    vecs = clustered(n) if vecs is None else vecs
    store = VectorStore(dim=D, metric=metric, device="cpu")
    slots = store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    eng = ShardedIVFIndex(store, mesh, config=IVFConfig(**{**CFG, **cfg}))
    eng.on_insert(slots, vecs)
    return store, vecs, eng


def recall(store, got, q, k=10):
    _, oi = ExactIndex(store).search_slots(q, k)
    return float(np.mean([len(set(got[b].tolist()) & set(oi[b].tolist())) / k
                          for b in range(len(q))]))


def both(jmesh, metric="euclidean", n=5000, n_probe=8):
    """(port engine on the JAX layout, JAX engine, port store, rows)."""
    vecs = clustered(n)
    ids = [f"v{i}" for i in range(n)]
    js = JStore(dim=D, metric=metric)
    jslots = js.add_batch(ids, vecs)
    jeng = JShardedIVF(js, jmesh, config=JConfig(**{**CFG, "n_probe": n_probe},
                                                 probe_approx=None))
    jeng.on_insert(jslots, vecs)
    st = VectorStore(dim=D, metric=metric, device="cpu")
    st.add_batch(ids, vecs)
    eng = ShardedIVFIndex(st, N_SHARDS, config=IVFConfig(**{**CFG, "n_probe": n_probe}))
    eng.import_topology(jeng.export_topology(), np.arange(st.capacity))
    return eng, jeng, st, vecs


@pytest.fixture(scope="module")
def pair(jmesh):
    return both(jmesh)


def invariants(eng):
    live, KL = eng._cluster_live, eng._k_local
    assert len(live) == N_SHARDS * KL
    for s in range(N_SHARDS):  # each shard's last id is reserved: the pad group
        assert not live[(s + 1) * KL - 1]
    assert not torch.cat(eng._keep_dev()).numpy()[~live].any()  # reserved ids hold no rows
    pos = eng._slot_pos[eng._slot_pos[:, 0] >= 0]
    assert live[pos[:, 0]].all()


def test_port_sharded_ivf_layout_invariants():
    _, _, eng = make()
    assert eng._built
    invariants(eng)


def test_port_sharded_ivf_serves_the_reference_layout(pair):
    eng, jeng, _, _ = pair
    np.testing.assert_array_equal(eng._cluster_live, jeng._cluster_live)
    assert eng._k_local == jeng._k_local
    np.testing.assert_array_equal(eng._slot_pos, jeng._slot_pos)
    np.testing.assert_array_equal(torch.cat(eng._block_slot).numpy(), np.asarray(jeng._block_slot))
    invariants(eng)


@pytest.mark.parametrize("B", [64, 512])
def test_port_sharded_ivf_query_matches_reference(jmesh, pair, B):
    """The two ``sharded_ivf_query`` functions on the same arrays: the
    same per-shard loads, the same recall (within 0.01). B=512 at
    ``local_pair_factor`` 1 drops pairs on the hottest shard."""
    from quiver_tpu.parallel.sharded_ivf import sharded_ivf_query as jquery

    eng, jeng, st, vecs = pair
    rng = np.random.default_rng(5)
    q = (vecs[:B] + 0.05 * rng.normal(size=(B, D))).astype(np.float32)
    P = 8
    m = jeng._m_pairs(B, P) if B == 64 else 512
    assert m == (eng._m_pairs(B, P) if B == 64 else 512)
    shards = list(zip(eng._blocks_t, eng._block_slot, eng._block_ns, eng._block_inv,
                      eng._keep_dev()))
    assert len(shards) == N_SHARDS
    dt, it, lt = sharded_ivf_query(
        torch.from_numpy(q), eng._cent_rep, shards,
        metric="euclidean", k=10, n_probe=P, m_pairs=m,
        oversample=eng.config.oversample, probe_sel_approx=eng.config.probe_sel_approx,
    )
    jc, jns = jeng._cent_dev
    dj, ij, lj = jquery(
        jax.numpy.asarray(q), jc, jns, jax.numpy.asarray(jeng._cluster_live),
        jeng._blocks_t, jeng._block_slot, jeng._block_ns, jeng._block_inv,
        jeng._keep_dev(), jax.numpy.zeros((8,), bool), mesh=jmesh,
        metric="euclidean", k=10, n_probe=P, m_pairs=m, oversample=jeng.config.oversample,
        probe_approx=None, probe_sel_approx=jeng.config.probe_sel_approx,
        seg_width=jeng.config.seg_width,
    )
    assert int(lt) == int(lj)
    assert (int(lt) > m) == (B == 512)
    it, ij = it.numpy(), np.asarray(ij)
    assert abs(recall(st, it, q) - recall(st, ij, q)) <= 0.01
    assert (it != ij).mean() <= 0.02
    same = it == ij
    np.testing.assert_allclose(dt.numpy()[same], np.asarray(dj)[same], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
def test_port_sharded_ivf_recall_matches_reference_and_single(jmesh, metric):
    eng, jeng, st, vecs = both(jmesh, metric=metric, n_probe=16)
    rng = np.random.default_rng(5)
    q = (vecs[:48] + 0.05 * rng.normal(size=(48, D))).astype(np.float32)
    r_port = recall(st, eng.search_slots(q, 10)[1], q)
    r_ref = recall(st, jeng.search_slots(q, 10)[1], q)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    st2, _, own = make(metric=metric, n_probe=16, vecs=vecs)
    single = IVFIndex(st2, config=IVFConfig(**{**CFG, "n_probe": 16}))
    single.build()
    r_own = recall(st2, own.search_slots(q, 10)[1], q)
    assert r_own >= recall(st2, single.search_slots(q, 10)[1], q) - 0.02
    assert r_own >= 0.9


def test_port_sharded_ivf_sorted_masked_negative(pair):
    eng, _, st, vecs = pair
    d, i = eng.search_slots(vecs[:8], k=10)
    for b in range(8):
        assert (np.diff(d[b][i[b] >= 0]) >= -1e-6).all()
    d, i = eng.search_slots(vecs[:64], k=1)
    assert (i[:, 0] == np.arange(64)).mean() >= 0.98
    assert (d[:, 0] < 0.2).mean() >= 0.98  # score-derived: bf16 residual noise
    allowed = np.arange(0, 5000, 7)
    mask = np.zeros(st.capacity, bool)
    mask[allowed] = True
    _, i = eng.search_slots(vecs[:16], k=10, mask=mask)
    got = i[i >= 0]
    assert len(got) and np.isin(got, allowed).all()
    _, i0 = eng.search_slots(vecs[:4], k=5)
    _, i1 = eng.search_slots(vecs[:4], k=5, negative=vecs[100:104], negative_weight=5.0)
    assert not np.array_equal(i0, i1)


def test_port_sharded_ivf_writes_and_refresh():
    store, vecs, eng = make(n=4000, rebuild_growth=10.0, retrain_growth=20.0)
    new = clustered(16, seed=9) + 0.01
    slots = store.add_batch([f"n{j}" for j in range(16)], new)
    eng.on_insert(slots, new)
    _, i = eng.search_slots(new, k=1)
    assert (i[:, 0] == slots).mean() >= 0.9
    assert eng._cluster_live[eng._slot_pos[slots, 0][eng._slot_pos[slots, 0] >= 0]].all()
    store.delete_batch(["n0"])
    eng.on_delete(np.asarray([slots[0]]))
    assert eng.search_slots(new[:1], k=1)[1][0, 0] != slots[0]
    more = clustered(4200, seed=0)[4000:]  # the corpus's blob centers
    ms = store.add_batch([f"r{j}" for j in range(200)], more)
    eng.on_insert(ms, more)
    live, kl, cents = eng._cluster_live.copy(), eng._k_local, eng._centroids.copy()
    eng.refresh()
    # only the drift-routed rows (the seed-9 blobs) stay outside the blocks
    assert eng._built and eng._churn == 0 and eng._overflow == eng._drift
    assert np.array_equal(eng._cluster_live, live) and eng._k_local == kl
    assert np.array_equal(eng._centroids, cents)
    invariants(eng)
    rng = np.random.default_rng(3)
    q = (more[:32] + 0.05 * rng.normal(size=(32, D))).astype(np.float32)
    assert recall(store, eng.search_slots(q, 10)[1], q) >= 0.9


def test_port_sharded_ivf_background_refresh_keeps_geometry():
    """A churn-triggered background refresh runs in a staging clone of the
    sharded engine (``_CLONE_EXTRA`` carries ``k_local``) and swaps in."""
    store, vecs, eng = make(n=4000, rebuild_growth=0.02, retrain_growth=20.0,
                            background_maintenance=True)
    live, kl = eng._cluster_live.copy(), eng._k_local
    more = clustered(4200, seed=0)[4000:]
    eng.on_insert(store.add_batch([f"r{j}" for j in range(200)], more), more)
    assert eng.wait_maintenance(timeout=60)
    m = eng.get_detailed_metrics()
    assert m["maintenance"]["swaps"] >= 1 and m["maintenance"]["error"] is None
    assert m["refreshes"] >= 1 and m["sharded"]["n_shards"] == N_SHARDS
    assert np.array_equal(eng._cluster_live, live) and eng._k_local == kl
    invariants(eng)


def test_port_sharded_ivf_topology_roundtrip_and_mismatch():
    store, vecs, eng = make(n=4000)
    data = eng.export_topology()
    assert bytes(data["kind"]) == b"ivf" and int(data["k_local"]) * 8 == len(data["cluster_live"])
    eng2 = ShardedIVFIndex(store, N_SHARDS, config=IVFConfig(**CFG))
    eng2.import_topology(data, np.arange(store.capacity))
    assert eng2._built and eng2._k_local == eng._k_local
    np.testing.assert_array_equal(eng.search_slots(vecs[:16], 5)[1], eng2.search_slots(vecs[:16], 5)[1])
    bad = dict(data, k_local=np.int64(len(data["cluster_live"]) // 2))  # a 2-shard sidecar
    eng3 = ShardedIVFIndex(store, N_SHARDS, config=IVFConfig(**CFG))
    eng3.import_topology(bad, np.arange(store.capacity))
    assert eng3._built and eng3._k_local * 8 == len(eng3._cluster_live)
    assert (eng3.search_slots(vecs[:64], k=1)[1][:, 0] == np.arange(64)).mean() >= 0.98


def test_port_sharded_ivf_construction_rules():
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    with pytest.raises(ValueError, match="rescore"):
        ShardedIVFIndex(store, N_SHARDS, config=IVFConfig(rescore=True))
    split = ShardedIVFIndex(store, ["cpu", "meta"])  # distinct devices: one per shard
    assert split.mesh == (torch.device("cpu"), torch.device("meta")) and split.n_shards == 2
    assert split.device == torch.device("cpu")  # queries in, results out
    eng = make_engine("sharded_ivf", store, mesh=N_SHARDS)
    assert eng.name == "sharded_ivf" and not eng.config.rescore and eng.n_shards == N_SHARDS


def test_port_m_pairs_matches_reference(jmesh):
    js, st = JStore(dim=D), VectorStore(dim=D, device="cpu")
    for n in (1, 4, 8):
        for f in (1.0, 2.0, 3.3):
            jeng = JShardedIVF(js, jmake_mesh(n), local_pair_factor=f)
            eng = ShardedIVFIndex(st, n, local_pair_factor=f)
            for B in (1, 7, 64, 2048, 65536):
                for P in (1, 2, 3, 8):
                    assert eng._m_pairs(B, P) == jeng._m_pairs(B, P), (n, f, B, P)


def test_port_sharded_ivf_skew_auto_raise():
    """Every query aims at shard 0's clusters: a tight bound drops pairs,
    the next batch reads the load and raises ``local_pair_factor``, and
    recall recovers (``test_sharded_skew_auto_raise``)."""
    store, vecs, eng = make(n=5000, n_probe=8)
    eng.local_pair_factor = 1.0
    kl = eng._k_local
    own0 = np.flatnonzero((eng._slot_pos[:, 0] >= 0) & (eng._slot_pos[:, 0] < kl))
    assert len(own0) > 64
    rng = np.random.default_rng(17)
    q = (vecs[rng.choice(own0, size=256)] + 0.05 * rng.normal(size=(256, D))).astype(np.float32)
    r1 = recall(store, eng.search_slots(q, 10)[1], q)
    r2 = recall(store, eng.search_slots(q, 10)[1], q)
    assert eng._overflow_raises >= 1 and eng.local_pair_factor > 1.0
    assert eng.get_detailed_metrics()["sharded"]["overflow_raises"] >= 1
    assert r2 >= r1 - 1e-9 and r2 >= 0.9, (r1, r2, eng.local_pair_factor)


@pytest.mark.parametrize("cls", [IVFIndex, ShardedIVFIndex])
def test_port_ivf_reload_keeps_the_tuned_n_probe(cls):
    """The sidecar carries the n_probe tuner's pick: an engine with a
    recall target serves at the exporter's tuned n_probe after an import
    (no tuner run), one without keeps its configured n_probe, and the
    reference still reads the port's sidecar."""
    from quiver_tpu.index.ivf import IVFIndex as JIVF

    kw = {"mesh": N_SHARDS} if cls is ShardedIVFIndex else {}
    cfg = {**CFG, "n_probe": 1, "recall_target": 0.99}
    vecs = clustered(4000)
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    slots = store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    eng = cls(store, config=IVFConfig(**cfg), **kw)
    eng.on_insert(slots, vecs)
    assert eng._tuned_n_probe == eng.config.n_probe > 1
    data = eng.export_topology()
    eng2 = cls(store, config=IVFConfig(**cfg), **kw)
    eng2.import_topology(data, np.arange(store.capacity))
    assert (eng2.config.n_probe, eng2.config.rescore, eng2._tuned_recall) == (
        eng.config.n_probe, eng.config.rescore, eng._tuned_recall)
    np.testing.assert_array_equal(eng.search_slots(vecs[:32], 10)[1],
                                  eng2.search_slots(vecs[:32], 10)[1])
    fixed = cls(store, config=IVFConfig(**{**cfg, "recall_target": None}), **kw)
    fixed.import_topology(data, np.arange(store.capacity))
    assert fixed.config.n_probe == 1 and fixed._tuned_n_probe is None
    if cls is IVFIndex:
        js = JStore(dim=D, metric="euclidean")
        js.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
        jeng = JIVF(js, config=JConfig(**cfg))
        jeng.import_topology(data, np.arange(js.capacity))
        assert jeng._built and jeng.config.n_probe == 1  # the reference's fault
