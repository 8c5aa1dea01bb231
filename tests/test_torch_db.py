"""The port's database layer against the JAX package's, on the CPU: the DB
at its defaults, the topology sidecar, stored-data aliasing, the stress and
edge batteries, the collector and Arrow IPC.

The scenarios of tests/test_topology_persistence.py (its IVF and hybrid
cases), test_aliasing.py (not the ``slow`` API stress), test_stress.py and
test_aux.py (the collector, Arrow IPC) run through both packages on the
same seeded numpy rows, each scenario one function over a package
namespace; results are held to each other: ids equal, distances to
rtol/atol 1e-4 (f32 in both: the exact scan, or IVF over f32 blocks,
where only the summation order differs), sizes and flags equal.

The reference's ``test_topology_roundtrip_identical_graph``,
``test_topology_with_wal_mutations`` and ``test_hybrid_engine_sidecar``
build the graph (its HNSW default engine); here the same flows run with
the IVF engine and the hybrid's IVF backend, and the HNSW sidecar's round
trip between the packages is held in test_torch_persistence.py.
"""

import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from quiver_tpu import types as jtypes
from quiver_tpu.core.collection import Collection as JCollection
from quiver_tpu.core.db import DB as JDB
from quiver_tpu.core.db import DBOptions as JDBOptions
from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.observability.collector import Collector as JCollector
from quiver_tpu.persistence import arrow_io as jarrow
from quiver_tpu_torch import types as ttypes
from quiver_tpu_torch.core.collection import Collection as TCollection
from quiver_tpu_torch.core.db import DB as TDB
from quiver_tpu_torch.core.db import DBOptions as TDBOptions
from quiver_tpu_torch.core.store import VectorStore as TStore
from quiver_tpu_torch.observability.collector import Collector as TCollector
from quiver_tpu_torch.persistence import arrow_io as tarrow

TOL = 1e-4

JAX = types.SimpleNamespace(
    name="jax", DB=JDB, DBOptions=JDBOptions, Collection=JCollection, Store=JStore,
    Collector=JCollector, arrow=jarrow, types=jtypes, dev={})
TORCH = types.SimpleNamespace(
    name="torch", DB=TDB, DBOptions=TDBOptions, Collection=TCollection, Store=TStore,
    Collector=TCollector, arrow=tarrow, types=ttypes, dev={"device": "cpu"})
PKGS = (JAX, TORCH)


def opts(pkg, root, **kw):
    kw.setdefault("storage_path", str(root))
    kw.setdefault("flush_interval_s", 0)
    return pkg.DBOptions(**kw, **pkg.dev)


def both(scenario, *args):
    """{package name: scenario(package, *args)} for both packages; a path
    argument becomes one directory per package under it."""
    return {p.name: scenario(p, *(a / p.name if isinstance(a, Path) else a for a in args))
            for p in PKGS}


def hits(pkg, coll, vec, k=1, **kw):
    r = coll.search(pkg.types.SearchRequest(vector=vec, top_k=k, **kw))
    return [(i.id, i.distance) for i in r.results]


def assert_hits_agree(a, b):
    assert [i for i, _ in a] == [i for i, _ in b]
    np.testing.assert_allclose([d for _, d in a], [d for _, d in b], rtol=TOL, atol=TOL)


def rows(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# ------------------------------------------------------ the DB's defaults


def test_db_defaults_serve_hybrid_over_f32_ivf(tmp_path):
    """DBOptions() at its defaults (engine "hybrid", "float32"): a collection
    is served by the hybrid engine whose IVF side holds f32 blocks, in both
    packages; the same requests give the same answers (the port's IVF side
    imports the JAX engine's topology through the storage directory)."""
    vecs = rows(3000, 16, seed=4)
    cfg = {"ivf": {"build_threshold": 512, "n_probe": 8},
           "adaptive": {"exploration_factor": 0.0, "initial_exact_threshold": 100}}
    jdb = JDB(opts(JAX, tmp_path / "d"))
    jc = jdb.create_collection("c", 16, "euclidean", engine_config=cfg)
    jc.add_batch([f"v{i}" for i in range(3000)], vecs)
    assert jdb.options.default_engine == "hybrid" and jdb.options.compute_dtype == "float32"
    jdb.close()
    jdb = JDB(opts(JAX, tmp_path / "d"))
    tdb = TDB(opts(TORCH, tmp_path / "d"))
    jc, tc = jdb.get_collection("c"), tdb.get_collection("c")
    assert tdb.options.device == "cpu" and tdb.device == torch.device("cpu")
    assert tc.engine.name == "hybrid" and tc.engine.ann.name == "ivf"
    assert tc.engine.ann._blocks_t.dtype == torch.float32 and tc.engine._graph_built
    assert np.asarray(jc.engine.ann._blocks_t).dtype == np.float32
    q = vecs[:32] + 0.05 * rows(32, 16, seed=5)
    for pkg, db in ((JAX, jdb), (TORCH, tdb)):
        db.responses = db.batch_search("c", [pkg.types.SearchRequest(vector=v, top_k=5) for v in q])
    for rj, rt in zip(jdb.responses, tdb.responses):
        assert_hits_agree([(i.id, i.distance) for i in rt.results],
                          [(i.id, i.distance) for i in rj.results])
        assert rt.metadata.strategy == rj.metadata.strategy == "ivf"
    jdb.close()
    tdb.close()


def test_db_bf16_compute_dtype_reaches_every_engine():
    """compute_dtype="bfloat16" gives bf16 IVF blocks and the exact scan's
    bf16 corpus, as the reference's string -> dtype map does."""
    db = TDB(TDBOptions(enable_persistence=False, compute_dtype="bfloat16", device="cpu"))
    c = db.create_collection("c", 8, "euclidean", engine="exact")
    assert c.engine.compute_dtype == torch.bfloat16
    h = db.create_collection("h", 8, "euclidean")
    assert h.engine.ann.compute_dtype == torch.bfloat16
    assert h.engine.exact.compute_dtype == torch.bfloat16
    vecs = rows(600, 8, seed=1)
    h.add_batch([f"v{i}" for i in range(600)], vecs)
    assert hits(TORCH, h, vecs[7])[0][0] == "v7"


# ---------------------------------------------------- the topology sidecar


def test_exact_engine_writes_no_sidecar(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root, default_engine="exact"))
        c = db.create_collection("g", 16, "euclidean")
        c.add_batch([f"v{i}" for i in range(50)], rows(50, 16))
        db.close()
        return (root / "g" / "topology.npz").exists()

    assert both(scenario, tmp_path / "x") == {"jax": False, "torch": False}


def _ivf_dir(pkg, root, engine):
    """Collection "g" of ``engine`` ("ivf" or the default hybrid) with 600
    rows, built, flushed; returns its rows."""
    cfg = ({"ivf": {"build_threshold": 256, "n_probe": 8, "n_clusters": 16}} if engine == "ivf"
           else {"ivf": {"build_threshold": 256, "n_probe": 8}})
    db = pkg.DB(opts(pkg, root))
    c = db.create_collection("g", 16, "euclidean", engine=engine, engine_config=cfg)
    vecs = rows(600, 16, seed=1)
    c.add_batch([f"v{i}" for i in range(600)], vecs)
    return db, c, vecs


@pytest.mark.parametrize("engine", ["ivf", "hybrid"])
def test_ivf_topology_roundtrip_through_the_sidecar(tmp_path, engine):
    """The IVF layout (or the hybrid's IVF side) comes back from
    topology.npz without a k-means: same centroids, same cluster of every
    row, same answers; both packages."""
    def scenario(pkg, root):
        db, c, vecs = _ivf_dir(pkg, root, engine)
        ivf = c.engine if engine == "ivf" else c.engine.ann
        cents = np.asarray(ivf._centroids).copy()
        cluster = {v: int(ivf._slot_pos[c.store.slot_of(v), 0]) for v in ("v0", "v300", "v599")}
        before = hits(pkg, c, vecs[5], 3)
        db.close()
        assert (root / "g" / "topology.npz").exists()
        db2 = pkg.DB(opts(pkg, root))
        c2 = db2.get_collection("g")
        ivf2 = c2.engine if engine == "ivf" else c2.engine.ann
        if engine == "hybrid":
            assert c2.engine._graph_built  # restored from the sidecar, not rebuilt
        np.testing.assert_array_equal(np.asarray(ivf2._centroids), cents)
        assert {v: int(ivf2._slot_pos[c2.store.slot_of(v), 0]) for v in cluster} == cluster
        after = hits(pkg, c2, vecs[5], 3)
        db2.close()
        return before, after

    out = both(scenario, tmp_path / engine)
    for pkg in ("jax", "torch"):
        assert_hits_agree(out[pkg][1], out[pkg][0])
        assert out[pkg][1][0][0] == "v5"


def test_ivf_topology_with_wal_mutations(tmp_path):
    """Flush (sidecar written), then WAL-only deletes and adds, then a crash:
    the reload imports the sidecar with the old-slot -> new-slot remap and
    inserts the WAL's rows; both packages."""
    def scenario(pkg, root):
        db, c, vecs = _ivf_dir(pkg, root, "ivf")
        db.persistence.flush_collection(c)
        c.delete_batch(["v0", "v5"])
        extra = rows(2, 16, seed=9)
        c.add_batch(["w0", "w1"], extra)
        del db, c  # crash: the WAL carries the delta
        db2 = pkg.DB(opts(pkg, root))
        c2 = db2.get_collection("g")
        out = (c2.size, "v0" in c2.store, hits(pkg, c2, extra[0], 3),
               [i for i, _ in hits(pkg, c2, vecs[0], 600)])
        db2.close()
        return out

    out = both(scenario, tmp_path / "w")
    t, j = out["torch"], out["jax"]
    assert t[:2] == j[:2] == (600, False)
    assert_hits_agree(t[2], j[2])
    assert t[2][0][0] == "w0" and "v0" not in t[3] and "v5" not in t[3]


def test_corrupt_sidecar_falls_back_to_rebuild(tmp_path):
    def scenario(pkg, root):
        db, c, vecs = _ivf_dir(pkg, root, "ivf")
        db.close()
        (root / "g" / "topology.npz").write_bytes(b"garbage")
        db2 = pkg.DB(opts(pkg, root))
        c2 = db2.get_collection("g")
        _, slots = c2.engine.search_slots(vecs[:2], k=3)
        out = [c2.store.id_of(int(slots[b, 0])) for b in range(2)]
        db2.close()
        return out

    assert both(scenario, tmp_path / "c") == {"jax": ["v0", "v1"], "torch": ["v0", "v1"]}


def test_engine_config_persists_across_reload(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root, default_engine="exact"))
        c = db.create_collection("t", 16, "euclidean", engine="ivf",
                                 engine_config={"ivf": {"n_probe": 4, "build_threshold": 64}})
        vecs = rows(128, 16)
        c.add_batch([f"v{i}" for i in range(128)], vecs)
        db.close()
        db2 = pkg.DB(opts(pkg, root, default_engine="exact"))
        c2 = db2.get_collection("t")
        out = (c2.engine_kind, c2.engine.config.n_probe, c2.engine.config.build_threshold,
               c2.engine_config_json, hits(pkg, c2, vecs[5]))
        db2.close()
        return out

    out = both(scenario, tmp_path / "e")
    assert out["torch"][:4] == out["jax"][:4] == (
        "ivf", 4, 64, {"ivf": {"n_probe": 4, "build_threshold": 64}})
    assert_hits_agree(out["torch"][4], out["jax"][4])


# --------------------------------------------------------------- aliasing


def _store(pkg, n=8, d=16):
    s = pkg.Store(dim=d, metric="euclidean", **pkg.dev)
    vecs = rows(n, d)
    mds = [{"tag": f"t{i}", "nums": [i, i + 1]} for i in range(n)]
    s.add_batch([f"v{i}" for i in range(n)], vecs, mds)
    return s, vecs, mds


def test_stored_data_does_not_alias_callers():
    """Vectors and metadata are copied in both directions: the caller's
    buffers after add/update, and records and search results handed out."""
    def scenario(pkg):
        s, vecs, mds = _store(pkg)
        orig = vecs[3].copy()
        vecs[3][:] = 999.0
        mds[2]["tag"] = "mutated"
        mds[2]["nums"].append(777)
        rec = s.get("v1")
        rec.values[:] = -5.0
        rec.metadata["nums"].append(-1)
        md = {"k": ["a"]}
        s.update_batch(["v0"], metadata=[md])
        md["k"].append("b")
        return (s.get("v3").values.copy(), orig, s.get("v2").metadata, s.get("v1").metadata,
                s.get("v0").metadata)

    for vals, orig, m2, m1, m0 in both(scenario).values():
        np.testing.assert_array_equal(vals, orig)
        assert m2 == {"tag": "t2", "nums": [2, 3]} and m1 == {"tag": "t1", "nums": [1, 2]}
        assert m0 == {"k": ["a"]}


def test_search_result_metadata_does_not_alias_the_store():
    def scenario(pkg):
        vecs = rows(6, 16, seed=1)
        c = pkg.Collection("alias", dim=16, metric="euclidean", **pkg.dev)
        c.add_batch([f"r{i}" for i in range(6)], vecs, [{"m": {"deep": [i]}} for i in range(6)])
        opts_ = pkg.types.SearchOptions(include_metadata=True, include_vectors=True)
        item = c.search(pkg.types.SearchRequest(vector=vecs[2], top_k=1, options=opts_)).results[0]
        item.metadata["m"]["deep"].append(99)
        item.vector[:] = 0.0
        again = c.search(pkg.types.SearchRequest(
            vector=vecs[2], top_k=1, options=pkg.types.SearchOptions(include_metadata=True)))
        return item.id, again.results[0].metadata, c.store.get("r2").values.copy(), vecs[2]

    for vid, md, stored, want in both(scenario).values():
        assert vid == "r2" and md == {"m": {"deep": [2]}}
        np.testing.assert_array_equal(stored, want)


# ------------------------------------------------------ stress and edges


def test_random_ops_match_model():
    """A seeded sequence of adds, deletes, updates and searches, against a
    dict model (exact k nearest) and against the other package."""
    def scenario(pkg):
        rng = np.random.default_rng(12)
        c = pkg.Collection("fuzz", 8, "euclidean", **pkg.dev)
        model, next_id, answers = {}, 0, []
        for step in range(200):
            op = rng.random()
            if op < 0.5 or not model:
                vid, next_id = f"f{next_id}", next_id + 1
                vec = rng.normal(size=8).astype(np.float32)
                c.add(vid, vec, {"step": step})
                model[vid] = vec
            elif op < 0.7:
                vid = str(rng.choice(list(model.keys())))
                c.delete(vid)
                del model[vid]
            elif op < 0.8:
                vid = str(rng.choice(list(model.keys())))
                vec = rng.normal(size=8).astype(np.float32)
                c.update(vid, vector=vec)
                model[vid] = vec
            else:
                q = rng.normal(size=8).astype(np.float32)
                k = int(rng.integers(1, 8))
                got = hits(pkg, c, q, k)
                ids = list(model)
                dists = [float(np.linalg.norm(q - model[i])) for i in ids]
                assert [i for i, _ in got] == [i for _, i in sorted(zip(dists, ids))[:k]]
                answers.append(got)
        assert c.size == len(model)
        return answers

    out = both(scenario)
    assert len(out["torch"]) == len(out["jax"]) > 10
    for t, j in zip(out["torch"], out["jax"]):
        assert_hits_agree(t, j)


def test_concurrent_mixed_ops():
    """Eight threads adding, deleting and searching one collection; the
    store stays consistent (bounded joins, asserted finished)."""
    for pkg in PKGS:
        c = pkg.Collection("conc", 8, "euclidean", **pkg.dev)
        c.add_batch([f"base{i}" for i in range(100)], rows(100, 8))
        errors = []

        def worker(tid, c=c, errors=errors, pkg=pkg):
            try:
                trng = np.random.default_rng(tid)
                for i in range(30):
                    r = trng.random()
                    if r < 0.4:
                        c.add(f"t{tid}-{i}", trng.normal(size=8).astype(np.float32))
                    elif r < 0.6:
                        try:
                            c.delete(f"t{tid}-{i - 1}")
                        except KeyError:
                            pass
                    else:
                        assert len(hits(pkg, c, trng.normal(size=8).astype(np.float32), 5)) <= 5
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errors, errors
        for vid in c.store.ids():
            assert c.store.id_of(c.store.slot_of(vid)) == vid


def test_concurrent_flush_and_writes(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root, default_engine="exact"))
        c = db.create_collection("cf", 8, "euclidean")
        rng = np.random.default_rng(1)
        errors = []

        def writer():
            try:
                for i in range(40):
                    c.add(f"w{i}", rng.normal(size=8).astype(np.float32))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        def flusher():
            try:
                for _ in range(10):
                    db.persistence.flush_collection(c)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        ts = [threading.Thread(target=writer), threading.Thread(target=flusher)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
            assert not t.is_alive()
        assert not errors, errors
        db.persistence.flush_collection(c)
        db.close()
        db2 = pkg.DB(opts(pkg, root, default_engine="exact"))
        out = db2.get_collection("cf").size
        db2.close()
        return out

    assert both(scenario, tmp_path / "f") == {"jax": 40, "torch": 40}


def test_exact_search_deterministic():
    def scenario(pkg):
        vecs, q = rows(200, 8, seed=4), rows(4, 8, seed=5)
        out = []
        for _ in range(2):
            c = pkg.Collection("det", 8, "euclidean", **pkg.dev)
            c.add_batch([f"v{i}" for i in range(200)], vecs)
            rs = c.search_batch([pkg.types.SearchRequest(vector=q[b], top_k=7) for b in range(4)])
            out.append([[r.id for r in resp.results] for resp in rs])
        assert out[0] == out[1]
        return out[0]

    out = both(scenario)
    assert out["torch"] == out["jax"]


def test_edge_cases():
    def scenario(pkg):
        c = pkg.Collection("edge", 8, "euclidean", **pkg.dev)
        q = np.ones(8, np.float32)
        S = pkg.types.SearchRequest
        assert c.search(S(vector=q, top_k=3)).results == []
        with pytest.raises(ValueError):
            c.search(S(vector=q, top_k=0))
        c.add("a", q, None)
        with pytest.raises(ValueError):
            c.add("a", q)
        assert len(c.search(S(vector=q, top_k=10_000)).results) == 1
        c.delete("a")
        assert c.search(S(vector=q, top_k=3)).results == []
        cz = pkg.Collection("edgez", 8, "cosine", **pkg.dev)
        cz.add("z", np.zeros(8, np.float32))
        zero = cz.search(S(vector=q, top_k=1)).results[0].distance
        cz.add("one", q)
        resp = cz.search(S(vector=q, top_k=1, options=pkg.types.SearchOptions(include_vectors=True)))
        resp.results[0].vector[:] = 999.0
        one = pkg.Collection("one", 1, "euclidean", **pkg.dev)
        one.add_batch([f"v{i}" for i in range(5)], np.arange(5, dtype=np.float32)[:, None])
        near = [x.id for x in one.search(S(vector=np.asarray([2.2], np.float32), top_k=2)).results]
        return zero, float(cz.get("one").values[0]), near

    out = both(scenario)
    assert out["torch"][0] == pytest.approx(1.0) and out["torch"] == out["jax"]
    assert out["torch"][1:] == (1.0, ["v2", "v3"])


# ---------------------------------------------------- collector and arrow


def test_collector_snapshot_and_recall():
    def scenario(pkg):
        c = pkg.Collection("coll", 8, "euclidean", **pkg.dev)
        c.add_batch([f"v{i}" for i in range(100)], rows(100, 8), [{"i": i} for i in range(100)])
        col = pkg.Collector()
        col.record_latency(4.0)
        col.record_latency(8.0)
        snap = col.snapshot()
        assert snap.memory_mb > 0
        r = col.measure_recall(c, k=5, sample=16)
        empty = pkg.Collector().measure_recall(pkg.Collection("e", 8, **pkg.dev))
        return snap.avg_latency_ms, r, col.snapshot().recall, empty

    out = both(scenario)
    assert out["torch"] == out["jax"] == (pytest.approx(6.0), 1.0, 1.0, 0.0)


def test_collector_recall_of_the_hybrid_matches_jax():
    """The collector's oracle against the hybrid's IVF side, the port's IVF
    holding the JAX engine's topology: the same recall."""
    vecs = rows(2000, 16, seed=6)
    out = {}
    topo = None
    for pkg in PKGS:
        c = pkg.Collection("h", 16, "euclidean", **pkg.dev, engine_factory=lambda s, pkg=pkg: (
            __import__(("quiver_tpu" if pkg is JAX else "quiver_tpu_torch") + ".index.hybrid",
                       fromlist=["HybridIndex"]).HybridIndex(s)))
        if topo is None:
            c.add_batch([f"v{i}" for i in range(2000)], vecs)
            topo = c.engine.export_topology()
        else:
            c.load_rows([f"v{i}" for i in range(2000)], vecs)
            c.engine.import_topology(topo, np.arange(c.store.capacity))
        out[pkg.name] = pkg.Collector().measure_recall(c, k=10, sample=64, seed=3)
    assert out["torch"] == pytest.approx(out["jax"], abs=1 / 640 + 1e-9)
    assert out["torch"] >= 0.9


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)])
def test_arrow_ipc_across_packages(tmp_path, writer, reader):
    p = str(tmp_path / "c.arrow")
    vecs = rows(50, 8)
    c = writer.Collection("arrow", 8, "euclidean", **writer.dev)
    c.add_batch([f"v{i}" for i in range(50)], vecs, [{"i": i} for i in range(50)])
    writer.arrow.export_collection(c, p)
    ids, rvecs, mds = reader.arrow.load_arrow_ipc(p)
    assert ids == [f"v{i}" for i in range(50)] and mds[3] == {"i": 3}
    np.testing.assert_array_equal(rvecs, vecs)
    c2 = reader.Collection("fresh", 8, "euclidean", **reader.dev)
    assert reader.arrow.import_collection(c2, p) == 50 and c2.size == 50
    assert hits(reader, c2, vecs[7])[0][0] == "v7"
    e = str(tmp_path / "e.arrow")
    writer.arrow.save_arrow_ipc(e, [], np.zeros((0, 8), np.float32), [])
    ids, vecs, _ = reader.arrow.load_arrow_ipc(e)
    assert ids == [] and len(vecs) == 0
