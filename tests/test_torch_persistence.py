"""The port's persistence (``quiver_tpu_torch.persistence``, ``native``) and
``DB`` against the JAX package's, on the CPU.

The scenarios of tests/test_persistence.py run through both packages on the
same seeded numpy rows (each scenario is one function over a package
namespace, run for both, the results held to each other): Parquet and JSON
codecs, WAL replay (deletes honored, torn tails cut, sealed segments in
order), the flush protocol (a write during the flush's disk phase
survives, a failed flush keeps its segment), reload, backup and restore,
the DB's lifecycle and options, and the native WAL. The port's WAL is
always the native writer, built with g++ at first use.

Then the files themselves: a storage directory written by either package
loads in the other, for an ``exact``, an ``ivf`` and an ``hnsw``
collection, with the topology sidecar (the reader imports the graph and
inserts only the rows the WAL added after it) and a WAL of writes after
the last flush; JSON-lines WALs
(the reference's Python writer) in both directions, and native frames with
each package's ``wal.cc`` built into ``tmp_path`` and each log read with
the other's library. Codecs are exact (arrays equal bit for bit); search
distances agree to rtol/atol 1e-5 (f32 in both; only the summation order
differs).

``test_engine_kind_survives_reload`` of the reference reloads an
``engine="hnsw"`` collection; :func:`test_engine_kind_survives_reload_ivf`
runs it with ``engine="ivf"``, and the cross-package directory test with
``engine="hnsw"``.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import quiver_tpu.native as jnative
import quiver_tpu.persistence.manager as jmanager
import quiver_tpu_torch.native as tnative
import quiver_tpu_torch.persistence.manager as tmanager
from quiver_tpu import types as jtypes
from quiver_tpu.core.db import DB as JDB
from quiver_tpu.core.db import DBOptions as JDBOptions
from quiver_tpu.index.hnsw import HNSWIndex as JHNSW
from quiver_tpu.persistence import parquet_io as jpq
from quiver_tpu_torch import types as ttypes
from quiver_tpu_torch.core.db import DB as TDB
from quiver_tpu_torch.core.db import DBOptions as TDBOptions
from quiver_tpu_torch.index.hnsw import HNSWIndex as THNSW
from quiver_tpu_torch.persistence import parquet_io as tpq

D = 6
TOL = 1e-5

JAX = types.SimpleNamespace(
    name="jax", DB=JDB, DBOptions=JDBOptions, manager=jmanager, pq=jpq, types=jtypes,
    native=jnative, hnsw=JHNSW, dev={})
TORCH = types.SimpleNamespace(
    name="torch", DB=TDB, DBOptions=TDBOptions, manager=tmanager, pq=tpq, types=ttypes,
    native=tnative, hnsw=THNSW, dev={"device": "cpu"})
PKGS = (JAX, TORCH)


def opts(pkg, root, **kw):
    kw.setdefault("storage_path", str(root))
    kw.setdefault("default_engine", "exact")
    kw.setdefault("flush_interval_s", 0)  # no background thread in tests
    return pkg.DBOptions(**kw, **pkg.dev)


def seed(db, n=20, name="c1"):
    rng = np.random.default_rng(1)
    c = db.create_collection(name, D, "euclidean")
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    c.add_batch([f"v{i}" for i in range(n)], vecs,
                [{"i": i, "tag": "a" if i % 2 else "b"} for i in range(n)])
    return c, vecs


def both(tmp_path, scenario):
    """Run ``scenario(pkg, root)`` for both packages; returns {name: result}."""
    return {p.name: scenario(p, tmp_path / p.name) for p in PKGS}


def top(pkg, coll, vec, k=1):
    r = coll.search(pkg.types.SearchRequest(vector=vec, top_k=k))
    return [(i.id, i.distance) for i in r.results]


def assert_hits_agree(a, b):
    assert [i for i, _ in a] == [i for i, _ in b]
    np.testing.assert_allclose([d for _, d in a], [d for _, d in b], rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ codecs


@pytest.mark.parametrize("writer,reader", [(jpq, tpq), (tpq, jpq), (tpq, tpq)])
def test_parquet_roundtrip_across_packages(tmp_path, writer, reader):
    p = str(tmp_path / "v.parquet")
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(2500, D)).astype(np.float32)  # > one read batch
    ids = [f"id{i}" for i in range(2500)]
    mds = [{"x": i} if i % 3 else None for i in range(2500)]
    writer.write_vectors_parquet(p, ids, vecs, mds)
    rids, rvecs, rmds = reader.read_vectors_parquet(p)
    assert rids == ids and rmds == mds
    np.testing.assert_array_equal(rvecs, vecs)
    assert not os.path.exists(p + ".tmp")
    e = str(tmp_path / "e.parquet")
    writer.write_vectors_parquet(e, [], np.zeros((0, D), np.float32), [])
    ids, vecs, _ = reader.read_vectors_parquet(e)
    assert ids == [] and len(vecs) == 0


@pytest.mark.parametrize("writer,reader", [(jpq, tpq), (tpq, jpq)])
def test_json_snapshot_and_safe_write_across_packages(tmp_path, writer, reader):
    p = str(tmp_path / "v.json")
    vecs = np.arange(3 * D, dtype=np.float32).reshape(3, D) / 7
    writer.write_vectors_json(p, ["a", "b", "c"], vecs, [None, {"k": 1}, None])
    ids, rvecs, mds = reader.read_vectors_json(p)
    assert ids == ["a", "b", "c"] and mds[1] == {"k": 1}
    np.testing.assert_array_equal(rvecs, vecs)
    f = str(tmp_path / "f.bin")
    writer.safe_write_file(f, b"hello")
    reader.safe_write_file(f, b"world")
    assert open(f, "rb").read() == b"world" and not os.path.exists(f + ".tmp")


def test_config_roundtrip_across_packages():
    kw = dict(name="x", dimension=4, distance_func="manhattan", facet_fields=["a", "b"],
              engine="ivf", engine_config={"ivf": {"n_probe": 4}})
    for w, r in ((jmanager, tmanager), (tmanager, jmanager)):
        cfg = w.CollectionConfig(**kw)
        back = r.CollectionConfig.from_json(cfg.to_json())
        assert back.to_json() == cfg.to_json()


def test_without_pyarrow_the_snapshot_is_json(tmp_path, monkeypatch):
    """The port imports and runs without pyarrow: its Parquet write raises
    ImportError and the reference's own fallback writes vectors.json,
    which both packages load."""
    db = TDB(opts(TORCH, tmp_path / "d"))
    c, vecs = seed(db)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError):
        tpq.write_vectors_parquet(str(tmp_path / "x.parquet"), ["a"], vecs[:1], [None])
    db.close()
    files = sorted(os.listdir(tmp_path / "d" / "c1"))
    assert "vectors.json" in files and "vectors.parquet" not in files
    monkeypatch.undo()
    for pkg in PKGS:
        db2 = pkg.DB(opts(pkg, tmp_path / "d"))
        c2 = db2.get_collection("c1")
        assert c2.size == 20 and top(pkg, c2, vecs[3])[0][0] == "v3"
        db2.close = lambda: None  # keep the JSON snapshot for the next package


# --------------------------------------------------------------------- wal


def test_wal_replay_add_and_delete(tmp_path):
    def scenario(pkg, root):
        mgr = pkg.manager.PersistenceManager(str(root), flush_interval_s=0)
        os.makedirs(mgr.collection_dir("c"), exist_ok=True)
        w = mgr.wal("c")
        w.append("add", "a", vector=np.ones(D, np.float32), metadata={"k": 1})
        w.append("add", "b", vector=np.zeros(D, np.float32))
        w.append("delete", "a")
        return mgr.load_collection_data("c")

    out = both(tmp_path, scenario)
    for ids, vecs, mds in out.values():
        assert ids == ["b"] and mds == [None]  # deletes are replayed
        np.testing.assert_array_equal(vecs, np.zeros((1, D)))


def test_wal_torn_tail_tolerated(tmp_path):
    def scenario(pkg, root):
        mgr = pkg.manager.PersistenceManager(str(root), flush_interval_s=0)
        os.makedirs(mgr.collection_dir("c"), exist_ok=True)
        mgr.wal("c").append("add", "a", vector=np.ones(D, np.float32))
        with open(mgr._wal_path("c"), "a") as f:
            f.write('{"type": "add", "vector_id": "torn...')  # simulated crash
        return pkg.manager.read_wal_any(mgr._wal_path("c"))

    for entries in both(tmp_path, scenario).values():
        assert len(entries) == 1 and entries[0]["vector_id"] == "a"


def test_wal_segments_replay_in_order(tmp_path):
    def scenario(pkg, root):
        mgr = pkg.manager.PersistenceManager(str(root), flush_interval_s=0)
        os.makedirs(mgr.collection_dir("c"), exist_ok=True)
        mgr.wal("c").append("add", "a", vector=np.ones(D, np.float32))
        mgr.rotate_wal("c")
        mgr.wal("c").append("delete", "a")
        mgr.wal("c").append("add", "b", vector=np.zeros(D, np.float32))
        mgr.rotate_wal("c")
        mgr.wal("c").append("add", "a", vector=np.full(D, 2, np.float32))
        return mgr.load_collection_data("c")

    for ids, vecs, _ in both(tmp_path, scenario).values():
        assert sorted(ids) == ["a", "b"]
        np.testing.assert_array_equal(vecs[ids.index("a")], np.full(D, 2))


def test_wal_truncated_after_flush(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root))
        c, _ = seed(db)
        wal_path = db.persistence._wal_path("c1")
        assert os.path.exists(wal_path) and os.path.getsize(wal_path) > 0
        db.persistence.flush_collection(c)
        gone = (not os.path.exists(wal_path)) or os.path.getsize(wal_path) == 0
        db.close()
        return gone

    assert all(both(tmp_path, scenario).values())


def test_write_during_flush_survives_crash(tmp_path, monkeypatch):
    """A write acknowledged during the flush's disk phase goes to the fresh
    live segment and survives a crash."""
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root))
        c, _ = seed(db, n=4)
        real_write = pkg.manager.write_vectors_parquet
        fired = []

        def write_and_mutate(path, ids, vecs, mds):
            real_write(path, ids, vecs, mds)
            if not fired:
                fired.append(True)
                c.add("mid_flush", np.full(D, 7, np.float32), {"late": True})

        monkeypatch.setattr(pkg.manager, "write_vectors_parquet", write_and_mutate)
        db.persistence.flush_collection(c)
        monkeypatch.undo()
        del db, c  # crash: no close()
        db2 = pkg.DB(opts(pkg, root))
        c2 = db2.get_collection("c1")
        out = (c2.size, "mid_flush" in c2.store, c2.get("mid_flush").metadata)
        db2.close()
        return out

    out = both(tmp_path, scenario)
    assert out["torch"] == out["jax"] == (5, True, {"late": True})


def test_failed_flush_keeps_sealed_segment(tmp_path, monkeypatch):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root))
        c, _ = seed(db, n=3)
        boom = lambda *a, **k: (_ for _ in ()).throw(OSError("disk full"))  # noqa: E731
        monkeypatch.setattr(pkg.manager, "write_vectors_parquet", boom)
        monkeypatch.setattr(pkg.manager, "write_vectors_json", boom)
        with pytest.raises(OSError):
            db.persistence.flush_collection(c)
        assert db.persistence._wal_segments("c1")
        c.add("post_fail", np.ones(D, np.float32))
        monkeypatch.undo()
        del db, c
        db2 = pkg.DB(opts(pkg, root))
        c2 = db2.get_collection("c1")
        out = (c2.size, "post_fail" in c2.store, "v0" in c2.store)
        db2.close()
        return out

    out = both(tmp_path, scenario)
    assert out["torch"] == out["jax"] == (4, True, True)


# ------------------------------------------------------------- db + reload


def test_flush_then_load_roundtrip(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root))
        c, vecs = seed(db)
        c.delete("v0")
        db.close()
        db2 = pkg.DB(opts(pkg, root))
        assert db2.list_collections() == ["c1"]
        c2 = db2.get_collection("c1")
        flt = __import__(f"{'quiver_tpu' if pkg is JAX else 'quiver_tpu_torch'}.facets.filters",
                         fromlist=["EqualityFilter"])
        items = c2.search_with_facets(vecs[0], 30, [flt.EqualityFilter("tag", "a")])
        out = (c2.size, c2.metric.value, top(pkg, c2, vecs[3], 3), sorted(i.id for i in items))
        db2.close()
        return out

    out = both(tmp_path, scenario)
    t, j = out["torch"], out["jax"]
    assert t[:2] == j[:2] == (19, "euclidean")
    assert_hits_agree(t[2], j[2])
    assert t[2][0][0] == "v3" and t[3] == j[3]
    assert all(int(i[1:]) % 2 == 1 for i in t[3])


def test_unflushed_writes_survive_via_wal(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root))
        _, vecs = seed(db, n=5)
        kind = type(db.persistence.wal("c1")).__name__
        del db  # crash
        db2 = pkg.DB(opts(pkg, root))
        c2 = db2.get_collection("c1")
        out = (c2.size, top(pkg, c2, vecs[2]), kind)
        db2.close()
        return out

    out = both(tmp_path, scenario)
    assert out["torch"][0] == out["jax"][0] == 5
    assert_hits_agree(out["torch"][1], out["jax"][1])
    assert out["torch"][1][0][0] == "v2" and out["torch"][2] == "NativeWalWriter"


def test_parquet_corruption_falls_back_to_json(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root))
        c, _ = seed(db, n=4)
        db.persistence.flush_collection(c)
        cdir = db.persistence.collection_dir("c1")
        pkg.pq.write_vectors_json(os.path.join(cdir, "vectors.json"),
                                  ["j1"], np.ones((1, D), np.float32), [None])
        with open(os.path.join(cdir, "vectors.parquet"), "wb") as f:
            f.write(b"not parquet")
        db.close = lambda: None  # avoid a reflush clobbering the corruption
        db2 = pkg.DB(opts(pkg, root))
        out = db2.get_collection("c1").size
        db2.close()
        return out

    assert both(tmp_path, scenario) == {"jax": 1, "torch": 1}


def test_backup_restore_roundtrip(tmp_path):
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root / "data"))
        c, vecs = seed(db)
        db.backup(str(root / "backup"))
        for _, _, files in os.walk(root / "backup"):
            assert not any(f.endswith(".wal") for f in files)
        c.delete_batch([f"v{i}" for i in range(10)])
        db.create_collection("c2", D)
        assert c.size == 10
        db.restore(str(root / "backup"))
        c1 = db.get_collection("c1")
        out = (db.list_collections(), c1.size, top(pkg, c1, vecs[3]))
        db.close()
        return out

    out = both(tmp_path, scenario)
    assert out["torch"][:2] == out["jax"][:2] == (["c1"], 20)
    assert_hits_agree(out["torch"][2], out["jax"][2])


def test_db_collection_lifecycle_and_options(tmp_path):
    for pkg in PKGS:
        db = pkg.DB(opts(pkg, tmp_path / pkg.name))
        db.create_collection("a", D)
        with pytest.raises(ValueError, match="already exists"):
            db.create_collection("a", D)
        with pytest.raises(KeyError):
            db.get_collection("nope")
        db.delete_collection("a")
        assert db.list_collections() == []
        assert not os.path.isdir(db.persistence.collection_dir("a"))
        db.close()
        mem = pkg.DB(pkg.DBOptions(enable_persistence=False, default_engine="exact", **pkg.dev))
        c = mem.create_collection("mem", D)
        c.add("x", np.ones(D, np.float32))
        assert top(pkg, c, np.ones(D, np.float32))[0][0] == "x"
        mem.close()
        for kw in ({"default_engine": "bogus"}, {"flush_interval_s": -1},
                   {"storage_path": "", "enable_persistence": True},
                   {"compute_dtype": "float16"}):
            with pytest.raises(ValueError):
                pkg.DBOptions(**kw).validate()


def test_engine_kind_survives_reload_ivf(tmp_path):
    """test_engine_kind_survives_reload with engine="ivf" (the reference's
    case reloads an HNSW collection): the engine and its persisted JSON
    config come back; a config without the field takes the DB default."""
    def scenario(pkg, root):
        db = pkg.DB(opts(pkg, root))
        c = db.create_collection("g", D, "euclidean", engine="ivf",
                                 engine_config={"ivf": {"n_probe": 4, "build_threshold": 64}})
        rng = np.random.default_rng(2)
        vecs = rng.normal(size=(128, D)).astype(np.float32)
        c.add_batch([f"v{i}" for i in range(128)], vecs)
        db.close()
        db2 = pkg.DB(opts(pkg, root))
        c2 = db2.get_collection("g")
        out = [c2.engine_kind, c2.engine.name, c2.engine.config.n_probe,
               c2.engine_config_json, top(pkg, c2, vecs[5])]
        db2.close()
        cfg_path = os.path.join(str(root), "g", "config.json")
        with open(cfg_path) as f:
            cfg = json.load(f)
        cfg.pop("engine")
        cfg.pop("engine_config")  # an ivf block would not apply to the default
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        db3 = pkg.DB(opts(pkg, root))
        out.append(db3.get_collection("g").engine_kind)
        db3.close()
        return out

    out = both(tmp_path, scenario)
    t, j = out["torch"], out["jax"]
    assert t[:4] == j[:4] == ["ivf", "ivf", 4, {"ivf": {"n_probe": 4, "build_threshold": 64}}]
    assert_hits_agree(t[4], j[4])
    assert t[4][0][0] == "v5" and t[5] == j[5] == "exact"


def test_cuda_db_without_card_raises(monkeypatch, tmp_path):
    """The port's DB runs on the card unless asked for the CPU: a "cuda" DB
    on a machine with no card raises and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TDBOptions().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDB(TDBOptions(enable_persistence=False))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDB(TDBOptions(storage_path=str(tmp_path / "d"), device="cuda:0"))


# -------------------------------------------------------------- native wal


def test_native_wal_roundtrip_and_torn_tail(tmp_path):
    def scenario(pkg, root):
        assert pkg.native.available()
        os.makedirs(root)
        p = str(root / "n.wal")
        w = pkg.native.NativeWalWriter(p)
        w.append("add", "a", vector=np.ones(D, np.float32), metadata={"k": 1})
        w.append_many([("add", "b", np.zeros(D, np.float32), None),
                       ("delete", "a", None, None)])
        w.close()
        entries = pkg.native.read_native_wal(p)
        with open(p, "ab") as f:
            f.write(b"\x50\x00\x00\x00garbage-partial-frame")  # torn write
        return entries, pkg.native.read_native_wal(p)

    out = both(tmp_path, scenario)
    for entries, torn in out.values():
        assert [e["type"] for e in entries] == ["add", "add", "delete"]
        assert entries[0]["metadata"] == {"k": 1} and len(torn) == 3
    strip = lambda es: [{k: v for k, v in e.items() if k != "timestamp"} for e in es]  # noqa: E731
    assert strip(out["torch"][0]) == strip(out["jax"][0])


def _build_wal(src, out_dir):
    os.makedirs(out_dir)
    lib = os.path.join(out_dir, "libquiver_wal.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-o", lib, src],
                   check=True, capture_output=True, timeout=120)
    return lib


def test_native_frames_read_across_packages(tmp_path, monkeypatch):
    """Each package's wal.cc, built into tmp_path: a log written through one
    library reads through the other's, frame for frame, both ways."""
    import ctypes

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jlib = _build_wal(os.path.join(here, "quiver_tpu", "native", "wal.cc"), tmp_path / "jlib")
    tlib = _build_wal(os.path.join(here, "quiver_tpu_torch", "native", "wal.cc"), tmp_path / "tlib")
    monkeypatch.setattr(jnative, "_LIB_PATH", jlib)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(tnative, "load", lambda: tnative.bind(ctypes.CDLL(tlib)))
    entries = [("add", f"v{i}", np.full(D, i, np.float32), {"i": i}) for i in range(5)]
    entries.append(("delete", "v2", None, None))
    for name, writer, reader in (("j", jnative, tnative), ("t", tnative, jnative)):
        p = str(tmp_path / f"{name}.wal")
        w = writer.NativeWalWriter(p)
        w.append_many(entries)
        w.close()
        got = reader.read_native_wal(p)
        assert [(e["type"], e["vector_id"], e.get("metadata")) for e in got] == \
            [(t, i, m) for t, i, _, m in entries]
        np.testing.assert_array_equal(got[3]["vector"], np.full(D, 3, np.float32))
        assert got == writer.read_native_wal(p)


# ------------------------------------------- directories across packages


def _write_dir(pkg, root, engine, *, crash):
    """Collection "c" of ``engine`` written by ``pkg``: 300 rows flushed
    (snapshot + sidecar), then 20 deletes and 20 adds in the WAL only;
    ``crash`` drops the DB unclosed. Returns (ids, vectors) of its rows."""
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(300, D)).astype(np.float32)
    db = pkg.DB(opts(pkg, root))
    cfg = {"ivf": {"n_clusters": 8, "n_probe": 8, "build_threshold": 64}} if engine == "ivf" else None
    c = db.create_collection("c", D, "euclidean", engine=engine, engine_config=cfg)
    c.add_batch([f"v{i}" for i in range(300)], vecs, [{"i": i} for i in range(300)])
    db.persistence.flush_collection(c)
    c.delete_batch([f"v{i}" for i in range(20)])
    extra = rng.normal(size=(20, D)).astype(np.float32)
    c.add_batch([f"w{i}" for i in range(20)], extra)
    if crash:
        del db, c
    else:
        db.close()
    ids = [f"v{i}" for i in range(20, 300)] + [f"w{i}" for i in range(20)]
    return ids, np.concatenate([vecs[20:], extra])


@pytest.mark.parametrize("crash", [False, True])
@pytest.mark.parametrize("engine", ["exact", "ivf", "hnsw"])
@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)])
def test_storage_directory_loads_in_the_other_package(tmp_path, monkeypatch, writer, reader,
                                                      engine, crash):
    """Written by one package, loaded by the other: rows, metadata, the
    engine kind and the sidecar's topology (for IVF the same centroids and
    assignment of every snapshot row; for HNSW the imported graph, with
    only the WAL's added rows inserted, none rebuilt); with ``crash`` the
    last writes come from the writer's native WAL. The HNSW queries sit a
    little off their rows: at a stored row the graph's affine f32 distance
    is cancellation noise."""
    root = tmp_path / "d"
    ids, vecs = _write_dir(writer, root, engine, crash=crash)
    assert os.path.exists(root / "c" / "topology.npz") == (engine != "exact")
    topo = dict(np.load(root / "c" / "topology.npz")) if engine != "exact" else None
    inserted = []
    insert = reader.hnsw.on_insert
    monkeypatch.setattr(reader.hnsw, "on_insert",
                        lambda self, s, v: (inserted.append(len(s)), insert(self, s, v))[1])
    db = reader.DB(opts(reader, root))
    c = db.get_collection("c")
    assert c.size == len(ids) and c.engine_kind == engine
    assert sorted(c.store.ids()) == sorted(ids) and c.get("v25").metadata == {"i": 25}
    np.testing.assert_array_equal(c.get("w3").values, vecs[ids.index("w3")])
    snap = dict(zip(topo["snapshot_ids"].tolist(), topo["snapshot_slots"].tolist())) if topo else {}
    if engine == "ivf":
        assert c.engine._built
        np.testing.assert_array_equal(np.asarray(c.engine._centroids), topo["centroids"])
        for vid in ("v20", "v150", "v299"):
            assert c.engine._slot_pos[c.store.slot_of(vid), 0] == topo["assign"][snap[vid]]
    if engine == "hnsw":
        assert sum(inserted) == (20 if crash else 0), inserted
        for vid in ("v20", "v150", "v299"):
            assert c.engine.node_level[c.store.slot_of(vid)] == topo["node_level"][snap[vid]]
    jitter = 0.2 if engine == "hnsw" else 0.0
    q5, q0 = vecs[ids.index("w5")] + jitter, vecs[0] + jitter
    hits = top(reader, c, q5, 3)
    assert hits[0][0] == "w5" and "v3" not in [i for i, _ in top(reader, c, q0, 50)]
    db.close()
    # and the writer reads back what the reader flushed
    db2 = writer.DB(opts(writer, root))
    c2 = db2.get_collection("c")
    assert c2.size == len(ids)
    assert_hits_agree(top(writer, c2, q5, 3), hits)
    db2.close()


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)])
def test_json_lines_wal_loads_in_the_other_package(tmp_path, monkeypatch, writer, reader):
    """A JSON-lines WAL (the reference's Python writer, which it uses when
    its native library is not built) written beside a flushed snapshot by
    one package replays in the other."""
    monkeypatch.setattr(jnative, "available", lambda: False)  # JAX: the Python writer
    root = tmp_path / "d"
    db = writer.DB(opts(writer, root))
    c, vecs = seed(db, n=10)
    db.close()
    wal = writer.manager.WalWriter(os.path.join(str(root), "c1", "c1.wal"))
    wal.append("delete", "v1")
    wal.append("add", "z", vector=np.full(D, 9, np.float32), metadata={"late": 1})
    with open(wal.path) as f:
        assert json.loads(f.readline())["type"] == "delete"  # JSON lines, not frames
    db2 = reader.DB(opts(reader, root))
    c2 = db2.get_collection("c1")
    assert c2.size == 10 and "v1" not in c2.store and c2.get("z").metadata == {"late": 1}
    assert top(reader, c2, np.full(D, 9, np.float32))[0][0] == "z"
    db2.close()
