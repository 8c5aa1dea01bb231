"""Where the port's sharded engines put their data (``quiver_tpu_torch/parallel/``).

* The mesh rules (``parallel/sharded.resolve_mesh``, ``make_mesh``) over
  ``torch.device`` objects: ``cuda:i`` devices can be built without a
  card, so the visible-card count is passed in. None, an int and a list;
  no CUDA mesh without a card, and never the CPU unless it is named.
* Every sharded kind on a 4-shard CPU mesh, served by a ``DB`` with
  ``VectorStore.device_view`` patched to raise: build, inserts, updates,
  deletes, a refresh, searches (plain, filtered, with a negative example),
  a flush and a reload from the sidecar. The engines never make the
  store's device view; their answers equal the same run's without the
  patch, and the exact kinds' equal ``ExactIndex``'s.
* Every sharded kind on ``["cpu", "meta"]``, two distinct devices on a
  machine without a card: each shard's tensors sit on its own device after
  construction and after a write, as far as the write path runs on
  ``meta`` (a meta tensor holds no data, so nothing that reads a value
  back runs there, and there are no answers to check).

Test names differ from the reference's: ``tests/conftest.py`` marks slow
by base name.
"""

import numpy as np
import pytest
import torch

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index import make_engine
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.parallel.sharded import make_mesh, resolve_mesh, sharded_exact_of
from quiver_tpu_torch.types import Filter, SearchRequest

from tests.torch_threads import one_torch_thread  # noqa: F401

D = 16
KINDS = ["sharded_exact", "sharded_ivf", "sharded_hnsw", "sharded_hybrid"]
CPU, META = torch.device("cpu"), torch.device("meta")


def cuda(i):
    return torch.device("cuda", i)


# ------------------------------------------------------------------ mesh


@pytest.fixture
def cards(monkeypatch):
    """Set the visible-card count the mesh rules see."""
    from quiver_tpu_torch.parallel import sharded

    return lambda n: monkeypatch.setattr(sharded, "visible_cards", lambda: n)


@pytest.mark.parametrize("mesh, store_dev, n_cards, want", [
    (None, "cuda:0", 4, [cuda(0), cuda(1), cuda(2), cuda(3)]),  # every card
    (None, "cuda:1", 1, [cuda(0)]),
    (None, "cpu", 4, [CPU]),  # a CPU store stays on the CPU
    (4, "cuda:0", 4, [cuda(0), cuda(1), cuda(2), cuda(3)]),  # one shard per card
    (4, "cuda:0", 1, [cuda(0)] * 4),  # four shards on the one card
    (3, "cuda:0", 2, [cuda(0), cuda(1), cuda(0)]),  # round-robin
    (8, "cpu", 0, [CPU] * 8),
    (["cuda:0", "cpu"], "cuda:0", 1, [cuda(0), CPU]),  # a list as it is
    ([cuda(1), cuda(0)], "cuda:0", 0, [cuda(1), cuda(0)]),
    (["cpu", "meta"], "cpu", 0, [CPU, META]),
])
def test_port_resolve_mesh(cards, mesh, store_dev, n_cards, want):
    cards(n_cards)
    assert resolve_mesh(mesh, torch.device(store_dev)) == tuple(want)


@pytest.mark.parametrize("call, n_cards", [
    (lambda: resolve_mesh(None, cuda(0)), 0),
    (lambda: resolve_mesh(2, cuda(0)), 0),
    (lambda: make_mesh(), 0),
    (lambda: make_mesh(), None),  # no card on this machine
])
def test_port_mesh_never_picks_the_cpu(cards, call, n_cards):
    if n_cards is not None:
        cards(n_cards)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_port_make_mesh_over_cards(cards):
    cards(4)
    assert make_mesh() == tuple(cuda(i) for i in range(4))
    assert make_mesh(2) == (cuda(0), cuda(1))
    assert make_mesh(devices=[cuda(2), "cpu"]) == (cuda(2), CPU)
    with pytest.raises(ValueError, match="requested 5 devices"):
        make_mesh(5)
    for bad in (0, -1, []):
        with pytest.raises(ValueError):
            resolve_mesh(bad, CPU)


# --------------------------------------------------- the store's view unmade


def rows(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, D)).astype(np.float32)
    return (centers[rng.integers(0, 24, n)] + 0.1 * rng.normal(size=(n, D))).astype(np.float32)


ENGINE_CONFIG = {
    "sharded_exact": {},
    "sharded_ivf": {"ivf": {"n_probe": 8, "build_threshold": 256, "rescore": False,
                            "background_maintenance": False}},
    "sharded_hnsw": {"hnsw": {"ef_search": 64, "build_batch": 256}},
    "sharded_hybrid": {"ivf": {"n_probe": 8, "build_threshold": 256, "rescore": False,
                               "background_maintenance": False},
                       "adaptive": {"initial_exact_threshold": 100}},
}


def scenario(tmp_path, kind, name):
    """One collection of ``kind`` on a 4-shard CPU mesh through its life;
    returns what it answered at each step and the engine."""
    from quiver_tpu_torch.core.db import DB, DBOptions

    root = str(tmp_path / name)
    opts = DBOptions(storage_path=root, flush_interval_s=0, device="cpu")
    n = 2000
    vecs = rows(n + 100)
    rng = np.random.default_rng(1)
    q = (vecs[:24] + 0.05 * rng.normal(size=(24, D))).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    out = {}
    db = DB(opts)
    coll = db.create_collection("c", D, "euclidean", engine=kind,
                                engine_config={"mesh": 4, **ENGINE_CONFIG[kind]})
    coll.add_batch(ids, vecs[:n], [{"p": i % 3} for i in range(n)])
    coll.add_batch([f"n{i}" for i in range(100)], vecs[n:])
    coll.update_batch(ids[:50], vecs[50:100] + 0.01)
    coll.delete_batch(ids[100:150])
    eng = coll.engine
    ann = getattr(eng, "ann", eng)
    if hasattr(ann, "refresh"):
        ann.refresh()
        assert ann._built

    def answers(tag):
        reqs = [SearchRequest(vector=v, top_k=10) for v in q]
        out[tag] = [[(it.id, round(it.distance, 5)) for it in r.results]
                    for r in coll.search_batch(reqs)]
        out[tag + "_filtered"] = [[it.id for it in coll.search(SearchRequest(
            vector=v, top_k=5, filters=[Filter("p", "=", 1)])).results] for v in q[:6]]
        out[tag + "_negative"] = [[it.id for it in coll.search(SearchRequest(
            vector=v, top_k=5, negative_example=vecs[500], negative_weight=2.0)).results]
            for v in q[:6]]

    answers("before")
    out["slots"] = coll.engine.search_slots(q, 10)[1]
    out["store"] = coll.store
    db.close()
    db = DB(opts)
    coll = db.get_collection("c")
    answers("reloaded")
    out["q"], out["engine"] = q, coll.engine
    db.close()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_port_sharded_kinds_never_make_the_store_view(tmp_path, monkeypatch, kind):
    free = scenario(tmp_path, kind, "free")

    from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex

    # the sharded HNSW engine's sub-stores hold one shard's rows each, on
    # the shard's device: their views are the shards' own copies
    subs, init, view = set(), ShardedHNSWIndex.__init__, VectorStore.device_view

    def register(self, *a, **kw):
        init(self, *a, **kw)
        subs.update(id(st) for st in self._sub_stores)

    def refuse(self):
        if id(self) not in subs:
            raise AssertionError("a sharded engine made the store's device view")
        return view(self)

    monkeypatch.setattr(ShardedHNSWIndex, "__init__", register)
    monkeypatch.setattr(VectorStore, "device_view", refuse)
    got = scenario(tmp_path, kind, "patched")
    monkeypatch.undo()
    for tag in ("before", "before_filtered", "before_negative",
                "reloaded", "reloaded_filtered", "reloaded_negative"):
        assert got[tag] == free[tag], tag
    assert got["reloaded"] == got["before"]  # the sidecar restores the same engine
    for r in got["before_filtered"]:
        assert r and all(int(i[1:]) % 3 == 1 for i in r if i[0] == "v")
    store, q = got["store"], got["q"]
    _, truth = ExactIndex(store).search_slots(q, 10)
    if kind == "sharded_exact":
        np.testing.assert_array_equal(got["slots"], truth)
    else:
        hit = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got["slots"], truth)])
        assert hit >= 0.9, hit
    assert sharded_exact_of(got["engine"]).mesh == (CPU,) * 4


# ----------------------------------------------------- distinct devices: meta


def placed(tensors, dev):
    ts = [t for t in tensors if isinstance(t, torch.Tensor)]
    return bool(ts) and all(t.device == dev for t in ts)


@pytest.mark.parametrize("kind", KINDS)
def test_port_sharded_kinds_place_each_shard_on_its_device(kind):
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    cfg = {"build_threshold": 1 << 20} if kind == "sharded_ivf" else {}
    eng = make_engine(kind, store, mesh=["cpu", "meta"], **cfg)
    exact = sharded_exact_of(eng)
    vecs = rows(3)
    for step in ("construction", "write"):
        if step == "write":
            slots = store.add_batch([f"w{i}" for i in range(len(vecs))], vecs)
            if kind == "sharded_hnsw":
                # one row, on shard 0 (round-robin from 0): a graph build
                # reads values back, which the meta shard cannot give
                eng.on_insert(slots[:1], vecs[:1])
            elif hasattr(eng, "on_insert"):  # the exact engine reads the store's feed
                eng.on_insert(slots, vecs)
        shards = exact.shards()
        assert placed(shards[0], CPU) and placed(shards[1], META), step
        assert shards[1][0].shape == (store.capacity // 2, D)
    if kind == "sharded_hnsw":
        assert [s.device for s in eng._sub_stores] == [CPU, META]
        assert eng._subs[0].entry_point >= 0 and eng._subs[1].entry_point < 0
        assert eng._sub_stores[0].device_view().vectors.device == CPU
    ivf = getattr(eng, "ann", eng)
    if kind in ("sharded_ivf", "sharded_hybrid"):
        ivf._cluster_live = np.ones(8, bool)
        ivf._put_cent_dev(np.zeros((8, D), np.float32))
        assert list(ivf._cent_rep) == [CPU, META]
        assert all(placed(ivf._cent_rep[dev], dev) for dev in (CPU, META))
        assert ivf._cuda_devices() == [] and ivf.device == CPU


def test_port_sharded_ivf_blocks_sit_on_their_shards_devices():
    """A 2-shard engine on ``["cpu", "cpu"]`` lays out and writes each
    shard's ``KL`` clusters in tensors of its own; ``device_bytes_by_device``
    reports the bytes on each device (``["cpu", "meta"]``: half the row
    mirrors on each)."""
    from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    from quiver_tpu_torch.utils.memory import device_bytes_by_device

    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    vecs = rows(3000)
    slots = store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    eng = ShardedIVFIndex(store, ["cpu", "cpu"], n_probe=8, build_threshold=256,
                          background_maintenance=False)
    eng.on_insert(slots, vecs)
    KL, cmax = eng._k_local, eng._cmax
    for t in (eng._blocks_t, eng._block_slot, eng._block_ns, eng._block_inv, eng._keep_dev()):
        assert len(t) == 2 and all(x.shape[0] == KL for x in t)
    assert eng._blocks_t[0].shape == (KL, D, cmax)
    new = rows(40, seed=5)
    ns = store.add_batch([f"n{i}" for i in range(40)], new)
    eng.on_insert(ns, new)
    pos = eng._slot_pos[ns]
    for (c, p), s in zip(pos, ns):
        if c >= 0:  # the row sits in its cluster's shard, at its position
            assert int(eng._block_slot[c // KL][c % KL, p]) == s
            assert bool(eng._keep_dev()[c // KL][c % KL, p])
    _, i = eng.search_slots(new, k=1)
    assert (i[:, 0] == ns).mean() >= 0.9
    per = device_bytes_by_device(eng, skip=(VectorStore,))
    assert list(per) == ["cpu"] and per["cpu"] > sum(
        t.numel() * t.element_size() for t in eng._blocks_t)
    meta = ShardedIVFIndex(store, ["cpu", "meta"], build_threshold=1 << 20)
    meta._exact.shards()
    assert device_bytes_by_device(meta, skip=(VectorStore,)) == {
        "cpu": store.capacity // 2 * (4 * D + 9), "meta": store.capacity // 2 * (4 * D + 9)}


@pytest.mark.parametrize("backend", ["ivf", "hnsw"])
def test_port_sharded_hybrid_keeps_one_mirror_set(backend):
    """A ``sharded_hybrid``'s ANN engine reads the exact side's row
    mirrors, so the corpus is on each device once: its two exact engines
    hold one mirror set, and an IVF hybrid holds that set plus the IVF
    layout (blocks and centroids) and nothing else."""
    from quiver_tpu_torch.utils.memory import device_bytes_by_device

    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    vecs = rows(3000)
    slots = store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    cfg = ({"n_probe": 8, "build_threshold": 256, "background_maintenance": False}
           if backend == "ivf" else {"ef_search": 64, "build_batch": 512})
    hyb = make_engine("sharded_hybrid", store, mesh=["cpu", "cpu"], ann_backend=backend, **cfg)
    hyb.ann.on_insert(slots, vecs)
    q = vecs[:8] + 0.01
    _, ann_i = hyb.ann.search_slots(q, 5)
    _, ex_i = hyb.exact.search_slots(q, 5)
    hyb.ann._exact.search_slots(q, 5, exact=True)
    assert (ann_i[:, 0] == ex_i[:, 0]).mean() >= 0.75
    mirrors = hyb.exact.shards()
    assert all(a is b for sa, sb in zip(hyb.ann._exact.shards(), mirrors) for a, b in zip(sa, sb))
    mirror_bytes = store.capacity * (4 * D + 9)
    # the hybrid's exact side and the ANN engine's fallback: one mirror set
    assert device_bytes_by_device([hyb.exact, hyb.ann._exact], skip=(VectorStore,)) == {
        "cpu": mirror_bytes}
    if backend == "ivf":
        total = device_bytes_by_device(hyb, skip=(VectorStore,))
        # the layout, and the last batch's pending skew check (a scalar)
        pending = [t for t in hyb.ann._pending_load or () if isinstance(t, torch.Tensor)]
        layout = {(t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
                  for t in hyb.ann._layout_tensors() + pending}
        assert total == {"cpu": mirror_bytes + sum(nb for _, nb in layout)}


def test_port_cli_mesh_setting(tmp_path, monkeypatch):
    """The CLI's ``mesh`` (``--mesh``, ``QUIVER_MESH``): empty is every
    card (None), digits a shard count, else device names; it reaches the
    DB as ``engine_config["mesh"]``, which places the sharded kinds and is
    dropped for the others."""
    from quiver_tpu_torch.cli import _make_db, load_config, parse_mesh

    assert [parse_mesh(t) for t in ("", None, "4", "cuda:0,cpu", " cuda:1 , cuda:0 ")] == [
        None, None, 4, ["cuda:0", "cpu"], ["cuda:1", "cuda:0"]]
    monkeypatch.setenv("QUIVER_MESH", "cpu,cpu")
    cfg = load_config(str(tmp_path / "none.yaml"))
    cfg.update(data_dir=str(tmp_path / "d"), device="cpu", flush_interval_s=0)
    db = _make_db(cfg)
    try:
        assert db.options.engine_config == {"mesh": ["cpu", "cpu"]}
        sharded = db.create_collection("s", D, "euclidean", engine="sharded_exact")
        assert sharded.engine.mesh == (CPU, CPU)
        assert db.create_collection("e", D, "euclidean", engine="exact").engine.name == "exact"
    finally:
        db.close()
