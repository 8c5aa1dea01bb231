"""Background maintenance of the port's IVF engine, on the CPU, and the store
API and change feed it reads, against the JAX package.

The maintenance tests are the port's counterparts of tests/test_ivf.py:
524-590 (writes do not block behind a rebuild; writes that race a job are
absorbed), plus a store growth during a job (``changes_since`` returns
None and the job restarts), a failed job (recorded, never raised into
serving), and a stress run of writer threads against a job. A CPU store
runs the job on its thread with no CUDA stream. Every wait has a timeout
and no test sleeps for a fixed time.

The store tests hold ids, metadata (deep-copied both ways), updates,
deletes, snapshots, the change feed and the view's generation to the JAX
store's, exactly.
"""

import sys
import threading
import time

import numpy as np
import pytest

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu_torch import ExactIndex, IVFConfig, IVFIndex, VectorStore

D = 32
WAIT = 120  # seconds: the bound of every wait below


def clustered(n, n_centers=40, seed=0, scale=0.15):
    """tests/test_ivf.py's corpus: Gaussian blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, D)).astype(np.float32)
    which = rng.integers(0, n_centers, n)
    return (centers[which] + scale * rng.normal(size=(n, D))).astype(np.float32)


def make(n=4000, **cfg):
    vecs = clustered(n)
    store = VectorStore(dim=D, metric="euclidean", device="cpu")
    slots = store.add_batch([f"v{i}" for i in range(n)], vecs)
    eng = IVFIndex(store, config=IVFConfig(build_threshold=256, **cfg))
    eng.on_insert(slots, vecs)
    assert eng._built
    return store, vecs, eng


def recall_vs_oracle(store, eng, q, k=10):
    _, oi = ExactIndex(store).search_slots(q, k)
    _, gi = eng.search_slots(q, k)
    return np.mean([len(set(gi[b].tolist()) & set(oi[b].tolist())) / k for b in range(len(q))])


def assert_layout_consistent(store, eng):
    """Each live slot is held exactly once (a kept block position or the
    overflow set) and no dead slot is held."""
    bs = eng._block_slot.numpy()
    keep = eng._keep_dev().numpy()
    held = bs[(bs >= 0) & keep]
    assert len(held) == len(np.unique(held))
    assert not set(held.tolist()) & eng._overflow
    live = set(np.flatnonzero(store._np_valid).tolist())
    assert set(held.tolist()) | eng._overflow == live


def test_writes_do_not_block_behind_maintenance():
    store, vecs, eng = make(rebuild_growth=0.05, n_probe=16)
    retrains0, refreshes0 = eng._n_retrains, eng._n_refreshes
    new = clustered(600, seed=7)
    slots = store.add_batch([f"bg{i}" for i in range(600)], new)
    t0 = time.perf_counter()
    eng.on_insert(slots, new)  # ratio 0.15 > 0.05: triggers maintenance
    assert time.perf_counter() - t0 < 5.0
    # queries serve during the job; fresh rows are found at once
    _, i = eng.search_slots(new[:16], k=1)
    assert (i[:, 0] == slots[:16]).mean() >= 0.9
    assert eng.wait_maintenance(timeout=WAIT)
    assert eng._maint_error is None, eng._maint_error
    m = eng.get_detailed_metrics()["maintenance"]
    assert m["swaps"] >= 1 and not m["inflight"] and m["last_swap_stall_s"] < 2.5
    assert eng._n_retrains + eng._n_refreshes > retrains0 + refreshes0
    assert eng._built_size == 4600 and eng._churn == 0
    assert eng._maint_stream is None  # a CPU store runs the job with no stream
    rng = np.random.default_rng(5)
    q = (new[:32] + 0.02 * rng.normal(size=(32, D))).astype(np.float32)
    assert recall_vs_oracle(store, eng, q) >= 0.9
    assert_layout_consistent(store, eng)


def test_racing_writes_are_absorbed():
    store, vecs, eng = make(rebuild_growth=0.05, n_probe=16)
    a = clustered(600, seed=21)
    sa = store.add_batch([f"ra{i}" for i in range(600)], a)
    eng.on_insert(sa, a)  # triggers background maintenance
    b = clustered(64, seed=22)
    sb = store.add_batch([f"rb{i}" for i in range(64)], b)
    eng.on_insert(sb, b)
    dead = np.asarray(sa[:32])
    store.delete_batch([f"ra{i}" for i in range(32)])
    eng.on_delete(dead)
    assert eng.wait_maintenance(timeout=WAIT)
    assert eng._maint_error is None, eng._maint_error
    _, gi = eng.search_slots(b, k=1)
    assert (gi[:, 0] == sb).mean() >= 0.95
    _, i = eng.search_slots(vecs[:8], k=64)
    assert not np.isin(i, dead).any()
    assert_layout_consistent(store, eng)


def test_store_growth_during_a_job_restarts_it():
    """A capacity growth while the job builds bumps the change feed's
    epoch: ``changes_since`` returns None and the job starts over from a
    fresh snapshot; the swap then holds the grown corpus."""
    store, vecs, eng = make(rebuild_growth=0.05, n_probe=16)
    started, go = threading.Event(), threading.Event()
    calls = []
    make_staging = eng._make_staging

    def gated(kind):
        calls.append(kind)
        staging = make_staging(kind)
        if len(calls) == 1:  # hold the first attempt after its cursor
            started.set()
            assert go.wait(WAIT)
        return staging

    eng._make_staging = gated
    a = clustered(600, seed=31)
    sa = store.add_batch([f"g{i}" for i in range(600)], a)
    eng.on_insert(sa, a)
    assert started.wait(WAIT)
    cap0 = store.capacity
    grow = clustered(cap0 - store.size + 100, seed=32)
    sg = store.add_batch([f"h{i}" for i in range(len(grow))], grow)
    assert store.capacity > cap0
    eng.on_insert(sg, grow)
    go.set()
    assert eng.wait_maintenance(timeout=WAIT)
    assert eng._maint_error is None, eng._maint_error
    # one swap from two attempts: the first restarted, never adopted
    assert len(calls) == 2
    assert eng.get_detailed_metrics()["maintenance"]["swaps"] == 1
    assert len(eng._slot_pos) == store.capacity
    _, gi = eng.search_slots(grow[:64], k=1)
    assert (gi[:, 0] == sg[:64]).mean() >= 0.95
    assert_layout_consistent(store, eng)


def test_a_failed_job_is_recorded_not_raised():
    store, vecs, eng = make(rebuild_growth=0.05, n_probe=16)

    def broken(kind):
        raise RuntimeError("staging failed")

    eng._make_staging = broken
    a = clustered(600, seed=41)
    sa = store.add_batch([f"f{i}" for i in range(600)], a)
    eng.on_insert(sa, a)  # the job fails on its thread
    assert eng.wait_maintenance(timeout=WAIT)
    m = eng.get_detailed_metrics()["maintenance"]
    assert "staging failed" in m["error"] and m["swaps"] == 0
    assert eng._churn == 600  # not reset: the next write re-triggers
    _, gi = eng.search_slots(a[:16], k=1)  # serving goes on
    assert (gi[:, 0] == sa[:16]).mean() >= 0.9
    del eng._make_staging
    store.delete_batch(["f0"])
    eng.on_delete(np.asarray(sa[:1]))  # churn still over the trigger
    assert eng.wait_maintenance(timeout=WAIT)
    m = eng.get_detailed_metrics()["maintenance"]
    assert m["error"] is None and m["swaps"] == 1


def test_writer_threads_race_a_job():
    """Three writer threads insert, update and delete while maintenance
    jobs run, under a short switch interval; afterwards the layout holds
    each live slot exactly once and every live row is found."""
    store, vecs, eng = make(n=3000, rebuild_growth=0.05, n_probe=16)
    errors = []
    lock = threading.Lock()  # the store and engine calls of one write

    def writer(w):
        try:
            rng = np.random.default_rng(100 + w)
            for step in range(12):
                rows = clustered(64, seed=1000 * w + step)
                with lock:
                    sl = store.add_batch([f"w{w}_{step}_{j}" for j in range(64)], rows)
                    eng.on_insert(sl, rows)
                if step % 3 == 2:
                    victims = [f"w{w}_{step - 1}_{j}" for j in range(0, 64, 4)]
                    with lock:
                        slots = np.asarray([store.slot_of(v) for v in victims])
                        store.delete_batch(victims)
                        eng.on_delete(slots)
                    upd = [f"v{int(x)}" for x in rng.choice(3000, 8, replace=False)]
                    new = clustered(8, seed=5000 + 100 * w + step)
                    with lock:
                        alive = [u for u in upd if u in store]
                        store.update_batch(alive, new[: len(alive)])
                        eng.on_update(np.asarray([store.slot_of(u) for u in alive]),
                                      new[: len(alive)])
        except Exception as e:  # noqa: BLE001 — reported by the test thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert eng.wait_maintenance(timeout=WAIT)
    assert eng._maint_error is None, eng._maint_error
    assert eng.get_detailed_metrics()["maintenance"]["swaps"] >= 1
    assert_layout_consistent(store, eng)
    live = np.flatnonzero(store._np_valid)
    _, gi = eng.search_slots(store._np_vectors[live], k=1)
    assert (gi[:, 0] == live).mean() >= 0.99


# ---------------------------------------------------------------- the store


def stores(n=300, d=8, seed=0, cap=1024):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    mds = [{"i": i, "tags": ["a", {"deep": i}]} if i % 3 else None for i in range(n)]
    js = JStore(dim=d, metric="euclidean", capacity=cap)
    ts = VectorStore(dim=d, metric="euclidean", capacity=cap, device="cpu")
    ids = [f"v{i}" for i in range(n)]
    for s in (js, ts):
        s.add_batch(ids, vecs, mds)
    return js, ts, vecs, mds


def test_store_ids_metadata_and_updates_match_jax():
    js, ts, vecs, mds = stores()
    assert ts.ids() == js.ids() and ("v5" in ts) and ("nope" not in ts)
    assert ts.slot_of("v7") == js.slot_of("v7") and ts.id_of(7) == js.id_of(7) == "v7"
    assert ts.id_of(-1) is None and ts.id_of(10**6) is None
    rec, jrec = ts.get("v4"), js.get("v4")
    assert rec.id == jrec.id and rec.metadata == jrec.metadata
    np.testing.assert_array_equal(rec.values, jrec.values)
    # deep copies both ways: neither the caller's dict nor a returned one
    # aliases the stored metadata
    mds[4]["tags"][1]["deep"] = -1
    rec.metadata["tags"][1]["deep"] = -2
    assert ts.get("v4").metadata["tags"][1]["deep"] == 4
    with pytest.raises(KeyError):
        ts.get("nope")
    new = np.full((2, 8), 3.0, np.float32)
    for s in (js, ts):
        s.update_batch(["v1", "v2"], new, [{"u": 1}, None])
        s.update_batch(["v3"], None, [{"only": "meta"}])
        assert s.delete("v9") and not s.delete("v9")
        s.add("x", np.ones(8, np.float32), {"x": True})
    with pytest.raises(KeyError):
        ts.update_batch(["nope"], new[:1])
    with pytest.raises(ValueError, match="shape"):
        ts.update_batch(["v1"], np.ones((1, 3), np.float32))
    for slot in range(ts.capacity):
        assert ts.id_of(slot) == js.id_of(slot)
        assert ts.metadata_of_slot(slot) == js.metadata_of_slot(slot)
    np.testing.assert_array_equal(ts.vector_of_slot(1), js.vector_of_slot(1))
    (ti, tv, tm), (ji, jv, jm) = ts.snapshot(), js.snapshot()
    assert ti == ji and tm == jm
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts.live_slots(), js.live_slots())
    with pytest.raises(ValueError, match="metadata length"):
        ts.add_batch(["m1", "m2"], np.ones((2, 8), np.float32), [None])


def test_change_feed_matches_jax():
    js, ts, vecs, _ = stores(n=500, cap=768)
    cur = {s: s.changes_since(None)[0] for s in (js, ts)}
    assert js.changes_since(None)[1] is None and ts.changes_since(None)[1] is None
    for s in (js, ts):
        s.update_batch(["v3", "v1"], vecs[:2])
        s.delete_batch(["v8", "nope", "v3"])
        s.add_batch(["a", "b"], vecs[:2])
    out = {}
    for s in (js, ts):
        cur[s], out[s] = s.changes_since(cur[s])
    np.testing.assert_array_equal(out[ts], out[js])
    assert set(out[ts].tolist()) >= {1, 3, 8}
    for s in (js, ts):  # growth past 768: the epoch bumps, replay impossible
        s.add_batch([f"g{i}" for i in range(400)], np.ones((400, 8), np.float32))
        _, delta = s.changes_since(cur[s])
        assert delta is None
    assert ts.capacity == js.capacity
    c_t, c_j = ts.changes_since(None)[0], js.changes_since(None)[0]
    assert c_t == c_j
    vt, valt = ts.read_rows(np.asarray([0, 8, 600]))
    vj, valj = js.read_rows(np.asarray([0, 8, 600]))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(valt, valj)


def test_view_generation_bumps_per_sync():
    ts = VectorStore(dim=4, metric="euclidean", device="cpu")
    js = JStore(dim=4, metric="euclidean")
    for s in (ts, js):
        s.add_batch(["a", "b"], np.ones((2, 4), np.float32))
    g = [s.device_view().generation for s in (ts, js)]
    assert g[0] == g[1] == 1
    for s in (ts, js):
        assert s.device_view().generation == 1  # nothing pending
        s.delete_batch(["a"])
    assert ts.device_view().generation == js.device_view().generation == 2
    assert ts.sync_stream() is None  # CPU stores sync with no stream
