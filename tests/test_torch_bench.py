"""The port's benchmark entry points, small on the CPU.

``quiver_tpu_torch.bench.headline`` and
``quiver_tpu_torch.benches.bench_latency.latency_rows`` run at n=8192
(the headline corpus generator, 128-d) and B=256 and return the fields the
card run prints, and so do the write path's benches
(``benches.streaming``, ``benches.churn``) at a few stream batches, whose
stream rows are bit-equal to ``benches/bench_streaming.py``'s; every entry
point refuses to run without CUDA and prints
no result; ``device_bytes()`` equals the JAX engine's on one imported
topology (the two engines hold the same arrays: centroids and their
norms, bf16 blocks, slot map, residual norms, inverse norms, keep mask),
and the accounting counts aliases once.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quiver_tpu.core.store import VectorStore as JStore
from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.index.ivf import IVFIndex as JIVF
from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
from quiver_tpu_torch import bench
from quiver_tpu_torch.benches import bench_latency
from quiver_tpu_torch.benches.common import clustered
from quiver_tpu_torch.utils.memory import device_bytes, store_device_bytes

from tests.test_ivf import clustered as small_clustered

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SMALL, B_SMALL, K_SMALL = 8192, 256, 64


def test_headline_runs_small_on_cpu():
    r = bench.headline("cpu", n=N_SMALL, b=B_SMALL, n_clusters=K_SMALL, depth=2,
                       rounds=2, log=lambda _: None)
    for key in ("metric", "commit", "utc", "value", "unit", "vs_baseline",
                "pipeline_depth", "n_probe", "batch", "batch_latency_ms",
                "run_spread_pct", "recall", "backend", "device", "card",
                "tuner_holdout_recall", "tuner_holdout_gap", "tuner_sample"):
        assert key in r, key
    assert r["backend"] == "torch-cpu" and r["card"] is None
    assert "CPU host clock" in r["metric"]
    assert r["unit"] == "qps" and r["value"] > 0 and r["batch"] == B_SMALL
    assert r["recall"] >= bench.RECALL_GATE
    assert r["tuner_sample"] == 1024 and r["n_probe"] >= 1
    assert abs(r["tuner_holdout_gap"] - (r["tuner_holdout_recall"] - r["recall"])) < 1e-3


def test_headline_build_cache_round_trip(tmp_path):
    """A fresh build writes the cache; the cached path imports it and
    tunes to the same pick."""
    vecs = clustered(N_SMALL)
    cache = tmp_path / "ivf.npz"
    e1 = bench.build_engine(vecs, "cpu", n_clusters=K_SMALL, cache=cache, log=lambda _: None)
    assert cache.exists()
    e2 = bench.build_engine(vecs, "cpu", n_clusters=K_SMALL, cache=cache)
    assert e2._n_retrains == 0 and e2._tuned_n_probe == e1._tuned_n_probe
    np.testing.assert_array_equal(e2._block_slot.numpy(), e1._block_slot.numpy())


def test_latency_rows_small_on_cpu():
    eng = bench_latency.serving_engine("cpu", clustered(N_SMALL), n_clusters=K_SMALL)
    assert eng.config.n_probe == 3 and not eng.config.rescore
    rows = bench_latency.latency_rows(eng, batches=(1, B_SMALL), emit_rows=False)
    assert [r["metric"].split(" ")[0] for r in rows] == ["ivf", "exact"] * 2
    for r, b in zip(rows, (1, 1, B_SMALL, B_SMALL)):
        assert f"B={b} " in r["metric"] and "cpu host-clock" in r["metric"]
        assert r["unit"] == "ms/batch" and r["value"] > 0
        assert r["us_per_query"] == pytest.approx(r["value"] * 1e3 / b, rel=1e-2, abs=1e-3)
        assert r["cpu_qps"] > 0 and "device_qps" not in r


def test_stream_rows_match_the_reference():
    from benches.bench_streaming import stream_rows as ref_stream_rows
    from quiver_tpu_torch.benches.streaming import stream_rows

    for n, seed in ((8192, 777), (1000, 3)):
        np.testing.assert_array_equal(stream_rows(n, seed), ref_stream_rows(n, seed))


def test_streaming_runs_small_on_cpu():
    from quiver_tpu_torch.benches import streaming

    rows = streaming.run("cpu", n=N_SMALL, stream_batches=3, stream_batch=512, b=64,
                         n_clusters=K_SMALL, log=lambda _: None)
    by = {r["metric"].split(",")[0]: r for r in rows}
    live = by["ivf streaming inserts/s"]
    for key in ("query_qps_during_stream", "recall_at_10_live", "first_batch_inserts_per_s"):
        assert key in live, key
    assert live["unit"] == "inserts/s" and live["value"] > 0 and live["card"] is None
    assert 0.5 <= live["recall_at_10_live"] <= 1.0
    assert "ivf refresh wall (existing centroids)" in by
    assert by["ivf full rebuild wall (k-means retrain)"]["n_clusters"] > 0


def test_churn_runs_small_on_cpu():
    from quiver_tpu_torch.benches import churn

    r = churn.run("cpu", n=N_SMALL, stream_batches=6, stream_batch=512, b=64,
                  n_clusters=K_SMALL, log=lambda _: None)
    for key in ("write_ms_p50", "write_ms_max", "inserts_per_s_steady",
                "first_batch_inserts_per_s", "query_qps_mean", "query_qps_during_rebuild_min",
                "n_rebuild_overlap_samples", "recall_at_10_live_min", "recall_at_10_final",
                "maint_swaps", "maint_swap_stall_ms", "card"):
        assert key in r, key
    assert r["maint_swaps"] >= 1 and r["maint"]["error"] is None
    assert r["unit"] == "ms write-call p99" and r["value"] >= r["write_ms_p50"] > 0
    assert r["recall_at_10_final"] >= 0.5


@pytest.mark.parametrize("module", [
    "quiver_tpu_torch.bench",
    "quiver_tpu_torch.benches.bench_latency",
    "quiver_tpu_torch.benches.probe",
    "quiver_tpu_torch.benches.streaming",
    "quiver_tpu_torch.benches.churn",
    "quiver_tpu_torch.benches.topw_f32_ab",
    "quiver_tpu_torch.benches.sharded_ab",
    "quiver_tpu_torch.benches.row_topr_ab",
    "quiver_tpu_torch.benches.bench_api",
    "quiver_tpu_torch.benches.bench_filtered",
    "quiver_tpu_torch.benches.bench_persistence",
    "quiver_tpu_torch.benches.profile_api",
    "quiver_tpu_torch.benches.bench_hnsw",
    "quiver_tpu_torch.benches.exp_hnsw_recall",
    "quiver_tpu_torch.benches.bench_hybrid",
    "quiver_tpu_torch.benches.bench_memory",
    "quiver_tpu_torch.benches.bench_ivf",
    "quiver_tpu_torch.benches.bench_ivf_mega",
    "quiver_tpu_torch.benches.bench_roofline",
    "quiver_tpu_torch.benches.bench_corpus_matrix",
    "quiver_tpu_torch.benches.bench_10m",
    "quiver_tpu_torch.benches.run_all",
])
def test_entry_points_refuse_without_cuda(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "{" not in proc.stdout


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    (tmp_path / "chip_smoke.py").write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_chip_smoke_live_check_holds_every_call():
    """chip_smoke's LiveCheck keeps every block_topw call the engine makes,
    with the blocks as that call saw them (cloned again only after a
    write), and holds each against the plain version."""
    import chip_smoke
    from quiver_tpu_torch.ops import ivf_kernels

    vecs = small_clustered(3000)
    ids = [f"v{i}" for i in range(len(vecs))]
    store = VectorStore(dim=vecs.shape[1], metric="euclidean", capacity=len(vecs), device="cpu")
    store.add_batch(ids[:2500], vecs[:2500])
    eng = IVFIndex(store, config=IVFConfig(build_threshold=256, background_maintenance=False))
    eng.build()
    real = ivf_kernels.block_topw
    with chip_smoke.LiveCheck() as live:
        eng.search_slots(vecs[:16], 10)
        eng.search_slots(vecs[16:32], 10)
        slots = store.add_batch(ids[2500:2600], vecs[2500:2600])
        eng.on_insert(np.asarray(slots), vecs[2500:2600])
        eng.search_slots(vecs[2500:2516], 10)
    assert ivf_kernels.block_topw is real
    assert len(live.calls) == 3
    blocks = [c[0][4] for c in live.calls]
    assert blocks[0] is blocks[1] and blocks[2] is not blocks[1]
    assert not torch.equal(blocks[1], blocks[2])  # the insert wrote into them
    assert live.verify(torch, "test") == 0.0 and live.calls == []
    with pytest.raises(AssertionError, match="no block_topw call"):
        live.verify(torch, "test")


def test_device_bytes_matches_jax():
    vecs = small_clustered(5000)
    ids = [f"v{i}" for i in range(len(vecs))]
    js = JStore(dim=vecs.shape[1], metric="euclidean", capacity=len(vecs))
    js.add_batch(ids, vecs)
    je = JIVF(js, config=JConfig(build_threshold=256))
    je.build()
    ts = VectorStore(dim=vecs.shape[1], metric="euclidean", capacity=len(vecs), device="cpu")
    ts.add_batch(ids, vecs)
    te = IVFIndex(ts, config=IVFConfig(build_threshold=256))
    te.import_topology(je.export_topology(), np.arange(js.capacity))
    assert te.device_bytes() == je.device_bytes()
    m = te.get_detailed_metrics()
    mj = je.get_detailed_metrics()
    # the reference's keys, and the port's own search counters beside them
    assert set(m) == set(mj) | {"search"} and set(m["maintenance"]) == set(mj["maintenance"])
    assert m["search"] == dict.fromkeys(("calls", "queries", "exact_route_calls",
                                         "underfill_calls", "underfill_rows",
                                         "overflow_merges", "fill_host_checks"), 0)
    assert m["device_bytes"] == mj["device_bytes"]
    assert m["retrains"] == 0 and m["churn_since_build"] == 0
    assert te.get_optimization_parameters() == je.get_optimization_parameters()
    te.set_optimization_parameters(n_probe=5)
    assert te.config.n_probe == 5
    for bad in (dict(n_probe=0), dict(n_clusters=3)):
        with pytest.raises(ValueError):
            te.set_optimization_parameters(**bad)


def test_device_bytes_counts_aliases_once():
    class Holder:
        pass

    Holder.__module__ = "quiver_tpu_torch.tests_holder"
    base = torch.zeros(100, dtype=torch.float32)
    h = Holder()
    h.a, h.b, h.c = base, base[10:20], [base.view(10, 10), torch.ones(3, dtype=torch.int64)]
    h.np_mirror = np.zeros(1000)
    assert device_bytes(h) == 400 + 24
    store = VectorStore(dim=4, metric="euclidean", device="cpu")
    assert store_device_bytes(store) == 0
    store.add_batch(["a"], np.ones((1, 4), np.float32))
    store.device_view()
    h.store = store
    assert store_device_bytes(store) == store.capacity * (4 * 4 + 1 + 4 + 4)
    assert device_bytes(h, skip=(VectorStore,)) == 424
    assert device_bytes(h) == 424 + store_device_bytes(store)


def test_hnsw_benches_small_on_cpu():
    """``bench_hnsw``, ``exp_hnsw_recall`` and ``bench_hybrid`` at a few
    thousand rows: the rows the card run prints, host-clock figures marked
    as the CPU's."""
    from quiver_tpu_torch.benches import bench_hnsw, bench_hybrid, exp_hnsw_recall

    rows = bench_hnsw.run("cpu", n=3000, b=32, batches=(16, 64), reps=1, emit_rows=False)
    assert [r["unit"] for r in rows] == ["s", "qps", "qps", "qps", "ms/batch", "ms/batch"]
    assert rows[0]["inserts_per_s"] > 0 and all("CPU host clock" in r["metric"] for r in rows)
    for r in rows[1:4]:
        assert 0.5 <= r["recall_at_10"] <= r["recall_at_10_ties"] <= 1.0 and r["card"] is None
    rows = exp_hnsw_recall.run("cpu", n=3000, b=32, efs=(50,), reps=1, emit_rows=False)
    assert [r["metric"].split(" ef=")[0].split("qd=")[1] for r in rows] == [
        "float32 visited=ring", "float32 visited=bitmap", "bfloat16 visited=ring",
        "bfloat16 visited=bitmap"]
    rows = bench_hybrid.run("cpu", n=3000, b=32, reps=1, emit_rows=False)
    assert [r.get("strategy") for r in rows] == ["ivf", None, "hnsw"]
    assert rows[2]["per_strategy_queries"]["hnsw"] > 0 and rows[1]["hybrid_vs_raw"] > 0


def test_bench_hnsw_beam_row_small_on_cpu():
    """``bench_hnsw.beam_row`` on a CPU graph: both sides are the plain
    version there, so no slot and no distance differs, the useful work and
    the accepted candidates are counted and no bytes bound is given (it
    needs a card's peaks)."""
    from quiver_tpu_torch.benches import bench_hnsw

    vecs = clustered(3000)
    _, idx, _ = bench_hnsw.build("cpu", vecs, build_batch=1024)
    r = bench_hnsw.beam_row(idx, vecs, b=32, ef=50, reps=1)
    assert (r["B"], r["ef"], r["mismatches"], r["dist_errors"], r["max_abs_err"]) == (
        32, 50, 0, 0, 0.0)
    assert 0 < r["work"] <= 32 * r["loops"] and r["bound_ms"] is None and r["ms"] > 0
    assert 0 < r["accepted"] <= r["work"] * bench_hnsw.EXPAND * 32


def test_bench_hnsw_descent_row_small_on_cpu():
    """``bench_hnsw.descent_row`` on a CPU graph: both sides are the plain
    chain there, so no layer-0 entry or distance differs; every query takes
    at least a step a layer; the distinct bytes lie between the queries,
    entries and one row a query and the rows of every step counted in full,
    and no bytes bound is given (it needs a card's peaks)."""
    from quiver_tpu_torch.benches import bench_hnsw

    vecs = clustered(3000)
    _, idx, _ = bench_hnsw.build("cpu", vecs, build_batch=1024)
    r = bench_hnsw.descent_row(idx, vecs, b=32, reps=1)
    assert (r["B"], r["layers"], r["mismatches"], r["dist_errors"], r["max_abs_err"]) == (
        32, idx.current_max_level, 0, 0, 0.0)
    assert r["layers"] >= 1 and 32 * r["layers"] <= r["steps"] <= 32 * 32 * r["layers"]
    assert r["max_steps"] <= 32 * r["layers"] and r["bound_ms"] is None and r["ms"] > 0
    assert r["us_per_step"] == 1e3 * r["ms"] / r["max_steps"]
    d, m = vecs.shape[1], 16
    assert 32 * (4 * d + 20) + 8 + 4 * d < r["bytes"]
    assert r["bytes"] <= 32 * (4 * d + 20) + r["steps"] * (8 + 4 * m + m * (1 + 4 * d)) + 4 * d + 1


def test_chip_smoke_hnsw_phase_small_on_cpu():
    """Phase 11's code path at a few thousand rows on the CPU (its card-only
    trace skipped): every gate passes on a sound graph."""
    import chip_smoke

    vecs = clustered(4096)
    out = chip_smoke.phase_hnsw(torch, torch.device("cpu"), vecs, n=2048, n_q=32,
                                efs=(50, 400), batches=(16,), n_parity=16, reps=1)
    assert out["n"] == 2048 and out["iters"]["max"] <= out["iters"]["max_iters"]
    assert [r["visited"] for r in out["sweep"]] == ["ring", "ring", "bitmap"]
    out = chip_smoke.phase_hnsw_stack(torch, torch.device("cpu"), vecs, n=2048, batch=512,
                                      n_q=16, n_rest=256, n_hybrid=2048)
    assert out["hybrid"]["split"]["hnsw"] > 0


def test_chip_smoke_hnsw_gates_catch_a_broken_graph():
    """``hnsw_invariants`` refuses a self edge, a repeated id and a fill
    count that disagrees with its row; ``ids_agree`` counts only swaps of
    entries whose distances differ."""
    import chip_smoke
    from quiver_tpu_torch.benches.bench_hnsw import build

    _, idx, _ = build("cpu", clustered(1024)[:, :16].copy(), build_batch=512)
    chip_smoke.hnsw_invariants(torch, idx)
    adj = idx.layer0._adj_dev
    for break_it in (lambda a: a.__setitem__((3, 0), int(idx.layer0.nodes[3])),
                     lambda a: a.__setitem__((5, 1), int(a[5, 0]))):
        saved = adj.clone()
        break_it(adj)
        with pytest.raises(AssertionError, match="graph invariants broken"):
            chip_smoke.hnsw_invariants(torch, idx)
        adj.copy_(saved)
    idx.layer0._fill_dev[7] -= 1
    with pytest.raises(AssertionError, match="'fill': 1"):
        chip_smoke.hnsw_invariants(torch, idx)
    ids = np.array([[1, 2, 3]])
    assert chip_smoke.ids_agree(ids, [[1.0, 2.0, 2.0]], [[1, 3, 2]], [[1.0, 2.0, 2.0]]) == 0
    assert chip_smoke.ids_agree(ids, [[1.0, 2.0, 3.0]], [[1, 3, 2]], [[1.0, 2.5, 3.0]]) == 1
