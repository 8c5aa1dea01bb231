"""The port's benches at scale, small on the CPU: ``bench_10m``,
``bench_corpus_matrix``, ``bench_memory``, ``bench_ivf``,
``bench_ivf_mega``, ``bench_roofline``, the HNSW leg of ``streaming`` and
``run_all`` (that each refuses to run without CUDA is in
tests/test_torch_bench.py).

* Each corpus generator is bit-equal to the reference module's.
* The corpus matrix at N=4,096 and 64 queries through both packages on the
  CPU (the reference's per-family flow with its own engine): the tuned
  n_probe, ``recall_shortfall`` and the hybrid's chosen engine are equal
  per family, and tie-aware recall agrees within 0.03 (the port's exact
  top-k may recall more than ``approx_max_k``).
* ``bench_10m`` at 20,000 rows: the reference's metric strings and units,
  and the layout imported from the cold build's assignment answers as the
  built one.
* ``peaks`` knows the H100 parts by name and refuses any other; the
  shared count of ``block_topw``'s bytes and operations gives the figures
  ``chip_smoke.py`` computed before it moved to ``benches/common.py``.
"""

import zlib

import numpy as np
import pytest
import torch

from quiver_tpu_torch.benches import bench_10m, bench_corpus_matrix, bench_memory
from quiver_tpu_torch.benches.common import PEAKS, peaks, topw_bound

H100_SXM = PEAKS["H100 80GB HBM3"]


def test_generators_match_the_reference():
    from benches import bench_10m as ref_10m
    from benches import bench_corpus_matrix as ref_matrix
    from benches import bench_memory as ref_memory

    np.testing.assert_array_equal(bench_10m.clustered(512, block=100),
                                  ref_10m.clustered(512, block=100))
    np.testing.assert_array_equal(bench_memory.clustered(512), ref_memory.clustered(512))
    assert [f for f, _ in bench_corpus_matrix.FAMILIES] == [f for f, _ in ref_matrix.FAMILIES]
    for name, gen in ref_matrix.FAMILIES:
        vecs, queries = bench_corpus_matrix.family_data(name, 512, 16)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        want = np.ascontiguousarray(gen(rng, 512), np.float32)
        np.testing.assert_array_equal(vecs, want)
        want_q = (want[rng.integers(0, 512, 16)] + 0.1 * want.std(axis=0, keepdims=True)
                  * rng.standard_normal((16, 128))).astype(np.float32)
        np.testing.assert_array_equal(queries, want_q)


def _reference_matrix_row(name, n, b):
    """The reference bench's per-family flow (``bench_corpus_matrix.py:
    102-150``) at n rows and b queries: (recall, tuned n_probe,
    recall_shortfall, hybrid recall, hybrid engine)."""
    from benches.truth import exact_truth_f64, recall_with_ties
    from quiver_tpu.core.store import VectorStore
    from quiver_tpu.index.hybrid import AdaptiveConfig, HybridIndex
    from quiver_tpu.index.ivf import IVFConfig, IVFIndex

    vecs, queries = bench_corpus_matrix.family_data(name, n, b)
    store = VectorStore(dim=128, metric="euclidean", capacity=n)
    store.add_batch([f"v{i}" for i in range(n)], vecs)
    eng = IVFIndex(store, config=IVFConfig(q_cap_factor=2, kmeans_iters=8, build_threshold=1024,
                                           rescore=False, recall_target=0.95))
    eng.build()
    d10 = exact_truth_f64(queries, vecs, 10)[1][:, 9]
    recall = recall_with_ties(np.asarray(eng.search_slots(queries, 10)[1]), queries, vecs, d10, 10)
    hyb = HybridIndex(store, adaptive_config=AdaptiveConfig(exploration_factor=0.0),
                      ann_factory=lambda s: eng)
    hyb._graph_built = True
    got = np.asarray(hyb.search_slots(queries, 10)[1])
    return (recall, eng.config.n_probe, bool(eng.recall_shortfall),
            recall_with_ties(got, queries, vecs, d10, 10), hyb.last_strategy)


@pytest.mark.parametrize("family", [f for f, _ in bench_corpus_matrix.FAMILIES])
def test_corpus_matrix_matches_the_reference(family):
    n, b = 4096, 64
    ivf, hyb = bench_corpus_matrix.run("cpu", n=n, b=b, families=[family], hnsw=False,
                                       emit_rows=False, log=lambda _: None)
    assert ivf["metric"] == f"corpus-matrix {family} N={n} [ivf], CPU (tests only)"
    assert hyb["metric"] == f"corpus-matrix {family} N={n} [hybrid auto], CPU (tests only)"
    for key in ("tuned_n_probe", "tuner_holdout", "holdout_gap", "n_clusters",
                "recall_shortfall", "meets_target"):
        assert key in ivf, key
    assert ivf["unit"] == hyb["unit"] == "recall@10"
    recall, n_probe, shortfall, recall_h, engine = _reference_matrix_row(family, n, b)
    assert ivf["tuned_n_probe"] == n_probe
    assert ivf["recall_shortfall"] == shortfall
    assert hyb["engine"] == engine
    assert abs(ivf["value"] - recall) <= 0.03
    assert abs(hyb["value"] - recall_h) <= 0.03


def test_corpus_matrix_hnsw_row():
    rows = bench_corpus_matrix.run("cpu", n=2048, b=32, families=["anisotropic"],
                                   emit_rows=False, log=lambda _: None)
    assert [r["metric"].split("[")[1] for r in rows] == [
        "ivf], CPU (tests only)", "hybrid auto], CPU (tests only)", "hnsw], CPU (tests only)"]
    g = rows[2]
    assert g["ef"] == 200 and g["m"] == 16 and g["ef_construction"] == 200
    assert g["build_s"] > 0 and 0.8 <= g["value"] <= 1.0


def test_bench_10m_rows_small_on_cpu():
    n = 20_000
    rows = bench_10m.run("cpu", n=n, n_clusters=64, batches=(256, 512), b_oracle=64, reps=1,
                         block=6000, ingest_batch=8192, emit_rows=False, log=lambda _: None)
    tag = ", CPU (tests only)"
    # the reference's strings (bench_10m.py:91-92, 113, 116, 173-175), its
    # "10M" the row count here
    want = [
        (f"ivf N={n} cold build (k-means K=64, 8 iters + layout){tag}", "s"),
        (f"ivf N={n} layout from cached assignment{tag}", "s"),
        (f"ivf N={n} device memory{tag}", "GiB"),
    ]
    recall = rows[3]["recall_at_10"]
    want += [(f"ivf N={n} x 128-d QPS/chip, B={b}, n_probe=3, recall@10={recall:.3f} "
              f"(tie-aware){tag}", "qps") for b in (256, 512)]
    assert [(r["metric"], r["unit"]) for r in rows] == want
    assert bench_10m.label(10_000_000) == "10M"
    build, imp, mem = rows[:3]
    assert build["inserts_per_s"] > 0 and build["n_clusters"] == 64
    assert imp["same_answers"] and imp["cold_build_s"] == build["value"]
    assert mem["bytes_per_vector"] > 128 * 4 and mem["engine_gib"] >= 0
    assert all(r["batch_latency_ms"] > 0 and 0 < r["recall_at_10"] <= 1 for r in rows[3:])


def test_peaks_by_card_name():
    assert peaks("NVIDIA H100 80GB HBM3") == H100_SXM
    assert H100_SXM["bf16"] == 989e12 and H100_SXM["hbm"] == 3.35e12
    assert peaks("NVIDIA H100 PCIe")["hbm"] == 2.0e12
    assert peaks("NVIDIA H100 NVL")["bf16"] == 835e12
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA GeForce RTX 4090", ""):
        with pytest.raises(ValueError, match="no published peaks"):
            peaks(name)


#: chip_smoke.topw_bound's figures at 989 TFLOP/s bf16, 495 TFLOP/s TF32
#: and 3.35 TB/s before the count moved to benches/common.py, on
#: ``kernel_inputs`` operands (L2, seed 5): (B, P, K, Cmax, d, variant,
#: blocks' dtype, key lanes) -> (ms, bound by)
PREVIOUS_BOUNDS = [
    ((64, 3, 16, 256, 32, "pairs", torch.bfloat16, 16), (9.034626865671643e-05, "bytes")),
    ((64, 3, 16, 256, 32, "fused", torch.bfloat16, 16), (9.011701492537313e-05, "bytes")),
    ((64, 3, 16, 256, 32, "row", torch.float32, 16), (0.00016836895522388058, "bytes")),
    ((64, 3, 16, 256, 32, "pairs", torch.float32, 16), (0.0001685982089552239, "bytes")),
    ((2048, 4, 4, 256, 256, "pairs", torch.bfloat16, 16), (0.0010856843518705765, "operations")),
    ((2048, 4, 4, 256, 256, "pairs", torch.float32, 16), (0.0065075262060606065, "operations")),
    ((2048, 4, 4, 256, 256, "fused", torch.float32, 16), (0.004338350804040404, "operations")),
]


@pytest.mark.parametrize("case,want", PREVIOUS_BOUNDS)
def test_topw_bound_keeps_chip_smokes_figures(case, want):
    import chip_smoke

    B, P, K, Cmax, d, variant, dtype, lanes = case
    args, kw = chip_smoke.kernel_inputs(torch, torch.device("cpu"), B=B, P=P, K=K, Cmax=Cmax,
                                        d=d, metric="euclidean", variant=variant, seed=5,
                                        dtype=dtype)
    got = topw_bound(args, kw, torch.zeros(B * P, lanes, dtype=torch.int32), H100_SXM)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-12)


def test_hnsw_streaming_leg_grows_the_store():
    from quiver_tpu_torch.benches import streaming

    build, line = streaming.run_hnsw("cpu", n=4096, stream_batches=2, stream_batch=1024, b=64)
    assert build["metric"] == "hnsw build wall-clock, N=4096 d=128 M=16 efC=200"
    assert line["metric"] == "hnsw streaming inserts/s, base N=4096 stream 2048"
    assert line["unit"] == "inserts/s" and line["value"] > 0
    assert line["store_capacity_after"] > line["store_capacity_before"] == 4096
    assert line["recall_at_10_live"] >= 0.9


def test_memory_ivf_and_roofline_small_on_cpu():
    from quiver_tpu_torch.benches import bench_ivf, bench_ivf_mega, bench_roofline

    mem = bench_memory.run("cpu", n=8192, emit_rows=False)
    assert [r["metric"].split(",")[1].split(" ")[1] for r in mem] == ["exact", "ivf", "hnsw"]
    exact = mem[0]
    # the store's capacity ladder: 8192 slots of 128 f32, valid, norm, inverse norm
    assert exact["bytes_per_vector"] == round(8192 * (128 * 4 + 1 + 4 + 4) / 8192, 1)
    assert mem[1]["engine_mib"] > 0 and mem[2]["engine_mib"] > 0
    assert all(r["unit"] == "MiB" and r["max_n_per_card"] is None for r in mem)

    rows = bench_ivf.run("cpu", n=8192, b=64, n_clusters=64, n_probes=(4, 16), reps=1,
                         emit_rows=False)
    assert [r["metric"].split(",")[0] for r in rows] == [
        "flat bf16 (exact top-k)", "IVF build", "IVF rescore=False n_probe=4",
        "IVF rescore=False n_probe=16", "IVF rescore=True n_probe=4", "IVF rescore=True n_probe=16"]
    assert rows[0]["recall_at_10"] >= 0.95 and rows[-1]["recall_at_10"] >= rows[-2]["recall_at_10"]

    rows = bench_ivf_mega.run("cpu", n=8192, batches=(64, 160), b_oracle=64, n_clusters=8,
                              reps=1, emit_rows=False, log=lambda _: None)
    assert [r["metric"].split(",")[0] for r in rows] == [
        f"ivf {f} n_probe={p} B={b}" for f, p in (("pairs", 3), ("fused", 3), ("pairs", 4),
                                                  ("fused", 4)) for b in (64, 160)]
    assert all(r["unit"] == "qps" and r["recall_at_10"] >= 0.9 for r in rows)
    assert bench_ivf_mega.batch_of(np.ones((4, 2), np.float32), 10).shape == (10, 2)

    rows = bench_roofline.run("cpu", n=8192, b=128, n_clusters=8, reps=1, scan_reps=1,
                              card_peaks=H100_SXM, emit_rows=False, log=lambda _: None)
    assert [r["metric"] for r in rows] == [
        "ivf pairs B=128 n_probe=2 seg_width=32", "ivf pairs B=128 n_probe=2 seg_width=64",
        "ivf pairs B=128 n_probe=2 seg_width=128", "exact flat scan f32 B=128",
        "exact flat scan bf16 B=128"]
    for r in rows:
        assert r["pct_bf16_peak"] == pytest.approx(
            100 * r["gflop_per_batch"] * 1e9 / (r["batch_ms"] / 1e3) / H100_SXM["bf16"])
    # the kernel's keys shrink as the windows widen: fewer bytes per batch
    assert rows[0]["gb_per_batch"] > rows[1]["gb_per_batch"] > rows[2]["gb_per_batch"]


def test_chip_smoke_roofline_phase_small_on_cpu():
    """Phase 13c's code path on the CPU: every seg_width's batch held
    against the plain version, the engine's settings restored."""
    import chip_smoke
    from quiver_tpu_torch.bench import build_engine
    from quiver_tpu_torch.benches.common import clustered

    vecs = clustered(8192)
    eng = build_engine(vecs, "cpu", n_clusters=8, n_probe=3, log=lambda _: None)
    out = chip_smoke.phase_roofline(torch, eng, torch.from_numpy(vecs[:96].copy()), reps=1,
                                    card_peaks_=H100_SXM)
    assert sorted(out["err"]) == [(32, 2), (64, 2), (128, 2)]
    assert [r["metric"].split(" ")[-1] for r in out["rows"]] == [
        "seg_width=32", "seg_width=64", "seg_width=128"]
    assert (eng.config.n_probe, eng.config.seg_width) == (3, 32)


def test_run_all_reports_a_failure_and_exits_non_zero(tmp_path, monkeypatch, capsys):
    from quiver_tpu_torch.benches import run_all

    (tmp_path / "scale_ok.py").write_text("print('ran')\n")
    (tmp_path / "scale_raises.py").write_text("raise RuntimeError('boom')\n")
    (tmp_path / "scale_exits.py").write_text("raise SystemExit('CUDA is not available')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert run_all.main(["scale_ok"], headline=False) == 0
    assert run_all.main(["scale_ok", "scale_raises", "scale_exits"], headline=False) == 2
    out = capsys.readouterr().out
    assert "ran" in out and "--- scale_raises FAILED: RuntimeError: boom" in out
    assert "--- scale_exits FAILED: exit CUDA is not available" in out
    assert "--- 2 failed: scale_raises, scale_exits" in out
    assert "quiver_tpu_torch.benches.bench_skew" not in run_all.MODULES
    assert run_all.MODULES[-2:] == ["quiver_tpu_torch.benches.bench_memory",
                                    "quiver_tpu_torch.benches.bench_10m"]
