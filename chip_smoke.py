"""Smoke run of the PyTorch/CUDA port (``quiver_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of ``quiver_tpu``, and has no CPU path: without
CUDA, or outside a checkout of the repository, it exits non-zero before
printing any result. Phases, one line each (any failure raises):

1. device: the card's name and power limit, the CUDA version, TF32 off;
2. build: ``csrc/*.cu`` compiled with nvcc (one process per source, in
   parallel) into the git-ignored build directory; build seconds;
3. kernel against twin: ``block_topw`` against ``block_topw_reference`` on
   the card at the main path's shapes (d=128, Cmax=1280, K=1405, B=65536,
   P in {2, 3, 4}), pairs variant (W=32, R=2: L2, dot, cosine), fused
   variant (W=128, R=4: L2, dot) and row mode (one window per row, R=16:
   the per-pair branch small corpora take); times of both with CUDA events;
4. slice: the headline bench's path (``quiver_tpu_torch/bench.py``): the
   1M x 128-d clustered L2 corpus through ``VectorStore(device="cuda")`` ->
   ``IVFIndex.build()`` with ``recall_target=0.96``, so the build tunes
   n_probe; the tuned n_probe, holdout recall and stderr, and
   ``recall_shortfall``; recall@10 at the tuned n_probe against an f64
   oracle (tie-aware, the rule of ``benches/truth.py``) >= 0.95; then
   n_probe in {2, 3} x {"pairs", "fused"}: recall and ms per batch / QPS of
   ``search_slots_device`` at B=65536; ``device_bytes()`` and the peak of
   allocated card memory; the kernel's launch counts over this phase;
5. probes: ``benches/probe.py``'s two kernels (``scatter_rows``,
   ``index_read``) at the TPU probe's shapes and at the main path's (the
   slice's own probe ids: 196,608 pairs over its clusters), each held
   against its expectation and its plain version; launch counts over that
   run; then kernel and plain version timed;
6. latency: ``benches/bench_latency.py``'s rows at B in {1, 128, 2048,
   65536} for the slice's engine (n_probe=3, "pairs") and the exact scan.

The 1M corpus is generated once and shared by phases 4-6. Then a JSON line
of kernels, the card line, and last the result line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from quiver_tpu_torch.bench import B as B_SERVE
from quiver_tpu_torch.bench import (
    B_ORACLE,
    RECALL_GATE,
    RECALL_TARGET,
    build_engine,
    make_queries,
)
from quiver_tpu_torch.benches.common import K as TOP_K
from quiver_tpu_torch.benches.common import N, card, clustered, cuda_ms, oracle_kth
from quiver_tpu_torch.benches.truth import recall_with_ties

#: kernel-phase shapes: the serving point of the slice (K' of the headline
#: build is ~1400 clusters of Cmax=1280)
KERNEL_SHAPE = dict(B=65536, K=1405, Cmax=1280, d=128)
KERNEL_PROBES = (2, 3, 4)
#: (variant name, W, R, position bits, metrics); W = 0 is row mode (one
#: window of Cmax columns, position bits to hold Cmax). Row mode serves the
#: per-pair branch of corpora whose Cmax holds fewer than k windows, so the
#: 1M slice does not launch it and the kernels line lists only the others.
VARIANTS = (
    ("pairs", 32, 2, 5, ("euclidean", "dot_product", "cosine")),
    ("fused", 128, 4, 11, ("euclidean", "dot_product")),
    ("row", 0, 16, 0, ("euclidean", "dot_product", "cosine")),
)


def variant_args(variant, W, R, pos_bits, Cmax):
    """(W, pos_bits, sentinel) of a VARIANTS entry at a given Cmax."""
    from quiver_tpu_torch.ops.ivf_cuda import KEY_MIN, _mask_key

    if W == 0:
        return Cmax, max(1, (Cmax - 1).bit_length()), KEY_MIN
    return W, pos_bits, int(_mask_key(W)) if variant == "pairs" else KEY_MIN


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_inputs(torch, dev, *, B, P, K, Cmax, d, metric, variant, seed):
    """Random operands of one block_topw call at the given shape, built the
    way ivf_query builds them (stable pair sort, CSR starts, epilogue)."""
    from quiver_tpu_torch.ops.ivf_kernels import _epilogue
    from quiver_tpu_torch.ops.scan import NEG_BIG
    from quiver_tpu_torch.types import DistanceType

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, d, generator=g, device=dev)
    cents = 0.5 * torch.randn(K, d, generator=g, device=dev)
    probe = torch.rand(B, K, generator=g, device=dev).topk(P, dim=1).indices
    blocks_t = (0.5 * torch.randn(K, d, Cmax, generator=g, device=dev)).to(torch.bfloat16)
    keep = torch.rand(K, Cmax, generator=g, device=dev) > 0.1
    rns = 0.25 * d * torch.rand(K, Cmax, generator=g, device=dev)
    inv = 0.5 + torch.rand(K, Cmax, generator=g, device=dev)
    c_dots = torch.randn(B, K, generator=g, device=dev)
    flat_c = probe.reshape(-1)
    order = torch.argsort(flat_c, stable=True).to(torch.int32)
    starts = torch.zeros(K + 1, dtype=torch.int32, device=dev)
    starts[1:] = torch.cumsum(torch.bincount(flat_c, minlength=K), 0)
    m = DistanceType.parse(metric)
    if variant in ("pairs", "row"):
        scale, sub_cent, col_add, row_add, col_mul = _epilogue(m, keep, rns, inv, c_dots, probe)
    elif m == DistanceType.EUCLIDEAN:
        scale, sub_cent, row_add, col_mul = 2.0, True, None, None
        col_add = torch.where(keep, -rns, NEG_BIG)
    else:
        scale, sub_cent, row_add, col_mul = 1.0, False, None, None
        col_add = torch.where(keep, 0.0, NEG_BIG)
    args = (q, cents, starts, order, blocks_t)
    kw = dict(P=P, scale=scale, col_add=col_add, row_add=row_add,
              col_mul=col_mul, sub_cent=sub_cent)
    return args, kw


def compare_keys(torch, k_kern, k_ref, s_orig, *, W, R, pos_bits):
    """Hold kernel keys against the twin's. Stated tolerance: unpacked
    scores agree within 2 quanta of the packing (2^(pos_bits-22) relative)
    plus 1e-4 absolute, which covers f32 summation order over d=128 bf16
    products of magnitude ~1; winner positions agree wherever the
    competing scores differ by more than that; masked winners agree key
    for key. Returns (max abs score error, positions that differ)."""
    from quiver_tpu_torch.ops.ivf_cuda import _from_key
    from quiver_tpu_torch.ops.scan import NEG_BIG

    pm = (1 << pos_bits) - 1
    sk = _from_key(k_kern & ~pm)
    sr = _from_key(k_ref & ~pm)
    real = sr > NEG_BIG / 2
    tol = 2.0 ** (pos_bits - 22) * sr.abs() + 1e-4
    err = torch.where(real, (sk - sr).abs(), 0.0)
    if not bool((err <= tol).all()):
        bad = int((err > tol).sum())
        raise AssertionError(f"{bad} winner scores differ beyond tolerance; max {float(err.max())}")
    if not bool((k_kern == k_ref)[~real].all()):
        raise AssertionError("masked winners differ")
    lane_w = (torch.arange(k_kern.shape[1], device=k_kern.device) // R) * W
    col_k = lane_w + ((k_kern & pm) % W).long()
    col_r = lane_w + ((k_ref & pm) % W).long()
    diff = (col_k != col_r) & real
    n_diff = int(diff.sum())
    if n_diff:
        rows = diff.nonzero()[:, 0]
        a = s_orig[rows, col_k[diff]]
        b = s_orig[rows, col_r[diff]]
        if not bool(((a - b).abs() <= 2 * tol[diff]).all()):
            raise AssertionError("winner positions differ where scores are separated")
    return float(err.max()), n_diff


def phase_kernels(torch, dev, *, shape, probes, reps):
    """Kernel against twin at the given shape; returns per-variant records."""
    from quiver_tpu_torch.ops.ivf_cuda import (
        block_topw, block_topw_reference, pair_scores_reference,
    )

    records = {}
    for variant, W, R, pos_bits, metrics in VARIANTS:
        W, pos_bits, sentinel = variant_args(variant, W, R, pos_bits, shape["Cmax"])
        rec = records.setdefault(variant, {"W": W, "R": R, "max_abs_err": 0.0})
        for P in probes:
            for metric in metrics:
                args, kw = kernel_inputs(
                    torch, dev, P=P, metric=metric, variant=variant,
                    seed=1000 * P + len(metric), **shape,
                )
                wkw = dict(kw, W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)
                k_kern = block_topw(*args, **wkw)
                k_ref = block_topw_reference(*args, **wkw)
                s_sorted = pair_scores_reference(*args, **kw)
                s_orig = torch.empty_like(s_sorted)
                s_orig[args[3].long()] = s_sorted
                del s_sorted
                err, n_diff = compare_keys(
                    torch, k_kern, k_ref, s_orig, W=W, R=R, pos_bits=pos_bits)
                del s_orig, k_ref
                ms = cuda_ms(lambda: block_topw(*args, **wkw), reps)
                plain_ms = cuda_ms(lambda: block_topw_reference(*args, **wkw), 1)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if P == 3 and metric == "euclidean":
                    rec["ms"], rec["plain_ms"] = ms, plain_ms
                log(
                    f"kernel {variant} W={W} R={R} {metric} B={shape['B']} P={P} "
                    f"BP={shape['B'] * P}: max_abs_err={err!r} pos_diffs={n_diff} "
                    f"kernel_ms={ms!r} twin_ms={plain_ms!r}"
                )
                del args, kw, wkw, k_kern
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    return records


def phase_slice(torch, dev, vecs, *, b_serve, reps):
    """The headline bench's path on the device, the tuner included.
    Returns (engine, serving queries on the device)."""
    n = len(vecs)
    queries, qb = make_queries(vecs, b_serve, min(B_ORACLE, n))
    kth = oracle_kth(dev, queries, vecs, TOP_K)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = build_engine(vecs, dev, recall_target=RECALL_TARGET, log=log)
    torch.cuda.synchronize()
    log(f"slice build (k-means, layout and tuner): n={n} wall_s={time.perf_counter() - t0!r} "
        f"build_s={eng._last_rebuild_s!r} K'={eng.n_clusters} "
        f"Cmax={int(eng._block_slot.shape[1])}")
    log(f"slice tuner: target={RECALL_TARGET} n_probe={eng._tuned_n_probe} "
        f"holdout_recall={eng._tuned_recall!r} stderr={eng._tuned_stderr!r} "
        f"rescore={eng.config.rescore} recall_shortfall={eng.recall_shortfall}")
    if eng._tuned_n_probe is None or eng.config.n_probe != eng._tuned_n_probe:
        raise AssertionError("build() with recall_target did not install a tuned n_probe")
    # the tuner alone, once more (deterministic: the same sample, the same pick)
    t0 = time.perf_counter()
    again = eng.tune_n_probe()
    torch.cuda.synchronize()
    log(f"slice tuner alone: wall_s={time.perf_counter() - t0!r} n_probe={again}")
    if again != eng._tuned_n_probe:
        raise AssertionError(f"the tuner picked {again} on a re-run")

    def recall_at(form, n_probe):
        eng.config.formulation, eng.config.n_probe = form, n_probe
        dist, slots = eng.search_slots(queries, TOP_K)
        if dist.shape != (len(queries), TOP_K) or not np.isfinite(dist).all():
            raise AssertionError(f"bad result: shape {dist.shape}, finite {np.isfinite(dist).all()}")
        if (slots < 0).any():
            raise AssertionError("empty result slots on a full corpus")
        return recall_with_ties(slots, queries, vecs, kth, TOP_K)

    tuned = eng._tuned_n_probe
    r = recall_at("pairs", tuned)
    log(f"slice recall@{TOP_K} pairs at the tuned n_probe={tuned}: {r!r} "
        f"(holdout gap {eng._tuned_recall - r!r})")
    if r < RECALL_GATE:
        raise AssertionError(f"recall@10 {r} < {RECALL_GATE} at the tuned n_probe={tuned}")
    for form in ("pairs", "fused"):
        for n_probe in (2, 3):
            log(f"slice recall@{TOP_K} {form} n_probe={n_probe}: {recall_at(form, n_probe)!r}")

    qdev = torch.from_numpy(qb).to(dev)
    for form in ("pairs", "fused"):
        for n_probe in sorted({2, 3, tuned}):
            eng.config.formulation, eng.config.n_probe = form, n_probe
            ms = cuda_ms(lambda: eng.search_slots_device(qdev, TOP_K), reps)
            log(f"slice search_slots_device {form} n_probe={n_probe} B={b_serve}: "
                f"ms_per_batch={ms!r} qps={b_serve / (ms / 1e3)!r}")
    eng.config.formulation, eng.config.n_probe = "pairs", tuned
    log(f"slice memory: device_bytes={eng.device_bytes()} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)}")
    return eng, qdev


def slice_probe_ids(eng, qdev, n_probe=3):
    """The slice's own probe ids for the serving batch at ``n_probe``."""
    from quiver_tpu_torch.ops.ivf_kernels import probe_stage

    cent, c_ns = eng._cent_dev
    return probe_stage(qdev, cent, c_ns, eng.store.metric, n_probe,
                       eng.config.probe_sel_approx)[2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from quiver_tpu_torch import _build
    from quiver_tpu_torch.benches import bench_latency, probe
    from quiver_tpu_torch.ops import ivf_cuda, probe_cuda

    dev = torch.device("cuda", 0)
    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    log(f"device: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    # phase 2: build
    path, build_secs = _build.build(verbose=True)
    _build.load_library()
    log(f"build: {path.name} in {build_secs!r} s")

    # phase 3: kernel against twin (these launches are not the main path's)
    records = phase_kernels(torch, dev, shape=KERNEL_SHAPE, probes=KERNEL_PROBES, reps=10)

    # phase 4: the main path; launch counts cover exactly this phase
    t0 = time.perf_counter()
    vecs = clustered(N)
    log(f"corpus: {vecs.shape} in {time.perf_counter() - t0!r} s")
    torch.cuda.empty_cache()
    ivf_cuda.reset_launch_counts()
    eng, qdev = phase_slice(torch, dev, vecs, b_serve=B_SERVE, reps=10)
    counts = dict(ivf_cuda.launch_counts)
    log(f"slice launches: {counts}")

    # phase 5: the probes' path; counts cover its run, not the timing after
    probe_ids = slice_probe_ids(eng, qdev)
    probe_cuda.reset_launch_counts()
    prec = probe.run_probes(dev, probe=probe_ids, K=eng.n_clusters, log=log)
    probe_counts = dict(probe_cuda.launch_counts)
    log(f"probe launches: {probe_counts}")
    probe_times = probe.time_probes(dev, prec.pop("main"), log=log)
    del probe_ids
    torch.cuda.empty_cache()

    # phase 6: the latency rows of the slice's engine and the exact scan
    eng.config.formulation, eng.config.n_probe = "pairs", bench_latency.N_PROBE
    ivf_cuda.reset_launch_counts()
    bench_latency.latency_rows(eng)
    log(f"latency launches: {dict(ivf_cuda.launch_counts)}")

    kernels = []
    for variant, rec in records.items():
        if variant == "row":  # not on the 1M slice's path (see VARIANTS)
            continue
        launches = counts[(rec["W"], rec["R"])]
        if launches <= 0:
            raise AssertionError(f"block_topw {variant} was not launched by the main path")
        kernels.append({
            "name": f"block_topw[W={rec['W']},R={rec['R']}] ({variant})",
            "route": "cuda",
            "source": "quiver_tpu_torch/csrc/ivf_block_topw.cu",
            "replaces": ("quiver_tpu/ops/ivf_kernels.py:633" if variant == "pairs"
                         else "quiver_tpu/ops/ivf_pallas.py:145"),
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
        })
    for name, replaces in (("scatter_rows", "benches/probe_pallas.py:42"),
                           ("index_read", "benches/probe_pallas.py:101")):
        if probe_counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the probes' path")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "quiver_tpu_torch/csrc/probe_kernels.cu",
            "replaces": replaces,
            "launches": probe_counts[name],
            "max_abs_err": prec[name]["max_abs_err"],
            "ms": probe_times[name][0],
            "plain_ms": probe_times[name][1],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
