"""Smoke run of the PyTorch/CUDA port (``quiver_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of ``quiver_tpu``, and has no CPU path: without
CUDA, or outside a checkout of the repository, it exits non-zero before
printing any result. Phases, one line each (any failure raises):

1. device: the card's name and power limit, the CUDA version, TF32 off;
2. build: ``csrc/*.cu`` compiled with nvcc into the git-ignored build
   directory; build seconds;
3. kernel against twin: ``block_topw`` against ``block_topw_reference`` on
   the card at the main path's shapes (d=128, Cmax=1280, K=1405, B=65536,
   P in {2, 3, 4}), pairs variant (W=32, R=2: L2, dot, cosine), fused
   variant (W=128, R=4: L2, dot) and row mode (one window per row, R=16:
   the per-pair branch small corpora take); times of both with CUDA events;
4. slice: ``bench.py``'s 1M x 128-d clustered L2 corpus through
   ``VectorStore(device="cuda")`` -> ``IVFIndex.build()`` ->
   ``search_slots``: recall@10 against an f64 oracle (tie-aware, the rule of
   ``benches/truth.py``) >= 0.95 at n_probe=3; ms per batch and QPS of
   ``search_slots_device`` at B=65536 for "pairs" and "fused"; the kernel's
   launch counts over this phase.

Then a JSON line of kernels, the card line, and last the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N, D, TOP_K = 1_000_000, 128, 10
N_CENTERS = 1000
B_ORACLE = 2048
B_SERVE = 65536
#: kernel-phase shapes: the serving point of the slice (K' of the headline
#: build is ~1400 clusters of Cmax=1280)
KERNEL_SHAPE = dict(B=65536, K=1405, Cmax=1280, d=128)
KERNEL_PROBES = (2, 3, 4)
RECALL_GATE = 0.95
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


def clustered(n, seed=0):
    """The headline corpus of bench.py:57-62 (same generator, same seed)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(N_CENTERS, D)).astype(np.float32)
    which = rng.integers(0, N_CENTERS, n)
    out = centers[which] + 0.25 * rng.normal(size=(n, D)).astype(np.float32)
    return out.astype(np.float32)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events after a warm-up
    call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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
                ms = cuda_ms(torch, lambda: block_topw(*args, **wkw), reps)
                plain_ms = cuda_ms(torch, lambda: block_topw_reference(*args, **wkw), 1)
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


def oracle_kth(torch, dev, queries, vecs, k, block=131_072):
    """True k-th smallest squared L2 distance per query, in float64 on the
    device (the affine f64 form of benches/truth.py:exact_truth_f64)."""
    q = torch.from_numpy(queries).to(dev, torch.float64)
    qns = (q * q).sum(1, keepdim=True)
    best = torch.full((q.shape[0], k), float("inf"), dtype=torch.float64, device=dev)
    for s in range(0, vecs.shape[0], block):
        v = torch.from_numpy(vecs[s:s + block]).to(dev, torch.float64)
        d = qns - 2.0 * (q @ v.T) + (v * v).sum(1)[None, :]
        best = torch.topk(torch.cat([best, d], 1), k, dim=1, largest=False).values
    return best[:, k - 1].cpu().numpy()


def recall_with_ties(found_slots, queries, vectors, true_kth_dist, k, rel_tol=1e-6):
    """The rule of benches/truth.py:recall_with_ties: a returned row is a
    hit when its true f64 distance <= the true k-th (+ rel tol); at most k
    hits per query."""
    hits = 0
    q = queries.astype(np.float64)
    for b in range(found_slots.shape[0]):
        s = found_slots[b][found_slots[b] >= 0][:k]
        if len(s) == 0:
            continue
        d = np.sum((vectors[s].astype(np.float64) - q[b][None, :]) ** 2, axis=1)
        hits += min(int((d <= true_kth_dist[b] * (1 + rel_tol) + 1e-12).sum()), k)
    return hits / (found_slots.shape[0] * k)


def phase_slice(torch, dev, *, n, b_serve, n_clusters, reps):
    """The port's main path on the device; returns (recalls, timings)."""
    from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore

    vecs = clustered(n)
    rng = np.random.default_rng(1)
    b_or = min(B_ORACLE, n)
    queries = (vecs[:b_or] + 0.1 * rng.normal(size=(b_or, D))).astype(np.float32)
    rngq = np.random.default_rng(2)
    qb = (vecs[rngq.integers(0, n, b_serve)]
          + 0.1 * rngq.normal(size=(b_serve, D))).astype(np.float32)
    qb[:min(b_or, b_serve)] = queries[:b_serve]
    kth = oracle_kth(torch, dev, queries, vecs, TOP_K)

    t0 = time.perf_counter()
    store = VectorStore(dim=D, metric="euclidean", capacity=n, device=dev)
    store.add_batch([f"v{i}" for i in range(n)], vecs)
    eng = IVFIndex(store, config=IVFConfig(
        n_clusters=n_clusters, n_probe=3, q_cap_factor=2, kmeans_iters=8,
        build_threshold=1024, rescore=False, recall_target=None))
    eng.build()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cmax = int(eng._block_slot.shape[1])
    log(f"slice build: n={n} wall_s={build_s!r} K'={eng.n_clusters} Cmax={cmax}")

    recalls = {}
    for form in ("pairs", "fused"):
        eng.config.formulation = form
        for n_probe in (2, 3):
            eng.config.n_probe = n_probe
            dist, slots = eng.search_slots(queries, TOP_K)
            if dist.shape != (b_or, TOP_K) or not np.isfinite(dist).all():
                raise AssertionError(f"bad result: shape {dist.shape}, finite {np.isfinite(dist).all()}")
            if (slots < 0).any():
                raise AssertionError("empty result slots on a full corpus")
            r = recall_with_ties(slots, queries, vecs, kth, TOP_K)
            recalls[(form, n_probe)] = r
            log(f"slice recall@{TOP_K} {form} n_probe={n_probe}: {r!r}")
    if recalls[("pairs", 3)] < RECALL_GATE:
        raise AssertionError(f"recall@10 {recalls[('pairs', 3)]} < {RECALL_GATE} at n_probe=3")

    qdev = torch.from_numpy(qb).to(dev)
    timings = {}
    for form in ("pairs", "fused"):
        eng.config.formulation = form
        for n_probe in (2, 3):
            eng.config.n_probe = n_probe
            if dev.type == "cuda":
                ms = cuda_ms(torch, lambda: eng.search_slots_device(qdev, TOP_K), reps)
            else:
                t = time.perf_counter()
                eng.search_slots_device(qdev, TOP_K)
                ms = 1e3 * (time.perf_counter() - t)
            timings[(form, n_probe)] = ms
            log(f"slice search_slots_device {form} n_probe={n_probe} B={b_serve}: "
                f"ms_per_batch={ms!r} qps={b_serve / (ms / 1e3)!r}")
    eng.config.formulation, eng.config.n_probe = "pairs", 3
    return build_s, recalls, timings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from quiver_tpu_torch import _build
    from quiver_tpu_torch.ops import ivf_cuda

    dev = torch.device("cuda", 0)
    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
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
    torch.cuda.empty_cache()
    ivf_cuda.reset_launch_counts()
    build_s, recalls, timings = phase_slice(
        torch, dev, n=N, b_serve=B_SERVE, n_clusters=1024, reps=10)
    counts = dict(ivf_cuda.launch_counts)
    log(f"slice launches: {counts}")

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
