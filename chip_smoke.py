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
   65536} for the slice's engine (n_probe=3, "pairs") and the exact scan;
7. writes: ``benches/streaming.py``'s run (8 x 8,192 inserts into the 1M
   engine with live recall, then the refresh and full-rebuild walls), then
   ``benches/churn.py``'s (45 x 8,192 inserts, a background refresh forced
   mid-stream on the engine's maintenance stream while queries are
   served); both engines import phase 4's topology from the bench's build
   cache. Gates: streaming ``recall_at_10_live`` >= 0.97; churn
   ``recall_at_10_live_min`` >= 0.92, ``recall_at_10_final`` >= 0.93, at
   least one maintenance swap and no job error; ``block_topw`` launched,
   and every one of its calls in the phase held against
   ``block_topw_reference`` on the operands it was given (:class:`LiveCheck`;
   the blocks are cloned after each query that follows a write, a copy
   inside the timed query);
8. collection: a ``Collection`` on ``cuda:0`` whose engine comes from the
   registry (``make_engine("ivf", ...)``, the headline config with
   ``recall_target=0.96``) loads the 1M corpus with ``{"cat", "price"}``
   metadata in one ``add_batch`` (its first ``on_insert`` builds and tunes
   the engine); ``search_batch`` of 2,048 requests unfiltered, ``cat = 3``
   and ``25 < price < 75``; then ``update_batch`` of 8,192 rows (new vectors
   and ``cat``) and ``delete_batch`` of 8,192 others. Gates: unfiltered
   recall@10 >= 0.95 against the exact f32 scan; every filtered result
   satisfies its filter (recall against the masked exact scan recorded,
   no gate); updated rows are found at their new vectors (top-1 >= 0.95),
   return their new ``cat`` and follow it through the ``cat`` filter; no
   deleted id is returned; ``block_topw`` launched, and every one of its
   calls in the phase (tuner, filter masks, keep bits cleared by the
   deletes) held against its plain version as in phase 7.

The 1M corpus is generated once and shared by phases 4-8; phase 4's engine
is dropped before phase 7. Then a JSON line of kernels (their launches are
the main path's, phase 4; the pairs entry's error covers phases 3, 7 and
8), the card line, and last the result line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from quiver_tpu_torch.bench import B as B_SERVE
from quiver_tpu_torch.bench import (
    B_ORACLE,
    N_CLUSTERS,
    RECALL_GATE,
    RECALL_TARGET,
    build_engine,
    cache_path,
    make_queries,
    save_cache,
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


class LiveCheck:
    """Every ``block_topw`` call the engine makes inside the ``with`` block,
    held against ``block_topw_reference`` afterwards (:meth:`verify`).

    It wraps the name ``ivf_query`` calls, so the launches are the main
    path's own, at its shapes, with the engine's real keep bits and filter
    masks. Each call's operands and keys are cloned as it runs, so later
    in-place writes to the blocks cannot change them; a block tensor is
    cloned again only when it was replaced or written since the last clone
    (its version counter), which costs one copy of the blocks (~0.46 GB on
    the card) per query that follows a write."""

    def __init__(self):
        import threading

        self.calls = []
        self._held = None  # (block tensor, its version, clone)
        self._lock = threading.Lock()

    def __enter__(self):
        from quiver_tpu_torch.ops import ivf_kernels

        self._mod, self._real = ivf_kernels, ivf_kernels.block_topw

        def block_topw(*args, **kw):
            out = self._real(*args, **kw)
            self._keep(args, kw, out)
            return out

        ivf_kernels.block_topw = block_topw
        return self

    def __exit__(self, *exc):
        self._mod.block_topw = self._real

    def _keep(self, args, kw, out):
        def clone(t):
            return t.clone() if hasattr(t, "clone") else t

        blocks = args[4]
        with self._lock:
            held = self._held
            if held is None or held[0] is not blocks or held[1] != blocks._version:
                held = self._held = (blocks, blocks._version, blocks.clone())
            self.calls.append(
                ([clone(a) for a in args[:4]] + [held[2]],
                 {k: clone(v) for k, v in kw.items()}, out.clone()))

    def verify(self, torch, phase: str) -> float:
        """Hold every kept call against the plain version (the tolerance of
        :func:`compare_keys`); raises on a mismatch or when no call was
        kept. Returns the largest score error."""
        from quiver_tpu_torch.ops.ivf_cuda import block_topw_reference, pair_scores_reference

        if not self.calls:
            raise AssertionError(f"{phase}: no block_topw call to check")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        worst, diffs, bps = 0.0, 0, set()
        for args, kw, k_kern in self.calls:
            k_ref = block_topw_reference(*args, **kw)
            s_sorted = pair_scores_reference(*args, **{
                k: kw[k] for k in ("P", "scale", "col_add", "row_add", "col_mul", "sub_cent")})
            s_orig = torch.empty_like(s_sorted)
            s_orig[args[3].long()] = s_sorted
            err, n_diff = compare_keys(torch, k_kern, k_ref, s_orig,
                                       W=kw["W"], R=kw["R"], pos_bits=kw["pos_bits"])
            worst, diffs = max(worst, err), diffs + n_diff
            bps.add((int(args[3].shape[0]), kw["P"], kw["W"], kw["R"]))
        log(f"{phase} live check: {len(self.calls)} block_topw calls within tolerance "
            f"of block_topw_reference (BP, P, W, R in {sorted(bps)}): "
            f"max_abs_err={worst!r} pos_diffs={diffs}")
        self.calls, self._held = [], None
        return worst


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


def pairs_launches(counts) -> int:
    """``block_topw`` launches of the pairs variant (W=32, R=2) in a
    launch-count snapshot."""
    return counts[(VARIANTS[0][1], VARIANTS[0][2])]


def phase_writes(torch, dev, vecs, *, cache) -> float:
    """Phase 7: the streaming and churn runs on the 1M corpus, gated, their
    engines imported from phase 4's topology in ``cache``. Returns the
    largest score error of the phase's own block_topw calls."""
    from quiver_tpu_torch.benches import churn, streaming
    from quiver_tpu_torch.ops import ivf_cuda

    ivf_cuda.reset_launch_counts()
    with LiveCheck() as live:
        rows = streaming.run(dev, base=vecs, cache=cache, log=log)
        res = churn.run(dev, base=vecs, cache=cache, log=log)
    counts = dict(ivf_cuda.launch_counts)
    stream = next(r for r in rows if r["metric"].startswith("ivf streaming"))
    if not stream["recall_at_10_live"] >= 0.97:
        raise AssertionError(f"streaming recall_at_10_live {stream['recall_at_10_live']} < 0.97")
    if res["maint"]["error"] is not None or res["maint_swaps"] < 1:
        raise AssertionError(f"churn maintenance: {res['maint']}")
    if not (res["recall_at_10_live_min"] >= 0.92 and res["recall_at_10_final"] >= 0.93):
        raise AssertionError(
            f"churn recall: live min {res['recall_at_10_live_min']} (gate 0.92), "
            f"final {res['recall_at_10_final']} (gate 0.93)")
    log(f"writes launches: {counts}")
    if pairs_launches(counts) <= 0:
        raise AssertionError("block_topw pairs was not launched by the write phase")
    return live.verify(torch, "writes")


def phase_collection(torch, dev, vecs, *, n_req=2048, n_upd=8192, seed=5) -> float:
    """Phase 8: the Collection on the card, gated (module docstring).
    Returns the largest score error of the phase's own block_topw calls."""
    from quiver_tpu_torch.ops import ivf_cuda

    ivf_cuda.reset_launch_counts()
    with LiveCheck() as live:
        _collection_run(torch, dev, vecs, n_req=n_req, n_upd=n_upd, seed=seed)
    counts = dict(ivf_cuda.launch_counts)
    log(f"collection launches: {counts}")
    if pairs_launches(counts) <= 0:
        raise AssertionError("block_topw pairs was not launched by the collection phase")
    return live.verify(torch, "collection")


def _collection_run(torch, dev, vecs, *, n_req, n_upd, seed):
    """Phase 8's run and gates, apart from its launch counts."""
    from quiver_tpu_torch import Collection, make_engine
    from quiver_tpu_torch.benches.common import recall_at_k
    from quiver_tpu_torch.benches.streaming import stream_rows
    from quiver_tpu_torch.index.exact import ExactIndex
    from quiver_tpu_torch.types import Filter, SearchOptions, SearchRequest

    n = len(vecs)

    def factory(store):
        return make_engine(
            "ivf", store, n_clusters=1024, n_probe=3, q_cap_factor=2, kmeans_iters=8,
            build_threshold=1024, rescore=False, recall_target=RECALL_TARGET)

    coll = Collection("chip", 128, "euclidean", device=dev, engine_factory=factory)
    rng = np.random.default_rng(seed)  # the recipe of benches/bench_filtered.py:23-26
    cats = rng.integers(0, 10, n)
    prices = rng.random(n) * 100
    mds = [{"cat": int(c), "price": float(p)} for c, p in zip(cats, prices)]
    ids = [f"v{i}" for i in range(n)]
    t0 = time.perf_counter()
    coll.add_batch(ids, vecs, mds)
    torch.cuda.synchronize()
    eng = coll.engine
    log(f"collection load: n={coll.size} load_s={time.perf_counter() - t0!r} "
        f"build_s={eng._last_rebuild_s!r} n_probe={eng.config.n_probe} "
        f"tuned_recall={eng._tuned_recall!r} K'={eng.n_clusters}")
    if not eng._built or eng.name != "ivf":
        raise AssertionError("the collection's first add_batch did not build the IVF engine")

    queries, _ = make_queries(vecs, n_req, n_req)
    forms = {
        "unfiltered": [],
        "cat=3": [Filter("cat", "=", 3)],
        "25<price<75": [Filter("price", ">", 25.0), Filter("price", "<", 75.0)],
    }
    exact = ExactIndex(coll.store)
    store = coll.store

    def requests(qs, filters, **kw):
        return [SearchRequest(vector=q, top_k=TOP_K, filters=list(filters), **kw) for q in qs]

    def slots_of(resps):
        out = np.full((len(resps), TOP_K), -1, np.int64)
        for b, r in enumerate(resps):
            for j, it in enumerate(r.results):
                out[b, j] = store.slot_of(it.id)
        return out

    def satisfied(resps, filters, cat_of, price_of):
        for r in resps:
            for it in r.results:
                c, p = cat_of(it.id), price_of(it.id)
                for f in filters:
                    v = c if f.field == "cat" else p
                    ok = {"=": v == f.value, ">": v > f.value, "<": v < f.value}[f.operator]
                    if not ok:
                        raise AssertionError(f"{it.id} ({c}, {p}) fails {f}")

    def meta(vid, key):
        return store.metadata_of_slot(store.slot_of(vid))[key]

    for name, filters in forms.items():
        reqs = requests(queries, filters)
        coll.search_batch(reqs)  # first use
        t0 = time.perf_counter()
        resps = coll.search_batch(reqs)
        ms = (time.perf_counter() - t0) * 1e3
        mask = coll.facets.compile_request_filters(filters) if filters else None
        _, truth = exact.search_slots(queries, TOP_K, mask=mask)
        r = recall_at_k(slots_of(resps), truth, TOP_K)
        satisfied(resps, filters, lambda v: meta(v, "cat"), lambda v: meta(v, "price"))
        log(f"collection search_batch {name}: B={n_req} ms_per_call={ms!r} "
            f"recall@{TOP_K}={r!r} (exact{' masked' if filters else ''} f32 oracle)")
        if not filters and r < 0.95:
            raise AssertionError(f"collection unfiltered recall@10 {r} < 0.95")

    # updates (new vectors, new cat) and deletes of disjoint rows
    pick = np.random.default_rng(seed + 1).permutation(np.arange(n_req, n))[: 2 * n_upd]
    upd, dele = pick[:n_upd], pick[n_upd:]
    new_vecs = stream_rows(n_upd, seed=seed + 2)
    new_cats = (cats[upd] + 1) % 10
    upd_ids = [ids[i] for i in upd]
    del_ids = {ids[i] for i in dele}
    t0 = time.perf_counter()
    coll.update_batch(upd_ids, new_vecs, [{"cat": int(c), "price": float(prices[i])}
                                          for c, i in zip(new_cats, upd)])
    torch.cuda.synchronize()
    t_upd = time.perf_counter() - t0
    t0 = time.perf_counter()
    if coll.delete_batch(sorted(del_ids)) != n_upd:
        raise AssertionError("delete_batch did not remove every row")
    torch.cuda.synchronize()
    log(f"collection update_batch {n_upd}: {t_upd!r} s; delete_batch {n_upd}: "
        f"{time.perf_counter() - t0!r} s; size {coll.size}")

    opts = SearchOptions(include_metadata=True)
    hits = coll.search_batch(requests(new_vecs, [], options=opts))
    top1 = np.mean([bool(r.results) and r.results[0].id == vid for r, vid in zip(hits, upd_ids)])
    for r, vid, c in zip(hits, upd_ids, new_cats):
        if r.results and r.results[0].id == vid and r.results[0].metadata["cat"] != int(c):
            raise AssertionError(f"{vid}: include_metadata returned a stale cat")
    follow = coll.search_batch([SearchRequest(vector=v, top_k=TOP_K, filters=[Filter("cat", "=", int(c))])
                                for v, c in zip(new_vecs, new_cats)])
    follow_hit = np.mean([any(it.id == vid for it in r.results) for r, vid in zip(follow, upd_ids)])
    old = coll.search_batch([SearchRequest(vector=v, top_k=TOP_K, filters=[Filter("cat", "=", int(c))])
                             for v, c in zip(new_vecs, cats[upd])])
    if any(it.id == vid for r, vid in zip(old, upd_ids) for it in r.results):
        raise AssertionError("an updated row still matches its old cat")
    log(f"collection after update: self top-1 {float(top1)!r}, cat filter follows {float(follow_hit)!r}")
    if top1 < 0.95 or follow_hit < 0.95:
        raise AssertionError(f"updated rows: top-1 {top1}, cat filter {follow_hit} (gate 0.95)")
    seen = [it.id for resps in (hits, follow, old) for r in resps for it in r.results]
    for filters in forms.values():
        seen += [it.id for r in coll.search_batch(requests(queries, filters)) for it in r.results]
    if del_ids.intersection(seen):
        raise AssertionError("a deleted id was returned")


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
    cache = cache_path(N, N_CLUSTERS)
    save_cache(eng, cache)  # phase 7 imports this topology, builds none
    del eng, qdev
    torch.cuda.empty_cache()

    # phase 7: the write path (streaming, then churn with background
    # maintenance); phase 8: the Collection with facet filters. Their own
    # block_topw calls join the pairs entry's error.
    live_err = phase_writes(torch, dev, vecs, cache=cache)
    torch.cuda.empty_cache()
    live_err = max(live_err, phase_collection(torch, dev, vecs))
    records["pairs"]["max_abs_err"] = max(records["pairs"]["max_abs_err"], live_err)

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
