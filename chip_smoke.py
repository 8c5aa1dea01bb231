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
   the card (:func:`check_call`) at the main path's shapes (d=128,
   Cmax=1280, K=1405, B=65536, P in {2, 3, 4}) and at a 768-d one (B=16384,
   K=1024, P=3), pairs variant (W=32, R=2: L2, dot, cosine; caff re-keyed
   onto the winners for L2 and dot), fused variant (W=128, R=4: L2, dot),
   row mode (one window per row: R=16, the running top-R; R=100, every
   key of the row and the wrapper's top-R) and the pairs stage at
   ``seg_width`` 64 and 128 (W=64 and 128, R=2, 6 and 7 position bits, the
   ``_mask_key(W)`` sentinel; at P in {2, 3} only); then the same variants
   over f32 blocks (``csrc/ivf_block_topw_f32.cu``; pairs and row mode on
   the f32 query, fused on the bf16-rounded one) at P in {2, 3} and at the
   768-d shape; times of kernel and plain version with CUDA events and the
   least time the card could take (``benches/common.py::topw_bound`` at
   the card's published peaks, ``peaks``: bytes at its HBM rate, products
   at the bf16 tensor-core peak or, for f32 blocks, three TF32 products
   each, two on a bf16-rounded query, at the TF32 peak); then the error of
   the card's dot products against f64 at d=128 and 768, for bf16 and for
   f32 blocks (:func:`phase_sums`);
4. slice: the headline bench's path (``quiver_tpu_torch/bench.py``): the
   1M x 128-d clustered L2 corpus through ``VectorStore(device="cuda")`` ->
   ``IVFIndex.build()`` with ``recall_target=0.96``, so the build tunes
   n_probe; the tuned n_probe, holdout recall and stderr, and
   ``recall_shortfall``; recall@10 at the tuned n_probe against an f64
   oracle (tie-aware, the rule of ``benches/truth.py``) >= 0.95; then
   n_probe in {2, 3} x {"pairs", "fused"}: recall and ms per batch / QPS of
   ``search_slots_device`` at B=65536; a profile of the tuned batch (device
   time by kernel, busy share); ``device_bytes()`` and the peak of
   allocated card memory; one k=100 batch (B=4096, :func:`phase_k100`:
   every slot filled, recall@100 recorded, the call held against the plain
   version); the kernel's launch counts over this phase;
5. probes: ``benches/probe.py``'s two kernels (``scatter_rows``,
   ``index_read``) at the TPU probe's shapes and at the main path's (the
   slice's own probe ids: 196,608 pairs over its clusters), each held
   against its expectation and its plain version; launch counts over that
   run; then kernel and plain version timed (``time_probes``):
   ``scatter_rows`` also at uniform clusters and beside PyTorch's own
   scatter of the same rows, ``index_read`` as device time from a CUDA
   graph replay beside its launch floor (one grid step) and its host cost
   per call;
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
   ``recall_target=0.96`` and clusters scaled with the rows) loads the
   first 262,144 rows of the corpus (``COLLECTION_ROWS``: cut from 1M for
   the run's time) with ``{"cat", "price"}`` metadata in one
   ``add_batch`` (its first ``on_insert`` builds and tunes the engine);
   ``search_batch`` of 2,048 requests unfiltered, ``cat = 3`` and
   ``25 < price < 75``; then ``update_batch`` of 8,192 rows (new vectors
   and ``cat``) and ``delete_batch`` of 8,192 others. Gates: unfiltered
   recall@10 >= 0.95 against the exact f32 scan; every filtered result
   satisfies its filter (recall against the masked exact scan recorded,
   no gate); updated rows are found at their new vectors (top-1 >= 0.95),
   return their new ``cat`` and follow it through the ``cat`` filter; no
   deleted id is returned; ``block_topw`` launched, and every one of its
   calls in the phase (tuner, filter masks, keep bits cleared by the
   deletes) held against its plain version as in phase 7;
9. the database at its defaults (``DB``: engine "hybrid", compute dtype
   "float32", so a collection is the hybrid engine over an IVF engine with
   f32 blocks): (a) with persistence off, the 1M corpus through
   ``batch_insert`` (the headline IVF config as the collection's
   ``engine_config``), ``batch_search`` of 2,048 requests at k=10 (gate
   recall@10 >= 0.95 against the exact f32 scan; the hybrid's split by
   engine recorded) and 512 at k=100 (every slot filled), the collector's
   ``measure_recall`` (gate >= 0.95), then the f32 slice: the hybrid's IVF
   side at its tuned n_probe, pairs and fused, recall@10 against the f64
   oracle (gate >= 0.95), ms per B=65536 batch and ``device_bytes()``; (b)
   the persistence round trip at 65,536 rows of the corpus
   (``PERSIST_ROWS``: every insert is journaled as a JSON record), the
   same engine config: 8,192-row ``batch_insert`` calls through the native
   WAL (rows/s), ``close()`` (flush seconds, the snapshot's format:
   Parquet with pyarrow, JSON without), a reopen through ``topology.npz``
   (load seconds; recall@10 >= 0.95 on 256 queries; the share of top-10
   lists identical to those before the close), a crash (a flush, 1,024
   deletes and 1,024 adds in the WAL only, the DB dropped unclosed; no
   deleted id returns, each added row is its own top-1), and a reopen
   without the sidecar (the cold build's seconds beside the sidecar's).
   Every ``block_topw`` call of (a) and (b) is held against its plain
   version (:class:`LiveCheck`); their launch counts are the f32 kernel's
   entries in the kernels line. The f32 slice is timed after them, on the
   engine of (a);
10. the server: (a) ``quiver_tpu_torch.api.server.Server`` on its own
   event-loop thread over phase 9a's DB (the 1M collection, kept alive),
   driven by stdlib ``http.client`` clients in a thread pool: 2,048 single
   searches from 64 clients (phase 9's queries; gate recall@10 >= 0.95
   against its exact f32 scan; QPS, p50/p95/p99 and the coalescer's mean
   dispatched batch recorded), one ``search/batch`` of 256 (same gate),
   ``vectors/batch`` of 8,192 new rows (each of 256 probed is its own
   top-1 at >= 0.95), 256 PUT updates (GET returns each new vector), a
   batch delete of 256 (no deleted id returned by searches at their
   vectors), both metrics endpoints (200); then a second server on the same
   DB with ``search_backlog=64`` and a burst of 512 concurrent searches
   (gates: at least one 429 with an integer ``Retry-After`` >= 1, every
   other answer 200). Its own launch counts (``block_topw_f32`` pairs must
   be launched; ``server_launches`` in the kernels line) and every
   ``block_topw`` call of the phase held against the plain version; (b)
   ``python -m quiver_tpu_torch.cli`` as its own processes over phase 9b's
   directory (65,536 rows): ``info`` counts them; ``serve`` answers
   ``/health`` and holds card memory (``nvidia-smi``'s compute processes:
   its pid, or their memory grown by >= 256 MiB where a container's PID
   namespace hides the pid); 8 searches and a ``vectors/batch`` of 1,024
   rows; SIGTERM: exit 0 within the shutdown timeout plus the flush (its
   seconds logged); ``info`` then counts 65,536 + 1,024; ``backup``, then
   ``restore`` into a fresh directory, whose ``info`` matches;
11. HNSW (torch ops, no hand-written kernel, so the kernels line does not
   change): (a) ``HNSWIndex`` built over the 1M corpus as
   ``benches/bench_hnsw.py`` builds it (M=16, m0=32, efC=200, bf16
   construction products, ``build_batch`` 8192): wall seconds, inserts/s,
   the spill count, each layer's graph checked on the card
   (:func:`hnsw_invariants`: a row's fill is its count of ids, no self
   edge, no id twice in a row, every id a live slot); (b) the ef sweep
   {50, 100, 200, 400} over 2,048 jittered corpus queries (ring visited;
   bitmap at ef=100): recall@10 plain and tie-aware against the f64
   oracle (gate: tie-aware >= 0.90 at ef=400; the first ef reaching 0.95
   is logged as a finding), ms per batch of ``search_device`` at B in
   {128, 2048, 65536} at ef=100, the beam's iterations (mean and max per
   query, the loop's count), one B=2048 search's kernel launches and the
   card's busy share from a profiler trace, each HNSW program's card ms
   and launches at the phase's shapes (:func:`hnsw_programs`); gate: 256
   queries at ef=100 return the same ids on the card as on a CPU index
   holding the same graph, up to swaps of entries tied within 1e-5
   (:func:`ids_agree`); then the HNSW leg of ``benches/streaming.py``
   on that graph (:func:`phase_hnsw_streaming`: 8 x 8,192 stream rows,
   B=256 queries half near old rows, half near new; the store grows under
   the graph; gates: it grew, recall@10 against the live exact scan >=
   0.90, the graph's invariants hold after); (c) through the stack
   (:func:`phase_hnsw_stack`): a ``DB`` collection with engine "hnsw" over the persist cell's 65,536
   rows, flushed and reopened from its sidecar (gates: no row inserted by
   the load, the same top-10 lists), against a cold reload without the
   sidecar (a rebuild); a hybrid with an ``hnsw`` block at
   ``benches/bench_hybrid.py``'s shape (20,000 x 64-d; gate: a 128-query
   batch routes mostly to the graph); a REST create, insert and search of
   an ``engine: "hnsw"`` collection (201, 201, 200);
12. the sharded engines, 4 shards placed together on the card
   (``SHARDS``; ``quiver_tpu_torch/parallel/``): (a) a ``ShardedIVFIndex``
   over the 1M corpus at the headline config (tuner on): tie-aware
   recall@10 against phase 4's oracle (gate >= 0.95), ms per batch at
   B=65536 and 2,048, each shard's candidate stage and the merge apart
   (CUDA events, ``sharded_ivf_query(stats=)``), launches per batch, card
   bytes per shard; (b) 2,048 queries in shard 0's clusters: the skew
   auto-raise must fire and the next batch's recall come within 0.01 of
   the no-drop control; (c) the engine's ``ShardedExactIndex`` at B=2,048
   against the single-card scan (ids equal up to tie swaps,
   :func:`ids_agree`), the merge's share of its wall; (d) a
   ``ShardedHNSWIndex`` over the first 65,536 rows (f32 construction, cut
   as the persist cell): recall@10 at ef {100, 200} (gate >= 0.95 at
   ef=200), ms per batch and launches per search at B=2,048, the batched
   search equal to per-shard calls on 256 queries; (e) a DB with
   ``default_engine="sharded_hybrid"`` (f32 blocks; the collection's
   IVF knobs are phase 9b's ``DB_IVF``, the n_probe tuner on) over those
   rows: recall@10 >= 0.95 against the exact scan, a refresh, then a
   flush and reload through the sidecar serving identical top-10 lists
   at the tuned n_probe with no build; a REST ``sharded_ivf`` collection
   (201, 201, 200). Every ``block_topw`` call of (a), (b) and (e), each on a shard's
   truncated pair list, is held against its plain version
   (:class:`LiveCheck`);
13. the benches at scale: (a) ``benches/bench_10m.py`` at full width
   (:func:`phase_10m`: 10M x 128-d, K=4096, n_probe=3; the cold build,
   the ``import_topology`` layout of its assignment, device GiB and bytes
   per vector, QPS at B=32768 and 65536; gates: recall@10 >= 0.95
   against the f64 oracle, the imported layout answers as the built one;
   every ``block_topw`` call outside the timed loops held against the
   plain version); (b) ``benches/bench_corpus_matrix.py`` at N=250,000
   (:func:`phase_matrix`: five families, the ``[ivf]``, ``[hybrid auto]``
   and ``[hnsw]`` rows beside the reference's recall; gate:
   ``[hybrid auto]`` >= 0.95 on every family; every ``block_topw`` call
   held against the plain version); (c) ``benches/bench_roofline.py``'s
   ``seg_width`` sweep {32, 64, 128} over phase 4's engine at B=65536,
   n_probe=2 (:func:`phase_roofline`, run after phase 6 while that engine
   lives; one batch per width held against the plain version), which
   launches the (64, 2) and (128, 2) variants; achieved TFLOP/s and GB/s
   and their shares of the card's published peaks. Each part's wall is
   logged.

The 1M corpus is generated once and shared by phases 4-12; phase 4's engine
is dropped before phase 7. Then a JSON line of kernels (the bf16 kernel's
launches are the main path's, phase 4, except the seg_width variants'
(pairs64, pairs128), which are phase 13c's, and the f32 kernel's the
database's, phase 9; ``sharded_launches`` and ``scale_launches`` on every
entry are phase 12's and phase 13's launches of that variant; the pairs
entry's error covers phases 3, 7 and 8, the row mode's phases 3 and 4,
the f32 entries' phases 3, 9 and 10, and each entry's also phase 12's and
13's calls of its variant; ``bound_ms`` is computed from this run's
operands at the card's published peaks and ``bound_share`` is it over
``ms``), the card line, the run's total seconds, and last the result
line.
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
from quiver_tpu_torch.benches.common import (
    N, bound, card, clustered, cuda_ms, kernel_ms, oracle_kth, peaks, topw_bound,
)
from quiver_tpu_torch.benches.truth import recall_with_ties

#: kernel-phase shapes: the serving point of the slice (K' of the headline
#: build is ~1400 clusters of Cmax=1280)
KERNEL_SHAPE = dict(B=65536, K=1405, Cmax=1280, d=128)
KERNEL_PROBES = (2, 3, 4)
#: a 768-d serving-like shape (the width of the reference deployment's
#: embeddings): every variant at P=3
WIDE_SHAPE = dict(B=16384, K=1024, Cmax=1280, d=768)
#: phase 8's rows: the first quarter of the 1M corpus (cut from 1M to keep
#: the run's time; its host-bound load is per-row Python)
COLLECTION_ROWS = 262144
#: (variant name, W, R, position bits, metrics); W = 0 is row mode (one
#: window of Cmax columns, position bits to hold Cmax). Row mode serves the
#: per-pair branch, taken when Cmax holds fewer than k windows: R=16 keeps
#: a running top-R in the kernel, R=100 (the 1M slice at k=100) has the
#: kernel write every key of the row for the wrapper's top-R.
VARIANTS = (
    ("pairs", 32, 2, 5, ("euclidean", "dot_product", "cosine")),
    ("fused", 128, 4, 11, ("euclidean", "dot_product")),
    ("row", 0, 16, 0, ("euclidean", "dot_product", "cosine")),
    ("row100", 0, 100, 0, ("euclidean", "dot_product", "cosine")),
    ("pairs64", 64, 2, 6, ("euclidean", "dot_product", "cosine")),
    ("pairs128", 128, 2, 7, ("euclidean", "dot_product", "cosine")),
)
#: the pairs stage at ``seg_width`` 64 and 128 (phase 13c's roofline sweep
#: launches them): held at the main path's P in {2, 3} and the 768-d shape
SEG_VARIANTS = {"pairs64": 64, "pairs128": 128}


#: the probes' times beside ms and plain_ms in the kernels line
#: (benches/probe.py::time_probes): scatter_rows at uniform clusters;
#: index_read's launch floor (grid=1) and the wrapper's host cost per call
PROBE_EXTRAS = {"scatter_rows": ("uniform_ms",), "index_read": ("floor_ms", "host_us")}


def variant_args(variant, W, R, pos_bits, Cmax):
    """(W, pos_bits, sentinel) of a VARIANTS entry at a given Cmax."""
    from quiver_tpu_torch.ops.ivf_cuda import KEY_MIN, _mask_key

    if W == 0:
        return Cmax, max(1, (Cmax - 1).bit_length()), KEY_MIN
    return W, pos_bits, int(_mask_key(W)) if variant.startswith("pairs") else KEY_MIN


_T0 = time.perf_counter()


def card_peaks(torch) -> dict:
    """The published peaks of the card this run is on (``peaks``; an
    unknown card raises)."""
    return peaks(torch.cuda.get_device_name(0))


def log(msg: str) -> None:
    """One line of the run, prefixed with the seconds since the script began."""
    print(f"[{time.perf_counter() - _T0:6.1f}s] {msg}", flush=True)


def kernel_inputs(torch, dev, *, B, P, K, Cmax, d, metric, variant, seed, dtype=None):
    """Random operands of one block_topw call at the given shape, built the
    way ivf_query builds them (stable pair sort, CSR starts, epilogue).
    ``dtype``: the blocks' (bf16 by default); f32 blocks take the f32 query
    in the pairs and row variants (``round_query=False``, the reference's
    f32 ragged_dot) and the bf16-rounded one in the fused variant."""
    from quiver_tpu_torch.ops.ivf_kernels import _epilogue
    from quiver_tpu_torch.ops.scan import NEG_BIG
    from quiver_tpu_torch.types import DistanceType

    g = torch.Generator(device=dev).manual_seed(seed)
    win_add = None
    q = torch.randn(B, d, generator=g, device=dev)
    cents = 0.5 * torch.randn(K, d, generator=g, device=dev)
    probe = torch.rand(B, K, generator=g, device=dev).topk(P, dim=1).indices
    dtype = torch.bfloat16 if dtype is None else dtype
    blocks_t = (0.5 * torch.randn(K, d, Cmax, generator=g, device=dev)).to(dtype)
    keep = torch.rand(K, Cmax, generator=g, device=dev) > 0.1
    rns = 0.25 * d * torch.rand(K, Cmax, generator=g, device=dev)
    inv = 0.5 + torch.rand(K, Cmax, generator=g, device=dev)
    c_dots = torch.randn(B, K, generator=g, device=dev)
    flat_c = probe.reshape(-1)
    order = torch.argsort(flat_c, stable=True).to(torch.int32)
    starts = torch.zeros(K + 1, dtype=torch.int32, device=dev)
    starts[1:] = torch.cumsum(torch.bincount(flat_c, minlength=K), 0)
    m = DistanceType.parse(metric)
    if variant != "fused":
        scale, sub_cent, col_add, row_add, col_mul = _epilogue(m, keep, rns, inv, c_dots, probe)
        if variant.startswith("pairs") and m != DistanceType.COSINE:
            # the per-pair constant caff, re-keyed onto each winner
            win_add = 0.25 * d * torch.randn(B * P, generator=g, device=dev)
    elif m == DistanceType.EUCLIDEAN:
        scale, sub_cent, row_add, col_mul = 2.0, True, None, None
        col_add = torch.where(keep, -rns, NEG_BIG)
    else:
        scale, sub_cent, row_add, col_mul = 1.0, False, None, None
        col_add = torch.where(keep, 0.0, NEG_BIG)
    args = (q, cents, starts, order, blocks_t)
    kw = dict(P=P, scale=scale, col_add=col_add, row_add=row_add,
              col_mul=col_mul, sub_cent=sub_cent)
    if win_add is not None:
        kw["win_add"] = win_add
    if dtype == torch.float32 and variant != "fused":
        kw["round_query"] = False
    return args, kw


#: the keyword operands of pair_scores_reference (block_topw's less the
#: window, the sentinel and win_add)
SCORE_KEYS = ("P", "scale", "col_add", "row_add", "col_mul", "sub_cent", "round_query")


def pair_scores_orig(torch, args, kw):
    """f32[B*P, Cmax] plain scores of a block_topw call, rows in original
    pair order (what compare_keys reads positions against); rows no sorted
    pair reaches (a shard's truncated list) are zero."""
    from quiver_tpu_torch.ops.ivf_cuda import pair_scores_reference

    s_sorted = pair_scores_reference(*args, **{k: kw[k] for k in SCORE_KEYS if k in kw})
    s_orig = s_sorted.new_zeros(args[0].shape[0] * kw["P"], s_sorted.shape[1])
    s_orig[args[3].long()] = s_sorted
    return s_orig


#: the card's sums keep |kernel - f64| <= SUM_ERR * 2^-24 * sum_scale (see
#: :func:`sum_scale`); phase 3 measures the ratio and fails above it
SUM_ERR = 16.0


def sum_scale(torch, args, kw):
    """f32[B*P] per pair, original order (zero for pairs a truncated list
    leaves out): |scale| * ||a|| * max_j |col_mul[c, j]|
    * ||b_j||, with a the pair's query row as the product takes it (minus the
    centroid for L2, bf16-rounded unless ``round_query`` is False) and b_j
    the columns of its cluster's block. By Cauchy-Schwarz it bounds
    scale * col_mul * sum_k |a_k b_kj|, which scales the rounding error of
    the dot products."""
    q, cents, starts, order, blocks = args
    K, _, Cmax = blocks.shape
    M = order.shape[0]
    sorted_c = torch.repeat_interleave(torch.arange(K, device=q.device),
                                       (starts[1:] - starts[:-1]).long(), output_size=M)
    a = q[order.long() // kw["P"]]
    if kw["sub_cent"]:
        a = a - cents[sorted_c]
    if kw.get("round_query", True):
        a = a.to(torch.bfloat16).float()
    a = torch.linalg.vector_norm(a, dim=1)
    bn = torch.cat([torch.linalg.vector_norm(blocks[c:c + 64].float(), dim=1)
                    for c in range(0, K, 64)])  # f32[K, Cmax]
    if kw.get("col_mul") is not None:
        bn = bn * kw["col_mul"].abs()
    out = torch.zeros(q.shape[0] * kw["P"], dtype=torch.float32, device=q.device)
    out[order.long()] = abs(kw["scale"]) * a * bn.max(dim=1).values[sorted_c]
    return out


def compare_keys(torch, k_kern, k_ref, s_orig, sums, *, W, R, pos_bits, win_add=None):
    """Hold kernel keys against the twin's. Stated tolerance: unpacked
    scores agree within 2 quanta of the packing (2^(pos_bits-22) relative)
    plus the sums' own error, SUM_ERR * 2^-24 * sums[row] (``sums``:
    :func:`sum_scale`; on an NVIDIA H100 80GB HBM3 at 700 W the tensor
    cores' f32 sums of bf16 products strayed from f64 by up to 2.29 of
    those units at d=768 where the f32 twin strayed by 0.26, and a score
    that cancels to near zero carries that absolute error; phase 3 measures
    it on every run);
    winner positions agree wherever the competing scores differ by more
    than that; masked winners agree key for key. Lane ``r*S + w`` holds
    window w's r-th winner (S windows). With ``win_add`` (f32[BP],
    original pair order) each winner was packed before the add as well as
    after it, so its quanta are counted at both magnitudes: |score| +
    |win_add| bounds the one before. Returns (max abs score error,
    positions that differ)."""
    from quiver_tpu_torch.ops.ivf_cuda import _from_key
    from quiver_tpu_torch.ops.scan import NEG_BIG

    pm = (1 << pos_bits) - 1
    sk = _from_key(k_kern & ~pm)
    sr = _from_key(k_ref & ~pm)
    real = sr > NEG_BIG / 2
    mag = sr.abs() if win_add is None else sr.abs() + win_add.abs()[:, None]
    tol = 2.0 ** (pos_bits - 22) * mag + SUM_ERR * 2.0 ** -24 * sums[:, None]
    err = torch.where(real, (sk - sr).abs(), 0.0)
    # KEY_MIN lanes (row mode's sentinel, e.g. the rows a shard's truncated
    # pair list leaves out) decode to NaN: they are masked winners, held
    # key for key below
    ok = (err <= tol) | ~real
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise AssertionError(f"{bad} winner scores differ beyond tolerance; max {float(err.max())}")
    if not bool((k_kern == k_ref)[~real].all()):
        raise AssertionError("masked winners differ")
    S = k_kern.shape[1] // R
    lane_w = (torch.arange(k_kern.shape[1], device=k_kern.device) % S) * W
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


def check_call(torch, args, kw, k_kern):
    """:func:`compare_keys` of one block_topw call's keys against
    ``block_topw_reference`` on the same operands (``kw`` with W, R,
    pos_bits and sentinel). Returns (max abs score error, positions that
    differ)."""
    from quiver_tpu_torch.ops.ivf_cuda import block_topw_reference

    k_ref = block_topw_reference(*args, **kw)
    return compare_keys(torch, k_kern, k_ref, pair_scores_orig(torch, args, kw),
                        sum_scale(torch, args, kw), W=kw["W"], R=kw["R"],
                        pos_bits=kw["pos_bits"], win_add=kw.get("win_add"))


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
        if not self.calls:
            raise AssertionError(f"{phase}: no block_topw call to check")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        from quiver_tpu_torch.ops import ivf_cuda

        worst, diffs, bps = 0.0, 0, set()
        #: the largest score error by (blocks' dtype, W, R), and by the
        #: launch-count key of ``ivf_cuda.launch_counts`` (the variant)
        self.worst_by, self.worst_by_variant = {}, {}
        for args, kw, k_kern in self.calls:
            err, n_diff = check_call(torch, args, kw, k_kern)
            worst, diffs = max(worst, err), diffs + n_diff
            bps.add((int(args[3].shape[0]), kw["P"], kw["W"], kw["R"]))
            key = (str(args[4].dtype).split(".")[-1], kw["W"], kw["R"])
            self.worst_by[key] = max(self.worst_by.get(key, 0.0), err)
            wr = (kw["W"], kw["R"])
            var = wr if wr in ivf_cuda.CUDA_VARIANTS else ivf_cuda.ROW_MODE
            var = (ivf_cuda.F32, var) if args[4].dtype == torch.float32 else var
            self.worst_by_variant[var] = max(self.worst_by_variant.get(var, 0.0), err)
        log(f"{phase} live check: {len(self.calls)} block_topw calls within tolerance "
            f"of block_topw_reference (BP, P, W, R in {sorted(bps)}): "
            f"max_abs_err={worst!r} pos_diffs={diffs}")
        self.calls, self._held = [], None
        return worst


def phase_kernels(torch, dev, *, shape, probes, reps, dtype=None):
    """Kernel against twin at the given shape and blocks' dtype (bf16 by
    default); returns per-variant records (max error; at P=3 L2: kernel,
    plain-version and bound ms)."""
    from quiver_tpu_torch.ops import ivf_cuda

    dtype = torch.bfloat16 if dtype is None else dtype
    records = {}
    for variant, W, R, pos_bits, metrics in VARIANTS:
        W, pos_bits, sentinel = variant_args(variant, W, R, pos_bits, shape["Cmax"])
        rec = records.setdefault(variant, {"W": W, "R": R, "max_abs_err": 0.0})
        for P in probes if variant not in SEG_VARIANTS else [p for p in probes if p <= 3]:
            for metric in metrics:
                args, kw = kernel_inputs(
                    torch, dev, P=P, metric=metric, variant=variant,
                    seed=1000 * P + len(metric), dtype=dtype, **shape,
                )
                wkw = dict(kw, W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)
                k_kern = ivf_cuda.block_topw(*args, **wkw)
                err, n_diff = check_call(torch, args, wkw, k_kern)
                ms = cuda_ms(lambda: ivf_cuda.block_topw(*args, **wkw), reps)
                plain_ms = cuda_ms(lambda: ivf_cuda.block_topw_reference(*args, **wkw), 1)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                extra = ""
                if P == 3 and metric == "euclidean":
                    rec["ms"], rec["plain_ms"] = ms, plain_ms
                    rec["bound_ms"], rec["bound_by"] = topw_bound(args, wkw, k_kern,
                                                                  card_peaks(torch))
                    extra = (f" bound_ms={rec['bound_ms']!r} ({rec['bound_by']}) "
                             f"bound_share={rec['bound_ms'] / ms!r}")
                log(
                    f"kernel {variant} {str(dtype).split('.')[-1]} blocks W={W} R={R} "
                    f"{metric} B={shape['B']} P={P} d={shape['d']} "
                    f"BP={shape['B'] * P}: max_abs_err={err!r} pos_diffs={n_diff} "
                    f"kernel_ms={ms!r} twin_ms={plain_ms!r}{extra}"
                )
                del args, kw, wkw, k_kern
                torch.cuda.empty_cache()
    return records


def phase_sums(torch, dev, *, d, dtype=None, seed=11):
    """The error of the card's dot products against f64 on the same
    operands (bf16 blocks and query by default; f32 blocks and the f32
    query of the pairs formulation with ``dtype=torch.float32``), in units
    of 2^-24 * sum_scale: row mode at Cmax=8 keeps all 8 keys of each pair
    (3 position bits, one quantum 2^-20 of the score, taken off). Fails
    above SUM_ERR, the unit count compare_keys allows."""
    from quiver_tpu_torch.ops import ivf_cuda

    B, K, Cmax = 65536, 1024, 8
    args, kw = kernel_inputs(torch, dev, B=B, P=1, K=K, Cmax=Cmax, d=d, metric="euclidean",
                             variant="row", seed=seed, dtype=dtype)
    q, cents, starts, order, blocks = args
    keys = ivf_cuda.block_topw(*args, **kw, W=Cmax, R=Cmax, pos_bits=3, sentinel=ivf_cuda.KEY_MIN)
    sk = torch.empty(B, Cmax, device=dev)
    sk.scatter_(1, (keys & 7).long(), ivf_cuda._from_key(keys & ~7))
    s32 = pair_scores_orig(torch, args, kw)
    sorted_c = torch.repeat_interleave(torch.arange(K, device=dev), (starts[1:] - starts[:-1]).long())
    o = order.long()
    a = q[o] - cents[sorted_c]
    a = (a.to(torch.bfloat16) if kw.get("round_query", True) else a).double()
    s64 = torch.empty(B, Cmax, dtype=torch.float64, device=dev)
    s64[o] = kw["scale"] * torch.einsum("pd,pdc->pc", a, blocks.double()[sorted_c]) \
        + kw["col_add"][sorted_c].double()
    unit = 2.0 ** -24 * sum_scale(torch, args, kw).double()[:, None]
    real = s64 > -1e30
    ratios = []
    for s in (sk, s32):
        e = ((s.double() - s64).abs() - 2.0 ** -20 * s64.abs()).clamp(min=0)
        ratios.append(float((e / unit)[real].max()))
    log(f"sums {str(blocks.dtype).split('.')[-1]} blocks d={d}: max |kernel - f64| = "
        f"{ratios[0]!r}, max |f32 twin - f64| = {ratios[1]!r} units of 2^-24 * sum_scale "
        f"(B={B}, Cmax={Cmax}; tolerance {SUM_ERR})")
    if ratios[0] > SUM_ERR:
        raise AssertionError(f"the card's sums stray {ratios[0]} units from f64 at d={d}")
    return ratios


def phase_slice(torch, dev, vecs, *, b_serve, reps):
    """The headline bench's path on the device, the tuner included.
    Returns (engine, serving queries on the device, the oracle sample and
    its f64 k-th distances)."""
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
    slice_profile(torch, eng, qdev)
    log(f"slice memory: device_bytes={eng.device_bytes()} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)}")
    return eng, qdev, queries, kth


def slice_profile(torch, eng, qdev, *, batches=5, top=8):
    """Device time by kernel over ``batches`` back-to-back slice batches
    (:func:`kernel_ms`) and the card's busy share of the window."""
    by_name, wall = kernel_ms(lambda: eng.search_slots_device(qdev, TOP_K), batches)
    busy = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    log(f"slice profile (pairs, n_probe={eng.config.n_probe}, B={qdev.shape[0]}, {batches} "
        f"batches): ms_per_batch={wall!r} device_busy_ms={busy!r} busy_share={busy / wall!r}; "
        + "; ".join(f"{name} {ms!r}" for name, ms in rows))


def phase_k100(torch, dev, eng, qb, vecs, *, b=4096, k=100) -> float:
    """Phase 4's k=100 batch: B=4096 serving queries through ``search_slots``
    at the tuned n_probe. Cmax=1280 holds 40 windows of 32 < k, so the
    per-pair branch serves it (row mode, R=100: every key of each row, then
    the wrapper's top-R). Every slot must be filled; recall@100 against the
    f64 oracle is recorded, not gated; the call is held against the plain
    version. Returns its largest score error."""
    q = qb[:b]
    kth = oracle_kth(dev, q, vecs, k)
    with LiveCheck() as live:
        dist, slots = eng.search_slots(q, k)
    if dist.shape != (b, k) or (slots < 0).any() or not np.isfinite(dist).all():
        raise AssertionError(f"k={k}: {int((slots < 0).sum())} empty slots, shape {dist.shape}")
    qdev = torch.from_numpy(q).to(dev)
    ms = cuda_ms(lambda: eng.search_slots_device(qdev, k), 3)
    log(f"slice k={k} B={b} n_probe={eng.config.n_probe}: all {b * k} slots filled; "
        f"recall@{k} {recall_with_ties(slots, q, vecs, kth, k)!r} (f64 oracle, tie-aware); "
        f"ms_per_batch={ms!r}")
    return live.verify(torch, f"slice k={k}")


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
        # clusters scaled with the rows, so each holds the 1M slice's ~1,000
        # rows (Cmax 1280): smaller clusters crowd a query's neighbours into
        # fewer 32-lane windows, whose top-2 then drops some (PERF.md)
        return make_engine(
            "ivf", store, n_clusters=max(8, N_CLUSTERS * n // N), n_probe=3, q_cap_factor=2,
            kmeans_iters=8, build_threshold=1024, rescore=False, recall_target=RECALL_TARGET)

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


#: phase 9: the headline engine's IVFConfig as the DB's JSON engine_config
DB_IVF = dict(n_clusters=N_CLUSTERS, kmeans_iters=8, q_cap_factor=2, build_threshold=1024,
              rescore=False, recall_target=RECALL_TARGET)
#: phase 9b: the persistence round trip's rows (cut from 1M: every insert
#: is journaled as a JSON record; PERF.md section 4) and insert batch
PERSIST_ROWS, PERSIST_BATCH = 65536, 8192


def phase_db(torch, dev, vecs, qdev, oracle_q, oracle_kth_, *, n_req=2048,
             n_k100=512) -> dict:
    """Phase 9a: the database at its defaults on the card (module
    docstring). Returns the f32 slice's records; raises on a failed gate."""
    from quiver_tpu_torch import DB, DBOptions
    from quiver_tpu_torch.benches.common import recall_at_k
    from quiver_tpu_torch.index.exact import ExactIndex
    from quiver_tpu_torch.observability.collector import Collector
    from quiver_tpu_torch.types import SearchRequest

    n = len(vecs)
    db = DB(DBOptions(enable_persistence=False, device=str(dev)))
    log(f"db options: default_engine={db.options.default_engine} "
        f"compute_dtype={db.options.compute_dtype} device={db.device}")
    coll = db.create_collection("docs", vecs.shape[1], "euclidean", engine_config={"ivf": DB_IVF})
    t0 = time.perf_counter()
    db.batch_insert("docs", [f"v{i}" for i in range(n)], vecs)
    torch.cuda.synchronize()
    hybrid = coll.engine
    ivf = hybrid.ann
    log(f"db batch_insert: n={coll.size} wall_s={time.perf_counter() - t0!r} "
        f"engine={hybrid.name}/{ivf.name} blocks={ivf._blocks_t.dtype} "
        f"build_s={ivf._last_rebuild_s!r} n_probe={ivf.config.n_probe} "
        f"tuned_recall={ivf._tuned_recall!r} K'={ivf.n_clusters}")
    if hybrid.name != "hybrid" or ivf.name != "ivf" or ivf._blocks_t.dtype != torch.float32:
        raise AssertionError("the DB's default collection is not hybrid over f32 IVF")

    queries, _ = make_queries(vecs, n_req, n_req)
    exact = ExactIndex(coll.store)
    for k, b in ((TOP_K, n_req), (100, n_k100)):
        reqs = [SearchRequest(vector=q, top_k=k) for q in queries[:b]]
        db.batch_search("docs", reqs[:8])  # first use
        before = dict(hybrid.stats()["per_strategy_queries"])
        t0 = time.perf_counter()
        resps = db.batch_search("docs", reqs)
        ms = (time.perf_counter() - t0) * 1e3
        after = hybrid.stats()["per_strategy_queries"]
        split = {s: after.get(s, 0) - before.get(s, 0) for s in after}
        got = np.full((b, k), -1, np.int64)
        for i, r in enumerate(resps):
            for j, it in enumerate(r.results):
                got[i, j] = coll.store.slot_of(it.id)
        _, truth = exact.search_slots(queries[:b], k)
        if k == TOP_K:
            truth10 = truth
        r = recall_at_k(got, truth, k)
        log(f"db batch_search k={k}: B={b} ms_per_call={ms!r} recall@{k}={r!r} "
            f"(exact f32 oracle) strategies={split} filled={int((got >= 0).sum())}/{b * k}")
        if k == TOP_K and r < RECALL_GATE:
            raise AssertionError(f"db recall@10 {r} < {RECALL_GATE}")
        if (got < 0).any():
            raise AssertionError(f"db k={k}: empty result slots on a full corpus")
    r = Collector().measure_recall(coll, k=TOP_K, sample=256)
    log(f"db collector measure_recall: recall@{TOP_K}={r!r} (256 stored rows, exact oracle)")
    if r < RECALL_GATE:
        raise AssertionError(f"collector recall {r} < {RECALL_GATE}")

    # the f32 slice at full width: the hybrid's IVF side at its tuned n_probe
    tuned, recs = ivf.config.n_probe, {}
    for form in ("pairs", "fused"):
        ivf.config.formulation = form
        _, slots = ivf.search_slots(oracle_q, TOP_K)
        r = recall_with_ties(slots, oracle_q, vecs, oracle_kth_, TOP_K)
        ivf.search_slots_device(qdev, TOP_K)  # a held call (LiveCheck)
        recs[form] = {"recall": r}
        log(f"db f32 slice {form} n_probe={tuned}: recall@{TOP_K} {r!r} (f64 oracle)")
        if r < RECALL_GATE:
            raise AssertionError(f"f32 slice {form} recall@10 {r} < {RECALL_GATE}")
    ivf.config.formulation = "pairs"
    recs["device_bytes"] = ivf.device_bytes()
    truth_ids = [[coll.store.id_of(int(s)) for s in row] for row in truth10]
    return {"db": db, "ivf": ivf, "records": recs, "queries": queries[:n_req],
            "truth_ids": truth_ids}


def time_f32_slice(torch, ivf, qdev, recs, *, reps=10):
    """ms per B=65536 batch of the f32 slice, both formulations (outside
    LiveCheck: these calls repeat the held ones' operands)."""
    for form in ("pairs", "fused"):
        ivf.config.formulation = form
        ms = cuda_ms(lambda: ivf.search_slots_device(qdev, TOP_K), reps)
        recs[form]["ms"] = ms
        log(f"db f32 slice search_slots_device {form} n_probe={ivf.config.n_probe} "
            f"B={qdev.shape[0]}: ms_per_batch={ms!r} qps={qdev.shape[0] / (ms / 1e3)!r}")
    ivf.config.formulation = "pairs"
    log(f"db f32 slice memory: device_bytes={recs['device_bytes']}")


def phase_persistence(torch, dev, vecs, *, n=PERSIST_ROWS, batch=PERSIST_BATCH,
                      n_q=256, n_crash=1024):
    """Phase 9b: the DB's persistence round trip at ``n`` rows of the
    corpus (module docstring); gates raise. Returns the storage directory,
    closed and holding ``n`` rows."""
    import gc
    import importlib
    import importlib.util
    import os
    import shutil
    from pathlib import Path

    from quiver_tpu_torch import DB, DBOptions
    from quiver_tpu_torch.benches.common import recall_at_k
    from quiver_tpu_torch.benches.streaming import stream_rows
    from quiver_tpu_torch.index.exact import ExactIndex
    from quiver_tpu_torch.types import SearchRequest

    root = Path(__file__).resolve().parent / "quiver_tpu_torch" / "_build" / "chip_smoke_db"
    shutil.rmtree(root, ignore_errors=True)
    opts = dict(storage_path=str(root), flush_interval_s=0, device=str(dev))
    rows = vecs[:n]
    ids = [f"v{i}" for i in range(n)]
    queries, _ = make_queries(rows, n_q, n_q)
    cdir = root / "docs"

    def reopen(what):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        db = DB(DBOptions(**opts))
        coll = db.get_collection("docs")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"persist {what}: load_s={secs!r} size={coll.size} "
            f"ivf_built={coll.engine.ann._built} blocks={coll.engine.ann._blocks_t.dtype}")
        return db, coll, secs

    def answers(db, coll, qs, k=TOP_K):
        resps = db.batch_search("docs", [SearchRequest(vector=q, top_k=k) for q in qs])
        return [[it.id for it in r.results] for r in resps]

    def recall(coll, got_ids):
        got = np.asarray([[coll.store.slot_of(i) for i in row] for row in got_ids])
        _, truth = ExactIndex(coll.store).search_slots(queries, TOP_K)
        return recall_at_k(got, truth, TOP_K)

    # the snapshot is Parquet where pyarrow is installed and JSON where it is
    # not (the reference's fallback); its first import is timed apart
    has_pyarrow = importlib.util.find_spec("pyarrow") is not None
    if has_pyarrow:
        t0 = time.perf_counter()
        importlib.import_module("pyarrow.parquet")
        log(f"persist: pyarrow imported in {time.perf_counter() - t0!r} s")
    else:
        log("persist: pyarrow is not installed; the snapshot will be JSON")
    db = DB(DBOptions(**opts))
    coll = db.create_collection("docs", rows.shape[1], "euclidean", engine_config={"ivf": DB_IVF})
    t0 = time.perf_counter()
    for at in range(0, n, batch):
        db.batch_insert("docs", ids[at:at + batch], rows[at:at + batch])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    wal = db.persistence.wal("docs")
    log(f"persist ingest: {n} rows in {n // batch} batch_insert calls of {batch}: "
        f"wall_s={secs!r} rows_per_s={n / secs!r} wal={type(wal).__name__}")
    # the WAL record's host cost: one JSON record per row, encoded at insert
    # and parsed at replay (the reference's format)
    t0 = time.perf_counter()
    recs = [wal._entry_bytes("add", i, v, None) for i, v in zip(ids[:batch], rows[:batch])]
    enc_us = (time.perf_counter() - t0) / batch * 1e6
    t0 = time.perf_counter()
    for r in recs:
        json.loads(r)
    log(f"persist wal record: {len(recs[0])} bytes per {rows.shape[1]}-d row, encode_us="
        f"{enc_us!r} parse_us={(time.perf_counter() - t0) / batch * 1e6!r} per row "
        f"({batch} rows; the ingest's {n} rows encode in ~{enc_us * n / 1e6!r} s)")
    coll.engine.ann.wait_maintenance(timeout=300)
    before = answers(db, coll, queries)
    t0 = time.perf_counter()
    db.close()
    flush_s = time.perf_counter() - t0
    fmt = "parquet" if (cdir / "vectors.parquet").exists() else "json"
    log(f"persist close: flush_s={flush_s!r} snapshot={fmt} files={sorted(os.listdir(cdir))}")
    if fmt != ("parquet" if has_pyarrow else "json"):
        raise AssertionError(f"snapshot {fmt} with pyarrow {'present' if has_pyarrow else 'absent'}")
    del db, coll

    db, coll, sidecar_s = reopen("reopen through topology.npz")
    after = answers(db, coll, queries)
    r = recall(coll, after)
    same = float(np.mean([a == b for a, b in zip(after, before)]))
    log(f"persist reload: recall@{TOP_K}={r!r} identical_top10_share={same!r} (n={n_q})")
    if r < RECALL_GATE:
        raise AssertionError(f"recall@10 after reload {r} < {RECALL_GATE}")

    # crash path: flush, then WAL-only deletes and adds, dropped unclosed
    db.persistence.flush_collection(coll)
    gone = ids[:n_crash]
    added = stream_rows(n_crash, seed=17)
    add_ids = [f"w{i}" for i in range(n_crash)]
    if db.batch_delete("docs", gone) != n_crash:
        raise AssertionError("batch_delete did not remove every row")
    db.batch_insert("docs", add_ids, added)
    del db, coll  # no close(): the WAL carries the delta
    db, coll, _ = reopen("reopen after a crash")
    seen = {i for row in answers(db, coll, rows[:n_crash]) for i in row}
    top1 = [row[:1] == [vid] for row, vid in zip(answers(db, coll, added, k=1), add_ids)]
    log(f"persist crash path: size={coll.size} deleted ids returned={len(seen & set(gone))} "
        f"added rows found as their own top-1={int(sum(top1))}/{n_crash}")
    if coll.size != n or seen & set(gone) or not all(top1):
        raise AssertionError("the crash path lost a write or resurrected a delete")
    db.close()
    del db, coll

    os.remove(cdir / "topology.npz")
    db, coll, cold_s = reopen("reopen without topology.npz (cold build)")
    r = recall(coll, answers(db, coll, queries))
    log(f"persist cold load: load_s={cold_s!r} against sidecar load_s={sidecar_s!r}; "
        f"recall@{TOP_K}={r!r}")
    db.close()
    del db, coll
    return root  # phase 10b serves this directory, then removes it


#: phase 10a: the server's load (module docstring)
SERVER_SEARCHES, SERVER_CLIENTS, SERVER_ADDS, SERVER_EDITS, SHED_BURST = 2048, 64, 8192, 256, 512


def http(port, method, path, body=None, timeout=300):
    """(status, headers, body: decoded JSON, else its text) of one request
    on a fresh loopback connection (stdlib ``http.client``)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        ctype = r.getheader("Content-Type", "")
        return (r.status, dict(r.getheaders()),
                json.loads(raw) if ctype.startswith("application/json") else raw.decode())
    finally:
        conn.close()


class ServerThread:
    """A port ``Server`` on its own event-loop thread (as tests/test_api.py
    runs one); ``stop`` closes its listeners, or the DB too."""

    def __init__(self, db, **cfg):
        import asyncio
        import threading

        from quiver_tpu_torch.api.server import Server, ServerConfig
        from quiver_tpu_torch.benches.bench_api import free_port

        self.server = Server(db, ServerConfig(host="127.0.0.1", port=free_port(), **cfg))
        self.port = self.server.config.port
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self._call(self.server.start_async())

    def _call(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=600)

    def stop(self, *, close_db=False):
        self._call(self.server.stop_async() if close_db else self.server.stop_listeners())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=60)
        self.loop.close()


def _fan_out(fn, items, workers):
    """[fn(item)] over a pool of ``workers`` client threads, in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


def phase_server(torch, db, queries, truth_ids, *, n_search=SERVER_SEARCHES,
                 clients=SERVER_CLIENTS, n_add=SERVER_ADDS, n_edit=SERVER_EDITS,
                 burst=SHED_BURST, seed=23):
    """Phase 10a: the port's REST server over phase 9a's database (module
    docstring); gates raise."""
    import threading

    from quiver_tpu_torch.benches.bench_api import free_port
    from quiver_tpu_torch.benches.streaming import stream_rows

    coll = db.get_collection("docs")
    path = "/api/v1/collections/docs"
    st = ServerThread(db, coalesce_window_ms=2.0, coalesce_max_batch=256, search_backlog=1024,
                      enable_metrics_server=True, metrics_port=free_port())
    try:
        def search(q, k=TOP_K):
            t0 = time.perf_counter()
            status, _, body = http(st.port, "POST", f"{path}/search",
                                   {"vector": q.tolist(), "top_k": k})
            ms = (time.perf_counter() - t0) * 1e3
            if status != 200:
                raise AssertionError(f"search answered {status}: {body}")
            return [it["id"] for it in body["results"]], ms

        def recall(got_ids, want_ids):
            return float(np.mean([len(set(g) & set(w)) / TOP_K
                                  for g, w in zip(got_ids, want_ids, strict=True)]))

        qs = [queries[i % len(queries)] for i in range(n_search)]
        want = [truth_ids[i % len(queries)] for i in range(n_search)]
        _fan_out(search, qs[:clients], clients)  # first use of the batch shapes
        co = st.server._coalescer
        d0, r0 = co.dispatches, co.dispatched
        t0 = time.perf_counter()
        out = _fan_out(search, qs, clients)
        wall = time.perf_counter() - t0
        p50, p95, p99 = np.percentile([ms for _, ms in out], (50, 95, 99)).tolist()
        r = recall([ids for ids, _ in out], want)
        log(f"server search: {n_search} single POSTs from {clients} clients: "
            f"qps={n_search / wall!r} p50_ms={p50!r} p95_ms={p95!r} p99_ms={p99!r} "
            f"dispatches={co.dispatches - d0} "
            f"mean_batch={(co.dispatched - r0) / max(1, co.dispatches - d0)!r} "
            f"recall@{TOP_K}={r!r} (exact f32 oracle)")
        if r < RECALL_GATE:
            raise AssertionError(f"server recall@10 {r} < {RECALL_GATE}")

        b = min(256, len(queries))
        t0 = time.perf_counter()
        status, _, body = http(st.port, "POST", f"{path}/search/batch", {
            "requests": [{"vector": q.tolist(), "top_k": TOP_K} for q in queries[:b]]})
        ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise AssertionError(f"search/batch answered {status}")
        r = recall([[it["id"] for it in x["results"]] for x in body["responses"]],
                   truth_ids[:b])
        log(f"server search/batch: {b} requests in one POST: ms={ms!r} recall@{TOP_K}={r!r}")
        if r < RECALL_GATE:
            raise AssertionError(f"server batch recall@10 {r} < {RECALL_GATE}")

        # writes through REST: add, then update and delete rows of the corpus
        added = stream_rows(n_add, seed=seed)
        add_ids = [f"s{i}" for i in range(n_add)]
        t0 = time.perf_counter()
        status, _, body = http(st.port, "POST", f"{path}/vectors/batch", {"vectors": [
            {"id": vid, "vector": v.tolist()} for vid, v in zip(add_ids, added)]})
        add_s = time.perf_counter() - t0
        if status != 201 or body["inserted"] != n_add:
            raise AssertionError(f"vectors/batch answered {status}: {body}")
        probe = np.random.default_rng(seed).choice(n_add, min(n_edit, n_add), replace=False)
        top1 = _fan_out(lambda i: search(added[i])[0][:1] == [add_ids[i]], probe, clients)
        log(f"server vectors/batch: {n_add} rows acknowledged in {add_s!r} s; "
            f"own top-1 {int(sum(top1))}/{len(probe)}; size={coll.size}")
        if np.mean(top1) < 0.95:
            raise AssertionError("added rows not found as their own top-1")

        rng = np.random.default_rng(seed + 1)
        picked = rng.choice(coll.size - n_add, 2 * n_edit, replace=False)
        upd_ids = [f"v{i}" for i in picked[:n_edit]]
        del_ids = [f"v{i}" for i in picked[n_edit:]]
        del_vecs = np.stack([coll.store.get(v).values for v in del_ids])
        new = stream_rows(n_edit, seed=seed + 2)
        codes = _fan_out(lambda a: http(st.port, "PUT", f"{path}/vectors/{a[0]}",
                                        {"vector": a[1].tolist()})[0],
                         list(zip(upd_ids, new)), clients)
        got = _fan_out(lambda v: http(st.port, "GET", f"{path}/vectors/{v}")[2]["vector"],
                       upd_ids, clients)
        same = np.asarray(got, np.float32) == new
        log(f"server PUT: {n_edit} updates answered {sorted(set(codes))}; GET returns the "
            f"new vector for {int(same.all(1).sum())}/{n_edit}")
        if set(codes) != {200} or not same.all():
            raise AssertionError("an updated vector was not read back")
        status, _, body = http(st.port, "POST", f"{path}/vectors/batch/delete", {"ids": del_ids})
        if status != 200 or body["deleted"] != n_edit:
            raise AssertionError(f"batch delete answered {status}: {body}")
        seen = {v for ids, _ in _fan_out(search, list(del_vecs), clients) for v in ids}
        log(f"server batch delete: {n_edit} rows; deleted ids returned by searches at their "
            f"vectors: {len(seen & set(del_ids))}")
        if seen & set(del_ids):
            raise AssertionError("a deleted id was returned")

        status, _, body = http(st.port, "GET", "/api/v1/metrics")
        prom = http(st.server.config.metrics_port, "GET", "/metrics")
        log(f"server metrics: /api/v1/metrics {status} (qps={body.get('qps')!r}), "
            f"/metrics {prom[0]}")
        if status != 200 or prom[0] != 200:
            raise AssertionError("a metrics endpoint did not answer 200")
    finally:
        st.stop()

    # load shed: a second server on the same DB with a small backlog, a burst
    shed_st = ServerThread(db, coalesce_window_ms=2.0, search_backlog=64,
                           enable_metrics_server=False)
    try:
        gate = threading.Barrier(burst)

        def burst_one(q):
            gate.wait(timeout=300)
            return http(shed_st.port, "POST", f"{path}/search",
                        {"vector": q.tolist(), "top_k": TOP_K})

        res = _fan_out(burst_one, [queries[i % len(queries)] for i in range(burst)], burst)
    finally:
        shed_st.stop()
    codes = [c for c, _, _ in res]
    retry = [h.get("Retry-After") for c, h, _ in res if c == 429]
    log(f"server load shed (backlog 64): {burst} concurrent searches: {codes.count(200)} x 200, "
        f"{codes.count(429)} x 429 (shed rate {codes.count(429) / burst!r}), "
        f"Retry-After {sorted(set(retry))}")
    if not retry or not all(r is not None and r.isdigit() and int(r) >= 1 for r in retry):
        raise AssertionError("no 429 with an integer Retry-After >= 1 in the burst")
    if set(codes) - {200, 429}:
        raise AssertionError(f"an admitted search failed: {sorted(set(codes))}")


def compute_apps():
    """[(pid, MiB)] of the card's compute processes, as ``nvidia-smi`` lists
    them."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return [tuple(int(x) for x in line.split(",")) for line in out.splitlines() if line.strip()]


def phase_cli(root, *, n_rows=PERSIST_ROWS, n_add=1024, env=None, shutdown_s=10.0):
    """Phase 10b: ``python -m quiver_tpu_torch.cli`` as its own processes
    over phase 9b's directory ``root`` (module docstring); gates raise."""
    import os
    import shutil
    import signal
    import subprocess
    from pathlib import Path

    from quiver_tpu_torch.benches.bench_api import free_port
    from quiver_tpu_torch.benches.streaming import stream_rows

    repo = Path(__file__).resolve().parent
    env = dict(os.environ if env is None else env, PYTHONPATH=str(repo))

    def cli(data, *args, timeout=600):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "quiver_tpu_torch.cli", "--log-level", "error",
                            "--data-dir", str(data), *args], cwd=repo, env=env,
                           capture_output=True, text=True, timeout=timeout)
        if p.returncode != 0:
            raise AssertionError(f"cli {args} exited {p.returncode}: {p.stderr[-2000:]}")
        return p.stdout, time.perf_counter() - t0

    def rows(data):
        out, secs = cli(data, "info")
        colls = json.loads(out)["collections"]
        return {k: v["vectors"] for k, v in colls.items()}, secs

    before, secs = rows(root)
    log(f"cli info: {before} in {secs!r} s")
    if before != {"docs": n_rows}:
        raise AssertionError(f"cli info counted {before}, want {n_rows}")

    port, mport = free_port(), free_port()
    apps_before = compute_apps()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "quiver_tpu_torch.cli", "--data-dir", str(root),
                             "serve", "--host", "127.0.0.1", "--port", str(port),
                             "--metrics-port", str(mport)], cwd=repo, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode}: {proc.stderr.read()[-2000:]}")
            try:
                if http(port, "GET", "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 300:
                raise AssertionError("serve did not answer /health in 300 s")
            time.sleep(0.2)
        up_s = time.perf_counter() - t0
        apps = compute_apps()
        grew = sum(m for _, m in apps) - sum(m for _, m in apps_before)
        log(f"cli serve: /health after {up_s!r} s; compute apps before {apps_before}, "
            f"serving {apps} (serve pid {proc.pid}; +{grew} MiB)")
        # a container's PID namespace can hide the pid: then the card's
        # memory held by compute processes must have grown by the child's
        if proc.pid not in [p for p, _ in apps] and grew < 256:
            raise AssertionError("the serve process holds no card memory")

        path = "/api/v1/collections/docs"
        qs = stream_rows(8, seed=31)
        for q in qs:
            status, _, body = http(port, "POST", f"{path}/search",
                                   {"vector": q.tolist(), "top_k": TOP_K})
            if status != 200 or len(body["results"]) != TOP_K:
                raise AssertionError(f"serve search answered {status}")
        new = stream_rows(n_add, seed=37)
        status, _, body = http(port, "POST", f"{path}/vectors/batch", {"vectors": [
            {"id": f"c{i}", "vector": v.tolist()} for i, v in enumerate(new)]})
        if status != 201 or body["inserted"] != n_add:
            raise AssertionError(f"serve vectors/batch answered {status}: {body}")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=shutdown_s + 300)
        stop_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stopped = [json.loads(line) for line in err.splitlines()
               if line.startswith("{") and '"server stopped"' in line]
    close_s = stopped[-1].get("close_s") if stopped else None
    log(f"cli serve: SIGTERM -> exit {proc.returncode} in {stop_s!r} s "
        f"(the flush: close_s={close_s!r})")
    if proc.returncode != 0 or not stopped:
        raise AssertionError(f"serve exited {proc.returncode} after SIGTERM: {err[-2000:]}")
    if stop_s > shutdown_s + 120:
        raise AssertionError(f"serve took {stop_s} s to stop")

    after, _ = rows(root)
    log(f"cli info after the restart: {after}")
    if after != {"docs": n_rows + n_add}:
        raise AssertionError(f"acknowledged rows lost: {after}, want {n_rows + n_add}")
    bak, fresh = root.parent / "chip_smoke_bak", root.parent / "chip_smoke_restored"
    shutil.rmtree(bak, ignore_errors=True)
    shutil.rmtree(fresh, ignore_errors=True)
    _, b_s = cli(root, "backup", str(bak))
    _, r_s = cli(fresh, "restore", str(bak))
    restored, _ = rows(fresh)
    log(f"cli backup {b_s!r} s, restore into a fresh directory {r_s!r} s: info {restored}")
    if restored != after:
        raise AssertionError(f"restore gave {restored}, want {after}")
    for d in (root, bak, fresh):
        shutil.rmtree(d, ignore_errors=True)


#: phase 11: the HNSW engine at bench_hnsw's build (M=16, m0=32, efC=200,
#: bf16 construction products, build_batch 8192) over the shared corpus
HNSW_ROWS = N
HNSW_EFS = (50, 100, 200, 400)
HNSW_BATCHES = (128, 2048, 65536)
HNSW_PARITY_QUERIES = 256
#: the gates: tie-aware recall@10 at ef=400, and the relative distance
#: within which two ids at one rank count as a tie swap
HNSW_RECALL_FLOOR, HNSW_TIE_REL = 0.90, 1e-5


def ids_agree(got_ids, got_dist, ref_ids, ref_dist, rel=HNSW_TIE_REL) -> int:
    """Positions where two sorted answers hold different ids at distances
    more than ``rel`` apart (relative to the reference's): 0 means equal
    up to swaps of tied entries."""
    got_ids, ref_ids = np.asarray(got_ids), np.asarray(ref_ids)
    got_dist = np.asarray(got_dist, np.float64)
    ref_dist = np.asarray(ref_dist, np.float64)
    tie = np.abs(got_dist - ref_dist) <= rel * np.abs(ref_dist) + 1e-30
    return int(((got_ids != ref_ids) & ~tie).sum())


def hnsw_invariants(torch, idx) -> list:
    """Each layer's graph checked on the device: a row's fill is its count
    of non-negative ids; no self edge; no id twice in a row; every id a
    live slot. Returns [(level, rows, edges)]; raises on a violation."""
    view = idx.store.device_view()
    out = []
    for level, layer in enumerate([idx.layer0] + idx.layers):
        n = len(layer.nodes)
        adj, _ = layer.device(idx.store.capacity)
        adj = adj[:n].long()
        fill = layer.device_fill()[:n].long()
        nodes = torch.from_numpy(layer.nodes.astype(np.int64)).to(adj.device)
        live = adj >= 0
        srt = torch.sort(torch.where(live, adj, -1 - torch.arange(
            adj.shape[1], device=adj.device)), dim=1).values
        bad = {
            "fill": int((fill != live.sum(1)).sum()),
            "self": int((adj == nodes[:, None]).sum()),
            "repeat": int((srt[:, 1:] == srt[:, :-1]).sum()),
            "dead": int((live & ~view.valid[adj.clamp_min(0)]).sum()),
        }
        if any(bad.values()):
            raise AssertionError(f"hnsw layer {level}: graph invariants broken {bad}")
        out.append((level, n, int(live.sum())))
    return out


def hnsw_programs(torch, idx, qd, *, ef=100, reps=3) -> dict:
    """Card ms (CUDA events) and kernel launches of one call of each HNSW
    program at phase 11's shapes: the layer-0 beam at ef=100 and the
    greedy descent of level 1 (the largest upper layer) at ``qd``'s batch; the selection
    and the level-0 connect at the build's (the last ``build_batch``
    inserted rows as a batch that selects its current rows again; the
    connect returns new tensors and leaves the graph as it is)."""
    from quiver_tpu_torch.benches.common import launch_trace
    from quiver_tpu_torch.index.hnsw import _pow2
    from quiver_tpu_torch.ops import hnsw_kernels as hk
    from quiver_tpu_torch.ops.scan import flat_scan_topk

    view = idx.store.device_view()
    layers, adj0, pos0 = idx._device_graph()
    metric = idx._metric()
    entries = torch.full((qd.shape[0],), idx.entry_point, dtype=torch.int64, device=qd.device)
    bb = idx.config.build_batch
    slots = torch.from_numpy(idx.layer0.nodes[-bb:].astype(np.int64)).to(qd.device)
    rows = pos0[slots]
    q_b = view.vectors[slots]
    deg = adj0.shape[1]
    kc = min(max(idx.config.ef_construction, deg), _pow2(3 * deg, lo=32))
    cand_d, cand_i = flat_scan_topk(q_b, view.vectors, view.valid, None, view.norms_sq,
                                    view.inv_norms, metric=metric, k=kc + 1,
                                    compute_dtype=idx.compute_dtype)
    calls = {
        "beam_search": lambda: hk.beam_search(
            qd, entries, view.vectors, view.valid, adj0, pos0, metric=metric, ef=ef,
            max_iters=int(1.5 * ef) + 8),
        "greedy_descent": lambda: hk.greedy_descent(
            qd, entries, view.vectors, view.valid, *layers[-1], metric=metric),
        "select_neighbors": lambda: hk.select_neighbors(
            q_b, cand_i, cand_d, view.vectors, metric=metric, m=deg,
            compute_dtype=idx.compute_dtype),
        "connect_level": lambda: hk.connect_level(
            adj0, idx.layer0.device_fill(), pos0, view.vectors, slots,
            torch.ones_like(slots, dtype=torch.bool), adj0[rows].long(), metric=metric,
            u_budget=bb, e_budget=max(16, _pow2(idx.config.m0 // 2, lo=16)),
            compute_dtype=idx.compute_dtype),
    }
    out = {}
    for name, fn in calls.items():
        tr = launch_trace(fn)
        ms = cuda_ms(fn, reps)
        out[name] = {"ms": ms, "launches": tr["launches"], "kernel_ms": tr["kernel_ms"]}
        log(f"hnsw program {name}: ms_per_call={ms!r} launches={tr['launches']} "
            f"kernel_ms={tr['kernel_ms']!r} busy_share={tr['kernel_ms'] / ms!r}")
    return out


def phase_hnsw(torch, dev, vecs, *, n=HNSW_ROWS, n_q=2048, efs=HNSW_EFS,
               batches=HNSW_BATCHES, n_parity=HNSW_PARITY_QUERIES, reps=3, stream=None) -> dict:
    """Phase 11a-b: the HNSW engine's build and search on ``dev`` (module
    docstring); gates raise. Returns the measured numbers. ``stream``:
    (batches, rows per batch, queries per batch) of the HNSW streaming leg
    (:func:`phase_hnsw_streaming`), run on the built graph after the rest."""
    from quiver_tpu_torch.benches import bench_hnsw
    from quiver_tpu_torch.benches.common import launch_trace, oracle_topk
    from quiver_tpu_torch.convert import hnsw_from_topology
    from quiver_tpu_torch.core.store import VectorStore

    cuda = dev.type == "cuda"
    rows = vecs[:n]
    if n < len(vecs):
        log(f"hnsw cut: N={n} of the {len(vecs)}-row corpus (PERF.md section 4)")
    store, idx, build_s = bench_hnsw.build(dev, rows)
    m = idx.get_detailed_metrics()
    log(f"hnsw build: N={n} d={rows.shape[1]} M={idx.config.m} m0={idx.config.m0} "
        f"efC={idx.config.ef_construction} compute_dtype={idx.compute_dtype} "
        f"build_batch={idx.config.build_batch}: wall_s={build_s!r} inserts_per_s="
        f"{n / build_s!r} max_level={m['max_level']} layer_nodes={m['layer_nodes']} "
        f"reverse_edges_spilled={m['reverse_edges_spilled']} device_bytes={m['device_bytes']}")
    log(f"hnsw graph invariants hold: (level, rows, edges) {hnsw_invariants(torch, idx)}")
    queries, _ = make_queries(rows, n_q, n_q)
    truth, kth = oracle_topk(dev, queries, rows, TOP_K)
    out = {"build_s": build_s, "n": n, "spilled": m["reverse_edges_spilled"]}
    qd = torch.from_numpy(queries).to(dev)
    sweep = bench_hnsw.recall_rows(idx, rows, queries, truth, kth, efs=efs, reps=reps)
    sweep += bench_hnsw.recall_rows(idx, rows, queries, truth, kth, efs=(100,), reps=reps,
                                    visited="bitmap")
    for r in sweep:
        log(f"hnsw search ef={r['ef']} visited={r['visited']} B={n_q}: recall@10 "
            f"{r['recall_at_10']!r} tie-aware {r['recall_at_10_ties']!r} (f64 oracle) "
            f"ms_per_call={r['ms']!r} qps={r['qps']!r}")
    out["sweep"] = sweep
    first = [r["ef"] for r in sweep if r["visited"] == "ring" and r["recall_at_10_ties"] >= 0.95]
    log(f"hnsw finding: the first ef reaching tie-aware recall@10 0.95: "
        f"{first[0] if first else 'none of ' + str(efs)}")
    at400 = [r for r in sweep if r["ef"] == max(efs) and r["visited"] == "ring"][0]
    if at400["recall_at_10_ties"] < HNSW_RECALL_FLOOR:
        raise AssertionError(f"hnsw tie-aware recall@10 at ef={max(efs)} "
                             f"{at400['recall_at_10_ties']} < {HNSW_RECALL_FLOOR}")
    idx.set_optimization_parameters(ef_search=100, visited="ring")
    out["batches"] = bench_hnsw.batch_rows(idx, rows, batches=batches, ef=100, reps=reps)
    for r in out["batches"]:
        log(f"hnsw search_device ef=100 B={r['B']}: ms_per_batch={r['ms']!r} qps={r['qps']!r}")
    stats = {}
    idx.search_device(qd, 100, stats=stats)
    it = stats["iters"].cpu().numpy()
    out["iters"] = {"mean": float(it.mean()), "max": int(it.max()), "loops": stats["loops"],
                    "max_iters": int(1.5 * 100) + 8}
    log(f"hnsw beam iterations ef=100 B={n_q}: per query mean={float(it.mean())!r} max={int(it.max())} "
        f"loop={stats['loops']} of max_iters={out['iters']['max_iters']}")
    if cuda:
        tr = launch_trace(lambda: idx.search_device(qd, 100))
        wall = cuda_ms(lambda: idx.search_device(qd, 100), reps)
        tr.update(wall_ms=wall, busy_share=tr["kernel_ms"] / wall)
        out["trace"] = tr
        log(f"hnsw trace ef=100 B={n_q}: launches_per_search={tr['launches']} "
            f"kernel_ms={tr['kernel_ms']!r} wall_ms={wall!r} (traced {tr['traced_wall_ms']!r}) "
            f"busy_share={tr['busy_share']!r}")

        out["programs"] = hnsw_programs(torch, idx, qd, reps=reps)

    # the same graph on the CPU: the card's answer held to it
    t0 = time.perf_counter()
    cpu_store = VectorStore(dim=rows.shape[1], metric="euclidean", capacity=store.capacity,
                            device="cpu")
    cpu_store.add_batch([f"v{i}" for i in range(n)], rows)
    cpu = hnsw_from_topology(cpu_store, idx.export_topology(), build_batch=idx.config.build_batch)
    pq = queries[:n_parity]
    d_card, i_card = idx.search_slots(pq, TOP_K)
    d_cpu, i_cpu = cpu.search_slots(pq, TOP_K)
    bad = ids_agree(i_card, d_card, i_cpu, d_cpu)
    log(f"hnsw card vs cpu, same graph, ef=100, {n_parity} queries: ids equal "
        f"{float((i_card == i_cpu).mean())!r}, differing beyond a tie swap: {bad} "
        f"(cpu side {time.perf_counter() - t0!r} s)")
    if bad:
        raise AssertionError(f"hnsw: {bad} result slots differ between the card and the CPU")
    del cpu, cpu_store
    if stream is not None:
        out["stream"] = phase_hnsw_streaming(torch, dev, store, idx, rows, *stream)
    return out


#: the HNSW streaming leg on phase 11a's graph: the IVF leg's stream (8 x
#: 8,192 rows, B=256 queries); its gate on recall against the live exact
#: scan (a floor a graph that lost the grown store's rows cannot pass)
HNSW_STREAM = (8, 8192, 256)
HNSW_STREAM_RECALL_FLOOR = 0.90


def phase_hnsw_streaming(torch, dev, store, idx, rows, stream_batches, stream_batch, b) -> dict:
    """``benches/streaming.py::run_hnsw`` on a built graph over ``rows``:
    the stream grows the store under it (gate: it grew, and recall@10
    against the live exact scan >= HNSW_STREAM_RECALL_FLOOR)."""
    from quiver_tpu_torch.benches import streaming

    t0 = time.perf_counter()
    line, = streaming.run_hnsw(dev, stream_batches=stream_batches, stream_batch=stream_batch,
                               b=b, base=rows, graph=(store, idx))
    log(f"hnsw streaming leg: {stream_batches} x {stream_batch} rows into the {len(rows)}-row "
        f"graph, store capacity {line['store_capacity_before']} -> "
        f"{line['store_capacity_after']}: steady inserts/s {line['value']!r} (first batch "
        f"{line['first_batch_inserts_per_s']!r}), query qps {line['query_qps_during_stream']!r}, "
        f"recall@10 live {line['recall_at_10_live']!r} at ef={line['ef_search']}; wall "
        f"{time.perf_counter() - t0!r} s")
    if line["store_capacity_after"] <= line["store_capacity_before"]:
        raise AssertionError("hnsw streaming: the stream did not grow the store")
    if line["recall_at_10_live"] < HNSW_STREAM_RECALL_FLOOR:
        raise AssertionError(f"hnsw streaming recall_at_10_live {line['recall_at_10_live']} "
                             f"< {HNSW_STREAM_RECALL_FLOOR}")
    hnsw_invariants(torch, idx)
    return line


def phase_hnsw_stack(torch, dev, vecs, *, n=PERSIST_ROWS, batch=PERSIST_BATCH, n_q=256,
                     n_rest=4096, n_hybrid=None) -> dict:
    """Phase 11c: the HNSW engine through the database, the hybrid and the
    REST server (module docstring); gates raise."""
    import gc
    import os
    import shutil
    from pathlib import Path

    from quiver_tpu_torch import DB, DBOptions
    from quiver_tpu_torch.benches.bench_hybrid import D as HY_D
    from quiver_tpu_torch.benches.bench_hybrid import N_HYBRID
    from quiver_tpu_torch.benches.common import make_clustered_corpus, recall_at_k
    from quiver_tpu_torch.index.exact import ExactIndex
    from quiver_tpu_torch.index.hnsw import HNSWIndex
    from quiver_tpu_torch.types import SearchRequest

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    root = Path(__file__).resolve().parent / "quiver_tpu_torch" / "_build" / "chip_smoke_hnsw"
    shutil.rmtree(root, ignore_errors=True)
    opts = dict(storage_path=str(root), flush_interval_s=0, device=str(dev))
    cfg = {"hnsw": {"build_batch": batch}}
    rows, ids = vecs[:n], [f"v{i}" for i in range(n)]
    queries, _ = make_queries(rows, n_q, n_q)
    out = {}

    def answers(db, qs, k=TOP_K):
        resps = db.batch_search("graph", [SearchRequest(vector=q, top_k=k) for q in qs])
        return [[it.id for it in r.results] for r in resps]

    inserted = []
    on_insert = HNSWIndex.on_insert

    def counted(self, slots, vectors):
        inserted.append(len(slots))
        return on_insert(self, slots, vectors)

    def reopen(what):
        gc.collect()
        inserted.clear()
        HNSWIndex.on_insert = counted
        try:
            t0 = time.perf_counter()
            db = DB(DBOptions(**opts))
            coll = db.get_collection("graph")
            sync()
            secs = time.perf_counter() - t0
        finally:
            HNSWIndex.on_insert = on_insert
        log(f"hnsw db {what}: load_s={secs!r} size={coll.size} engine={coll.engine.name} "
            f"rows inserted by the load={sum(inserted)}")
        return db, coll, secs

    db = DB(DBOptions(**opts))
    coll = db.create_collection("graph", rows.shape[1], "euclidean", engine="hnsw",
                                engine_config=cfg)
    t0 = time.perf_counter()
    for at in range(0, n, batch):
        db.batch_insert("graph", ids[at:at + batch], rows[at:at + batch])
    sync()
    out["ingest_s"] = time.perf_counter() - t0
    _, truth = ExactIndex(coll.store).search_slots(queries, TOP_K)
    before = answers(db, queries)
    got = np.asarray([[coll.store.slot_of(i) for i in row] for row in before])
    r = recall_at_k(got, truth, TOP_K)
    log(f"hnsw db: engine={coll.engine.name} compute_dtype={coll.engine.compute_dtype} "
        f"{n} rows in {out['ingest_s']!r} s; recall@10 {r!r} (exact f32, {n_q} queries)")
    t0 = time.perf_counter()
    db.close()
    log(f"hnsw db close: flush_s={time.perf_counter() - t0!r} "
        f"files={sorted(os.listdir(root / 'graph'))}")
    if not (root / "graph" / "topology.npz").exists():
        raise AssertionError("hnsw db: the flush wrote no topology sidecar")
    del db, coll
    db, coll, out["sidecar_load_s"] = reopen("reopen through topology.npz")
    if sum(inserted) or coll.engine.entry_point < 0:
        raise AssertionError("hnsw db: the reload rebuilt the graph instead of importing it")
    after = answers(db, queries)
    same = float(np.mean([a == b for a, b in zip(after, before)]))
    log(f"hnsw db reload: identical top-10 lists {same!r} ({n_q} queries)")
    if same < 1.0:
        raise AssertionError(f"hnsw db: searches before and after the reload differ ({same})")
    db.close()
    del db, coll
    os.remove(root / "graph" / "topology.npz")
    db, coll, out["cold_load_s"] = reopen("reopen without topology.npz (cold build)")
    if sum(inserted) != n:
        raise AssertionError("hnsw db: the cold load did not rebuild the graph")
    log(f"hnsw db: sidecar load_s={out['sidecar_load_s']!r} against cold "
        f"rebuild load_s={out['cold_load_s']!r}")
    db.close()
    del db, coll
    shutil.rmtree(root, ignore_errors=True)

    # the hybrid with an hnsw block at bench_hybrid's shape: large batches
    # route to the graph
    n_hybrid = n_hybrid or N_HYBRID
    hv, hrng = make_clustered_corpus(n_hybrid, HY_D)
    hq = (hv[hrng.integers(0, n_hybrid, 128)] + 0.1 * hrng.normal(size=(128, HY_D))).astype(np.float32)
    db = DB(DBOptions(enable_persistence=False, device=str(dev)))
    coll = db.create_collection("hy", HY_D, "euclidean", engine="hybrid", engine_config=cfg)
    db.batch_insert("hy", [f"h{i}" for i in range(n_hybrid)], hv)
    eng = coll.engine
    db.batch_search("hy", [SearchRequest(vector=q, top_k=TOP_K) for q in hq])
    split = eng.stats()["per_strategy_queries"]
    _, s = eng.ann.search_slots(hq, TOP_K)
    _, truth = ExactIndex(coll.store).search_slots(hq, TOP_K)
    r = recall_at_k(s, truth, TOP_K)
    log(f"hnsw hybrid: N={n_hybrid} d={HY_D} ann={eng.ann_backend} split of {len(hq)} "
        f"queries={split} graph recall@10 {r!r} (exact f32)")
    if eng.ann_backend != "hnsw" or split.get("hnsw", 0) <= split.get("exact", 0):
        raise AssertionError(f"hnsw hybrid: large batches did not route to the graph {split}")
    out["hybrid"] = {"split": split, "recall": r}

    # one REST create, insert and search of an hnsw collection
    st = ServerThread(db, enable_metrics_server=False)
    try:
        codes = [http(st.port, "POST", "/api/v1/collections", {
            "name": "g", "dimension": rows.shape[1], "distance_function": "euclidean",
            "engine": "hnsw", "engine_config": cfg})[0]]
        codes.append(http(st.port, "POST", "/api/v1/collections/g/vectors/batch", {
            "vectors": [{"id": ids[i], "vector": rows[i].tolist()} for i in range(n_rest)]})[0])
        status, _, body = http(st.port, "POST", "/api/v1/collections/g/search",
                               {"vector": rows[7].tolist(), "top_k": TOP_K})
        codes.append(status)
        log(f"hnsw rest: create/insert/search -> {codes}, top hit {body['results'][0]['id']} "
            f"(engine {db.get_collection('g').engine.name})")
        if codes != [201, 201, 200] or body["results"][0]["id"] != ids[7]:
            raise AssertionError(f"hnsw rest: {codes}, {body}")
    finally:
        st.stop(close_db=True)
    return out


#: phase 12: the sharded engines, their shards placed together on the card
SHARDS = 4
#: phase 12b: the skewed batch (every query in shard 0's clusters)
SKEW_B = 2048


def add_counts(total: dict, counts: dict) -> dict:
    """``total`` plus the nonzero entries of ``counts``, key by key."""
    for key, n in counts.items():
        if n:
            total[key] = total.get(key, 0) + n
    return total


def max_by(total: dict, errs: dict) -> dict:
    """``total`` with each key's largest value of the two."""
    for key, e in errs.items():
        total[key] = max(total.get(key, 0.0), e)
    return total


def dtype_launches(ivf_cuda, *, f32: bool) -> int:
    """``block_topw`` launches counted since the last reset, every variant
    of the f32-block kernel (``f32``) or of the bf16 one."""
    return sum(v for k, v in ivf_cuda.launch_counts.items()
               if (isinstance(k, tuple) and k[0] == ivf_cuda.F32) == f32)


def shard_bytes(eng) -> list:
    """Card bytes each shard of a ``ShardedIVFIndex`` reads: its slice of
    the block arrays and its rows of the store's device view (the exact
    fallbacks' shards are views of the store, not copies)."""
    KL = eng._k_local
    out = []
    for s, rows in enumerate(eng._exact.shards()):
        sl = slice(s * KL, (s + 1) * KL)
        blocks = sum(t[sl].numel() * t.element_size() for t in (
            eng._blocks_t, eng._block_slot, eng._block_ns, eng._block_inv, eng._block_keep))
        out.append(blocks + sum(t.numel() * t.element_size() for t in rows))
    return out


def phase_sharded_ivf(torch, dev, vecs, oracle_q, oracle_kth_, *, reps=10) -> dict:
    """Phases 12a-c: the sharded IVF engine over the 1M corpus, 4 shards on
    ``dev`` (module docstring), its skew auto-raise, then the sharded exact
    scan against the single-card one; gates raise. Returns the measured
    numbers, the block_topw calls' largest error and their launches."""
    from quiver_tpu_torch import IVFConfig, VectorStore
    from quiver_tpu_torch.index.exact import ExactIndex
    from quiver_tpu_torch.ops import ivf_cuda
    from quiver_tpu_torch.ops.scan import flat_scan_topk
    from quiver_tpu_torch.parallel.sharded import merge_topk
    from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex, span_ms

    n, d = vecs.shape
    out = {}
    t0 = time.perf_counter()
    store = VectorStore(dim=d, metric="euclidean", capacity=n, device=dev)
    store.add_batch([f"v{i}" for i in range(n)], vecs)
    eng = ShardedIVFIndex(store, SHARDS, config=IVFConfig(
        n_clusters=N_CLUSTERS, n_probe=3, q_cap_factor=2, kmeans_iters=8,
        build_threshold=1024, rescore=False, recall_target=RECALL_TARGET))
    eng.build()
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    log(f"sharded ivf build: {SHARDS} shards on {dev}: wall_s={out['build_s']!r} "
        f"(store load included) K'={int(eng._cluster_live.sum())} Kg={len(eng._cluster_live)} "
        f"KL={eng._k_local} Cmax={eng._cmax} tuned n_probe={eng._tuned_n_probe} "
        f"holdout_recall={eng._tuned_recall!r}")
    _, qb = make_queries(vecs, B_SERVE, B_ORACLE)
    qdev = torch.from_numpy(qb).to(dev)
    ivf_cuda.reset_launch_counts()
    with LiveCheck() as live:
        dist, slots = eng.search_slots(oracle_q, TOP_K)
        r = recall_with_ties(slots, oracle_q, vecs, oracle_kth_, TOP_K)
        eng.search_slots_device(qdev, TOP_K)
    if dist.shape != (len(oracle_q), TOP_K) or not np.isfinite(dist).all() or (slots < 0).any():
        raise AssertionError("sharded ivf: bad result")
    log(f"sharded ivf recall@{TOP_K} (tie-aware, phase 4's f64 oracle, {len(oracle_q)} "
        f"queries) at n_probe={eng.config.n_probe}: {r!r}")
    if r < RECALL_GATE:
        raise AssertionError(f"sharded ivf recall@10 {r} < {RECALL_GATE}")
    out["recall"] = r
    live.verify(torch, "sharded ivf")
    out["err"] = dict(live.worst_by_variant)
    out["launches"] = add_counts({}, ivf_cuda.launch_counts)
    ivf_cuda.reset_launch_counts()
    eng.search_slots_device(qdev, TOP_K)
    torch.cuda.synchronize()
    per_batch = {str(k): v for k, v in ivf_cuda.launch_counts.items() if v}
    log(f"sharded ivf launches per B={B_SERVE} batch: {per_batch}")
    for b in (B_SERVE, 2048):
        q = qdev[:b]
        ms = cuda_ms(lambda: eng.search_slots_device(q, TOP_K), reps)
        stats = {}
        eng.search_slots_device(q, TOP_K, stats=stats)
        torch.cuda.synchronize()
        spans = span_ms(stats)
        shard_ms = [spans[f"shard{s}"] for s in range(SHARDS)]
        out[f"B{b}"] = {"ms": ms, "probe_ms": spans["probe"], "shard_ms": shard_ms,
                        "merge_ms": spans["merge"]}
        log(f"sharded ivf B={b} n_probe={eng.config.n_probe}: ms_per_batch={ms!r} "
            f"qps={b / (ms / 1e3)!r}; one batch by stage (CUDA events): probe "
            f"{spans['probe']!r} ms, per-shard candidates {shard_ms!r} ms, merge "
            f"{spans['merge']!r} ms ({spans['merge'] / sum(spans.values())!r} of the batch)")
    per_shard = shard_bytes(eng)
    log(f"sharded ivf memory: per shard {per_shard} bytes (blocks slice + store rows, "
        f"the rows shared with the exact fallbacks, no copy); "
        f"engine device_bytes={eng.device_bytes()} memory_allocated="
        f"{torch.cuda.memory_allocated(dev)} max_memory_allocated={torch.cuda.max_memory_allocated(dev)}")
    out["shard_bytes"] = per_shard

    # 12b: every query in shard 0's clusters
    kl = eng._k_local
    own0 = np.flatnonzero((eng._slot_pos[:, 0] >= 0) & (eng._slot_pos[:, 0] < kl))
    rng = np.random.default_rng(17)
    qs = (vecs[rng.choice(own0, size=SKEW_B)]
          + 0.05 * vecs.std(axis=0) * rng.normal(size=(SKEW_B, d))).astype(np.float32)
    kth_s = oracle_kth(dev, qs, vecs, TOP_K)
    factor0 = eng.local_pair_factor
    eng.local_pair_factor = float(SHARDS)  # the control: M >= B*P, nothing drops
    r_ctrl = recall_with_ties(eng.search_slots(qs, TOP_K)[1], qs, vecs, kth_s, TOP_K)
    eng._pending_load, eng.local_pair_factor = None, factor0
    ivf_cuda.reset_launch_counts()
    with LiveCheck() as live:
        r1 = recall_with_ties(eng.search_slots(qs, TOP_K)[1], qs, vecs, kth_s, TOP_K)
        r2 = recall_with_ties(eng.search_slots(qs, TOP_K)[1], qs, vecs, kth_s, TOP_K)
    live.verify(torch, "sharded ivf skew")
    max_by(out["err"], live.worst_by_variant)
    add_counts(out["launches"], ivf_cuda.launch_counts)
    log(f"sharded ivf skew: B={SKEW_B} all in shard 0 ({len(own0)} rows): recall@10 "
        f"{r1!r} at local_pair_factor={factor0}, then {r2!r} at the raised "
        f"{eng.local_pair_factor} (overflow_raises={eng._overflow_raises}); "
        f"no-drop control {r_ctrl!r}")
    if eng._overflow_raises < 1 or r2 < r_ctrl - 0.01:
        raise AssertionError(f"sharded ivf skew: raises={eng._overflow_raises} "
                             f"recall {r2} against the control {r_ctrl}")
    out["skew"] = {"before": r1, "after": r2, "control": r_ctrl}

    # 12c: the sharded exact scan (the engine's own fallback) against the
    # single-card one
    sh = eng._exact
    qx = qdev[:2048]
    d1, i1 = ExactIndex(store).search_slots(qb[:2048], TOP_K)
    d2, i2 = sh.search_slots(qb[:2048], TOP_K)
    bad = ids_agree(i2, d2, i1, d1)
    view = store.device_view()
    ms_one = cuda_ms(lambda: flat_scan_topk(qx, view.vectors, view.valid, None, view.norms_sq,
                                            view.inv_norms, metric="euclidean", k=TOP_K), 5)
    ms_sh = cuda_ms(lambda: sh.search_slots_device(qx, TOP_K), 5)
    parts = [flat_scan_topk(qx, *t[:2], None, *t[2:], metric="euclidean", k=TOP_K)
             for t in sh.shards()]
    ms_merge = cuda_ms(lambda: merge_topk([p[0] for p in parts], [p[1] for p in parts], TOP_K), 20)
    log(f"sharded exact: {SHARDS} shards, B=2048: ids equal to the single-card scan "
        f"{float((i1 == i2).mean())!r}, differing beyond a tie swap: {bad}; ms_per_batch "
        f"{ms_sh!r} against single-card {ms_one!r}; merge {ms_merge!r} ms "
        f"({ms_merge / ms_sh!r} of the sharded wall)")
    if bad:
        raise AssertionError(f"sharded exact: {bad} ids differ from the single-card scan")
    out["exact"] = {"ms": ms_sh, "single_ms": ms_one, "merge_ms": ms_merge}
    del eng, sh, store, view, parts
    return out


def phase_sharded_hnsw(torch, dev, vecs, *, n=PERSIST_ROWS, n_q=2048, efs=(100, 200),
                       n_parity=256, reps=3) -> dict:
    """Phase 12d: the sharded HNSW engine, 4 subgraphs on ``dev``, over the
    first 65,536 rows (cut as the persist cell); gates raise."""
    from quiver_tpu_torch.benches.common import launch_trace, oracle_topk
    from quiver_tpu_torch.core.store import VectorStore
    from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex

    rows = vecs[:n]
    store = VectorStore(dim=rows.shape[1], metric="euclidean", capacity=n, device=dev)
    slots = store.add_batch([f"v{i}" for i in range(n)], rows)
    g = ShardedHNSWIndex(store, SHARDS, m=16, m0=32, ef_construction=200, build_batch=8192,
                         compute_dtype=torch.float32)
    t0 = time.perf_counter()
    g.on_insert(slots, rows)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    log(f"sharded hnsw build: N={n} in {SHARDS} subgraphs (f32 construction, M=16, m0=32, "
        f"efC=200, build_batch 8192): wall_s={out['build_s']!r} sub sizes "
        f"{[s.size for s in g._sub_stores]} levels {[sub.current_max_level for sub in g._subs]}")
    queries, _ = make_queries(rows, n_q, n_q)
    _, kth = oracle_topk(dev, queries, rows, TOP_K)
    qd = torch.from_numpy(queries).to(dev)
    for ef in efs:
        g.set_optimization_parameters(ef_search=ef)
        _, s = g.search_slots(queries, TOP_K)
        r = recall_with_ties(s, queries, rows, kth, TOP_K)
        ms = cuda_ms(lambda: g.search_device(qd, ef, TOP_K), reps)
        tr = launch_trace(lambda: g.search_device(qd, ef, TOP_K))
        out[f"ef{ef}"] = {"recall": r, "ms": ms, "launches": tr["launches"]}
        log(f"sharded hnsw ef={ef} B={n_q}: recall@10 tie-aware {r!r} (f64 oracle) "
            f"ms_per_batch={ms!r} qps={n_q / (ms / 1e3)!r} launches_per_search={tr['launches']} "
            f"kernel_ms={tr['kernel_ms']!r} busy_share={tr['kernel_ms'] / tr['traced_wall_ms']!r}")
    if out["ef200"]["recall"] < 0.95:
        raise AssertionError(f"sharded hnsw recall@10 at ef=200 {out['ef200']['recall']} < 0.95")
    pq = qd[:n_parity]
    bd, bi = g.search_device(pq, 100, TOP_K, batched=True)
    pd, pi = g.search_device(pq, 100, TOP_K, batched=False)
    bad = ids_agree(bi.cpu().numpy(), bd.cpu().numpy(), pi.cpu().numpy(), pd.cpu().numpy())
    tr1 = launch_trace(lambda: g.search_device(pq, 100, TOP_K, batched=False))
    log(f"sharded hnsw batched vs per-shard calls, ef=100, {n_parity} queries: ids equal "
        f"{float((bi == pi).float().mean())!r}, differing beyond a tie swap: {bad}; "
        f"per-shard calls launch {tr1['launches']}")
    if bad:
        raise AssertionError(f"sharded hnsw: the batched search differs from per-shard calls ({bad})")
    return out


def phase_sharded_stack(torch, dev, vecs, *, n=PERSIST_ROWS, batch=PERSIST_BATCH, n_q=256,
                        n_rest=4096) -> dict:
    """Phase 12e: a ``sharded_hybrid`` DB (f32 blocks) over the persist
    cell's rows, flushed and reloaded through its sidecar, and a REST
    ``sharded_ivf`` collection; gates raise. Returns the f32 kernel's
    launches and the largest error of its calls."""
    import gc
    import shutil
    from pathlib import Path

    from quiver_tpu_torch import DB, DBOptions
    from quiver_tpu_torch.benches.common import recall_at_k
    from quiver_tpu_torch.index.exact import ExactIndex
    from quiver_tpu_torch.ops import ivf_cuda
    from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    from quiver_tpu_torch.types import SearchRequest

    root = Path(__file__).resolve().parent / "quiver_tpu_torch" / "_build" / "chip_smoke_sharded"
    shutil.rmtree(root, ignore_errors=True)
    opts = dict(storage_path=str(root), flush_interval_s=0, device=str(dev),
                default_engine="sharded_hybrid", engine_config={"mesh": SHARDS})
    rows, ids = vecs[:n], [f"v{i}" for i in range(n)]
    queries, _ = make_queries(rows, n_q, n_q)
    out = {}

    def answers(db):
        resps = db.batch_search("s", [SearchRequest(vector=q, top_k=TOP_K) for q in queries])
        return [[it.id for it in r.results] for r in resps]

    ivf_cuda.reset_launch_counts()
    with LiveCheck() as live:
        db = DB(DBOptions(**opts))
        coll = db.create_collection("s", rows.shape[1], "euclidean",
                                    engine_config={"ivf": DB_IVF})
        t0 = time.perf_counter()
        for at in range(0, n, batch):
            db.batch_insert("s", ids[at:at + batch], rows[at:at + batch])
        eng = coll.engine
        if not eng.ann.wait_maintenance(timeout=300):
            raise AssertionError("sharded db: background maintenance did not finish")
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        # IVF's sidecar holds the centroids and each row's cluster, not its
        # block position: a reload lays the rows out afresh, in slot order.
        # A refresh lays the served engine out the same way, so the reload
        # must then answer identically.
        eng.ann.refresh()
        before = answers(db)
        _, truth = ExactIndex(coll.store).search_slots(queries, TOP_K)
        _, ann = eng.ann.search_slots(queries, TOP_K)
    got = np.asarray([[coll.store.slot_of(i) for i in row] for row in before])
    r_db, r_ann = recall_at_k(got, truth, TOP_K), recall_at_k(ann, truth, TOP_K)
    n_probe = eng.ann.config.n_probe
    log(f"sharded db: engine={eng.name} ann={eng.ann.name} ({eng.ann.n_shards} shards, "
        f"{eng.ann.compute_dtype}, n_probe={eng.ann.config.n_probe}, K'={eng.ann.n_clusters}, "
        f"local_pair_factor={eng.ann.local_pair_factor}, "
        f"retrains={eng.ann._n_retrains}) exact={eng.exact.name}: {n} rows in "
        f"{t_ingest!r} s (background maintenance drained); recall@10 {r_db!r} through batch_search (split "
        f"{eng.stats()['per_strategy_queries']}), {r_ann!r} on the ann side (exact f32, "
        f"{n_q} queries)")
    if min(r_db, r_ann) < RECALL_GATE:
        raise AssertionError(f"sharded db recall@10 {r_db} / {r_ann} < {RECALL_GATE}")
    db.close()
    del db, coll, eng
    gc.collect()
    builds = []
    build = ShardedIVFIndex.build
    ShardedIVFIndex.build = lambda self, *a, **kw: (builds.append(1), build(self, *a, **kw))[1]
    try:
        with LiveCheck() as live2:
            t0 = time.perf_counter()
            db = DB(DBOptions(**opts))
            coll = db.get_collection("s")
            out["load_s"] = time.perf_counter() - t0
            after = answers(db)
            _, ann2 = coll.engine.ann.search_slots(queries, TOP_K)
    finally:
        ShardedIVFIndex.build = build
    same = float(np.mean([a == b for a, b in zip(after, before)]))
    n_probe2 = coll.engine.ann.config.n_probe
    log(f"sharded db reload through topology.npz: load_s={out['load_s']!r} builds={len(builds)} "
        f"n_probe {n_probe2} (tuned before: {n_probe}) local_pair_factor "
        f"{coll.engine.ann.local_pair_factor} identical top-10 lists {same!r}, "
        f"ann side {float((ann2 == ann).all(axis=1).mean())!r}")
    if builds or n_probe2 != n_probe or same < 1.0 or not (ann2 == ann).all():
        raise AssertionError(f"sharded db reload: builds={len(builds)} n_probe {n_probe2} "
                             f"against {n_probe} identical={same}")
    live.verify(torch, "sharded db")
    live2.verify(torch, "sharded db reload")
    out["err"] = max_by(dict(live.worst_by_variant), live2.worst_by_variant)
    out["launches"] = add_counts({}, ivf_cuda.launch_counts)
    if dtype_launches(ivf_cuda, f32=True) <= 0:
        raise AssertionError("block_topw_f32 was not launched by the sharded db")

    st = ServerThread(db, enable_metrics_server=False)
    try:
        codes = [http(st.port, "POST", "/api/v1/collections", {
            "name": "r", "dimension": rows.shape[1], "distance_function": "euclidean",
            "engine": "sharded_ivf"})[0]]
        codes.append(http(st.port, "POST", "/api/v1/collections/r/vectors/batch", {
            "vectors": [{"id": ids[i], "vector": rows[i].tolist()} for i in range(n_rest)]})[0])
        status, _, body = http(st.port, "POST", "/api/v1/collections/r/search",
                               {"vector": rows[7].tolist(), "top_k": TOP_K})
        codes.append(status)
        log(f"sharded rest: create/insert/search -> {codes}, top hit {body['results'][0]['id']} "
            f"(engine {db.get_collection('r').engine.name})")
        if codes != [201, 201, 200] or body["results"][0]["id"] != ids[7]:
            raise AssertionError(f"sharded rest: {codes}, {body}")
    finally:
        st.stop(close_db=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


#: phase 13a: the 10M cell's gate (the reference reached 0.978 at n_probe=3,
#: docs/BENCH_RESULTS.md:158-161) and its timed calls per batch size
TEN_M_RECALL_GATE = 0.95
TEN_M_REPS = 5
#: phase 13b: the hybrid's gate on every family, as the reference's; and
#: the reference's [ivf] recall per family (docs/BENCH_RESULTS.md:211-220)
MATRIX_GATE = 0.95
MATRIX_REFERENCE_IVF = {"clustered": 0.956, "anisotropic": 0.959, "heavy-tail": 0.846,
                        "near-dup": 0.991, "uniform": 0.512}
#: phase 13c: timed batches per seg_width of the roofline sweep
ROOFLINE_REPS = 10


def phase_roofline(torch, eng, qdev, *, reps=ROOFLINE_REPS, card_peaks_=None) -> dict:
    """Phase 13c: ``benches/bench_roofline.py``'s seg_width sweep over
    phase 4's engine at B=65536, n_probe=2 (pairs). One un-timed batch per
    seg_width is held against the plain version (:class:`LiveCheck`); the
    launch counts cover the sweep. Returns the rows, the largest error by
    variant and the launches. ``card_peaks_``: the card's by default."""
    from quiver_tpu_torch.benches import bench_roofline
    from quiver_tpu_torch.ops import ivf_cuda

    form0, probe0 = eng.config.formulation, eng.config.n_probe
    eng.config.formulation, eng.config.n_probe = "pairs", bench_roofline.N_PROBE
    ivf_cuda.reset_launch_counts()
    try:
        with LiveCheck() as live:
            for seg in bench_roofline.SEG_WIDTHS:
                eng.config.seg_width = seg
                eng.search_slots_device(qdev, TOP_K)
        eng.config.seg_width = 32
        rows = bench_roofline.ivf_rows(eng, qdev, card_peaks_ or card_peaks(torch), reps=reps)
    finally:
        eng.config.formulation, eng.config.n_probe, eng.config.seg_width = form0, probe0, 32
    launches = add_counts({}, ivf_cuda.launch_counts)
    for r in rows:
        log(f"roofline {r['metric']}: ms_per_batch={r['batch_ms']!r} qps={r['value']!r} "
            f"TFLOP/s={r['achieved_tflops']!r} ({r['pct_bf16_peak']!r}% of bf16 peak) "
            f"GB/s={r['achieved_gbs']!r} ({r['pct_hbm_bw']!r}% of HBM) K={r['K']} Cmax={r['Cmax']}")
    log(f"roofline launches: {launches}")
    live.verify(torch, "roofline")
    for W in (64, 128):  # the CPU takes the plain version and counts none
        if qdev.is_cuda and launches.get((W, 2), 0) <= 0:
            raise AssertionError(f"block_topw (W={W}, R=2) was not launched by the roofline sweep")
    return {"rows": rows, "err": dict(live.worst_by_variant), "launches": launches}


def phase_10m(torch, dev, *, reps=TEN_M_REPS) -> dict:
    """Phase 13a: ``benches/bench_10m.py`` at full width (10M x 128-d,
    K=4096, n_probe=3); every ``block_topw`` call outside its timed loops
    held against the plain version (:class:`LiveCheck`). Gates: recall@10
    >= TEN_M_RECALL_GATE, the imported layout answers as the built one.
    Returns the rows, the largest error by variant and the launches."""
    from quiver_tpu_torch.benches import bench_10m
    from quiver_tpu_torch.ops import ivf_cuda

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    ivf_cuda.reset_launch_counts()
    live = LiveCheck()
    rows = bench_10m.run(dev, reps=reps, check=live, emit_rows=False, log=log)
    launches = add_counts({}, ivf_cuda.launch_counts)
    build, imp, mem, *serve = rows
    log(f"10m cold build: {build['value']!r} s ({build['inserts_per_s']!r} inserts/s) "
        f"K'={build['n_clusters']} Cmax={build['cmax']}; import_topology layout "
        f"{imp['value']!r} s, beats the cold build: {imp['beats_cold_build']}, same answers: "
        f"{imp['same_answers']}")
    log(f"10m device memory: {mem['value']!r} GiB (engine {mem['engine_gib']}, store "
        f"{mem['store_gib']}), bytes/vector {mem['bytes_per_vector']}; "
        f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)}")
    for r in serve:
        log(f"10m {r['metric']}: qps={r['value']!r} ms_per_batch={r['batch_latency_ms']!r}")
    log(f"10m launches: {launches}; wall {time.perf_counter() - t0!r} s")
    err = live.verify(torch, "10m")
    recall = serve[0]["recall_at_10"]
    if recall < TEN_M_RECALL_GATE:
        raise AssertionError(f"10m recall@10 {recall} < {TEN_M_RECALL_GATE}")
    if not imp["same_answers"]:
        raise AssertionError("10m: the imported layout does not answer as the built one")
    return {"rows": rows, "err": dict(live.worst_by_variant), "launches": launches,
            "max_abs_err": err}


def phase_matrix(torch, dev) -> dict:
    """Phase 13b: ``benches/bench_corpus_matrix.py`` at N=250,000 on the
    five families, every ``block_topw`` call held against the plain
    version (:class:`LiveCheck`). Gate: ``[hybrid auto]`` recall@10 >=
    MATRIX_GATE on every family. Returns the rows, the largest error by
    variant and the launches."""
    from quiver_tpu_torch.benches import bench_corpus_matrix
    from quiver_tpu_torch.ops import ivf_cuda

    t0 = time.perf_counter()
    ivf_cuda.reset_launch_counts()
    with LiveCheck() as live:
        rows = bench_corpus_matrix.run(dev, emit_rows=False, log=log)
    launches = add_counts({}, ivf_cuda.launch_counts)
    by = {}
    for r in rows:
        fam, kind = r["metric"].split()[1], r["metric"].split("[")[1].split("]")[0]
        by.setdefault(fam, {})[kind] = r
    for fam, kinds in by.items():
        ivf, hyb, g = kinds["ivf"], kinds["hybrid auto"], kinds["hnsw"]
        log(f"matrix {fam}: [ivf] {ivf['value']!r} (reference {MATRIX_REFERENCE_IVF[fam]}) "
            f"tuned n_probe {ivf['tuned_n_probe']} holdout {ivf['tuner_holdout']} K' "
            f"{ivf['n_clusters']} recall_shortfall {ivf['recall_shortfall']}; [hybrid auto] "
            f"{hyb['value']!r} via {hyb['engine']}; [hnsw] {g['value']!r} at ef={g['ef']} "
            f"(build {g['build_s']!r} s)")
    log(f"matrix launches: {launches}; wall {time.perf_counter() - t0!r} s")
    live.verify(torch, "matrix")
    low = {fam: k["hybrid auto"]["value"] for fam, k in by.items()
           if k["hybrid auto"]["value"] < MATRIX_GATE}
    if low or len(by) != len(MATRIX_REFERENCE_IVF):
        raise AssertionError(f"matrix: [hybrid auto] below {MATRIX_GATE}: {low} "
                             f"(families run: {sorted(by)})")
    return {"rows": rows, "err": dict(live.worst_by_variant), "launches": launches}


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
    wide = phase_kernels(torch, dev, shape=WIDE_SHAPE, probes=(3,), reps=10)
    for variant, rec in wide.items():
        records[variant]["max_abs_err"] = max(records[variant]["max_abs_err"], rec["max_abs_err"])
    # f32 blocks at the DB's tuned n_probe (2) and the kernels line's (3)
    records_f32 = phase_kernels(torch, dev, shape=KERNEL_SHAPE, probes=(2, 3), reps=10,
                                dtype=torch.float32)
    wide = phase_kernels(torch, dev, shape=WIDE_SHAPE, probes=(3,), reps=3, dtype=torch.float32)
    for variant, rec in wide.items():
        records_f32[variant]["max_abs_err"] = max(records_f32[variant]["max_abs_err"],
                                                  rec["max_abs_err"])
    for dtype in (torch.bfloat16, torch.float32):
        for d in (KERNEL_SHAPE["d"], WIDE_SHAPE["d"]):
            phase_sums(torch, dev, d=d, dtype=dtype)

    # phase 4: the main path; launch counts cover exactly this phase
    t0 = time.perf_counter()
    vecs = clustered(N)
    log(f"corpus: {vecs.shape} in {time.perf_counter() - t0!r} s")
    torch.cuda.empty_cache()
    ivf_cuda.reset_launch_counts()
    eng, qdev, oracle_q, oracle_kth_ = phase_slice(torch, dev, vecs, b_serve=B_SERVE, reps=10)
    k100_err = phase_k100(torch, dev, eng, qdev.cpu().numpy(), vecs)
    records["row100"]["max_abs_err"] = max(records["row100"]["max_abs_err"], k100_err)
    counts = dict(ivf_cuda.launch_counts)
    log(f"slice launches: {counts}")

    # phase 5: the probes' path; counts cover its run, not the timing after
    probe_ids = slice_probe_ids(eng, qdev)
    probe_cuda.reset_launch_counts()
    prec = probe.run_probes(dev, probe=probe_ids, K=eng.n_clusters, log=log)
    probe_counts = dict(probe_cuda.launch_counts)
    log(f"probe launches: {probe_counts}")
    scatter_ops, read_ops = prec.pop("main")
    probe_times = probe.time_probes(dev, (scatter_ops, read_ops), log=log)
    del probe_ids
    torch.cuda.empty_cache()

    # phase 6: the latency rows of the slice's engine and the exact scan
    eng.config.formulation, eng.config.n_probe = "pairs", bench_latency.N_PROBE
    ivf_cuda.reset_launch_counts()
    bench_latency.latency_rows(eng)
    log(f"latency launches: {dict(ivf_cuda.launch_counts)}")
    # phase 13c (run here, on phase 4's engine): the roofline's seg_width
    # sweep; its launches are the (64, 2) and (128, 2) entries' own
    t13c = time.perf_counter()
    roof = phase_roofline(torch, eng, qdev)
    t13c_wall = time.perf_counter() - t13c
    cache = cache_path(N, N_CLUSTERS)
    save_cache(eng, cache)  # phase 7 imports this topology, builds none
    del eng, qdev
    torch.cuda.empty_cache()

    # phase 7: the write path (streaming, then churn with background
    # maintenance); phase 8: the Collection with facet filters. Their own
    # block_topw calls join the pairs entry's error.
    live_err = phase_writes(torch, dev, vecs, cache=cache)
    torch.cuda.empty_cache()
    live_err = max(live_err, phase_collection(torch, dev, vecs[:COLLECTION_ROWS]))
    records["pairs"]["max_abs_err"] = max(records["pairs"]["max_abs_err"], live_err)
    torch.cuda.empty_cache()

    # phase 9: the database at its defaults (hybrid over an IVF engine with
    # f32 blocks): 9a at 1M with the f32 slice, 9b the persistence round
    # trip. Launch counts cover the two parts and not the f32 slice's timing
    # after them; every block_topw call of the parts is held against its
    # plain version.
    ivf_cuda.reset_launch_counts()
    qdev = torch.from_numpy(make_queries(vecs, B_SERVE, B_ORACLE)[1]).to(dev)
    with LiveCheck() as live:
        db9 = phase_db(torch, dev, vecs, qdev, oracle_q, oracle_kth_)
    live.verify(torch, "db")
    db_worst = dict(live.worst_by)
    with LiveCheck() as live:
        persist_root = phase_persistence(torch, dev, vecs)
    live.verify(torch, "persist")
    for key, err in live.worst_by.items():
        db_worst[key] = max(db_worst.get(key, 0.0), err)
    counts_db = dict(ivf_cuda.launch_counts)
    log(f"db launches: {counts_db}")
    time_f32_slice(torch, db9["ivf"], qdev, db9["records"])
    del qdev
    torch.cuda.empty_cache()

    # phase 10: the server. (a) in process over phase 9a's DB; its own
    # launch counts, and every block_topw call held against the plain
    # version; (b) the CLI's processes over phase 9b's directory
    ivf_cuda.reset_launch_counts()
    with LiveCheck() as live:
        phase_server(torch, db9["db"], db9["queries"], db9["truth_ids"])
    live.verify(torch, "server")
    for key, err in live.worst_by.items():
        db_worst[key] = max(db_worst.get(key, 0.0), err)
    counts_server = dict(ivf_cuda.launch_counts)
    log(f"server launches: {counts_server}")
    if counts_server[(ivf_cuda.F32, (32, 2))] <= 0:
        raise AssertionError("block_topw_f32 was not launched by the server phase")
    db9["db"].close()
    del db9
    torch.cuda.empty_cache()
    phase_cli(persist_root)

    # phase 11: the HNSW engine (torch ops, no hand-written kernel): its
    # build and search on the shared corpus, then through the stack
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    phase_hnsw(torch, dev, vecs, stream=HNSW_STREAM)
    log(f"phase 11a-b wall (the streaming leg included): {time.perf_counter() - t11!r} s")
    torch.cuda.empty_cache()
    phase_hnsw_stack(torch, dev, vecs)

    # phase 12: the sharded engines, 4 shards placed together on the card;
    # their block_topw calls are held against the plain version and their
    # launches join the kernels line (sharded_launches)
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    sharded = phase_sharded_ivf(torch, dev, vecs, oracle_q, oracle_kth_)
    t_ivf = time.perf_counter()
    torch.cuda.empty_cache()
    phase_sharded_hnsw(torch, dev, vecs)
    t_hnsw = time.perf_counter()
    torch.cuda.empty_cache()
    stack = phase_sharded_stack(torch, dev, vecs)
    log(f"phase 12 walls: ivf+skew+exact {t_ivf - t12!r} s, hnsw {t_hnsw - t_ivf!r} s, "
        f"stack {time.perf_counter() - t_hnsw!r} s")
    # phase 12's launches and largest error, by variant (launch-count key)
    sharded_launches = add_counts(dict(sharded["launches"]), stack["launches"])
    sharded_err = max_by(dict(sharded["err"]), stack["err"])
    log(f"phase 12 block_topw launches by variant: {sharded_launches}; largest error "
        f"against the plain version by variant: {sharded_err}")
    del sharded, stack

    # phase 13: the benches at scale. (a) the 10M cell, (b) the corpus
    # matrix; (c) ran after phase 6. Their block_topw calls are held
    # against the plain version; their launches join the kernels line
    # (scale_launches, and the seg_width variants' launches from 13c)
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    tenm = phase_10m(torch, dev)
    t13a = time.perf_counter()
    torch.cuda.empty_cache()
    matrix = phase_matrix(torch, dev)
    log(f"phase 13 walls: 10m {t13a - t13!r} s, matrix {time.perf_counter() - t13a!r} s, "
        f"roofline (13c) {t13c_wall!r} s")
    scale_launches = add_counts(add_counts(dict(tenm["launches"]), matrix["launches"]),
                                roof["launches"])
    scale_err = max_by(max_by(dict(tenm["err"]), matrix["err"]), roof["err"])
    log(f"phase 13 block_topw launches by variant: {scale_launches}; largest error against "
        f"the plain version by variant: {scale_err}")

    # bounds: block_topw's from phase 3's operands (topw_bound); the probes'
    # from their main-path operands: scatter_rows reads and writes its rows,
    # index_read reads G entries of big and x once and writes G floats
    vals = scatter_ops["vals"]
    pk = card_peaks(torch)
    probe_bounds = {
        "scatter_rows": bound(2 * vals.numel() * 4 + 4 * (scatter_ops["starts"].numel()
                                                          + scatter_ops["pos"].numel()), 0.0,
                              pk["bf16"], pk["hbm"]),
        "index_read": bound(8 * read_ops["grid"] + 4, 0.0, pk["bf16"], pk["hbm"]),
    }
    replaces = {"pairs": "quiver_tpu/ops/ivf_kernels.py:633",
                "fused": "quiver_tpu/ops/ivf_pallas.py:145",
                "row100": "quiver_tpu/ops/ivf_kernels.py:716",
                "pairs64": "quiver_tpu/ops/ivf_kernels.py:660",
                "pairs128": "quiver_tpu/ops/ivf_kernels.py:660"}
    kernels, listed = [], set()
    for tag, recs, launches, source in (
            ("", records, counts, "quiver_tpu_torch/csrc/ivf_block_topw.cu"),
            ("_f32", records_f32, counts_db, "quiver_tpu_torch/csrc/ivf_block_topw_f32.cu")):
        for variant, rec in recs.items():
            # row mode at R=16 is on no main path, nor the seg_width variants
            # over f32 blocks
            if variant not in replaces or (tag and variant in SEG_VARIANTS):
                continue
            key = ivf_cuda.ROW_MODE if rec["W"] == KERNEL_SHAPE["Cmax"] else (rec["W"], rec["R"])
            if tag:
                key = (ivf_cuda.F32, key)
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         db_worst.get(("float32", rec["W"], rec["R"]), 0.0))
            rec["max_abs_err"] = max(rec["max_abs_err"], sharded_err.get(key, 0.0),
                                     scale_err.get(key, 0.0))
            listed.add(key)
            # the seg_width variants' path is the roofline sweep (13c)
            path = roof["launches"] if variant in SEG_VARIANTS else launches
            if path.get(key, 0) <= 0:
                raise AssertionError(f"block_topw{tag} {variant} was not launched by the main path")
            kernels.append({
                "name": f"block_topw{tag}[W={rec['W']},R={rec['R']}] ({variant})",
                "route": "cuda",
                "source": source,
                "replaces": replaces[variant],
                "launches": path[key],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "bound_share": rec["bound_ms"] / rec["ms"],
                "library_ms": None,  # no one PyTorch call scores pairs by cluster into windowed winners
                **({"server_launches": counts_server[key]} if tag else {}),
                "sharded_launches": sharded_launches.get(key, 0),
                "scale_launches": scale_launches.get(key, 0),
            })
    for phase, seen in (("12", sharded_launches), ("13", scale_launches)):
        if set(seen) - listed:
            raise AssertionError(f"phase {phase} launched variants with no kernels entry: "
                                 f"{set(seen) - listed}")
    for name, replaces in (("scatter_rows", "benches/probe_pallas.py:42"),
                           ("index_read", "benches/probe_pallas.py:101")):
        if probe_counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the probes' path")
        bound_ms, bound_by = probe_bounds[name]
        t = probe_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "quiver_tpu_torch/csrc/probe_kernels.cu",
            "replaces": replaces,
            "launches": probe_counts[name],
            "max_abs_err": prec[name]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_share": bound_ms / t["ms"],
            "library_ms": None,  # none: no one PyTorch call does what either probe does
            **{k: t[k] for k in PROBE_EXTRAS[name]},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"chip_smoke total: {time.perf_counter() - _T0!r} s")
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
