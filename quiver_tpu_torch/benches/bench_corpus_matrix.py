"""Recall across corpus families on one CUDA card
(``benches/bench_corpus_matrix.py``).

    python -m quiver_tpu_torch.benches.bench_corpus_matrix [--n N] [--families a,b]

Five corpus families, each N x 128-d L2 (N=250,000 by default), made by
generators bit-identical to the reference's (``bench_corpus_matrix.py:
37-70``), each from its own seed (crc32 of the family's name):

* clustered: isotropic Gaussian blobs (the headline's family);
* anisotropic: blobs stretched 10:1 along random axes;
* heavy-tail: Zipf-distributed blob sizes;
* near-dup: a third of the rows are near-duplicates of others;
* uniform: i.i.d. Gaussian, no structure.

Queries: 1,024 corpus rows plus 0.1 x the corpus's per-axis std of
jitter. Tie-aware recall@10 against the true 10th distance per query,
in f64 on the card (``common.oracle_kth``; the reference's f64 host scan
holds the same rule, ``benches/truth.py``). Rows per family, one JSON
line each with the card's name and power limit:

* ``[ivf]``: one engine configuration for every family with the n_probe
  tuner (``IVFConfig(q_cap_factor=2, kmeans_iters=8, build_threshold=1024,
  rescore=False, recall_target=0.95)``): recall, the tuned n_probe, the
  tuner's holdout recall and its gap to the measured recall, the cluster
  count, ``recall_shortfall`` and whether the target is met;
* ``[hybrid auto]``: the hybrid over that built engine (no exploration),
  routing to IVF or, on a tuner shortfall, the exact scan: recall, the
  engine it chose;
* ``[hnsw]`` (the port's addition, after the reference's two rows): the
  port's ``HNSWIndex`` at ``bench_hnsw``'s build (M=16, efC=200, bf16
  construction, ``build_batch`` 8192) searched at ef=200: recall, build
  seconds.

Not ported: the ``QUIVER_BENCH_MATRIX_N`` / ``QUIVER_BENCH_FAMILIES``
variables (``--n`` / ``--families`` and ``run``'s arguments). Without
CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import gc
import time
import zlib

import numpy as np
import torch

from quiver_tpu_torch.benches.common import card, emit, oracle_kth, require_cuda
from quiver_tpu_torch.benches.truth import recall_with_ties

N_MATRIX = 250_000
D, K_TOP = 128, 10
B_ORACLE = 1024
TARGET = 0.95
HNSW_EF = 200


def family_clustered(rng, n):
    centers = rng.normal(size=(max(32, n // 1000), D)).astype(np.float32)
    which = rng.integers(0, len(centers), n)
    return centers[which] + 0.25 * rng.normal(size=(n, D)).astype(np.float32)


def family_anisotropic(rng, n):
    k = max(32, n // 1000)
    centers = rng.normal(size=(k, D)).astype(np.float32)
    scales = rng.uniform(0.05, 0.5, size=(k, D)).astype(np.float32)
    which = rng.integers(0, k, n)
    return centers[which] + scales[which] * rng.normal(size=(n, D)).astype(np.float32)


def family_heavy_tail(rng, n):
    k = max(64, n // 2000)
    centers = rng.normal(size=(k, D)).astype(np.float32)
    p = 1.0 / np.arange(1, k + 1) ** 1.5
    p /= p.sum()
    which = rng.choice(k, size=n, p=p)
    return centers[which] + 0.25 * rng.normal(size=(n, D)).astype(np.float32)


def family_near_dup(rng, n):
    base = family_clustered(rng, n - n // 3)
    dups = base[rng.integers(0, len(base), n // 3)] + 1e-4 * rng.normal(
        size=(n // 3, D)).astype(np.float32)
    return np.concatenate([base, dups])


def family_uniform(rng, n):
    return rng.normal(size=(n, D)).astype(np.float32)


FAMILIES = (
    ("clustered", family_clustered),
    ("anisotropic", family_anisotropic),
    ("heavy-tail", family_heavy_tail),
    ("near-dup", family_near_dup),
    ("uniform", family_uniform),
)


def family_data(name: str, n: int, b: int = B_ORACLE):
    """(corpus f32[n, 128], queries f32[b, 128]) of a family, as the
    reference draws them from ``default_rng(crc32(name))``."""
    gen = dict(FAMILIES)[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    vecs = np.ascontiguousarray(gen(rng, n), np.float32)
    queries = (vecs[rng.integers(0, n, b)]
               + 0.1 * vecs.std(axis=0, keepdims=True)
               * rng.standard_normal((b, D))).astype(np.float32)
    return vecs, queries


def run(device, *, n=N_MATRIX, b=B_ORACLE, families=None, hnsw=True, hnsw_ef=HNSW_EF,
        emit_rows=True, log=print) -> list[dict]:
    """The rows of the module docstring on ``device`` for ``families``
    (names; all five by default); returns them (and emits them)."""
    from quiver_tpu_torch.benches.bench_hnsw import build as build_hnsw
    from quiver_tpu_torch.core.store import VectorStore
    from quiver_tpu_torch.index.hybrid import AdaptiveConfig, HybridIndex
    from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex

    device = torch.device(device)
    cuda = device.type == "cuda"
    tag = "" if cuda else ", CPU (tests only)"
    extra = dict(backend=f"torch-{device.type}", card=card() if cuda else None)
    rows = []
    for name in families or [f for f, _ in FAMILIES]:
        t0 = time.perf_counter()
        vecs, queries = family_data(name, n, b)
        kth = oracle_kth(device, queries, vecs, K_TOP)
        store = VectorStore(dim=D, metric="euclidean", capacity=n, device=device)
        store.add_batch([f"v{i}" for i in range(n)], vecs)
        eng = IVFIndex(store, config=IVFConfig(
            q_cap_factor=2, kmeans_iters=8, build_threshold=1024, rescore=False,
            recall_target=TARGET))
        eng.build()
        _, got = eng.search_slots(queries, K_TOP)
        recall = recall_with_ties(got, queries, vecs, kth, K_TOP)
        rows.append(dict(
            metric=f"corpus-matrix {name} N={n} [ivf]{tag}", value=recall, unit="recall@10",
            tuned_n_probe=eng.config.n_probe,
            tuner_holdout=round(eng._tuned_recall or -1, 4),
            holdout_gap=round((eng._tuned_recall or 0) - recall, 4),
            n_clusters=eng.n_clusters, recall_shortfall=bool(eng.recall_shortfall),
            meets_target=bool(recall >= TARGET), **extra))

        # the hybrid over the built engine: the row measures routing, not a
        # second build
        hyb = HybridIndex(store, adaptive_config=AdaptiveConfig(exploration_factor=0.0),
                          ann_factory=lambda s: eng)
        hyb._graph_built = True
        _, got_h = hyb.search_slots(queries, K_TOP)
        recall_h = recall_with_ties(got_h, queries, vecs, kth, K_TOP)
        rows.append(dict(
            metric=f"corpus-matrix {name} N={n} [hybrid auto]{tag}", value=recall_h,
            unit="recall@10", engine=hyb.last_strategy, meets_target=bool(recall_h >= TARGET),
            **extra))
        del hyb, eng, store

        if hnsw:
            _, g, build_s = build_hnsw(device, vecs)
            g.set_optimization_parameters(ef_search=hnsw_ef)
            _, got_g = g.search_slots(queries, K_TOP)
            recall_g = recall_with_ties(got_g, queries, vecs, kth, K_TOP)
            rows.append(dict(
                metric=f"corpus-matrix {name} N={n} [hnsw]{tag}", value=recall_g,
                unit="recall@10", ef=hnsw_ef, m=g.config.m,
                ef_construction=g.config.ef_construction, build_s=build_s,
                meets_target=bool(recall_g >= TARGET), **extra))
            del g
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        log(f"# corpus-matrix {name}: {time.perf_counter() - t0:.1f} s")
        if emit_rows:
            for r in rows[-(3 if hnsw else 2):]:
                emit(**r)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="quiver_tpu_torch.benches.bench_corpus_matrix")
    ap.add_argument("--n", type=int, default=N_MATRIX)
    ap.add_argument("--families", default=None, help="comma list (default: all five)")
    args = ap.parse_args(argv)
    dev = require_cuda("quiver_tpu_torch.benches.bench_corpus_matrix")
    run(dev, n=args.n, families=args.families.split(",") if args.families else None)


if __name__ == "__main__":
    main()
