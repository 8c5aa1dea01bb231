"""Recall sweep of the HNSW engine on one CUDA card: query dtype x visited
set x ef (``benches/exp_hnsw_recall.py``).

    python -m quiver_tpu_torch.benches.exp_hnsw_recall [--n N]

One bf16-construction build (``build_batch=8192``) of
``make_clustered_corpus(N, 128)`` (N=100,000 by default, as the
reference's), then for query dtype in {float32, bfloat16}, visited in
{ring, bitmap} and ef in {50, 100, 200, 400}: QPS of ``search_slots`` on
B=256 queries near the corpus, recall@10 against the exact f64 top-10 and
tie-aware (``benches/truth.py``), one ``emit`` line each with the card's
name and power limit. Not ported: the topology cache under ``/tmp``
(``exp_hnsw_recall.py:29,45-54``; the port reads and writes nothing
outside its checkout, so each run builds) and ``pipelined_ms``. Without
CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from quiver_tpu_torch.benches.bench_hnsw import B, D, K, build, recall_rows
from quiver_tpu_torch.benches.common import (
    card,
    emit,
    make_clustered_corpus,
    oracle_topk,
    require_cuda,
)

N_EXP = 100_000
EFS = (50, 100, 200, 400)


def run(device, *, n=N_EXP, b=B, efs=EFS, reps=5, emit_rows=True) -> list[dict]:
    """The sweep of the module docstring on ``device``; returns its rows
    (and emits them)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    vecs, rng = make_clustered_corpus(n, D)
    _, idx, build_s = build(device, vecs)
    queries = (vecs[:b] + 0.1 * rng.normal(size=(b, D))).astype(np.float32)
    truth, kth = oracle_topk(device, queries, vecs, K)
    rows = []
    for qd in ("float32", "bfloat16"):
        for visited in ("ring", "bitmap"):
            for r in recall_rows(idx, vecs, queries, truth, kth, efs=efs, reps=reps,
                                 visited=visited, query_dtype=qd):
                rows.append(dict(
                    metric=(f"hnsw sweep N={n} qd={qd} visited={visited} ef={r['ef']}"
                            + ("" if cuda else ", CPU host clock (tests only)")),
                    value=r["qps"], unit="qps", recall_at_10=round(r["recall_at_10"], 4),
                    recall_at_10_ties=round(r["recall_at_10_ties"], 4),
                    build_s=round(build_s, 3), backend=f"torch-{device.type}",
                    card=card() if cuda else None))
    if emit_rows:
        for r in rows:
            emit(**r)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="quiver_tpu_torch.benches.exp_hnsw_recall")
    ap.add_argument("--n", type=int, default=N_EXP)
    args = ap.parse_args(argv)
    run(require_cuda("quiver_tpu_torch.benches.exp_hnsw_recall"), n=args.n)


if __name__ == "__main__":
    main()
