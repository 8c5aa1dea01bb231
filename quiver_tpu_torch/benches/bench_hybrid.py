"""The hybrid engine's adaptive routing on one CUDA card
(``benches/bench_hybrid.py``, BASELINE config #3).

    python -m quiver_tpu_torch.benches.bench_hybrid [--n N]

``make_clustered_corpus(N, 64)`` (N=20,000 by default, as the
reference's), B=128 queries near the corpus at k=10. Three rows, QPS of
``search_slots`` (host clock over back-to-back calls, each ending in its
device-to-host copy), with the card's name and power limit:

* the default hybrid (``HybridIndex(store)``: the ANN side resolves to the
  IVF engine), with the strategy it routed to and its exact threshold;
* raw IVF on the same corpus (``build_threshold=1024``), the routing
  overhead's denominator (``hybrid_vs_raw``);
* the graph-backed hybrid (``ann_backend="hnsw"``, bf16 construction,
  ``build_batch=8192``), the reference-parity configuration.

Not ported: ``pipelined_ms`` and the ``QUIVER_BENCH_N`` variable (``--n``).
Without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from quiver_tpu_torch.benches.common import card, emit, make_clustered_corpus, require_cuda, wall_ms

N_HYBRID, D, B, K = 20_000, 64, 128, 10


def graph_hybrid(store, **kw):
    """The graph-backed hybrid of the reference bench."""
    from quiver_tpu_torch.index.hybrid import HybridIndex

    return HybridIndex(store, compute_dtype=torch.bfloat16, ann_backend="hnsw",
                       build_batch=8192, **kw)


def run(device, *, n=N_HYBRID, b=B, reps=10, emit_rows=True) -> list[dict]:
    """The three rows of the module docstring on ``device``; returns them
    (and emits them)."""
    from quiver_tpu_torch.core.store import VectorStore
    from quiver_tpu_torch.index.hybrid import HybridIndex
    from quiver_tpu_torch.index.ivf import IVFIndex

    device = torch.device(device)
    cuda = device.type == "cuda"
    tag = "" if cuda else ", CPU host clock (tests only)"
    extra = dict(backend=f"torch-{device.type}", card=card() if cuda else None)
    vecs, rng = make_clustered_corpus(n, D)
    store = VectorStore(dim=D, metric="euclidean", capacity=max(n, 1024), device=device)
    slots = store.add_batch([f"v{i}" for i in range(n)], vecs)
    queries = (vecs[rng.integers(0, n, b)] + 0.1 * rng.normal(size=(b, D))).astype(np.float32)

    rows = []
    idx = HybridIndex(store)
    idx.on_insert(slots, vecs)
    idx.search_slots(queries, K, exact=True)  # mixed load warms both paths
    ms = wall_ms(device, lambda: idx.search_slots(queries, K), reps)
    rows.append(dict(metric=f"hybrid adaptive QPS (default config), N={n} d={D}{tag}",
                     value=b / (ms / 1e3), unit="qps", strategy=idx.last_strategy,
                     exact_threshold=idx.selector.exact_threshold, **extra))
    raw = IVFIndex(store, build_threshold=1024)
    raw.build()
    ms_raw = wall_ms(device, lambda: raw.search_slots(queries, K), reps)
    rows.append(dict(metric=f"raw ivf QPS (hybrid denominator), N={n} d={D}{tag}",
                     value=b / (ms_raw / 1e3), unit="qps", hybrid_vs_raw=round(ms_raw / ms, 3),
                     **extra))
    idx2 = graph_hybrid(store)
    idx2.on_insert(slots, vecs)
    ms = wall_ms(device, lambda: idx2.search_slots(queries, K), reps)
    rows.append(dict(metric=f"hybrid adaptive QPS (hnsw backend), N={n} d={D}{tag}",
                     value=b / (ms / 1e3), unit="qps", strategy=idx2.last_strategy,
                     per_strategy_queries=idx2.stats()["per_strategy_queries"], **extra))
    if emit_rows:
        for r in rows:
            emit(**r)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="quiver_tpu_torch.benches.bench_hybrid")
    ap.add_argument("--n", type=int, default=N_HYBRID)
    args = ap.parse_args(argv)
    run(require_cuda("quiver_tpu_torch.benches.bench_hybrid"), n=args.n)


if __name__ == "__main__":
    main()
