"""Streaming ingest into the live IVF engine on one CUDA card (the IVF leg of
``benches/bench_streaming.py``).

    python -m quiver_tpu_torch.benches.streaming

The base is the headline corpus ``clustered(1_000_000)``; the engine is the
headline bench's (``quiver_tpu_torch/bench.py::build_engine``:
``IVFConfig(n_clusters=1024, n_probe=3, q_cap_factor=2, kmeans_iters=8,
build_threshold=1024, rescore=False)`` at the default churn policy, from
its build cache), in a store with room for the stream. Then 8 batches of
8,192 fresh in-distribution rows (:func:`stream_rows`) go through
``VectorStore.add_batch`` + ``IVFIndex.on_insert``; after each, B=256
queries — half near old rows, half near the batch just inserted, plus 0.1
noise — are served and their recall@10 taken against ``ExactIndex`` over
the live corpus. Then the refresh wall and the full-rebuild wall at the
grown size.

Emits the reference's JSON lines (``bench_streaming.py:81-90, 128-145``)
with ``card`` (name and power limit) added to each. Write walls are host
clock around the call and a ``torch.cuda.synchronize()``; the first
batch's sample is left out of the steady rates, as in the reference.
Without CUDA it exits non-zero before printing a result. Not ported yet:
the HNSW leg (ROADMAP.md queue 1, item 4's open cells); not ported: the
``QUIVER_BENCH_*`` environment overrides (``run`` takes the sizes as
arguments).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from quiver_tpu_torch.benches.common import (
    D, K, N, N_CENTERS, card, clustered, emit, recall_at_k, require_cuda,
)

B = 256
STREAM_BATCH = 8192
STREAM_BATCHES = 8


def stream_rows(n: int, seed: int = 777) -> np.ndarray:
    """Fresh in-distribution rows: the same blob centers as
    :func:`clustered` but an independent noise stream — bit-identical to
    ``benches/bench_streaming.py:36-47``."""
    centers = np.random.default_rng(0).normal(size=(N_CENTERS, D)).astype(np.float32)
    rng = np.random.default_rng(seed)
    which = rng.integers(0, N_CENTERS, n)
    out = centers[which] + 0.25 * rng.normal(size=(n, D)).astype(np.float32)
    return out.astype(np.float32)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def live_engine(corpus: np.ndarray, n: int, device, *, n_clusters: int, cache=None, log=print):
    """The headline engine over ``corpus[:n]`` in a store with room for
    all of ``corpus``, at n_probe=3 and the default churn policy; returns
    (engine, build seconds or None when the cache served it)."""
    from quiver_tpu_torch.bench import build_engine

    hit = cache is not None and cache.exists()
    t0 = time.perf_counter()
    eng = build_engine(corpus[:n], device, n_clusters=n_clusters, n_probe=3,
                       cache=cache, capacity=len(corpus), log=log)
    sync(torch.device(device))
    return eng, None if hit else time.perf_counter() - t0


def queries_near(rng, old: np.ndarray, new: np.ndarray, b: int) -> np.ndarray:
    """b queries: half near ``old`` rows, half near ``new`` rows, + 0.1
    noise (the reference's query model)."""
    qold = old[rng.integers(0, len(old), b // 2)]
    qnew = new[rng.integers(0, len(new), b - b // 2)]
    q = np.concatenate([qold, qnew])
    return (q + 0.1 * rng.normal(size=q.shape)).astype(np.float32)


def run(
    device, *, n: int = N, stream_batches: int = STREAM_BATCHES,
    stream_batch: int = STREAM_BATCH, b: int = B, n_clusters: int = 1024,
    cache=None, base=None, log=print,
) -> list[dict]:
    """The streaming run on ``device``; returns the emitted result dicts.
    ``base`` is the base corpus when the caller already holds
    ``clustered(n)``."""
    from quiver_tpu_torch.index.exact import ExactIndex

    device = torch.device(device)
    tag = {"card": card() if device.type == "cuda" else None}
    out = []

    def put(metric, value, unit, **extra):
        out.append({"metric": metric, "value": value, "unit": unit, **extra, **tag})
        emit(metric, value, unit, **extra, **tag)

    base = clustered(n) if base is None else base
    n = len(base)
    corpus = np.concatenate([base, stream_rows(stream_batches * stream_batch)])
    rng = np.random.default_rng(7)
    eng, build_s = live_engine(corpus, n, device, n_clusters=n_clusters, cache=cache, log=log)
    store = eng.store
    if build_s is not None:
        put(f"ivf build wall-clock, N={n} d={D}", build_s, "s", n_clusters=eng.n_clusters)
    exact = ExactIndex(store)
    put("ivf warmup (first use of the serve and write paths)",
        eng.warmup(query_batches=(b,), write_batches=(stream_batch,)), "s")

    ins_s, q_ms, recalls = [], [], []
    at = n
    for _ in range(stream_batches):
        rows = corpus[at: at + stream_batch]
        t0 = time.perf_counter()
        slots = store.add_batch([f"s{at + j}" for j in range(len(rows))], rows)
        eng.on_insert(np.asarray(slots), rows)
        sync(device)
        ins_s.append(time.perf_counter() - t0)
        at += len(rows)
        q = queries_near(rng, corpus[:n], rows, b)
        t0 = time.perf_counter()
        _, got = eng.search_slots(q, K)
        q_ms.append((time.perf_counter() - t0) * 1e3)
        _, truth = exact.search_slots(q, K)
        recalls.append(recall_at_k(got, truth, K))
    warm = 1 if stream_batches > 1 else 0  # the first batch's sample
    put(
        f"ivf streaming inserts/s, base N={n} stream {stream_batches * stream_batch}",
        (stream_batches - warm) * stream_batch / sum(ins_s[warm:]), "inserts/s",
        query_qps_during_stream=b / (float(np.mean(q_ms[warm:])) / 1e3),
        recall_at_10_live=float(np.mean(recalls)),
        first_batch_inserts_per_s=stream_batch / ins_s[0],
    )

    t0 = time.perf_counter()
    eng.refresh()
    sync(device)
    put(f"ivf refresh wall (existing centroids), N={store.size}",
        time.perf_counter() - t0, "s")
    t0 = time.perf_counter()
    eng.build()
    sync(device)
    put(f"ivf full rebuild wall (k-means retrain), N={store.size}",
        time.perf_counter() - t0, "s", n_clusters=eng.n_clusters)
    return out


def main() -> None:
    from quiver_tpu_torch.bench import N_CLUSTERS, cache_path

    dev = require_cuda("quiver_tpu_torch.benches.streaming")
    run(dev, cache=cache_path(N, N_CLUSTERS))


if __name__ == "__main__":
    main()
