"""Forced-refresh availability run on one CUDA card (port of
``benches/bench_churn.py``).

    python -m quiver_tpu_torch.benches.churn

Streams 45 x 8,192 = 368,640 fresh rows (36.9% of the 1M base,
``streaming.stream_rows``) into the headline engine
(``streaming.live_engine``) at the DEFAULT churn policy, so a background
refresh (``rebuild_growth=0.3``) is forced mid-stream, and measures what an
operator cares about while it runs:

* write-call wall per batch (p50/p99/max): ``add_batch`` + ``on_insert``
  and a ``torch.cuda.synchronize()``, host clock;
* query QPS and live recall@10 (against ``ExactIndex`` over the live
  corpus) every 3rd batch, and while the maintenance job drains after the
  stream: ``query_qps_during_rebuild_min`` against ``query_qps_mean``;
* the maintenance counters: swaps >= 1 (the run raises otherwise, and on a
  job error), the swap's locked-replay stall.

Emits the reference's JSON fields (``bench_churn.py:119-140``) plus
``card`` (name and power limit). Without CUDA it exits non-zero before
printing a result. Not ported: the ``QUIVER_BENCH_*`` environment
overrides (``run`` takes the sizes as arguments).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from quiver_tpu_torch.benches.common import D, K, N, card, clustered, emit, recall_at_k, require_cuda
from quiver_tpu_torch.benches.streaming import live_engine, queries_near, stream_rows, sync

B = 256
STREAM_BATCH = 8192
STREAM_BATCHES = 45
QUERY_EVERY = 3


def run(
    device, *, n: int = N, stream_batches: int = STREAM_BATCHES,
    stream_batch: int = STREAM_BATCH, b: int = B, query_every: int = QUERY_EVERY,
    n_clusters: int = 1024, cache=None, base=None, log=print,
) -> dict:
    """The churn run on ``device``; returns the result dict it emits (the
    warmup line aside). ``base`` is the base corpus when the caller
    already holds ``clustered(n)``. Raises if no maintenance swap happened
    or the job failed."""
    from quiver_tpu_torch.index.exact import ExactIndex

    device = torch.device(device)
    base = clustered(n) if base is None else base
    n = len(base)
    corpus = np.concatenate([base, stream_rows(stream_batches * stream_batch)])
    rng = np.random.default_rng(11)
    eng, _ = live_engine(corpus, n, device, n_clusters=n_clusters, cache=cache, log=log)
    store = eng.store
    exact = ExactIndex(store)
    tag = {"card": card() if device.type == "cuda" else None}
    emit("ivf warmup (first use of the serve and write paths)",
         eng.warmup(query_batches=(b,), write_batches=(stream_batch,)), "s", **tag)

    def serve(q):
        t0 = time.perf_counter()
        _, got = eng.search_slots(q, K)
        dt = time.perf_counter() - t0
        _, truth = exact.search_slots(q, K)
        recalls.append(recall_at_k(got, truth, K))
        return dt

    ins_ms, q_ms, recalls, qps_during_rebuild = [], [], [], []
    at = n
    for i in range(stream_batches):
        rows = corpus[at: at + stream_batch]
        t0 = time.perf_counter()
        sl = store.add_batch([f"s{at + j}" for j in range(len(rows))], rows)
        eng.on_insert(np.asarray(sl), rows)
        sync(device)
        ins_ms.append((time.perf_counter() - t0) * 1e3)
        at += len(rows)
        if i % query_every:
            continue
        dt = serve(queries_near(rng, corpus[:n], rows, b))
        q_ms.append(dt * 1e3)
        if eng.get_detailed_metrics()["maintenance"]["inflight"]:
            qps_during_rebuild.append(b / dt)

    # drain: keep querying while the job finishes, so the availability
    # window covers the whole rebuild
    while not eng.wait_maintenance(timeout=2.0):
        q = (corpus[rng.integers(0, at, b)] + 0.1 * rng.normal(size=(b, D))).astype(np.float32)
        qps_during_rebuild.append(b / serve(q))

    m = eng.get_detailed_metrics()["maintenance"]
    if m["error"] is not None:
        raise RuntimeError(f"maintenance job failed: {m['error']}")
    if m["swaps"] < 1:
        raise RuntimeError("the stream never forced a maintenance swap")
    recall_live_min = float(np.min(recalls))

    # post-swap recall over the full corpus
    q = (corpus[rng.integers(0, at, b)] + 0.1 * rng.normal(size=(b, D))).astype(np.float32)
    _, got = eng.search_slots(q, K)
    _, truth = exact.search_slots(q, K)

    rows_in = stream_batches * stream_batch
    ins = np.asarray(ins_ms)
    result = dict(
        metric=(f"ivf forced-refresh churn run: stream {rows_in} rows "
                f"({rows_in / n:.0%} of {n}) at default rebuild_growth=0.3"),
        value=float(np.percentile(ins, 99)),
        unit="ms write-call p99",
        write_ms_p50=float(np.percentile(ins, 50)),
        write_ms_max=float(ins.max()),
        inserts_per_s_steady=stream_batch / (float(np.percentile(ins, 50)) / 1e3),
        first_batch_inserts_per_s=stream_batch / (ins[0] / 1e3),
        query_qps_mean=b / (float(np.mean(q_ms)) / 1e3) if q_ms else None,
        query_qps_during_rebuild_min=min(qps_during_rebuild) if qps_during_rebuild else None,
        n_rebuild_overlap_samples=len(qps_during_rebuild),
        recall_at_10_live_min=recall_live_min,
        recall_at_10_final=recall_at_k(got, truth, K),
        maint_swaps=m["swaps"],
        maint_swap_stall_ms=m["last_swap_stall_s"] * 1e3,
        maint=m,
        **tag,
    )
    emit(**{k: v for k, v in result.items() if k != "maint"})
    return result


def main() -> None:
    from quiver_tpu_torch.bench import N_CLUSTERS, cache_path

    dev = require_cuda("quiver_tpu_torch.benches.churn")
    run(dev, cache=cache_path(N, N_CLUSTERS))


if __name__ == "__main__":
    main()
