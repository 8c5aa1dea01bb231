"""10M x 128-d on one CUDA card (``benches/bench_10m.py``).

    python -m quiver_tpu_torch.benches.bench_10m

The corpus is the reference's generator (:func:`clustered`: 10,000
Gaussian centers, sigma 0.25, drawn in 2M-row blocks; bit-identical),
ingested into a ``VectorStore`` on the card in 1M-row batches. The engine
is ``IVFConfig(n_clusters=4096, n_probe=3, q_cap_factor=2, kmeans_iters=8,
build_threshold=1024, rescore=False)``. Rows, one JSON line each with the
card's name and power limit:

* the cold build (k-means and layout): wall seconds and inserts/s;
* the layout from the cold build's assignment, through
  ``import_topology`` into a fresh engine on the same store: wall
  seconds, whether it beats the cold build, and whether the imported
  layout answers the 2,048 oracle queries as the built one did (the
  reference's run takes one path or the other, from its ``/tmp`` cache;
  here both run, so the two walls are compared in one process);
* ``device_bytes()``: GiB (engine, store) and bytes per vector;
* QPS and ms per batch of ``search_slots_device`` (CUDA events over
  back-to-back calls) at B=32768, the reference's row (cut there for the
  v5e's memory, ``bench_10m.py:28-32``), and at B=65536, the headline
  batch; each with tie-aware recall@10 of the 2,048 oracle queries
  against the true 10th distance per query, exact in f64 on the card
  (``common.oracle_kth``; the reference re-scores a device f32 top-50 in
  f64 on its host, and frees the engine first for its 16 GB: the card's
  80 GB need not).

Not ported: the ``QUIVER_BENCH_10M_*`` / ``_B`` / ``_DEPTH`` variables
(``run``'s arguments) and the ``/tmp`` corpus, build and truth caches.
Without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from quiver_tpu_torch.benches.common import card, device_ms, emit, oracle_kth, require_cuda
from quiver_tpu_torch.benches.streaming import sync
from quiver_tpu_torch.benches.truth import recall_with_ties

N_10M = 10_000_000
D, K_TOP = 128, 10
N_CENTERS = 10_000
N_CLUSTERS = 4096
BATCHES = (32768, 65536)
B_ORACLE = 2048
DEPTH = 16
INGEST_BATCH = 1_000_000


def clustered(n, seed=0, block=2_000_000):
    """The headline generator's family, blocked to bound host memory:
    bit-identical to ``benches/bench_10m.py:40-50``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(N_CENTERS, D)).astype(np.float32)
    out = np.empty((n, D), np.float32)
    for s in range(0, n, block):
        e = min(n, s + block)
        which = rng.integers(0, N_CENTERS, e - s)
        out[s:e] = centers[which] + 0.25 * rng.normal(size=(e - s, D)).astype(np.float32)
    return out


def label(n: int) -> str:
    """The reference's "10M" at its size, else the row count."""
    return "10M" if n == N_10M else f"N={n}"


def engine_config(n_clusters: int):
    from quiver_tpu_torch.index.ivf import IVFConfig

    return IVFConfig(n_clusters=n_clusters, n_probe=3, q_cap_factor=2, kmeans_iters=8,
                     build_threshold=1024, rescore=False)


def run(device, *, n=N_10M, n_clusters=N_CLUSTERS, batches=BATCHES, b_oracle=B_ORACLE,
        reps=DEPTH, block=2_000_000, ingest_batch=INGEST_BATCH,
        check=contextlib.nullcontext(), emit_rows=True, log=print) -> list[dict]:
    """The rows of the module docstring on ``device``; returns them (and
    emits them). ``check``:
    a context manager entered around every search outside the timed loops
    (``chip_smoke.LiveCheck`` holds those ``block_topw`` calls against the
    plain version)."""
    from quiver_tpu_torch.core.store import VectorStore
    from quiver_tpu_torch.index.ivf import IVFIndex

    device = torch.device(device)
    cuda = device.type == "cuda"
    tag = "" if cuda else ", CPU (tests only)"
    extra = dict(backend=f"torch-{device.type}", card=card() if cuda else None)
    lab = label(n)
    t0 = time.perf_counter()
    vecs = clustered(n, block=block)
    log(f"# corpus gen {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(1)
    queries = (vecs[:b_oracle] + 0.1 * rng.normal(size=(b_oracle, D))).astype(np.float32)

    store = VectorStore(dim=D, metric="euclidean", capacity=n, device=device)
    t0 = time.perf_counter()
    for s in range(0, n, ingest_batch):
        e = min(n, s + ingest_batch)
        store.add_batch([f"v{i}" for i in range(s, e)], vecs[s:e])
    store.device_view()
    sync(device)
    log(f"# ingest {time.perf_counter() - t0:.1f}s")
    rows = []

    eng = IVFIndex(store, config=engine_config(n_clusters))
    sync(device)
    t0 = time.perf_counter()
    eng.build()
    sync(device)
    build_s = time.perf_counter() - t0
    rows.append(dict(metric=f"ivf {lab} cold build (k-means K={n_clusters}, 8 iters + layout){tag}",
                     value=build_s, unit="s", inserts_per_s=n / build_s,
                     n_clusters=eng.n_clusters, cmax=int(eng._block_slot.shape[1]), **extra))
    with check:
        built = eng.search_slots(queries, K_TOP)[1]
    topo = eng.export_topology()
    slot_map = eng._block_slot.cpu().numpy()
    del eng
    if cuda:
        torch.cuda.empty_cache()

    eng = IVFIndex(store, config=engine_config(n_clusters))
    sync(device)
    t0 = time.perf_counter()
    eng.import_topology(topo, np.arange(store.capacity))
    sync(device)
    import_s = time.perf_counter() - t0
    with check:
        _, got = eng.search_slots(queries, K_TOP)
    same = bool(np.array_equal(eng._block_slot.cpu().numpy(), slot_map)
                and np.array_equal(got, built))
    rows.append(dict(metric=f"ivf {lab} layout from cached assignment{tag}", value=import_s,
                     unit="s", beats_cold_build=bool(import_s < build_s), cold_build_s=build_s,
                     same_answers=same, **extra))
    del topo, built

    mem = eng.device_bytes()
    rows.append(dict(metric=f"ivf {lab} device memory{tag}", value=mem["total"] / 2**30,
                     unit="GiB", engine_gib=round(mem["engine"] / 2**30, 2),
                     store_gib=round(mem["store"] / 2**30, 2),
                     bytes_per_vector=mem["per_vector"], **extra))

    kth = oracle_kth(device, queries, vecs, K_TOP)
    recall = recall_with_ties(got, queries, vecs, kth, K_TOP)
    for b in batches:
        qb = (vecs[rng.integers(0, n, b)] + 0.1 * rng.normal(size=(b, D))).astype(np.float32)
        qd = torch.from_numpy(qb).to(device)
        with check:
            eng.search_slots_device(qd, K_TOP)
        ms = device_ms(device, lambda: eng.search_slots_device(qd, K_TOP), reps)
        rows.append(dict(
            metric=f"ivf {lab} x {D}-d QPS/chip, B={b}, n_probe=3, "
                   f"recall@10={recall:.3f} (tie-aware){tag}",
            value=b / (ms / 1e3), unit="qps", batch_latency_ms=ms, recall_at_10=recall,
            **extra))
        del qd
    if cuda:
        rows[-1]["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    if emit_rows:
        for r in rows:
            emit(**r)
    return rows


def main() -> None:
    run(require_cuda("quiver_tpu_torch.benches.bench_10m"))


if __name__ == "__main__":
    main()
