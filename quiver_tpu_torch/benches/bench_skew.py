"""Probe skew on the sharded IVF engine (``benches/bench_skew.py``).

    python -m quiver_tpu_torch.benches.bench_skew [--n N]

The sharded engine bounds each shard's (query, probe) pair list at
``local_pair_factor`` x the mean load B*P/n and drops the lowest-rank
pairs past it (``parallel/sharded_ivf.py``). At the reference bench's
shapes (200,000 x 64-d Gaussian blobs round 128 centers, 128 clusters,
B=512, n_probe=3, 8 shards, here placed together on one card):

* adversarial skew: every query targets clusters that shard 0 owns, so it
  sees ~8x its mean load: recall@10 against the exact scan at
  ``local_pair_factor`` in {1, 2, 4}, beside the uniform-query control.
  Each factor's engine serves the skewed batch first, so that batch runs
  at the factor; the uniform batch after it reads the skewed batch's load
  and may run at a raised factor (the engine's auto-raise): each line
  records the factor its batch was served at (``served_at_factor``), and
  both batches are timed at the engine's factor after them;
* the score-derived (``rescore=False``, the only mode the sharded engine
  serves) against the rescored recall of the single-card engine, on the
  same corpus and queries.

Each line also carries ms per batch of ``search_slots`` on the host clock
and the card's name and power limit. Without CUDA it exits non-zero
before printing a result.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from quiver_tpu_torch.benches.common import card, emit, recall_at_k, require_cuda

N_SKEW = 200_000
D, K_TOP, B = 64, 10, 512
N_CLUSTERS, N_PROBE, N_SHARDS = 128, 3, 8
FACTORS = (1.0, 2.0, 4.0)


def _ms(fn, device, reps=5) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run(device, *, n=N_SKEW, emit_rows=True) -> list[dict]:
    """The bench of the module docstring on ``device``; returns its rows
    (and emits them)."""
    from quiver_tpu_torch.core.store import VectorStore
    from quiver_tpu_torch.index.exact import ExactIndex
    from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex
    from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    device = torch.device(device)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(N_CLUSTERS, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, N_CLUSTERS, n)]
            + 0.25 * rng.normal(size=(n, D))).astype(np.float32)
    store = VectorStore(dim=D, metric="euclidean", capacity=n, device=device)
    store.add_batch([f"v{i}" for i in range(n)], vecs)
    exact = ExactIndex(store)
    cfg = dict(n_clusters=N_CLUSTERS, n_probe=N_PROBE, q_cap_factor=2, kmeans_iters=6,
               build_threshold=1024)

    def queries_near(rows):
        return (vecs[rng.choice(rows, size=B)] + 0.1 * rng.normal(size=(B, D))).astype(np.float32)

    def recall(eng, q):
        _, got = eng.search_slots(q, K_TOP)
        _, truth = exact.search_slots(q, K_TOP)
        return recall_at_k(got, truth, K_TOP)

    q_uniform = queries_near(np.arange(n))
    where = f"{n} x {D}-d, n_probe={N_PROBE}, B={B}"
    extra = dict(backend=f"torch-{device.type}", card=card() if device.type == "cuda" else None)
    rows = []
    for factor in FACTORS:
        eng = ShardedIVFIndex(store, N_SHARDS, config=IVFConfig(**cfg, rescore=False),
                              local_pair_factor=factor)
        eng.build()
        kl = eng._k_local
        own0 = np.flatnonzero((eng._slot_pos[:, 0] >= 0) & (eng._slot_pos[:, 0] < kl))
        q_skew = queries_near(own0)
        got = []
        for label, q in (("skew", q_skew), ("uniform", q_uniform)):
            r = recall(eng, q)  # the uniform batch first reads the skewed one's load
            got.append((label, q, r, eng.local_pair_factor))
        for label, q, r, at in got:
            def serve():
                eng._pending_load = None  # time at the factor reached, raising nothing
                return eng.search_slots(q, K_TOP)
            rows.append(dict(
                metric=f"sharded-ivf recall@10, local_pair_factor={factor}, {label} queries "
                       f"({N_SHARDS} shards on one device, {where})",
                value=r, unit="recall", served_at_factor=at,
                overflow_raises=eng._overflow_raises, ms_per_batch=round(_ms(serve, device), 3),
                timed_at_factor=eng.local_pair_factor, **extra))
        del eng
    for rescore in (False, True):
        eng1 = IVFIndex(store, config=IVFConfig(**cfg, rescore=rescore))
        eng1.build()
        rows.append(dict(
            metric=f"single-card ivf recall@10, rescore={rescore} ({where})",
            value=recall(eng1, q_uniform), unit="recall",
            ms_per_batch=round(_ms(lambda: eng1.search_slots(q_uniform, K_TOP), device), 3),
            **extra))
    if emit_rows:
        for r in rows:
            emit(r.pop("metric"), r.pop("value"), r.pop("unit"), **r)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_SKEW)
    run(require_cuda("bench_skew"), n=ap.parse_args().n)


if __name__ == "__main__":
    main()
