"""One rank of the port's two-process sharded scan (tests/test_torch_dcn.py).

Launched twice with a shared rendezvous address. The 1024-row corpus is 8
shards of 128 rows; each of the 2 ranks owns 4 of them (rows
[rank*512, rank*512 + 512)) on the CPU, joins a gloo group, scans its
shards and merges with the other rank over ``all_gather``
(``quiver_tpu_torch/parallel/distributed.py``). The port of
tests/dcn_worker.py: the same data, k and checks.

Exit code 0: this rank's merged top-k passed the f32 oracle checks.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    init_method, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import numpy as np
    import torch

    from quiver_tpu_torch.ops.distance import inv_norms, norms_sq
    from quiver_tpu_torch.parallel import distributed as qd

    qd.init(init_method, world, rank, device="cpu")
    cap, d, B, k, n_shards = 1024, 32, 16, 10, 8
    rng = np.random.default_rng(7)  # same data in every process
    vecs = rng.normal(size=(cap, d)).astype(np.float32)
    queries = vecs[:B] + 0.01 * rng.normal(size=(B, d)).astype(np.float32)
    per_rank = cap // world
    L = cap // n_shards
    shards = []
    for s in range(per_rank // L):
        lo = rank * per_rank + s * L
        v = torch.from_numpy(vecs[lo:lo + L].copy())
        ns = norms_sq(v)
        shards.append((v, torch.ones(L, dtype=torch.bool), ns, inv_norms(ns)))
    dist, idx = qd.dist_scan_topk(
        torch.from_numpy(queries), shards, rank * per_rank, metric="euclidean", k=k, tile=L,
    )
    dist, idx = dist.numpy(), idx.numpy()
    qd.dist.destroy_process_group()

    true_d = np.linalg.norm(queries[:, None, :] - vecs[None, :, :], axis=2)
    oracle = np.argsort(true_d, axis=1)[:, :k]
    hits = sum(len(set(idx[b].tolist()) & set(oracle[b].tolist())) for b in range(B))
    recall = hits / (B * k)
    seeded_ok = bool((idx[:, 0] == np.arange(B)).all())
    sorted_ok = bool((np.diff(dist, axis=1) >= -1e-5).all())
    print(f"[rank {rank}] recall={recall:.3f} seeded_ok={seeded_ok} sorted_ok={sorted_ok}",
          flush=True)
    return 0 if (recall >= 0.99 and seeded_ok and sorted_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
