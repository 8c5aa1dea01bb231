"""One step of the sharded pipeline over a shard list: the port's
counterpart of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:
70-220``).

It runs, over a mesh of devices (``parallel/sharded.resolve_mesh``: every
card by default, n shards, or a list such as ``cuda:0,cpu``, as the JAX
one runs across n chips): a sharded ingest scatter of new rows, a
construction kNN round of those rows against the sharded corpus (each
must find itself first), a filtered cosine search with the merge and a
negative rerank, then the sharded HNSW engine (a build, a search, a write
after the first search) and the sharded IVF engine (a build, a search, a
refresh that keeps the cluster ownership). A failed check raises
``AssertionError``.

Run: ``python -m quiver_tpu_torch.parallel.dryrun [n_shards] [--mesh
cuda:0,cpu] [--device cpu]`` (every card by default; ``--device`` is the
stores' device).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from quiver_tpu_torch.core.store import VectorStore, resolve_device
from quiver_tpu_torch.ops.distance import inv_norms, norms_sq
from quiver_tpu_torch.parallel.sharded import (
    resolve_mesh,
    shard_rows,
    sharded_negative_rerank,
    sharded_scan_topk,
)


def dryrun_multichip(mesh=8, device="cuda") -> dict:
    """The pipeline step (module doc) over ``mesh`` (None, an int or a
    list of devices; the stores live on ``device``); returns its checked
    figures."""
    from quiver_tpu_torch.index.ivf import IVFConfig
    from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex
    from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    n_shards = len(mesh)
    cap = max(1024, 128 * n_shards)
    cap -= cap % n_shards
    d, B, k, new_n = 32, 8, 5, 16
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(cap, d)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[: cap - new_n] = True
    mask = rng.random(cap) < 0.5
    queries = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev)
    negative = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev)
    new_vecs = rng.normal(size=(new_n, d)).astype(np.float32)

    # 1. sharded ingest: scatter the new rows into their owning shard
    v_sh, va_sh = shard_rows(vecs, mesh), shard_rows(valid, mesh)
    L = cap // n_shards
    at = np.arange(cap - new_n, cap)
    for s in np.unique(at // L):
        pick = at // L == s
        idx = torch.from_numpy(at[pick] - s * L).to(mesh[s])
        v_sh[s].index_copy_(0, idx, torch.from_numpy(new_vecs[pick]).to(mesh[s]))
        va_sh[s][idx] = True
    shards = []
    for v, va in zip(v_sh, va_sh):
        ns = norms_sq(v)
        shards.append((v, va, ns, inv_norms(ns)))
    # 2. a construction round: kNN of the new rows against the corpus
    _, build_i = sharded_scan_topk(
        torch.from_numpy(new_vecs).to(dev), shards, metric="euclidean", k=8, tile=L)
    build_i = build_i.cpu().numpy()
    assert build_i.shape == (new_n, 8) and (build_i >= 0).all()
    self_hits = float((build_i[:, 0] == at).mean())
    assert self_hits == 1.0, f"sharded build round broken: self-recall {self_hits}"
    # 3. filtered search + merge, 4. negative rerank of the merged candidates
    q_d, q_i = sharded_scan_topk(
        queries, shards, shard_rows(mask, mesh), metric="cosine", k=k, tile=L)
    r_d, r_i = sharded_negative_rerank(
        q_d, q_i, [sh[0] for sh in shards], negative, metric="cosine", k=k, weight=0.5)
    r_i = r_i.cpu().numpy()
    assert r_i.shape == (B, k) and mask[r_i[r_i >= 0]].all()

    # 5. the graph engine on the same shards, a write after its first search
    g_n = 64 * n_shards
    g_vecs = rng.normal(size=(g_n, d)).astype(np.float32)
    g_store = VectorStore(dim=d, metric="euclidean", device=dev)
    g_slots = g_store.add_batch([f"g{i}" for i in range(g_n)], g_vecs)
    graph = ShardedHNSWIndex(g_store, mesh, ef_search=32, build_batch=256)
    graph.on_insert(g_slots, g_vecs)
    _, gi = graph.search_slots(g_vecs[:8], k=3)
    g_hits = float((gi[:, 0] == np.arange(8)).mean())
    assert g_hits >= 0.8, f"sharded graph query broken: self-recall {g_hits}"
    w_vecs = (g_vecs[:4] + 0.01 * rng.normal(size=(4, d))).astype(np.float32)
    w_slots = g_store.add_batch([f"w{j}" for j in range(4)], w_vecs)
    graph.on_insert(np.asarray(w_slots), w_vecs)
    _, wi = graph.search_slots(w_vecs, k=1)
    assert (wi[:, 0] == np.asarray(w_slots)).mean() >= 0.75, "graph write broken"

    # 6. the cluster-sharded IVF engine, and a refresh on its shards
    i_n = 256 * n_shards
    centers = 4.0 * rng.normal(size=(16, d)).astype(np.float32)
    i_vecs = (centers[rng.integers(0, 16, i_n)]
              + 0.2 * rng.normal(size=(i_n, d))).astype(np.float32)
    i_store = VectorStore(dim=d, metric="euclidean", device=dev)
    i_slots = i_store.add_batch([f"i{j}" for j in range(i_n)], i_vecs)
    ivf = ShardedIVFIndex(i_store, mesh, config=IVFConfig(
        n_clusters=32, n_probe=8, build_threshold=256, rescore=False))
    ivf.on_insert(i_slots, i_vecs)
    assert ivf._built, "sharded IVF did not build"
    _, ii = ivf.search_slots(i_vecs[:8], k=3)
    i_hits = float((ii[:, 0] == np.arange(8)).mean())
    assert i_hits >= 0.8, f"sharded IVF query broken: self-recall {i_hits}"
    live_before = ivf._cluster_live.copy()
    ivf.refresh()
    assert ivf._built and np.array_equal(ivf._cluster_live, live_before)
    _, ii = ivf.search_slots(i_vecs[:8], k=3)
    assert (ii[:, 0] == np.arange(8)).mean() >= 0.8, "post-refresh query broken"
    return {"n_shards": n_shards, "mesh": [str(m) for m in mesh], "self_hits": self_hits,
            "graph_self_hits": g_hits, "ivf_self_hits": i_hits}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_shards", type=int, nargs="?", default=None,
                    help="shards round-robin over the cards (default: one per card)")
    ap.add_argument("--mesh", default=None, help="comma-separated devices, e.g. cuda:0,cpu")
    ap.add_argument("--device", default="cuda", help="the stores' device")
    a = ap.parse_args()
    mesh = a.mesh.split(",") if a.mesh else a.n_shards
    print(dryrun_multichip(mesh, a.device))


if __name__ == "__main__":
    main()
