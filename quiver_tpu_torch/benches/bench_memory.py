"""Card bytes per vector, engine by engine (``benches/bench_memory.py``).

    python -m quiver_tpu_torch.benches.bench_memory [--n N]

Each engine is built over the same 200,000 x 128-d clustered corpus
(:func:`clustered`, bit-identical to the reference's) and reports its
card footprint from ``device_bytes()`` (``utils/memory.py``): the
engine's own tensors (blocks, graph, masks), the store's device view it
shares, and bytes per vector. The engines are the reference's:

* exact: the store's device view alone (vectors, norms, validity);
* IVF: ``IVFConfig(n_clusters=512, n_probe=3, kmeans_iters=6,
  build_threshold=1024)``, bf16 blocks;
* HNSW: M=16, ``build_batch=8192``, bf16 construction products.

The store keeps the reference's {2^k, 3*2^(k-1)} capacity ladder
(``core/store.py::_next_cap``: 262,144 slots for 200,000 rows), so the
store's share of bytes per vector is the reference's. Each line also
carries ``max_n_per_card``: the usable card memory (``USABLE_FRACTION``
of ``torch.cuda.get_device_properties(0).total_memory``, the rest left
to the allocator's scratch and the serving batch's temporaries) over
bytes per vector, and the card's name and power limit.

Not ported: the ``QUIVER_BENCH_MEM_N`` variable (``--n`` and ``run``'s
argument). Without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from quiver_tpu_torch.benches.common import card, emit, require_cuda

N_MEM, D = 200_000, 128
#: the share of the card's memory an index may hold; the rest is the
#: serving batch's scratch (a B=65536 IVF batch at 1M rows peaks near 6 GB
#: above the resident engine on an 80 GB card)
USABLE_FRACTION = 0.9


def clustered(n, seed=0):
    """1000 Gaussian centers in 128-d, sigma 0.25: bit-identical to
    ``benches/bench_memory.py:21-26``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(1000, D)).astype(np.float32)
    which = rng.integers(0, 1000, n)
    return (centers[which] + 0.25 * rng.normal(size=(n, D))).astype(np.float32)


def usable_bytes(device: torch.device) -> int | None:
    """The card memory an index may hold (:data:`USABLE_FRACTION` of the
    total); None off the card."""
    if device.type != "cuda":
        return None
    return int(USABLE_FRACTION * torch.cuda.get_device_properties(device).total_memory)


def run(device, *, n=N_MEM, emit_rows=True) -> list[dict]:
    """The three audit lines on ``device``; returns them (and emits them)."""
    from quiver_tpu_torch.benches.bench_hnsw import build as build_hnsw
    from quiver_tpu_torch.core.store import VectorStore
    from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex
    from quiver_tpu_torch.utils.memory import store_device_bytes

    device = torch.device(device)
    cuda = device.type == "cuda"
    usable = usable_bytes(device)
    extra = dict(backend=f"torch-{device.type}", card=card() if cuda else None,
                 usable_bytes=usable)
    vecs = clustered(n)
    rows = []

    def audit(name, mem, tail=""):
        per = mem["per_vector"]
        rows.append(dict(
            metric=f"device memory, {name} (N={n} x {D}-d{tail})",
            value=mem["total"] / 2**20, unit="MiB",
            engine_mib=round(mem["engine"] / 2**20, 1), store_mib=round(mem["store"] / 2**20, 1),
            bytes_per_vector=per, max_n_per_card=None if usable is None else int(usable // per),
            **extra))

    store = VectorStore(dim=D, metric="euclidean", device=device)
    slots = store.add_batch([f"v{i}" for i in range(n)], vecs)
    store.device_view()  # the exact engine's footprint is the materialized view
    st = store_device_bytes(store)
    audit("exact", {"total": st, "engine": 0, "store": st, "per_vector": round(st / n, 1)})

    ivf = IVFIndex(store, config=IVFConfig(n_clusters=512, n_probe=3, kmeans_iters=6,
                                           build_threshold=1024))
    ivf.on_insert(np.asarray(slots), vecs)
    audit("ivf", ivf.device_bytes(), ", K=512 bf16 blocks")
    del ivf, store

    _, g, _ = build_hnsw(device, vecs)
    audit("hnsw", g.device_bytes(), ", M=16")
    if emit_rows:
        for r in rows:
            emit(**r)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="quiver_tpu_torch.benches.bench_memory")
    ap.add_argument("--n", type=int, default=N_MEM)
    args = ap.parse_args(argv)
    run(require_cuda("quiver_tpu_torch.benches.bench_memory"), n=args.n)


if __name__ == "__main__":
    main()
