"""``block_topw``'s row mode (the per-pair top-R branch): this checkout's
kernels against another checkout's, timed on one card in turns.

    python -m quiver_tpu_torch.benches.row_topr_ab OTHER_ROOT

``OTHER_ROOT`` is another checkout of the repository, for example the
parent commit unpacked with ``git archive``, or a copy with other tuning
constants. One process runs each turn, in the order other, this, this,
other (``benches/common.py::ab_main``); each imports ``quiver_tpu_torch``
and ``chip_smoke`` from its own root and builds its own kernels there.

A turn times with CUDA events (``benches/common.py::cuda_ms``, 10 launches)
row mode over bf16 and f32 blocks at R in {16, 64, 100, 128}, B=65536,
P=3, K=1405, Cmax=1280, d=128, on ``chip_smoke.kernel_inputs``' L2
operands, each beside its bound (``benches/common.py::topw_bound`` at the
card's peaks). Then the k=100 batch end to end: the 1M headline corpus in
the headline engine (bf16 blocks) and in one with f32 blocks (the
database's default), n_probe=2, ``search_slots_device`` of B=4096 queries
at k=100 (the per-pair branch, R=100), and the ``block_topw`` call that
batch makes, on its own operands (captured from the batch): by CUDA
events, and as the device time of the library's kernels alone (the query
gather and ``block_topw``, from the profiler's trace,
``benches/common.py::kernel_ms``). Then the row-mode calls at R=16 over
f32 blocks that the databases of ``chip_smoke.py`` phases 9b and 12e
make: a ``hybrid`` and a ``sharded_hybrid`` (4 shards) database of the
corpus's first 65,536 rows, inserted in batches of 8192, answering 256
queries at k=10. Each of those calls is captured (``chip_smoke.LiveCheck``)
and timed again on its own operands, both ways; the record holds the sums
of their times, their count and their shapes. Each turn prints one JSON
line; the last line holds each measurement's times in turn order, the
bounds, and the card's name and power limit. Without CUDA it exits 1
before printing a result.
"""

from __future__ import annotations

import json
import sys

#: row mode's R bands (the kernels' lists of 32, 64, 112 and 128 entries)
ROW_RS = (16, 64, 100, 128)
#: phases 9b / 12e: the databases' rows, insert batch and queries
DB_ROWS, DB_BATCH, DB_QUERIES = 65536, 8192, 256


def turn(root: str) -> dict:
    """One turn's times, with ``quiver_tpu_torch`` and ``chip_smoke``
    imported from ``root`` (in place of this file's directory, the
    process's first import path)."""
    sys.path[0] = root
    import os

    import torch

    import chip_smoke as cs
    from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
    from quiver_tpu_torch.bench import make_queries
    from quiver_tpu_torch.benches.common import N, clustered, cuda_ms, kernel_ms, topw_bound
    from quiver_tpu_torch.ops import ivf_cuda, ivf_kernels

    def lib_ms(fn) -> float:
        """Device ms per call of the kernel library's launches in ``fn``
        (the query gather and ``block_topw``; the wrapper's torch ops
        apart), from the profiler's trace of 10 calls."""
        by_name, _ = kernel_ms(fn, 10)
        ms = sum(ms for name, ms in by_name.items()
                 if name.startswith(("block_topw", "gather_queries")))
        if not ms:
            raise RuntimeError(f"no kernel of the library in the trace: {sorted(by_name)}")
        return ms

    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(root):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    peaks = cs.card_peaks(torch)
    times, bounds, shapes = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for R in ROW_RS:
            args, kw = cs.kernel_inputs(torch, dev, P=3, metric="euclidean", variant="row",
                                        seed=3000 + len("euclidean"), dtype=dtype,
                                        **cs.KERNEL_SHAPE)
            W, pos_bits, sentinel = cs.variant_args("row", 0, R, 0, cs.KERNEL_SHAPE["Cmax"])
            kw.update(W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)
            key = f"row {name} R={R}"
            out = ivf_cuda.block_topw(*args, **kw)
            bounds[key] = topw_bound(args, kw, out, peaks)
            times[key] = cuda_ms(lambda: ivf_cuda.block_topw(*args, **kw), 10)
            del args, kw, out
            torch.cuda.empty_cache()
    vecs = clustered(N)
    qdev = torch.from_numpy(make_queries(vecs, 4096, 2048)[1]).to(dev)
    store = VectorStore(dim=vecs.shape[1], metric="euclidean", capacity=N, device=dev)
    store.add_batch([f"v{i}" for i in range(N)], vecs)
    for dtype in (torch.bfloat16, torch.float32):
        eng = IVFIndex(store, config=IVFConfig(
            n_clusters=1024, n_probe=2, q_cap_factor=2, kmeans_iters=8, build_threshold=1024,
            rescore=False), compute_dtype=dtype)
        eng.build()
        name = str(dtype).split(".")[-1]
        times[f"k=100 B=4096 {name}"] = cuda_ms(lambda: eng.search_slots_device(qdev, 100), 10)
        calls, real = [], ivf_kernels.block_topw
        ivf_kernels.block_topw = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
        try:
            eng.search_slots_device(qdev, 100)
        finally:
            ivf_kernels.block_topw = real
        (a, kw), = calls
        times[f"k=100 B=4096 {name} kernel"] = cuda_ms(lambda: ivf_cuda.block_topw(*a, **kw), 10)
        times[f"k=100 B=4096 {name} kernel device"] = lib_ms(
            lambda: ivf_cuda.block_topw(*a, **kw))
        del eng, calls, a, kw
        torch.cuda.empty_cache()
    del store
    rows = vecs[:DB_ROWS]
    for engine in ("hybrid", "sharded_hybrid"):
        row16 = db_row_calls(dev, rows, engine, 16)
        key = f"{engine} db f32 row R=16"
        times[key] = sum(cuda_ms(lambda: ivf_cuda.block_topw(*a, **kw), 10) for a, kw in row16)
        times[f"{key} device"] = sum(lib_ms(lambda: ivf_cuda.block_topw(*a, **kw))
                                     for a, kw in row16)
        shapes[key] = {"calls": len(row16), "(M, P, Cmax)": sorted(
            {(int(a[3].shape[0]), kw["P"], int(a[4].shape[2])) for a, kw in row16})}
        del row16
        torch.cuda.empty_cache()
    return {"root": root, "ms": times, "bound": bounds, "db calls": shapes}


def db_row_calls(dev, rows, engine: str, R: int) -> list:
    """The row-mode ``block_topw`` calls at ``R`` over f32 blocks, as
    (args, kwargs) on cloned operands, that a database of ``engine``
    (``hybrid``, or ``sharded_hybrid`` over ``chip_smoke.SHARDS`` shards)
    on ``dev`` makes while ``rows`` are inserted in batches of
    ``DB_BATCH`` and it answers ``DB_QUERIES`` queries at k=10 (phases 9b
    and 12e of ``chip_smoke.py``). Raises when it makes none."""
    import torch

    import chip_smoke as cs
    from quiver_tpu_torch import DB, DBOptions
    from quiver_tpu_torch.bench import make_queries
    from quiver_tpu_torch.ops import ivf_cuda
    from quiver_tpu_torch.types import SearchRequest

    ids = [f"v{i}" for i in range(len(rows))]
    queries = make_queries(rows, DB_QUERIES, DB_QUERIES)[0]
    sharded = engine.startswith("sharded")
    db = DB(DBOptions(enable_persistence=False, device=str(dev), default_engine=engine,
                      engine_config={"mesh": cs.SHARDS} if sharded else {}))
    try:
        with cs.LiveCheck() as live:
            coll = db.create_collection("s", rows.shape[1], "euclidean",
                                        engine_config={"ivf": cs.DB_IVF})
            for at in range(0, len(rows), DB_BATCH):
                db.batch_insert("s", ids[at:at + DB_BATCH], rows[at:at + DB_BATCH])
            if not coll.engine.ann.wait_maintenance(timeout=300):
                raise RuntimeError(f"{engine}: background maintenance did not finish")
            db.batch_search("s", [SearchRequest(vector=q, top_k=10) for q in queries])
    finally:
        db.close()
    calls = [(a, kw) for a, kw, _ in live.calls
             if a[4].dtype == torch.float32 and kw["R"] == R
             and (kw["W"], kw["R"]) not in ivf_cuda.CUDA_VARIANTS]
    if not calls:
        raise RuntimeError(f"{engine}: no row-mode call at R={R} over f32 blocks")
    return calls


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2])), flush=True)
    else:
        from quiver_tpu_torch.benches.common import ab_main

        sys.exit(ab_main(sys.argv[1:], __file__, __doc__))
