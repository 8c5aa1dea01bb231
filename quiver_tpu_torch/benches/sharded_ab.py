"""The sharded IVF engine on one card and the single-card slice: this
checkout against another, timed on one card in turns.

    python -m quiver_tpu_torch.benches.sharded_ab OTHER_ROOT [TURNS]

``OTHER_ROOT`` is another checkout of the repository, for example the
parent commit unpacked with ``git archive``. One process runs each turn,
in the order other, this, this, other, then again (``TURNS`` turns of
each, default 3: other, this, this, other, other, this); each imports
``quiver_tpu_torch`` and ``chip_smoke`` from its own root and builds its
own kernels there. A turn builds the 1M headline corpus (``bench.py``'s
generator), times the single-card headline engine at B=65536 (CUDA
events, three rounds of 10 batches, ``benches/common.py::cuda_ms``), then
runs that root's ``chip_smoke.phase_sharded_ivf`` at 10 timed batches: 4
shards on the card, ms per batch at B=65536 and 2048, one batch's probe,
per-shard and merge spans, the sharded exact scan, bytes per shard, with
the phase's own gates. Each turn prints one JSON line; the last line holds
each measurement's readings in turn order and the card's name and power
limit. Without CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import json
import os
import sys



def turn(root: str) -> dict:
    """One turn's readings, with ``quiver_tpu_torch`` and ``chip_smoke``
    imported from ``root`` (in place of this file's directory, the
    process's first import path)."""
    sys.path[0] = root
    import torch

    import chip_smoke as cs
    from quiver_tpu_torch.bench import B_ORACLE, RECALL_TARGET, build_engine, make_queries
    from quiver_tpu_torch.bench import B as B_SERVE
    from quiver_tpu_torch.benches.common import K, N, clustered, cuda_ms, oracle_kth

    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(root):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    vecs = clustered(N)
    oracle_q, qb = make_queries(vecs, B_SERVE, B_ORACLE)
    kth = oracle_kth(dev, oracle_q, vecs, K)
    eng = build_engine(vecs, dev, recall_target=RECALL_TARGET, log=lambda _: None)
    qdev = torch.from_numpy(qb).to(dev)
    single = [cuda_ms(lambda: eng.search_slots_device(qdev, K), 10) for _ in range(3)]
    del eng, qdev
    torch.cuda.empty_cache()
    out = cs.phase_sharded_ivf(torch, dev, vecs, oracle_q, kth, reps=10)
    big, small = out[f"B{B_SERVE}"], out["B2048"]
    return {"root": root, "ms": {
        "single B=65536": min(single),
        "sharded B=65536": big["ms"],
        "sharded B=65536 probe": big["probe_ms"],
        "sharded B=65536 slowest shard": max(big["shard_ms"]),
        "sharded B=65536 merge": big["merge_ms"],
        "sharded B=2048": small["ms"],
        "sharded exact B=2048": out["exact"]["ms"],
    }, "recall": out["recall"], "shard_bytes": out["shard_bytes"]}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2])), flush=True)
    else:
        from quiver_tpu_torch.benches.common import ab_main

        sys.exit(ab_main(sys.argv[1:], __file__, __doc__, turns=3))
