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
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_ab: CUDA is not available", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--turn":
        print(json.dumps(turn(argv[1])), flush=True)
        return 0
    from quiver_tpu_torch.benches.common import card

    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    turns = int(argv[1]) if len(argv) == 2 else 3
    pattern = (("other", other), ("this", HERE), ("this", HERE), ("other", other))
    order = [pattern[i % 4] for i in range(2 * turns)]
    runs = []
    for tag, root in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": tag, **rec}), flush=True)
        runs.append((tag, rec["ms"]))
    table = {key: {"other": [ms[key] for tag, ms in runs if tag == "other"],
                   "this": [ms[key] for tag, ms in runs if tag == "this"]}
             for key in runs[0][1]}
    print(json.dumps({"order": [tag for tag, _ in runs], "ms": table, "card": card()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
