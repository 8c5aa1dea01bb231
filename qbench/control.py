"""The control of ``correct``: the plain reference put in the program's
place, computed one precision below the one the configuration states
(its ``control`` key: "fp8" below bf16 blocks, "tf32" below float32), has
to come out not correct.

    python3 -m qbench.control --workload <cell> --seeds 1,2,3

For each seed it makes the cell's corpus and as many queries as a run
judges, answers them with the lower-precision reference (its ids and the
distances it computed), and prints the judge's numbers against the
configuration's limits, one JSON line a seed. It runs on the card when
there is one; the tests run it small on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from qbench import manifest
from qbench.reference import exact, judge


def readings(cell: manifest.Cell, seed: int, device, root=manifest.ROOT) -> dict:
    """The judge's numbers of the control on ``cell`` at ``seed``, and its
    verdict against the configuration's limits."""
    cfg, tr = cell.config, cell.traffic
    k, m = tr["k"], tr["judge"]
    corpus, queries = manifest.family(cfg["data"]["family"], root).make(
        cfg["data"], cfg["n"], cfg["d"], m, *manifest.generators(cfg, seed, device))
    ids, dists = exact.topk(corpus, queries, k, cfg["metric"], rounding=cfg["control"])
    ans = judge.Answers(np.arange(m), ids.cpu().numpy(), dists.cpu().numpy(), np.zeros(m, bool))
    nums = judge.numbers(corpus, queries, ans, k, cfg["metric"])
    ok, checks = judge.verdict(nums, cfg["check"])
    return {"workload": cell.name, "seed": seed, "control": cfg["control"], "correct": ok,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = manifest.cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), dev)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
