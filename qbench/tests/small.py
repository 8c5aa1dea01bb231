"""A copy of the benchmark at sizes a CPU test holds: the same files,
configurations and mixes, cut in rows, batch and window."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from qbench import manifest

REPO = manifest.ROOT.parent

#: per configuration: what the copy changes (the widths of the sift
#: configuration are kept, so its bf16 blocks round as at full size)
CONFIGS = {
    "sift1m-ivf-bf16": {"n": 8192, "data": {"n_centers": 64}, "serving.ivf": {"n_clusters": 64}},
}
TRAFFIC = {
    "batch64k": {"batch": 256, "pool_batches": 2, "judge": 64, "warm_calls": 1},
    "k100": {"batch": 128, "pool_batches": 2, "judge": 64, "warm_calls": 1},
}
SECONDS = 1.0


def copy(dst: Path) -> Path:
    """The benchmark copied under ``dst``, cut to CPU sizes; returns the
    copy's ``qbench`` folder, the ``root`` of the manifest's lookups."""
    shutil.copytree(REPO / "qbench", dst / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    root = dst / "qbench"
    for name, cut in CONFIGS.items():
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        for key, val in cut.items():
            node = cfg
            for part in key.split(".")[:-1]:
                node = node[part]
            last = key.split(".")[-1]
            node[last] = dict(node[last], **val) if isinstance(val, dict) else val
        path.write_text(json.dumps(cfg))
    for name, cut in TRAFFIC.items():
        path = manifest.traffic_path(name, root)
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    return root
