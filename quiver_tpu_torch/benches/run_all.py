"""Every bench of the port on one CUDA card, in the reference's order
(``benches/run_all.py``).

    python -m quiver_tpu_torch.benches.run_all

First the headline bench (``python -m quiver_tpu_torch.bench``) in its own
process, then each module of :data:`MODULES` in this process, as
``python -m`` runs it; every module prints its JSON lines. A failure (a
non-zero exit of the headline bench, an exception or a non-zero
``SystemExit`` of a module) is reported on its own line and the run goes
on; the run exits 1 at its end if anything failed. The reference prints
"failed" and exits 0 all the same (``run_all.py:43-44``).

``bench_skew`` runs apart, as in the reference (``python -m
quiver_tpu_torch.benches.bench_skew``). Without CUDA it exits non-zero
before printing a result.
"""

from __future__ import annotations

import gc
import os
import runpy
import subprocess
import sys
import traceback

import torch

from quiver_tpu_torch.benches.common import require_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the reference's list (``run_all.py:19-31``) under the port's names
MODULES = [
    "quiver_tpu_torch.benches.bench_hnsw",
    "quiver_tpu_torch.benches.bench_ivf",
    "quiver_tpu_torch.benches.bench_hybrid",
    "quiver_tpu_torch.benches.bench_filtered",
    "quiver_tpu_torch.benches.bench_persistence",
    "quiver_tpu_torch.benches.streaming",
    "quiver_tpu_torch.benches.churn",
    "quiver_tpu_torch.benches.bench_latency",
    "quiver_tpu_torch.benches.bench_api",
    "quiver_tpu_torch.benches.bench_memory",
    "quiver_tpu_torch.benches.bench_10m",
]


def run_module(mod: str) -> str | None:
    """Run ``mod`` as ``python -m`` would, with no arguments; returns None,
    or what failed."""
    argv = sys.argv
    sys.argv = [mod]
    try:
        runpy.run_module(mod, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (None, 0):
            return f"exit {e.code}"
    except Exception as e:  # noqa: BLE001 - reported, then the next module runs
        traceback.print_exc()
        return f"{type(e).__name__}: {e}"
    finally:
        sys.argv = argv
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return None


def main(modules=None, headline: bool = True) -> int:
    """Run the headline bench (``headline``) and ``modules`` (default
    :data:`MODULES`); returns the number that failed."""
    failed = []
    if headline:
        rc = subprocess.run([sys.executable, "-m", "quiver_tpu_torch.bench"], cwd=ROOT).returncode
        if rc != 0:
            print(f"--- quiver_tpu_torch.bench FAILED rc={rc}", flush=True)
            failed.append("quiver_tpu_torch.bench")
    for mod in MODULES if modules is None else modules:
        print(f"--- {mod}", flush=True)
        why = run_module(mod)
        if why is not None:
            print(f"--- {mod} FAILED: {why}", flush=True)
            failed.append(mod)
    if failed:
        print(f"--- {len(failed)} failed: {', '.join(failed)}", flush=True)
    return len(failed)


if __name__ == "__main__":
    require_cuda("quiver_tpu_torch.benches.run_all")
    sys.exit(1 if main() else 0)
