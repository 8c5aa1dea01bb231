"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes: one ``nvcc`` per source, all
started together, then one link. The build runs at first use,
into ``quiver_tpu_torch/_build/<hash>/`` (git-ignored), keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads the library already built. A build is a ``kernels.build`` span and
one info line of the port's logger (library, sources, seconds). Nothing
here runs at import time.

Run ``python -m quiver_tpu_torch._build`` to build ahead of use; it prints
the library path and the build seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from quiver_tpu_torch.observability.logging import info
from quiver_tpu_torch.utils.profiling import trace_span

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
    # each source's kernels compile on all the host's cores: nvcc's front
    # end over row mode's unrolled merges (csrc/row_topr.cuh) sets the
    # build's time
    "--split-compile=0",
)
LIB_NAME = "libquiver_tpu_torch_kernels.so"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build(verbose: bool = False) -> tuple[Path, float]:
    """(library path, build seconds); 0 seconds when already built."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    with trace_span("kernels.build", len(_sources())) as span:
        _compile(out_dir, lib, verbose)
    info("kernels built", library=str(lib), sources=[src.name for src in _sources()],
         seconds=round(span.seconds, 1))
    return lib, span.seconds


def _compile(out_dir: Path, lib: Path, verbose: bool) -> None:
    nvcc = _nvcc()
    # build into a private directory, then rename the library: concurrent
    # build processes never load a half-written one
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs, procs = [], []
        for src in _sources():
            obj = tmp_dir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            objs.append(obj)
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        so = tmp_dir / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so), *map(str, objs)],
            capture_output=True, text=True,
        ) if all(p.returncode == 0 for p in procs) else None
        if link is None or link.returncode != 0:
            detail = "\n".join(logs) + ("" if link is None else link.stdout + link.stderr)
            raise RuntimeError(f"nvcc failed:\n{detail}")
        if verbose:
            print("".join(logs), flush=True)
        os.replace(so, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built if needed and bound (argtypes set by each
    ops module for its own entries)."""
    from quiver_tpu_torch.ops import hnsw_cuda, ivf_cuda, probe_cuda

    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for mod in (ivf_cuda, probe_cuda, hnsw_cuda):
        mod.bind(lib)
    return lib


if __name__ == "__main__":
    path, secs = build(verbose=True)
    print(f"built {path} in {secs:.1f} s")
