"""The probes of ``benches/probe_pallas.py`` on one CUDA card, through the
port's two kernels (``ops/probe_cuda.py``).

    python -m quiver_tpu_torch.benches.probe

1. ``scatter_rows`` (the scatter-store probe, ``probe_pallas.py:26-95``) at
   the TPU probe's own shape: nchunks=2, K=64, BPc=1024, 128 lanes, the
   same numpy inputs (seed 0, pair i of a chunk in cluster i // (BPc/K),
   a random permutation of targets per chunk). Prints
   ``probe scatter: OK``.
2. ``index_read`` (the large scalar-prefetch probe, ``:97-119``) at its
   shape: ``big = arange(65536)`` i32, grid 4, stride 1000. Prints
   ``probe index-read: 3000.0 (expect 3000.0)``.
3. Both again at the main path's shape: ``scatter_rows`` over one chunk of
   BPc = 65536 x 3 = 196,608 rows x 128 lanes (~100 MB read and written),
   with ``starts`` from a stable sort of probe ids over K=1405 clusters
   (uneven, as the slice's are) and the pair order as targets: the write
   ``block_topw`` makes to each pair's original row; ``index_read`` with
   ``big`` = that pair order (196,608 i32, 768 KB, above the TPU's
   scalar-prefetch bound) and ceil(196,608 / 64) = 3,072 grid steps at
   stride 64, one per tile of pairs, each reading its tile's first pair
   index as ``block_topw``'s blocks do.

Each result is asserted: against the probe's own expectation and against
the kernel's plain PyTorch version (exactly: the kernels copy and double
floats, which is exact). Then kernel and plain version are timed at the
main path's shape (:func:`time_probes`): ``scatter_rows`` by CUDA events,
also at uniform clusters and beside PyTorch's own scatter of the same rows;
``index_read`` as device time from a CUDA graph replay, beside its launch
floor at one grid step and the wrapper's host cost per call. Without CUDA
it exits non-zero before printing a result; its functions take a device,
so tests call them on the CPU, where the wrappers run the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from quiver_tpu_torch.benches.common import (
    clustered,
    device_ms,
    graph_ms,
    host_us,
    kernel_ms,
    require_cuda,
)
from quiver_tpu_torch.ops.probe_cuda import (
    index_read,
    index_read_reference,
    scatter_rows,
    scatter_rows_reference,
)

#: the TPU probe's shapes (probe_pallas.py:28, 98, 103-110)
TPU_SCATTER = dict(nchunks=2, K=64, BPc=1024)
TPU_BIG_N, TPU_GRID, TPU_STRIDE = 65536, 4, 1000
LANES = 128
#: the main path's shape: B=65536 queries x n_probe=3 over K~1400 clusters
MAIN_B, MAIN_P, MAIN_K = 65536, 3, 1405
#: pairs per tile of block_topw (csrc/ivf_block_topw.cu, TQ)
TILE = 64


def tpu_scatter_inputs(nchunks, K, BPc):
    """The numpy inputs of probe_pallas.py:31-38, and the expected output
    of probe_pallas.py:90-92."""
    rng = np.random.default_rng(0)
    gs = BPc // K
    starts = np.arange(K + 1, dtype=np.int32) * gs
    starts_all = np.tile(starts, (nchunks, 1)).reshape(-1)
    perm = np.stack([rng.permutation(BPc) for _ in range(nchunks)])
    pair_pos = perm.astype(np.int32).reshape(-1)
    vals = rng.normal(size=(nchunks, BPc, LANES)).astype(np.float32)
    want = np.empty_like(vals)
    for c in range(nchunks):
        want[c, perm[c]] = vals[c] * 2.0
    return starts_all, pair_pos, vals, want


def synthetic_probe(device, *, B=MAIN_B, P=MAIN_P, K=MAIN_K, seed=0):
    """i64[B, P] probe ids from the engine's probe selection
    (``ops/ivf_kernels.probe_stage``) over K centroids drawn from the
    headline corpus, for B jittered corpus queries: uneven clusters, as the
    slice's are."""
    from quiver_tpu_torch.ops.ivf_kernels import probe_stage

    vecs = clustered(max(4 * K, B), seed=seed)
    rng = np.random.default_rng(seed + 1)
    cents = torch.from_numpy(vecs[rng.choice(len(vecs), K, replace=False)]).to(device)
    q = vecs[rng.integers(0, len(vecs), B)] + 0.1 * rng.normal(size=(B, vecs.shape[1]))
    q = torch.from_numpy(q.astype(np.float32)).to(device)
    _, _, probe, _ = probe_stage(q, cents, (cents * cents).sum(1), "euclidean", P, 0.99)
    return probe


def main_inputs(probe: torch.Tensor, K: int, *, seed=0):
    """Operands at the main path's shape from probe ids i64[B, P]: one
    chunk of B*P rows in cluster order (stable sort of the pairs), the pair
    order as targets, random rows; and index_read's pair order, grid and
    stride."""
    dev = probe.device
    flat_c = probe.reshape(-1)
    BP = flat_c.shape[0]
    order = torch.argsort(flat_c, stable=True).to(torch.int32)
    starts = torch.zeros(K + 1, dtype=torch.int32, device=dev)
    starts[1:] = torch.cumsum(torch.bincount(flat_c, minlength=K), 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randn(1, BP, LANES, generator=g, device=dev)
    scatter = dict(vals=vals, starts=starts, pos=order, K=K)
    read = dict(big=order, x=torch.zeros(1, 1, device=dev),
                grid=(BP + TILE - 1) // TILE, stride=TILE)
    return scatter, read


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def run_probes(device, *, probe=None, K=MAIN_K, log=print) -> dict:
    """Both probes at the TPU probe's shapes and at the main path's shape,
    each held against its expectation and its plain version (exact).
    ``probe``: the main path's probe ids (default :func:`synthetic_probe`).
    Returns per-kernel records (``max_abs_err`` over both shapes) and the
    main-shape operands (``main``) for :func:`time_probes`."""
    device = torch.device(device)
    st, pos, vals, want = tpu_scatter_inputs(**TPU_SCATTER)
    args = dict(vals=torch.from_numpy(vals).to(device), starts=torch.from_numpy(st).to(device),
                pos=torch.from_numpy(pos).to(device), K=TPU_SCATTER["K"])
    out = scatter_rows(**args)
    err_s = _max_abs_err(out, scatter_rows_reference(**args))
    ok = bool(np.array_equal(out.cpu().numpy(), want)) and err_s == 0.0
    log(f"probe scatter: {'OK' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"scatter_rows differs at the TPU probe's shape (max_abs_err {err_s})")

    big = torch.arange(TPU_BIG_N, dtype=torch.int32, device=device)
    x = torch.zeros(1, 1, device=device)
    got = index_read(big, x, grid=TPU_GRID, stride=TPU_STRIDE)
    err_r = _max_abs_err(got, index_read_reference(big, x, grid=TPU_GRID, stride=TPU_STRIDE))
    value = float(got[0, 0])
    log(f"probe index-read: {value} (expect 3000.0)")
    if value != 3000.0 or err_r != 0.0:
        raise AssertionError(f"index_read gave {value}, expected 3000.0")

    if probe is None:
        probe = synthetic_probe(device, K=K)
    scatter, read = main_inputs(probe, K)
    BP = scatter["pos"].shape[0]
    out = scatter_rows(**scatter)
    e = _max_abs_err(out, scatter_rows_reference(**scatter))
    direct = torch.empty_like(scatter["vals"])
    direct[0, scatter["pos"].long()] = 2.0 * scatter["vals"][0]
    if e != 0.0 or not torch.equal(out, direct):
        raise AssertionError(f"scatter_rows differs at the main path's shape (max_abs_err {e})")
    err_s = max(err_s, e)
    counts = (scatter["starts"][1:] - scatter["starts"][:-1]).float()
    log(f"probe scatter (main path: 1 chunk x {BP} rows x {LANES} lanes, K={K}, "
        f"rows per cluster mean {float(counts.mean())!r} max {int(counts.max())}): "
        f"OK max_abs_err={e!r}")
    got = index_read(**read)
    expect = float(read["big"][(read["grid"] - 1) * read["stride"]])
    e = _max_abs_err(got, index_read_reference(**read))
    log(f"probe index-read (main path: big={BP} i32, grid={read['grid']}, "
        f"stride={read['stride']}): {float(got[0, 0])} (expect {expect})")
    if float(got[0, 0]) != expect or e != 0.0:
        raise AssertionError("index_read differs at the main path's shape")
    err_r = max(err_r, e)
    return {
        "scatter_rows": {"max_abs_err": err_s},
        "index_read": {"max_abs_err": err_r},
        "main": (scatter, read),
    }


def uniform_starts(starts: torch.Tensor, BPc: int) -> torch.Tensor:
    """Starts of K equal clusters over the same chunk, ``arange(K+1) *
    (BPc // K)``: the layout beside which the slice's uneven one is timed
    (the last ``BPc % K`` rows are in no range)."""
    K = starts.shape[0] - 1
    return (torch.arange(K + 1, device=starts.device) * (BPc // K)).to(torch.int32)


def time_probes(device, main, *, reps=20, log=print) -> dict:
    """Kernel and plain version at the main path's shape, ms per call.

    ``scatter_rows`` by CUDA events over back-to-back calls (``ms``), the
    same at uniform clusters (``uniform_ms``, :func:`uniform_starts`), and
    PyTorch's own scatter of the same rows (``torch_scatter_ms``: a multiply
    and an indexed store, without the ranges). ``index_read`` takes a few
    microseconds on the card, less than the wrapper's host cost, so its
    ``ms`` is device time from a CUDA graph replay (``graph_ms``), beside
    its launch floor at one grid step timed the same way (``floor_ms``) and
    the host µs per call (``host_us``). On CUDA it also logs
    ``scatter_rows``'s device time by pass (``kernel_ms``). On the CPU
    (tests) every time is the host clock's. Returns {name: record}."""
    device = torch.device(device)
    scatter, read = main
    BPc = scatter["vals"].shape[1]
    uniform = dict(scatter, starts=uniform_starts(scatter["starts"], BPc))
    vals, tgt = scatter["vals"], scatter["pos"].long()

    def torch_scatter():
        out = torch.empty_like(vals)
        out[0, tgt] = 2.0 * vals[0]

    rec = {
        "scatter_rows": {
            "ms": device_ms(device, lambda: scatter_rows(**scatter), reps),
            "uniform_ms": device_ms(device, lambda: scatter_rows(**uniform), reps),
            "torch_scatter_ms": device_ms(device, torch_scatter, reps),
            "plain_ms": device_ms(device, lambda: scatter_rows_reference(**scatter), reps),
        },
        "index_read": {
            "host_us": host_us(device, lambda: index_read(**read), reps),
            "ms": graph_ms(device, lambda: index_read(**read), reps),
            "floor_ms": graph_ms(device, lambda: index_read(**dict(read, grid=1)), reps),
            "plain_ms": device_ms(device, lambda: index_read_reference(**read), reps),
        },
    }
    if device.type == "cuda":
        passes, _ = kernel_ms(lambda: scatter_rows(**scatter), reps)
        log("probe scatter_rows passes (device ms per call): " + "; ".join(
            f"{name.split('(')[0]} {ms!r}" for name, ms in sorted(passes.items(), key=lambda kv: -kv[1])))
    s, r = rec["scatter_rows"], rec["index_read"]
    log(f"probe scatter_rows yardstick: torch scatter of the same rows "
        f"(out[0, pos] = 2 * vals[0]) ms={s['torch_scatter_ms']!r}")
    log(f"probe index_read host: us_per_call={r['host_us']!r} (the wrapper's host cost)")
    log(f"probe scatter_rows (main path shape): kernel_ms={s['ms']!r} "
        f"uniform_clusters_ms={s['uniform_ms']!r} plain_ms={s['plain_ms']!r}")
    log(f"probe index_read (main path shape, grid={read['grid']}): device_ms={r['ms']!r} "
        f"floor_ms={r['floor_ms']!r} (grid=1) plain_ms={r['plain_ms']!r}")
    return rec


def main() -> None:
    dev = require_cuda("quiver_tpu_torch.benches.probe")
    rec = run_probes(dev)
    time_probes(dev, rec["main"])


if __name__ == "__main__":
    main()
