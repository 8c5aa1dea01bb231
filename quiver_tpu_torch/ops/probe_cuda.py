"""The two probe kernels of ``benches/probe_pallas.py`` as CUDA kernels
(``csrc/probe_kernels.cu``).

* ``scatter_rows`` replaces ``kernel`` in ``probe_pallas.py::main``
  (``:42-71``, ``pallas_call`` at ``:83``): ``out[c, pos[c*BPc + r]] =
  2 * vals[c, r]`` for every row r inside a cluster's range
  ``[starts[c*(K+1)+k], starts[c*(K+1)+k+1])``; output rows that no copied
  row targets hold -1.0. It is the scatter-by-pair-row by which
  ``block_topw`` writes a pair's winners to the pair's original row. On the
  card it is three passes over one-byte flags that the wrapper zeroes: the
  rows the ranges cover are marked (a byte per row, so the largest cluster
  is cheap), then warps copy fixed tiles of rows whatever the clusters'
  sizes, several rows' loads in flight before their stores, and flag each
  target they write, then only unflagged output rows are filled with -1.0.
  At the main path's shape (196,608 rows x 128 f32, a permutation covered
  by the ranges) that is ~201 MB of rows and no fill; it is bound by those
  bytes.
* ``index_read`` replaces ``kernel2`` (``:101-103``, ``pallas_call`` at
  ``:105``): grid step i of G, one thread each, reads ``big[i*stride]``
  from device memory and writes ``x + float(big[i*stride])`` to ``out[i]``.
  It moves 8 G + 4 bytes and is bound by its launch. The TPU kernel's grid
  steps all write one revisited ``[1, 1]`` output, so its last step wins;
  the wrapper returns ``out[G-1]`` as ``[1, 1]``, which is that value.

Beside each kernel stands its plain PyTorch version
(``scatter_rows_reference``, ``index_read_reference``). The wrappers
dispatch on the inputs' device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from quiver_tpu_torch.ops.ivf_cuda import _check, _raise_on

#: Launches of each kernel in this process, counted where the kernel is
#: launched and nowhere else (the plain versions do not count).
launch_counts = {"scatter_rows": 0, "index_read": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ----------------------------------------------------------- scatter_rows


def scatter_rows_reference(vals, starts, pos, *, K):
    """Plain PyTorch version of :func:`scatter_rows`: per chunk, the rows
    covered by any cluster's range (a difference array over the ranges)
    are written to their targets; rows and targets outside ``[0, BPc)``
    are skipped."""
    nchunks, BPc, _ = vals.shape
    out = torch.full_like(vals, -1.0)
    st = starts.reshape(nchunks, K + 1).long().clamp(0, BPc)
    ps = pos.reshape(nchunks, BPc).long()
    for c in range(nchunks):
        lo, hi = st[c, :-1], st[c, 1:]
        nz = hi > lo
        delta = torch.zeros(BPc + 1, dtype=torch.int64, device=vals.device)
        delta.index_add_(0, lo[nz], torch.ones_like(lo[nz]))
        delta.index_add_(0, hi[nz], -torch.ones_like(hi[nz]))
        r = torch.nonzero(torch.cumsum(delta, 0)[:BPc] > 0).reshape(-1)
        t = ps[c, r]
        ok = (t >= 0) & (t < BPc)
        out[c, t[ok]] = 2.0 * vals[c, r[ok]]
    return out


def scatter_rows(vals, starts, pos, *, K):
    """f32[nchunks, BPc, L] rows scattered by pair position.

    Args:
      vals: f32[nchunks, BPc, L] rows in sorted (cluster) order; L % 4 == 0
        on CUDA.
      starts: i32[nchunks * (K+1)] CSR offsets of each cluster's rows within
        its chunk.
      pos: i32[nchunks * BPc] target row of each sorted row. Targets are
        expected to be distinct within a chunk (a permutation, as the pair
        order is); the TPU kernel's sequential grid made the last write win,
        the card's parallel blocks leave a repeated target's winner open.
    """
    fn = "scatter_rows"
    dev = vals.device
    if vals.dim() != 3:
        raise ValueError(f"{fn}: vals must be [nchunks, BPc, L], got {tuple(vals.shape)}")
    nchunks, BPc, L = vals.shape
    _check("vals", vals, torch.float32, None, dev, fn)
    _check("starts", starts, torch.int32, (nchunks * (K + 1),), dev, fn)
    _check("pos", pos, torch.int32, (nchunks * BPc,), dev, fn)
    if dev.type == "cpu":
        return scatter_rows_reference(vals, starts, pos, K=K)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if L % 4 or K < 1 or vals.data_ptr() % 16:
        # rows move as float4s: 16-byte aligned rows of a multiple of 4 lanes
        raise ValueError(
            f"{fn}: needs L % 4 == 0, 16-byte aligned vals and K >= 1 on CUDA (L={L}, K={K})"
        )
    from quiver_tpu_torch._build import load_library

    lib = load_library()
    out = torch.empty_like(vals)
    flags = torch.zeros(2, nchunks * BPc, dtype=torch.uint8, device=dev)  # covered rows, hit targets
    err = lib.probe_scatter_rows(
        vals.data_ptr(), starts.data_ptr(), pos.data_ptr(), out.data_ptr(), flags.data_ptr(),
        nchunks, K, BPc, L, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, fn, lib)
    launch_counts[fn] += 1
    return out


# ------------------------------------------------------------- index_read


def index_read_reference(big, x, *, grid, stride):
    """Plain PyTorch version of :func:`index_read`: the last grid step's
    ``x + float(big[(grid-1)*stride])`` as f32[1, 1]."""
    per_step = x.reshape(1) + big[torch.arange(grid, device=big.device) * stride].float()
    return per_step[-1:].reshape(1, 1)


def index_read(big, x, *, grid, stride):
    """f32[1, 1]: what the TPU kernel's revisited output holds after its
    last step, ``x + float(big[(grid-1)*stride])``. On CUDA every one of the
    ``grid`` blocks reads its own entry of ``big`` from device memory and
    writes its own output element; the wrapper returns the last.

    Args:
      big: i32[n] with ``(grid-1)*stride < n``; x: f32[1, 1].
    """
    fn = "index_read"
    dev = big.device
    _check("big", big, torch.int32, None, dev, fn)
    _check("x", x, torch.float32, (1, 1), dev, fn)
    if big.dim() != 1 or grid < 1 or stride < 0 or (grid - 1) * stride >= big.shape[0]:
        raise ValueError(
            f"{fn}: grid={grid} at stride={stride} reads past big of shape {tuple(big.shape)}"
        )
    if dev.type == "cpu":
        return index_read_reference(big, x, grid=grid, stride=stride)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    from quiver_tpu_torch._build import load_library

    lib = load_library()
    out = torch.empty(grid, dtype=torch.float32, device=dev)
    err = lib.probe_index_read(
        big.data_ptr(), x.data_ptr(), out.data_ptr(), grid, stride, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, fn, lib)
    launch_counts[fn] += 1
    return out[grid - 1:].reshape(1, 1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the two kernels (pointers and the stream
    as c_void_p, so ctypes passes 64-bit values)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_scatter_rows.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.probe_scatter_rows.restype = ci
    lib.probe_index_read.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.probe_index_read.restype = ci
    return lib
