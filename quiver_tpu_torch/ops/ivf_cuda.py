"""IVF candidate-stage kernel ``block_topw``: grouped block scoring plus a
windowed top-R, in one CUDA kernel per block dtype: bf16 blocks run
``csrc/ivf_block_topw.cu`` (tensor cores through ``wgmma``, both operands
through a TMA ring), f32 blocks run ``csrc/ivf_block_topw_f32.cu`` (tensor
cores in 3xTF32 through ``mma.sync``, the slab read as its TMA ring lands
it); see their headers.

It replaces both candidate formulations of the JAX package:

* the Pallas kernel ``quiver_tpu/ops/ivf_pallas.py::fused_block_topw``
  (``formulation="fused"``: windows of 128 lanes, top 4 per window, 11
  position bits, ``KEY_MIN`` sentinel);
* the XLA chain ``ragged_dot`` + bias epilogue + packed top-2 per 32-lane
  window of ``quiver_tpu/ops/ivf_kernels.py::_pairs_candidates``
  (``ivf_kernels.py:629-694``; ``formulation="pairs"``: W=32, R=2, 5
  position bits, ``_mask_key(32)`` sentinel), the per-pair constant
  ``caff`` included (``win_add``, the f32 add of ``ivf_kernels.py:692-693``
  on each winner);
* that function's per-pair top-R branch (``ivf_kernels.py:716-759``), as
  one window spanning the row (W=Cmax, any R <= Cmax, ``KEY_MIN``
  sentinel). Unlike the reference's f32 top-k, the packed keys quantize the
  score by ceil(log2(Cmax)) bits.

For every (query, probe) pair, grouped by cluster through the CSR ``starts``
over the stably sorted pairs, it scores the pair's query (minus the
centroid, for L2; rounded to bf16 when ``round_query``) against the
cluster's block (bf16 or f32) with f32 products and sums, applies
the epilogue ``s = (scale*dot + row_add[pair]) * col_mul[c, j] +
col_add[c, j]``, packs (score | position) into a monotone int32 key, keeps
the top R keys of every W-lane window and writes them to the pair's
ORIGINAL row in lane ``r*S + w`` (S = Cmax // W windows; the reference's
``concat([m1 over windows, m2 over windows])``), so no regroup by inverse
permutation and no transpose is needed.

The query's rounding follows the reference's formulations: its f32-block
``ragged_dot`` takes the f32 query as it is (``ivf_kernels.py:633-636``:
``round_query=False``), the Pallas kernel rounds it to bf16 whatever the
blocks (``ivf_pallas.py:93-96``), and bf16 blocks always pair with a bf16
query.

``block_topw`` dispatches on the device of its inputs: CPU tensors take the
plain PyTorch version ``block_topw_reference`` (the same operand rounding,
f32 products and sums, the same packing); CUDA tensors launch the kernel or
raise. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quiver_tpu_torch.ops.scan import NEG_BIG

KEY_MIN = int(np.iinfo(np.int32).min)
_INT_MASK = 0x7FFFFFFF

#: (W, R) pairs the CUDA library instantiates (csrc/ivf_block_topw.cu):
#: (W, 2) serves formulation="pairs" at seg_width W, (128, 4)
#: formulation="fused". Any other W equal to Cmax runs in row mode (one
#: window, any R <= Cmax).
CUDA_VARIANTS = ((32, 2), (64, 2), (128, 2), (128, 4))
ROW_MODE = "row"
#: launch-count key prefix of the f32-block kernel
F32 = "f32"


def row_key(R: int) -> tuple:
    """Launch-count key of row mode at R winners: ``(ROW_MODE, R)``."""
    return (ROW_MODE, int(R))


#: Launches of block_topw in this process by (W, R), or by ``row_key(R)``
#: for row mode, of the bf16-block kernel, and by (F32, (W, R)) or (F32,
#: row_key(R)) of the f32-block kernel; counted where a kernel is launched
#: and nowhere else (the CPU twin does not count). Row-mode keys appear at
#: their first launch.
launch_counts = {k: 0 for v in CUDA_VARIANTS for k in (v, (F32, v))}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _count(key) -> None:
    launch_counts[key] = launch_counts.get(key, 0) + 1


# ------------------------------------------------------------------ keys


def _to_key(s: torch.Tensor) -> torch.Tensor:
    """f32 -> monotone i32: an order-preserving involution (nonnegative
    floats map to themselves bitwise; negative floats flip their magnitude
    bits), so integer max == float max."""
    b = s.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & _INT_MASK)


def _from_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_to_key` (it is an involution)."""
    b = key ^ ((key >> 31) & _INT_MASK)
    return b.contiguous().view(torch.float32)


def _pack_lane(s: torch.Tensor, lane_mask: int) -> torch.Tensor:
    """f32 scores -> monotone i32 keys whose low bits carry the position
    along the trailing axis, so one max yields score AND position."""
    key = _to_key(s)
    lane = torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    return (key & ~lane_mask) | (lane & lane_mask)


def _mask_key(w: int) -> np.int32:
    """Packed key of NEG_BIG with zero lane bits: the masked-entry
    sentinel of the W-lane windowed reduce."""
    b = np.float32(NEG_BIG).view(np.int32).item()
    return np.int32((b ^ ((b >> 31) & 0x7FFFFFFF)) & ~(w - 1))


def unpack_keys(acc: torch.Tensor, pos_bits: int = 11):
    """(score f32, pos i32, valid bool) from packed keys; KEY_MIN lanes
    -> (-inf, ., False)."""
    pm = (1 << pos_bits) - 1
    score = _from_key(acc & ~pm)
    valid = acc != KEY_MIN
    return torch.where(valid, score, -torch.inf), acc & pm, valid


# ------------------------------------------------------------ plain twin


def pair_scores_reference(
    q, centroids, starts, order, blocks_t, *, P, scale, col_add,
    row_add=None, col_mul=None, sub_cent, round_query=True,
):
    """f32[M, Cmax] epilogue scores of the M sorted pairs (row i is pair
    ``order[i]``): the block as stored (bf16 or f32), the query rounded to
    bf16 when ``round_query``, f32 products and sums. Plain PyTorch; loops
    over the clusters on the host."""
    K, d, Cmax = blocks_t.shape
    M = order.shape[0]
    counts = starts[1:] - starts[:-1]
    sorted_c = torch.repeat_interleave(
        torch.arange(K, device=q.device), counts.long(), output_size=M
    )
    orig = order.long()
    qp = q[orig // P]
    if sub_cent:
        qp = qp - centroids[sorted_c]
    if round_query:
        qp = qp.to(torch.bfloat16).float()
    dots = torch.zeros(M, Cmax, dtype=torch.float32, device=q.device)
    bounds = starts.tolist()
    for c in range(K):
        lo, hi = bounds[c], bounds[c + 1]
        if hi > lo:
            dots[lo:hi] = qp[lo:hi] @ blocks_t[c].float()
    s = scale * dots
    if row_add is not None:
        s = s + row_add[orig][:, None]
    if col_mul is not None:
        s = s * col_mul[sorted_c]
    return s + col_add[sorted_c]


def block_topw_reference(
    q, centroids, starts, order, blocks_t, *, P, scale, col_add,
    row_add=None, col_mul=None, win_add=None, sub_cent, round_query=True, W, R,
    pos_bits, sentinel,
):
    """Plain PyTorch version of the kernel: i32[B*P, R*S] winner keys
    (S = Cmax // W) in original pair order, lane ``r*S + w`` holding the
    r-th best key of window w; with ``win_add`` each winner ``m`` becomes
    ``(to_key(from_key(m & ~pm) + win_add[pair]) & ~pm) | (m & pm)``. A
    row that no sorted pair reaches (``order`` truncated) holds
    ``sentinel`` in every lane."""
    Cmax = blocks_t.shape[2]
    M = order.shape[0]
    BP = q.shape[0] * P
    S = Cmax // W
    pm = (1 << pos_bits) - 1
    s = pair_scores_reference(
        q, centroids, starts, order, blocks_t, P=P, scale=scale,
        col_add=col_add, row_add=row_add, col_mul=col_mul, sub_cent=sub_cent,
        round_query=round_query,
    )
    keys = _pack_lane(s, pm).reshape(M, S, W)
    sent = torch.tensor(int(sentinel), dtype=torch.int32, device=q.device)
    wins = []
    for _ in range(R):
        m = keys.max(dim=2).values
        wins.append(m)
        keys = torch.where(keys == m[:, :, None], sent, keys)
    wins = torch.stack(wins, dim=1).reshape(M, R * S)
    if win_add is not None:
        f = _from_key(wins & ~pm) + win_add[order.long()][:, None]
        wins = (_to_key(f) & ~pm) | (wins & pm)
    out = torch.full((BP, R * S), int(sentinel), dtype=torch.int32, device=q.device)
    out[order.long()] = wins
    return out


# --------------------------------------------------------------- wrapper


def _check(name, t, dtype, shape, device, fn="block_topw"):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on ``device``
    with ``shape`` (None: any shape); ``fn`` names the wrapper."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _raise_on(err: int, fn: str, lib) -> None:
    """Raise if a C entry of the kernel library returned a cudaError."""
    if err != 0:
        raise RuntimeError(
            f"{fn}: CUDA launch failed with cudaError {err} "
            f"({lib.ivf_cuda_error_string(err).decode()})"
        )


def block_topw(
    q, centroids, starts, order, blocks_t, *, P, scale, col_add,
    row_add=None, col_mul=None, win_add=None, sub_cent, round_query=True, W, R,
    pos_bits, sentinel,
):
    """Winner keys i32[B*P, R*(Cmax//W)] of every (query, probe) pair,
    lane ``r*S + w`` (S = Cmax // W) in each pair's original row.

    Two counts: the M sorted pairs to score (the rows of ``order``, M =
    ``starts[K]``) and the B*P output rows, which original pair ids index,
    as ``row_add`` and ``win_add`` do. M < B*P is a truncated pair list (a
    shard scores only the pairs whose cluster it owns,
    ``parallel/sharded_ivf.py``); the output rows no sorted pair reaches
    hold ``sentinel`` in every lane.

    Args:
      q: f32[B, d] queries; centroids: f32[K, d].
      starts: i32[K+1] CSR offsets of each cluster's run in the stably
        sorted pair list; order: i32[M] original pair index (query-major,
        ``b*P + j``) of each sorted pair, M <= B*P, no index twice.
      blocks_t: bf16 or f32 [K, d, Cmax] residual blocks.
      col_add: f32[K, Cmax]; row_add: optional f32[B*P] per original pair;
        col_mul: optional f32[K, Cmax] (the epilogue in the module doc).
      win_add: optional f32[B*P] per original pair, added in f32 to each
        winner's unpacked score and packed again (its position bits kept):
        the per-pair constant of the affine identity, which cannot change
        the ranking within a pair. Windowed variants only on CUDA.
      sub_cent: subtract the pair's centroid from the query (f32), before
        any rounding.
      round_query: round the (centred) query to bf16 before the products.
        bf16 blocks require it; with f32 blocks it is the fused
        formulation's product, and False the pairs formulation's.
      W, R: window width (a power of two dividing Cmax, or Cmax itself:
        one window per row) and winners kept per window; pos_bits: low key
        bits replaced by the block column (W <= 2**pos_bits); sentinel:
        the key a removed winner is replaced by.

    On CUDA, row mode (W = Cmax outside ``CUDA_VARIANTS``) takes the
    ``KEY_MIN`` sentinel and keeps each row's running top R in the kernel
    for R <= 128 (the library's row max: a threshold filter, then a merge
    for the keys above it, ``csrc/row_topr.cuh``), writing only the
    i32[B*P, R] winners. Above 128 (still to do) the kernel writes every
    packed key of each pair's row (i32[B*P, Cmax], 1.0 GB at B=65536, P=3,
    Cmax=1280) and ``torch.topk`` takes the R best, as the reference takes
    ``lax.top_k`` outside any kernel.
    """
    dev = q.device
    B, d = q.shape
    K, _, Cmax = blocks_t.shape
    BP = B * P
    _check("q", q, torch.float32, (B, d), dev)
    _check("centroids", centroids, torch.float32, (K, d), dev)
    _check("starts", starts, torch.int32, (K + 1,), dev)
    _check("order", order, torch.int32, None, dev)
    if order.dim() != 1 or order.shape[0] > BP:
        raise ValueError(f"block_topw: order shape {tuple(order.shape)}: want (M,), M <= {BP}")
    bdt = getattr(blocks_t, "dtype", None)
    if bdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"block_topw: blocks_t must be bf16 or f32, got {bdt}")
    _check("blocks_t", blocks_t, bdt, (K, d, Cmax), dev)
    if blocks_t.dtype == torch.bfloat16 and not round_query:
        raise ValueError("block_topw: bf16 blocks take a bf16 query (round_query=True)")
    _check("col_add", col_add, torch.float32, (K, Cmax), dev)
    if row_add is not None:
        _check("row_add", row_add, torch.float32, (BP,), dev)
    if col_mul is not None:
        _check("col_mul", col_mul, torch.float32, (K, Cmax), dev)
    if win_add is not None:
        _check("win_add", win_add, torch.float32, (BP,), dev)
    if W < 1 or (W & (W - 1) and W != Cmax) or Cmax % W or not 1 <= R <= W:
        raise ValueError(f"block_topw: bad window W={W}, R={R} for Cmax={Cmax}")
    if not (W <= (1 << pos_bits) and 0 < pos_bits < 31):
        raise ValueError(f"block_topw: pos_bits={pos_bits} cannot hold W={W}")
    kw = dict(
        P=P, scale=scale, col_add=col_add, row_add=row_add, col_mul=col_mul,
        win_add=win_add, sub_cent=sub_cent, W=W, R=R, pos_bits=pos_bits,
        sentinel=sentinel,
    )
    if dev.type == "cpu":
        return block_topw_reference(
            q, centroids, starts, order, blocks_t, round_query=round_query, **kw)
    if dev.type != "cuda":
        raise ValueError(f"block_topw: unsupported device {dev}")
    return _launch_cuda(q, centroids, starts, order, blocks_t, round_query=round_query, **kw)


def _variant(lib_row_max, W, R, Cmax, win_add, sentinel):
    """(launch-count variant, W argument of the C entry, whether row mode
    writes every key of the row) of one CUDA launch. Row mode keeps the
    running top R in the kernel up to ``lib_row_max`` and writes the whole
    row above it: chosen by R alone, never on a failure."""
    if (W, R) in CUDA_VARIANTS:
        return (W, R), W, False
    if W == Cmax and win_add is None:
        if int(sentinel) != KEY_MIN:
            # the running top-R admits only keys above its R-th best, which
            # equals the reference's passes when the sentinel is below every key
            raise ValueError("block_topw: row mode takes the KEY_MIN sentinel on CUDA")
        return row_key(R), 0, R > lib_row_max
    raise ValueError(
        f"block_topw: no CUDA variant for W={W}, R={R}"
        f"{'' if win_add is None else ' with win_add'} (built: {CUDA_VARIANTS}, "
        f"and W=Cmax without win_add)"
    )


def _tile_start(starts, K, M, tq):
    """(tile_start i32[K+1], grid): cluster c owns tiles [tile_start[c],
    tile_start[c+1]) of ``tq`` sorted pairs, made without a host sync; the
    grid is an upper bound on the tile count of the M sorted pairs and
    surplus blocks exit."""
    counts = starts[1:] - starts[:-1]
    tile_start = torch.zeros(K + 1, dtype=torch.int32, device=starts.device)
    tile_start[1:] = torch.cumsum((counts + (tq - 1)) // tq, 0)
    return tile_start, (M + tq - 1) // tq + K


def _out_rows(BP, M, width, sentinel, device):
    """The kernel's output, i32[BP, width]: the kernel writes every row a
    sorted pair reaches, so a full pair list needs no fill; a truncated one
    (M < BP) starts from the sentinel."""
    if M == BP:
        return torch.empty(BP, width, dtype=torch.int32, device=device)
    return torch.full((BP, width), int(sentinel), dtype=torch.int32, device=device)


#: per block dtype on CUDA: (the Cmax quantum that makes the blocks' row
#: stride a multiple of 16 bytes, as their tensor map needs; the depth the
#: prologue pads each sorted pair's query row to, the kernel's chunk; the C
#: entry, whose ``_tile_rows`` and ``_row_max`` queries share its name)
_CUDA_BLOCKS = {
    torch.bfloat16: (8, 64, "ivf_block_topw"),
    torch.float32: (4, 32, "ivf_block_topw_f32"),
}


def _launch_cuda(
    q, centroids, starts, order, blocks_t, *, P, scale, col_add, row_add,
    col_mul, win_add, sub_cent, round_query, W, R, pos_bits, sentinel,
):
    """One launch of the kernel of ``blocks_t``'s dtype (:data:`_CUDA_BLOCKS`).
    The prologue writes each sorted pair's query row in that dtype (the
    f32 kernel's bf16-rounded when ``round_query``); launches count under
    the variant, behind :data:`F32` for f32 blocks."""
    from quiver_tpu_torch._build import load_library

    B, d = q.shape
    K, _, Cmax = blocks_t.shape
    f32 = blocks_t.dtype == torch.float32
    quantum, depth, entry = _CUDA_BLOCKS[blocks_t.dtype]
    if Cmax % quantum:
        raise ValueError(
            f"block_topw: {blocks_t.dtype} blocks need Cmax % {quantum} == 0, a multiple "
            f"of {quantum} (Cmax={Cmax}), on CUDA")
    for name, t in (("blocks_t", blocks_t), ("col_add", col_add), ("col_mul", col_mul)):
        if t is not None and t.data_ptr() % 16:
            # TMA and bulk copies read from 16-byte aligned addresses
            raise ValueError(f"block_topw: {name} must start on a 16-byte boundary on CUDA")
    lib = load_library()
    variant, w_arg, whole = _variant(getattr(lib, entry + "_row_max")(), W, R, Cmax, win_add,
                                     sentinel)
    BP, M = B * P, order.shape[0]
    out = _out_rows(BP, M, Cmax if whole else (Cmax // W) * R, sentinel, q.device)
    if M == 0:
        return out[:, :R] if whole else out
    tile_start, n_tiles_max = _tile_start(starts, K, M, getattr(lib, entry + "_tile_rows")())
    qa = torch.empty(M, (d + depth - 1) // depth * depth, dtype=blocks_t.dtype, device=q.device)
    err = getattr(lib, entry)(
        q.data_ptr(), centroids.data_ptr(), starts.data_ptr(),
        tile_start.data_ptr(), order.data_ptr(), blocks_t.data_ptr(),
        qa.data_ptr(),
        0 if row_add is None else row_add.data_ptr(),
        0 if col_mul is None else col_mul.data_ptr(),
        col_add.data_ptr(),
        0 if win_add is None else win_add.data_ptr(),
        out.data_ptr(),
        K, d, Cmax, P, M, n_tiles_max, float(scale), int(bool(sub_cent)),
        *((int(bool(round_query)),) if f32 else ()),
        w_arg, R, pos_bits, int(sentinel), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "block_topw", lib)
    _count((F32, variant) if f32 else variant)
    if whole:
        out = torch.topk(out, R, dim=1).values  # keys are distinct in a row
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the kernel library (pointers and the
    stream as c_void_p, so ctypes passes 64-bit values)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ivf_block_topw.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, ci, ci, ci, ci, vp,
    ]
    lib.ivf_block_topw.restype = ci
    lib.ivf_block_topw_f32.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, ci, ci, ci, ci, ci, vp,
    ]
    lib.ivf_block_topw_f32.restype = ci
    for fn in (lib.ivf_block_topw_tile_rows, lib.ivf_block_topw_row_max,
               lib.ivf_block_topw_f32_tile_rows, lib.ivf_block_topw_f32_row_max):
        fn.argtypes = []
        fn.restype = ci
    lib.ivf_cuda_error_string.argtypes = [ci]
    lib.ivf_cuda_error_string.restype = ctypes.c_char_p
    return lib
