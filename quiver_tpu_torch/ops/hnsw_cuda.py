"""The HNSW layer-0 beam (``ops/hnsw_kernels.py::beam_search``) as one
CUDA kernel (``csrc/hnsw_beam.cu``; see its header).

It replaces no Pallas kernel: the reference's beam
(``quiver_tpu/ops/hnsw_kernels.py:102-290``) is an XLA ``lax.while_loop``.
One CTA per query keeps the query, the beam, the ring (and a hash of the
beam's and the ring's ids) and the candidate block in shared memory and
loops on the card until that query's own termination test holds (or
``max_iters``), so there are no host reads inside the loop and no work for
queries already done.

:func:`beam_search` is what ``hnsw_kernels.beam_search`` calls for CUDA
tensors; CPU tensors run the plain version ``hnsw_kernels._beam_rows``.
It launches the kernel or raises a ``ValueError`` where a size is past the
kernel's limits: there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from quiver_tpu_torch.ops.ivf_cuda import _raise_on
from quiver_tpu_torch.types import DistanceType

#: metric codes of ``csrc/hnsw_beam.cu``
METRICS = {
    DistanceType.EUCLIDEAN: 0,
    DistanceType.SQUARED_EUCLIDEAN: 1,
    DistanceType.DOT_PRODUCT: 2,
    DistanceType.COSINE: 3,
    DistanceType.MANHATTAN: 4,
}

#: Launches of the beam kernel in this process, counted where it is
#: launched and nowhere else (the plain version does not count).
launch_counts = {"hnsw_beam": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def beam_search(queries, entries, vectors, valid, adj, pos_map, *, metric, ef, max_iters,
                compute_dtype, expand, bitmap, sizes, chunk_bytes, stats):
    """``hnsw_kernels.beam_search`` on CUDA tensors: (dist f32[B, ef], ids
    i64[B, ef]). ``stats``, when given, receives ``"iters"`` (i64[B] on the
    card, each query's active iterations), ``"accepted"`` (i64[B] on the
    card, the candidates whose distances each query computed) and
    ``"loops"`` (the longest query's loop iterations, the one that found it
    done included, at most ``max_iters``), read back in one 8-byte copy.
    With the bitmap, rows run in chunks whose bitsets take at most
    ``chunk_bytes``; one counter takes every chunk's longest loop."""
    fn = "beam_search"
    dev = queries.device
    B, d = queries.shape
    cap = vectors.shape[0]
    rows, deg = adj.shape
    block, _, beam_len, ring_len = sizes
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: the CUDA kernel takes compute_dtype float32 or bfloat16, "
                         f"got {compute_dtype}")
    if cap >= 2**31:
        raise ValueError(f"{fn}: the CUDA kernel keeps ids as int32; capacity {cap} >= 2**31")
    for name, t in (("entries", entries), ("vectors", vectors), ("valid", valid),
                    ("adj", adj), ("pos_map", pos_map)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, queries on {dev}")
    if vectors.shape[1] != d or entries.shape != (B,) or valid.shape != (cap,):
        raise ValueError(f"{fn}: shapes queries {tuple(queries.shape)}, entries "
                         f"{tuple(entries.shape)}, vectors {tuple(vectors.shape)}, valid "
                         f"{tuple(valid.shape)} do not agree")
    from quiver_tpu_torch._build import load_library

    lib = load_library()
    smem = lib.hnsw_beam_smem_bytes(d, beam_len, ring_len, block, expand, int(bitmap))
    if smem > lib.hnsw_beam_smem_max():
        raise ValueError(
            f"{fn}: ef={ef}, d={d}, block={block} need {smem} bytes of shared memory a query, "
            f"past the kernel's {lib.hnsw_beam_smem_max()}")
    queries = queries.to(torch.float32).contiguous()
    entries = entries.to(torch.int64).contiguous()
    vectors = vectors.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    adj = adj.to(torch.int32).contiguous()
    pos_map = pos_map.to(torch.int64).contiguous()
    out_d = torch.empty((B, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, ef), dtype=torch.int64, device=dev)
    iters = torch.empty(B, dtype=torch.int64, device=dev)
    accepted = torch.empty(B, dtype=torch.int64, device=dev)
    loops = torch.zeros(1, dtype=torch.int64, device=dev)
    words = (cap + 31) // 32
    chunk = max(1, chunk_bytes // (4 * words)) if bitmap else max(B, 1)
    bits = torch.empty((min(chunk, B), words), dtype=torch.int32, device=dev) if bitmap else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, B, chunk):
        n = min(chunk, B - lo)
        if bitmap:
            bits.zero_()
        err = lib.hnsw_beam(
            queries[lo].data_ptr(), entries[lo:].data_ptr(), vectors.data_ptr(),
            valid.data_ptr(), adj.data_ptr(), pos_map.data_ptr(), out_d[lo].data_ptr(),
            out_i[lo].data_ptr(), iters[lo:].data_ptr(), accepted[lo:].data_ptr(),
            loops.data_ptr(), bits.data_ptr() if bitmap else None, cap, pos_map.shape[0], rows, n, d, deg, ef,
            max_iters, expand, block, beam_len, ring_len, words, METRICS[metric],
            int(compute_dtype == torch.bfloat16), dev.index, stream,
        )
        _raise_on(err, fn, lib)
        launch_counts["hnsw_beam"] += 1
    if stats is not None:
        stats["iters"] = iters
        stats["accepted"] = accepted
        stats["loops"] = stats.get("loops", 0) + int(loops)
    return out_d, out_i


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the beam kernel (pointers and the stream
    as c_void_p, so ctypes passes 64-bit values)."""
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hnsw_beam.argtypes = [vp] * 12 + [cll] * 3 + [ci] * 13 + [vp]
    lib.hnsw_beam.restype = ci
    lib.hnsw_beam_smem_bytes.argtypes = [ci] * 6
    lib.hnsw_beam_smem_bytes.restype = ci
    lib.hnsw_beam_smem_max.argtypes = []
    lib.hnsw_beam_smem_max.restype = ci
    return lib
