"""The HNSW search's two kernels (``csrc/hnsw_beam.cu``; see its notes):
the layer-0 beam (``ops/hnsw_kernels.py::beam_search``) and the greedy
descent through the upper layers (``ops/hnsw_kernels.py::descend``).

It replaces no Pallas kernel: the reference's beam
(``quiver_tpu/ops/hnsw_kernels.py:102-290``) is an XLA ``lax.while_loop``.
One CTA per query keeps the query, the beam, the ring (and a hash of the
beam's and the ring's ids) and the candidate block in shared memory and
loops on the card until that query's own termination test holds (or
``max_iters``), so there are no host reads inside the loop and no work for
queries already done.

:func:`descend` replaces no Pallas kernel either (the reference's
``greedy_descent``, ``:294-338``, is a ``lax.while_loop`` a layer): one
warp a query walks every upper layer on the card in one launch, with the
layer table in the kernel's parameters, so a search's descent makes no
host read and no host-to-device copy.

:func:`beam_search` and :func:`descend` are what ``hnsw_kernels.beam_search``
and ``hnsw_kernels.descend`` call for CUDA tensors; CPU tensors run the
plain versions ``hnsw_kernels._beam_rows`` and ``hnsw_kernels._descend_chain``.
Each launches its kernel or raises a ``ValueError`` where a size is past
the kernel's limits: there is no fallback from one to the other.
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

#: Launches of each kernel in this process, counted where it is launched
#: and nowhere else (the plain versions do not count).
launch_counts = {"hnsw_beam": 0, "hnsw_descent": 0}


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


def descend(queries, entries, vectors, valid, layers, *, metric, compute_dtype, max_iters,
            stats):
    """``hnsw_kernels.descend`` on CUDA tensors: (dist f32[B], ids i64[B]),
    each query's local minimum on the last of ``layers`` ((adj i32[rows,
    deg], pos_map i64[cap]) pairs, top first, at least one). One launch
    walks up to ``hnsw_descent_layers_max()`` layers; a deeper graph runs
    further launches, each from the last one's ids. ``stats``, when given,
    receives ``"descent_steps"`` (i64[B] on the card: each query's steps
    summed over the layers, the step that found no better neighbour
    included). Nothing is read back or copied from the host."""
    fn = "descend"
    dev = queries.device
    B, d = queries.shape
    cap = vectors.shape[0]
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: the CUDA kernel takes compute_dtype float32 or bfloat16, "
                         f"got {compute_dtype}")
    if cap >= 2**31:
        raise ValueError(f"{fn}: the CUDA kernel keeps ids as int32; capacity {cap} >= 2**31")
    if not layers:
        raise ValueError(f"{fn}: no upper layer to walk")
    named = [("entries", entries), ("vectors", vectors), ("valid", valid)]
    for li, (adj, pos_map) in enumerate(layers):
        named += [(f"layer {li} adj", adj), (f"layer {li} pos_map", pos_map)]
        if adj.dim() != 2 or adj.shape[0] < 1 or adj.shape[1] < 1 or pos_map.dim() != 1:
            raise ValueError(f"{fn}: layer {li} has adj {tuple(adj.shape)}, pos_map "
                             f"{tuple(pos_map.shape)}: an adjacency of at least one row and "
                             f"one column, a 1-d pos_map")
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, queries on {dev}")
    if vectors.shape[1] != d or entries.shape != (B,) or valid.shape != (cap,):
        raise ValueError(f"{fn}: shapes queries {tuple(queries.shape)}, entries "
                         f"{tuple(entries.shape)}, vectors {tuple(vectors.shape)}, valid "
                         f"{tuple(valid.shape)} do not agree")
    from quiver_tpu_torch._build import load_library

    lib = load_library()
    bf16 = int(compute_dtype == torch.bfloat16)
    smem = lib.hnsw_descent_smem_bytes(d, bf16)
    if smem > lib.hnsw_beam_smem_max():
        raise ValueError(f"{fn}: d={d} needs {smem} bytes of shared memory a CTA, past the "
                         f"kernel's {lib.hnsw_beam_smem_max()}")
    queries = queries.to(torch.float32).contiguous()
    ids = entries.to(torch.int64).contiguous()
    vectors = vectors.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    # kept referenced until the launches are queued
    layers = [(adj.to(torch.int32).contiguous(), pos_map.to(torch.int64).contiguous())
              for adj, pos_map in layers]
    dist = torch.empty(B, dtype=torch.float32, device=dev)
    out = torch.empty(B, dtype=torch.int64, device=dev)
    steps = torch.empty(B, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    per = lib.hnsw_descent_layers_max()
    for lo in range(0, len(layers), per):
        part = layers[lo:lo + per]
        n = len(part)
        err = lib.hnsw_descent(
            queries.data_ptr(), ids.data_ptr(), vectors.data_ptr(), valid.data_ptr(),
            (ctypes.c_void_p * n)(*(adj.data_ptr() for adj, _ in part)),
            (ctypes.c_void_p * n)(*(pos.data_ptr() for _, pos in part)),
            (ctypes.c_longlong * n)(*(adj.shape[0] for adj, _ in part)),
            (ctypes.c_longlong * n)(*(pos.shape[0] for _, pos in part)),
            (ctypes.c_int * n)(*(adj.shape[1] for adj, _ in part)), n,
            dist.data_ptr(), out.data_ptr(), steps.data_ptr(), cap, B, d, max_iters,
            METRICS[metric], bf16, int(lo > 0), dev.index, stream,
        )
        _raise_on(err, fn, lib)
        launch_counts["hnsw_descent"] += 1
        ids = out
    if stats is not None:
        stats["descent_steps"] = steps
    return dist, out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the two kernels (pointers, the host
    arrays of the layer table and the stream as c_void_p, so ctypes passes
    64-bit values)."""
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hnsw_beam.argtypes = [vp] * 12 + [cll] * 3 + [ci] * 13 + [vp]
    lib.hnsw_beam.restype = ci
    lib.hnsw_beam_smem_bytes.argtypes = [ci] * 6
    lib.hnsw_beam_smem_bytes.restype = ci
    lib.hnsw_beam_smem_max.argtypes = []
    lib.hnsw_beam_smem_max.restype = ci
    lib.hnsw_descent.argtypes = [vp] * 9 + [ci] + [vp] * 3 + [cll] + [ci] * 7 + [vp]
    lib.hnsw_descent.restype = ci
    lib.hnsw_descent_smem_bytes.argtypes = [ci, ci]
    lib.hnsw_descent_smem_bytes.restype = ci
    lib.hnsw_descent_layers_max.argtypes = []
    lib.hnsw_descent_layers_max.restype = ci
    return lib
