"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip without a card. On the GPU machine, from the repository root
(``--noconftest``: tests/conftest.py sets up JAX, which that machine lacks;
this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The hand-written kernels are held against their plain PyTorch versions on
the card: ``block_topw`` (bf16 and f32 blocks) within the tolerance of
``chip_smoke.compare_keys``
(two packing quanta plus the bound of the dot products' rounding on
unpacked scores, positions equal where scores are separated), ``scatter_rows`` and ``index_read`` exactly (they
copy and double floats, or add one int to a float); the slice on the card
against the slice on the CPU; the live index on the card (writes and a
background refresh on the maintenance stream) against the CPU, and serving
while a job runs; IVF's einsum formulation (torch ops) on the card against
the CPU; the HNSW engine's beam search and build on the card
against the same calls on the CPU; the HNSW beam kernel against its plain
version ``_beam_rows`` on the card, and the HNSW descent kernel against its
plain version ``_descend_chain`` on the card, bit for bit on integer
coordinates.
"""

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
from quiver_tpu_torch.ops import ivf_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("d", [33, 48, 100, 768])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize(
    "variant,W,R,pos_bits,metric",
    [(v, w, r, pb, m) for v, w, r, pb, ms in chip_smoke.VARIANTS for m in ms],
)
def test_block_topw_kernel_matches_twin(cuda, variant, W, R, pos_bits, metric, P, d):
    # d and Cmax=384 differ from the serving shape on purpose (d=100 is not
    # a multiple of the kernel's 64-deep chunks, d=768 takes 12 of them and
    # streams the query tiles, odd d=33 takes the prologue's scalar loads);
    # K=37 with B=300 leaves some clusters empty and others with several
    # tiles
    args, kw = chip_smoke.kernel_inputs(
        torch, cuda, B=300, P=P, K=37, Cmax=384, d=d, metric=metric,
        variant=variant, seed=7,
    )
    count_key = ivf_cuda.row_key(R) if W == 0 else (W, R)
    W, pos_bits, sentinel = chip_smoke.variant_args(variant, W, R, pos_bits, 384)
    wkw = dict(kw, W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)
    before = ivf_cuda.launch_counts.get(count_key, 0)
    got = ivf_cuda.block_topw(*args, **wkw)
    assert ivf_cuda.launch_counts[count_key] == before + 1
    torch.cuda.synchronize()
    chip_smoke.check_call(torch, args, wkw, got)


#: pairs per cluster of the tiling-edge cases: one pair, counts that are
#: not multiples of a warp's 16 rows or a tile's 64, an empty cluster
EDGE_COUNTS = (1, 15, 17, 63, 65, 130, 0, 2)


def _f32_cases():
    """(variant, W, R, pos_bits, metric, P, d, Cmax, edges) of the f32-block
    kernel's card test: kernel_inputs' own layout (B=300, K=37, Cmax=384:
    some clusters empty, others several tiles) at P in {1, 3} and d in
    {33, 100, 128, 768}; then the edges of its tiling (``edges``: clusters
    of EDGE_COUNTS pairs, P=1) at d in {8, 100, 129} (not a multiple of the
    32-deep stage) and 768, with the windowed variants at Cmax=1280 (ten
    slabs) and row mode at Cmax=132 (a slab and a partial 32-column box;
    R=160 becomes R = Cmax = 132, above the kernel's list) and Cmax=8 (less
    than one box; R=8 keeps the row)."""
    cases = []
    for v, w, r, pb, ms in chip_smoke.VARIANTS:
        for m in ms:
            cases += [(v, w, r, pb, m, P, d, 384, False) for P in (1, 3) for d in (33, 100, 128, 768)]
            for d in (8, 100, 129, 768):
                cases.append((v, w, r, pb, m, 1, d, 1280, True))
                if w == 0:
                    cases.append((v, w, min(r, 132), pb, m, 1, d, 132, True))
                    if r == 16:
                        cases.append((v, w, 8, pb, m, 1, d, 8, True))
    return cases


@pytest.mark.parametrize("variant,W,R,pos_bits,metric,P,d,Cmax,edges", _f32_cases())
def test_block_topw_f32_kernel_matches_twin(cuda, variant, W, R, pos_bits, metric, P, d,
                                            Cmax, edges):
    """The f32-block kernel (csrc/ivf_block_topw_f32.cu): pairs and row mode
    on the f32 query, fused on the bf16-rounded one, at the shapes of
    test_block_topw_kernel_matches_twin plus d=128 (one query tile of four
    32-deep chunks), and at the edges of its tiling (:func:`_f32_cases`)."""
    B, K = (sum(EDGE_COUNTS), len(EDGE_COUNTS)) if edges else (300, 37)
    args, kw = chip_smoke.kernel_inputs(
        torch, cuda, B=B, P=P, K=K, Cmax=Cmax, d=d, metric=metric,
        variant=variant, seed=11 if edges else 7, dtype=torch.float32,
    )
    if edges:
        starts = torch.zeros(K + 1, dtype=torch.int32, device=cuda)
        starts[1:] = torch.cumsum(torch.tensor(EDGE_COUNTS, device=cuda), 0)
        order = torch.randperm(B, generator=torch.Generator().manual_seed(11))
        args = (*args[:2], starts, order.to(cuda, torch.int32), args[4])
    assert args[4].dtype == torch.float32
    assert kw.get("round_query", True) == (variant == "fused")
    count_key = (ivf_cuda.F32, ivf_cuda.row_key(R) if W == 0 else (W, R))
    W, pos_bits, sentinel = chip_smoke.variant_args(variant, W, R, pos_bits, Cmax)
    wkw = dict(kw, W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)
    before = dict(ivf_cuda.launch_counts)
    got = ivf_cuda.block_topw(*args, **wkw)
    assert ivf_cuda.launch_counts[count_key] == before.get(count_key, 0) + 1
    assert sum(ivf_cuda.launch_counts.values()) == sum(before.values()) + 1
    torch.cuda.synchronize()
    chip_smoke.check_call(torch, args, wkw, got)


def _shard_of(torch, args, kw, lo, KL):
    """One shard's call: the clusters [lo, lo+KL) of a kernel_inputs call,
    the blocks, centroids and column operands as contiguous views (no
    copies), and the sorted pairs of those clusters only (a truncated
    list, M < B*P; ``starts`` rebased)."""
    q, cents, starts, order, blocks = args
    s0, s1 = int(starts[lo]), int(starts[lo + KL])
    sub = dict(kw)
    for name in ("col_add", "col_mul"):
        if kw.get(name) is not None:
            sub[name] = kw[name][lo:lo + KL]
    return (q, cents[lo:lo + KL], (starts[lo:lo + KL + 1] - s0).contiguous(),
            order[s0:s1], blocks[lo:lo + KL]), sub


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize(
    "variant,W,R,pos_bits,metric",
    [(v, w, r, pb, m) for v, w, r, pb, ms in chip_smoke.VARIANTS for m in ms],
)
def test_block_topw_truncated_pairs_kernel_matches_twin(cuda, variant, W, R, pos_bits, metric,
                                                        dtype):
    """A shard's call (``parallel/sharded_ivf.py``): the pairs of clusters
    [12, 28) of K=37 against the views of their blocks. The kernel's keys
    match the plain version's (``chip_smoke.check_call``), and the rows of
    pairs outside the shard hold the sentinel in every lane."""
    dt = getattr(torch, dtype)
    args, kw = chip_smoke.kernel_inputs(
        torch, cuda, B=300, P=3, K=37, Cmax=384, d=100, metric=metric,
        variant=variant, seed=13, dtype=dt,
    )
    count_key = ivf_cuda.row_key(R) if W == 0 else (W, R)
    if dt == torch.float32:
        count_key = (ivf_cuda.F32, count_key)
    W, pos_bits, sentinel = chip_smoke.variant_args(variant, W, R, pos_bits, 384)
    wkw = dict(kw, W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)
    sargs, skw = _shard_of(torch, args, wkw, 12, 16)
    M = sargs[3].shape[0]
    assert 0 < M < 300 * 3
    assert sargs[4].data_ptr() == args[4].data_ptr() + 12 * 100 * 384 * sargs[4].element_size()
    before = ivf_cuda.launch_counts.get(count_key, 0)
    got = ivf_cuda.block_topw(*sargs, **skw)
    assert ivf_cuda.launch_counts[count_key] == before + 1
    torch.cuda.synchronize()
    assert got.shape[0] == 300 * 3
    chip_smoke.check_call(torch, sargs, skw, got)
    hit = torch.zeros(300 * 3, dtype=torch.bool, device=cuda)
    hit[sargs[3].long()] = True
    assert bool((got[~hit] == int(sentinel)).all())


@pytest.mark.parametrize("k", [10, 24, 48, 100])
def test_per_pair_row_mode_on_cuda_matches_cpu(cuda, k):
    """Cmax=64 leaves 2 windows < k: ivf_query takes the per-pair top-R
    branch, on the card through block_topw's row mode (R = min(Cmax,
    max(16, k)) <= 64: the running top-R kept in the kernel)."""
    from quiver_tpu_torch.convert import ivf_arrays_from_numpy
    from quiver_tpu_torch.ops.ivf_kernels import ivf_query

    rng = np.random.default_rng(1)
    K, Cmax, d = 32, 64, 16
    ops = (rng.normal(size=(K, d)), rng.random(K), 0.3 * rng.normal(size=(K, d, Cmax)),
           rng.permutation(K * Cmax).reshape(K, Cmax), rng.random((K, Cmax)),
           rng.random((K, Cmax)), rng.random((K, Cmax)) > 0.05,
           rng.normal(size=(K * Cmax, d)))
    q = rng.normal(size=(16, d)).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        tops = ivf_arrays_from_numpy(*ops, device=dev)
        out.append(ivf_query(torch.from_numpy(q).to(dev), *tops, metric="euclidean",
                             k=k, n_probe=4, rescore=True))
    assert ivf_cuda.launch_counts[ivf_cuda.row_key(min(64, max(16, k)))] > 0
    np.testing.assert_allclose(out[1][0].cpu().numpy(), out[0][0].numpy(), rtol=1e-4, atol=1e-4)
    assert np.mean(out[1][1].cpu().numpy() == out[0][1].numpy()) >= 0.98


@pytest.mark.parametrize("k", [10, 100])
def test_per_pair_row_mode_f32_on_cuda_matches_cpu(cuda, k):
    """The per-pair branch over f32 blocks (row mode of the f32 kernel on the
    card: the running top-R, R=16 at k=10 and R = Cmax = 64 at k=100)."""
    from quiver_tpu_torch.convert import ivf_arrays_from_numpy
    from quiver_tpu_torch.ops.ivf_kernels import ivf_query

    rng = np.random.default_rng(2)
    K, Cmax, d = 32, 64, 16
    ops = (rng.normal(size=(K, d)), rng.random(K), 0.3 * rng.normal(size=(K, d, Cmax)),
           rng.permutation(K * Cmax).reshape(K, Cmax), rng.random((K, Cmax)),
           rng.random((K, Cmax)), rng.random((K, Cmax)) > 0.05,
           rng.normal(size=(K * Cmax, d)))
    q = rng.normal(size=(16, d)).astype(np.float32)
    out = []
    key = (ivf_cuda.F32, ivf_cuda.row_key(min(64, max(16, k))))
    before = ivf_cuda.launch_counts.get(key, 0)
    for dev in ("cpu", cuda):
        tops = ivf_arrays_from_numpy(*ops, device=dev, blocks_dtype=torch.float32)
        out.append(ivf_query(torch.from_numpy(q).to(dev), *tops, metric="euclidean",
                             k=k, n_probe=4, rescore=True))
    assert ivf_cuda.launch_counts[key] == before + 1
    np.testing.assert_allclose(out[1][0].cpu().numpy(), out[0][0].numpy(), rtol=1e-4, atol=1e-4)
    assert np.mean(out[1][1].cpu().numpy() == out[0][1].numpy()) >= 0.98


#: row mode's R bands: the kernels' lists of 32 (R <= 32), 64, 112 and 128
#: entries and their edges, then the whole row above 128
ROW_RS = (16, 32, 33, 64, 100, 112, 113, 128, 129)


def _row_call(cuda, dtype, *, R, Cmax=384, d=100, B=300, P=3, K=37, seed=17):
    """Operands of one row-mode call (kernel_inputs' L2 epilogue) and its
    keywords at W = Cmax."""
    args, kw = chip_smoke.kernel_inputs(
        torch, cuda, B=B, P=P, K=K, Cmax=Cmax, d=d, metric="euclidean", variant="row",
        seed=seed, dtype=getattr(torch, dtype))
    W, pos_bits, sentinel = chip_smoke.variant_args("row", 0, R, 0, Cmax)
    return args, dict(kw, W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)


@pytest.mark.parametrize("d", [100, 768])
@pytest.mark.parametrize("R", ROW_RS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_mode_r_bands_match_twin(cuda, dtype, R, d):
    """Row mode at each band of R against block_topw_reference: the
    running top-R in the kernel up to 128 (lists of 32, 64, 112 and 128
    entries and their edges), the whole row and torch.topk at 129; the keys
    of each row in descending order, one launch counted under row_key(R)."""
    args, wkw = _row_call(cuda, dtype, R=R, d=d)
    key = ivf_cuda.row_key(R) if dtype == "bfloat16" else (ivf_cuda.F32, ivf_cuda.row_key(R))
    before = ivf_cuda.launch_counts.get(key, 0)
    got = ivf_cuda.block_topw(*args, **wkw)
    assert ivf_cuda.launch_counts[key] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (300 * 3, R)
    assert bool((got[:, 1:] < got[:, :-1]).all())  # distinct keys, descending
    chip_smoke.check_call(torch, args, wkw, got)


@pytest.mark.parametrize("R", ROW_RS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_mode_truncated_pairs_match_twin(cuda, dtype, R):
    """A shard's truncated pair list in row mode: the rows no sorted pair
    reaches hold the sentinel in every lane, the others the plain
    version's keys."""
    args, wkw = _row_call(cuda, dtype, R=R, seed=19)
    sargs, skw = _shard_of(torch, args, wkw, 12, 16)
    got = ivf_cuda.block_topw(*sargs, **skw)
    torch.cuda.synchronize()
    chip_smoke.check_call(torch, sargs, skw, got)
    hit = torch.zeros(300 * 3, dtype=torch.bool, device=cuda)
    hit[sargs[3].long()] = True
    assert bool((got[~hit] == ivf_cuda.KEY_MIN).all())


@pytest.mark.parametrize("R", [8, 16, 128, 160])
@pytest.mark.parametrize("dtype,Cmax", [("bfloat16", 8), ("bfloat16", 136), ("float32", 8),
                                        ("float32", 132)])
def test_row_mode_cmax_edges_match_twin(cuda, dtype, Cmax, R):
    """Row mode at the Cmax edges: one slab of 8 columns, and a slab and a
    partial one (136 for bf16 blocks, whose rows need Cmax % 8 == 0; 132
    for f32 ones); R past Cmax becomes R = Cmax (above 128: the whole
    row)."""
    R = min(R, Cmax)
    args, wkw = _row_call(cuda, dtype, R=R, Cmax=Cmax)
    got = ivf_cuda.block_topw(*args, **wkw)
    torch.cuda.synchronize()
    chip_smoke.check_call(torch, args, wkw, got)


@pytest.mark.parametrize("R", [16, 100, 128, 160])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_mode_allocates_no_whole_row(cuda, dtype, R):
    """Up to R=128 a row-mode call allocates no i32[B*P, Cmax]: its peak of
    allocated card bytes stays below that tensor's size. Above 128 the
    kernel writes the whole row, and the same measure sees it."""
    B, P, Cmax = 4096, 3, 1280
    args, wkw = _row_call(cuda, dtype, R=R, Cmax=Cmax, d=128, B=B, P=P, K=256)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    got = ivf_cuda.block_topw(*args, **wkw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    whole = B * P * Cmax * 4
    assert got.shape == (B * P, R)
    assert (peak >= whole) == (R > 128), (peak, whole)


@pytest.mark.parametrize("k", [10, 48, 100, 128, 160])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_per_pair_branch_large_k_on_cuda_matches_cpu(cuda, dtype, k):
    """ivf_query's per-pair branch at Cmax=256 (8 windows < k) on the card
    against the CPU copy of the same engine state: R = min(Cmax, max(16,
    k)) spans the kernel's list bands (16, 48, 100, 128) and the whole row
    (160). Distances agree (rescored, f32) and ids agree up to ties."""
    from quiver_tpu_torch.convert import ivf_arrays_from_numpy
    from quiver_tpu_torch.ops.ivf_kernels import ivf_query

    rng = np.random.default_rng(3)
    K, Cmax, d = 16, 256, 32
    ops = (rng.normal(size=(K, d)), rng.random(K), 0.3 * rng.normal(size=(K, d, Cmax)),
           rng.permutation(K * Cmax).reshape(K, Cmax), rng.random((K, Cmax)),
           rng.random((K, Cmax)), rng.random((K, Cmax)) > 0.05,
           rng.normal(size=(K * Cmax, d)))
    q = rng.normal(size=(16, d)).astype(np.float32)
    out = []
    key = ivf_cuda.row_key(min(Cmax, max(16, k)))
    key = key if dtype == "bfloat16" else (ivf_cuda.F32, key)
    before = ivf_cuda.launch_counts.get(key, 0)
    for dev in ("cpu", cuda):
        tops = ivf_arrays_from_numpy(*ops, device=dev, blocks_dtype=getattr(torch, dtype))
        out.append(ivf_query(torch.from_numpy(q).to(dev), *tops, metric="euclidean",
                             k=k, n_probe=4, rescore=True))
    assert ivf_cuda.launch_counts[key] == before + 1
    dg, ig = out[1][0].cpu().numpy(), out[1][1].cpu().numpy()
    dc, ic = out[0][0].numpy(), out[0][1].numpy()
    assert dg.shape == (16, k)
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-4)
    assert chip_smoke.ids_agree(ig, dg, ic, dc, rel=1e-4) == 0


@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("formulation", ["pairs", "fused"])
def test_ivf_index_on_cuda_matches_cpu(cuda, formulation, d):
    """The engine on the card against its CPU twin; d=768 (the reference
    deployment's embedding width) with a few thousand rows."""
    rng = np.random.default_rng(0)
    # 16 clusters of ~500 rows at d=768 keep Cmax >= 384, which the fused
    # formulation's 4 winners per 128 lanes need for k=10
    n, n_clusters = (20000, 64) if d == 64 else (8000, 16)
    centers = rng.normal(size=(100, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 100, n)] + 0.25 * rng.normal(size=(n, d))).astype(np.float32)
    queries = (vecs[:256] + 0.1 * rng.normal(size=(256, d))).astype(np.float32)
    cfg = dict(n_clusters=n_clusters, n_probe=4, build_threshold=256, formulation=formulation)
    engines = []
    for dev in ("cpu", cuda):
        store = VectorStore(dim=d, metric="euclidean", capacity=n, device=dev)
        store.add_batch([f"v{i}" for i in range(n)], vecs)
        engines.append(IVFIndex(store, config=IVFConfig(**cfg)))
    engines[0].build()
    engines[1].import_topology(engines[0].export_topology(), np.arange(n))
    ivf_cuda.reset_launch_counts()
    dg, ig = engines[1].search_slots(queries, 10)
    assert sum(ivf_cuda.launch_counts.values()) == 1
    dc, ic = engines[0].search_slots(queries, 10)
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-4)
    assert np.mean(ig == ic) >= 0.99


@pytest.mark.parametrize("blocks", [torch.bfloat16, torch.float32])
def test_ivf_einsum_on_cuda_matches_cpu(cuda, blocks):
    """formulation="einsum" (torch ops: the f32 GEMM over per-cluster query
    lists) on the card against its CPU twin, at a q_cap that drops pairs;
    it launches no block_topw."""
    rng = np.random.default_rng(5)
    n, d = 20000, 64
    centers = rng.normal(size=(100, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 100, n)] + 0.25 * rng.normal(size=(n, d))).astype(np.float32)
    queries = (vecs[:256] + 0.1 * rng.normal(size=(256, d))).astype(np.float32)
    cfg = dict(n_clusters=64, n_probe=4, build_threshold=256, formulation="einsum",
               q_cap_factor=1)
    engines = []
    for dev in ("cpu", cuda):
        store = VectorStore(dim=d, metric="euclidean", capacity=n, device=dev)
        store.add_batch([f"v{i}" for i in range(n)], vecs)
        engines.append(IVFIndex(store, config=IVFConfig(**cfg), compute_dtype=blocks))
    engines[0].build()
    engines[1].import_topology(engines[0].export_topology(), np.arange(n))
    assert engines[1]._blocks_t.dtype == blocks
    ivf_cuda.reset_launch_counts()
    dg, ig = engines[1].search_slots(queries, 10)
    assert sum(ivf_cuda.launch_counts.values()) == 0
    dc, ic = engines[0].search_slots(queries, 10)
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-4)
    assert np.mean(ig == ic) >= 0.99


@pytest.mark.parametrize("formulation", ["pairs", "fused"])
def test_ivf_index_f32_on_cuda_matches_cpu(cuda, formulation):
    """An engine built at compute_dtype=float32 (f32 blocks, the DB's
    default) on the card against its CPU twin."""
    rng = np.random.default_rng(4)
    n, d = 20000, 64
    centers = rng.normal(size=(100, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 100, n)] + 0.25 * rng.normal(size=(n, d))).astype(np.float32)
    queries = (vecs[:256] + 0.1 * rng.normal(size=(256, d))).astype(np.float32)
    cfg = dict(n_clusters=64, n_probe=4, build_threshold=256, formulation=formulation)
    engines = []
    for dev in ("cpu", cuda):
        store = VectorStore(dim=d, metric="euclidean", capacity=n, device=dev)
        store.add_batch([f"v{i}" for i in range(n)], vecs)
        engines.append(IVFIndex(store, config=IVFConfig(**cfg), compute_dtype=torch.float32))
    engines[0].build()
    engines[1].import_topology(engines[0].export_topology(), np.arange(n))
    assert engines[1]._blocks_t.dtype == torch.float32
    ivf_cuda.reset_launch_counts()
    dg, ig = engines[1].search_slots(queries, 10)
    assert sum(v for k, v in ivf_cuda.launch_counts.items() if k[0] == ivf_cuda.F32) == 1
    dc, ic = engines[0].search_slots(queries, 10)
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-4)
    assert np.mean(ig == ic) >= 0.99


def test_block_topw_f32_rejects_unaligned_cmax(cuda):
    """The f32 kernel copies whole float4s of each block row: Cmax % 4 != 0
    is refused before any launch."""
    args, kw = chip_smoke.kernel_inputs(
        torch, cuda, B=8, P=1, K=4, Cmax=34, d=16, metric="euclidean",
        variant="row", seed=3, dtype=torch.float32,
    )
    before = dict(ivf_cuda.launch_counts)
    with pytest.raises(ValueError, match="Cmax % 4"):
        ivf_cuda.block_topw(*args, **kw, W=34, R=16, pos_bits=6, sentinel=ivf_cuda.KEY_MIN)
    assert ivf_cuda.launch_counts == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_topw_f32_row_mode_rejects_other_sentinels(cuda, dtype):
    """Both kernels' running top-R admits only keys above its R-th best,
    which is the reference's passes only under the KEY_MIN sentinel."""
    args, kw = chip_smoke.kernel_inputs(
        torch, cuda, B=8, P=1, K=4, Cmax=64, d=16, metric="euclidean",
        variant="row", seed=3, dtype=getattr(torch, dtype),
    )
    before = dict(ivf_cuda.launch_counts)
    with pytest.raises(ValueError, match="KEY_MIN"):
        ivf_cuda.block_topw(*args, **kw, W=64, R=16, pos_bits=6,
                            sentinel=int(ivf_cuda._mask_key(64)))
    assert ivf_cuda.launch_counts == before


def test_block_topw_rejects_unaligned_cmax(cuda):
    """The blocks' tensor map needs a row stride of a multiple of 16 bytes:
    Cmax % 8 != 0 is refused before any launch."""
    args, kw = chip_smoke.kernel_inputs(
        torch, cuda, B=8, P=1, K=4, Cmax=36, d=16, metric="euclidean",
        variant="row", seed=3,
    )
    before = dict(ivf_cuda.launch_counts)
    with pytest.raises(ValueError, match="multiple of 8"):
        ivf_cuda.block_topw(*args, **kw, W=36, R=16, pos_bits=6, sentinel=ivf_cuda.KEY_MIN)
    assert ivf_cuda.launch_counts == before


def _scatter_case(case, dev):
    """Operands of one scatter_rows launch: the TPU probe's shape; an empty
    cluster; ranges that leave rows unwritten; a width of 64 lanes; one
    cluster with 90% of 24,000 rows (many row tiles of the kernel) beside an
    overlapping and a decreasing range; the overlapping, decreasing and
    empty ranges of test_torch_probe.py::test_scatter_rows_edges with a
    target outside the chunk."""
    from quiver_tpu_torch.benches import probe

    rng = np.random.default_rng(5)
    if case == "tpu_probe":
        st, pos, vals, _ = probe.tpu_scatter_inputs(**probe.TPU_SCATTER)
        K = probe.TPU_SCATTER["K"]
    elif case in ("skewed", "overlap"):
        if case == "skewed":
            nchunks, BPc, K, L = 2, 24000, 6, 128
            big = 9 * BPc // 10
            st = np.array([[0, big, big - 300, big + 100, big + 300, BPc - 40, BPc - 20],
                           [20, 20, big + 20, big - 500, big + 200, BPc, BPc]], dtype=np.int32)
        else:
            nchunks, BPc, K, L = 2, 40, 5, 8
            st = np.array([[2, 9, 9, 20, 31, 35], [0, 10, 5, 25, 30, 40]], dtype=np.int32)
        st = st.reshape(-1)
        pos = np.stack([rng.permutation(BPc) for _ in range(nchunks)]).astype(np.int32).reshape(-1)
        pos[3] = BPc + 7  # chunk 0, row 3: a target outside the chunk, skipped
        vals = rng.normal(size=(nchunks, BPc, L)).astype(np.float32)
    else:
        nchunks, BPc, K = 2, 1000, 7
        L = 64 if case == "lanes64" else 128
        lo, hi = (100, BPc - 150) if case == "unwritten_rows" else (0, BPc)
        cuts = np.sort(rng.integers(lo, hi, (nchunks, K + 1)), axis=1)
        cuts[:, 0], cuts[:, -1] = lo, hi  # unwritten_rows: head and tail stay -1
        if case == "empty_cluster":
            cuts[:, 3] = cuts[:, 2]  # cluster 2 holds no rows
        st = cuts.astype(np.int32).reshape(-1)
        pos = np.stack([rng.permutation(BPc) for _ in range(nchunks)]).astype(np.int32).reshape(-1)
        vals = rng.normal(size=(nchunks, BPc, L)).astype(np.float32)
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(st).to(dev),
            torch.from_numpy(pos).to(dev)), K


@pytest.mark.parametrize(
    "case", ["tpu_probe", "empty_cluster", "unwritten_rows", "lanes64", "skewed", "overlap"])
def test_scatter_rows_kernel_matches_plain(cuda, case):
    from quiver_tpu_torch.ops import probe_cuda

    (vals, starts, pos), K = _scatter_case(case, cuda)
    before = probe_cuda.launch_counts["scatter_rows"]
    got = probe_cuda.scatter_rows(vals, starts, pos, K=K)
    assert probe_cuda.launch_counts["scatter_rows"] == before + 1
    want = probe_cuda.scatter_rows_reference(vals, starts, pos, K=K)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "unwritten_rows":
        nchunks, BPc = vals.shape[:2]
        for c in range(nchunks):
            lo, hi = int(starts[c * (K + 1)]), int(starts[(c + 1) * (K + 1) - 1])
            outside = torch.ones(BPc, dtype=torch.bool, device=cuda)
            outside[pos[c * BPc + lo: c * BPc + hi].long()] = False
            assert int(outside.sum()) == BPc - (hi - lo) > 0
            assert bool((got[c][outside] == -1.0).all())


@pytest.mark.parametrize("n,grid,stride", [(65536, 4, 1000), (196_608, 3072, 64), (5, 1, 0),
                                           (320_000, 5000, 64)])
def test_index_read_kernel_matches_plain(cuda, n, grid, stride):
    from quiver_tpu_torch.ops import probe_cuda

    rng = np.random.default_rng(n)
    big = (torch.arange(n, dtype=torch.int32) if n == 65536
           else torch.from_numpy(rng.integers(-2**24, 2**24, n).astype(np.int32))).to(cuda)
    x = torch.full((1, 1), 0.5 if n == 5 else 0.0, device=cuda)
    before = probe_cuda.launch_counts["index_read"]
    got = probe_cuda.index_read(big, x, grid=grid, stride=stride)
    assert probe_cuda.launch_counts["index_read"] == before + 1
    want = probe_cuda.index_read_reference(big, x, grid=grid, stride=stride)
    assert got.shape == (1, 1) and torch.equal(got, want)
    if n == 65536:
        assert float(got) == 3000.0


def test_scatter_rows_rejects_ragged_lanes(cuda):
    from quiver_tpu_torch.ops import probe_cuda

    vals = torch.zeros(1, 8, 6, device=cuda)
    starts = torch.tensor([0, 8], dtype=torch.int32, device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    before = dict(probe_cuda.launch_counts)
    with pytest.raises(ValueError, match="L % 4"):
        probe_cuda.scatter_rows(vals, starts, pos, K=1)
    assert probe_cuda.launch_counts == before


# ------------------------------------------------------------ the live index


def _blob_engines(devices, *, n=20000, d=32, n_blobs=64, **cfg):
    """One store + IVF engine per device over the same rows: 64 blobs far
    apart, and a topology whose centroids are the blob centers, so every
    row's nearest centroid is unambiguous on any device (assignments and
    host maps can be compared exactly)."""
    rng = np.random.default_rng(3)
    centers = (4.0 * rng.normal(size=(n_blobs, d))).astype(np.float32)
    which = rng.integers(0, n_blobs, n)
    vecs = (centers[which] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    topo = {"kind": np.bytes_(b"ivf"), "centroids": centers,
            "assign": which.astype(np.int64),
            "cmax": np.int64((2 * n // n_blobs + 127) // 128 * 128)}
    config = dict(n_probe=8, build_threshold=256, **cfg)
    engines = []
    for dev in devices:
        store = VectorStore(dim=d, metric="euclidean", capacity=n, device=dev)
        store.add_batch([f"v{i}" for i in range(n)], vecs)
        eng = IVFIndex(store, config=IVFConfig(**config))
        eng.import_topology(topo, np.arange(n))
        engines.append(eng)
    return engines, centers, vecs


def _blob_rows(centers, n, seed):
    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(centers), n)
    return (centers[which] + 0.3 * rng.normal(size=(n, centers.shape[1]))).astype(np.float32)


def test_store_on_plain_cuda_serves(cuda):
    """``device="cuda"`` resolves to the card's index, so the engine's own
    query tensors (``cuda:0``) match the store's device."""
    (eng,), _, vecs = _blob_engines(("cuda",), n=4000)
    assert eng.store.device == torch.device("cuda", torch.cuda.current_device())
    assert eng.warmup(query_batches=(4,), write_batches=(4,)) >= 0
    _, i = eng.search_slots(vecs[:8] + 0.01, 1)
    assert (i[:, 0] == np.arange(8)).all()


def test_writes_and_background_refresh_on_cuda_match_cpu(cuda):
    """An insert/update/delete sequence and a churn-triggered background
    refresh (on the engine's maintenance stream on the card) leave the same
    host maps and serve the same results as on the CPU."""
    (ec, eg), centers, vecs = _blob_engines(("cpu", cuda), rebuild_growth=0.05)
    new, moved, more = (_blob_rows(centers, m, s) for m, s in ((500, 1), (100, 2), (300, 3)))
    for eng in (ec, eg):
        store = eng.store
        eng.on_insert(store.add_batch([f"n{i}" for i in range(500)], new), new)
        upd = [f"v{i}" for i in range(100)]
        store.update_batch(upd, moved)
        eng.on_update(np.asarray([store.slot_of(u) for u in upd]), moved)
        gone = [f"v{i}" for i in range(1000, 1200)]
        slots = np.asarray([store.slot_of(g) for g in gone])
        store.delete_batch(gone)
        eng.on_delete(slots)
        # below the trigger (a moved update counts twice: vacate + insert)
        assert eng._churn < 1000 and not eng.get_detailed_metrics()["maintenance"]["inflight"]
        eng.on_insert(store.add_batch([f"m{i}" for i in range(300)], more), more)  # > 0.05
        assert eng.wait_maintenance(timeout=120)
        m = eng.get_detailed_metrics()["maintenance"]
        assert m["error"] is None and m["swaps"] == 1 and eng._n_refreshes == 1
    assert eg._maint_stream is not None and ec._maint_stream is None
    np.testing.assert_array_equal(eg._slot_pos, ec._slot_pos)
    np.testing.assert_array_equal(eg._fill, ec._fill)
    assert eg._overflow == ec._overflow and eg._drift == ec._drift
    np.testing.assert_array_equal(eg._block_slot.cpu().numpy(), ec._block_slot.numpy())
    np.testing.assert_array_equal(eg._keep_dev().cpu().numpy(), ec._keep_dev().numpy())
    q = np.concatenate([vecs[:128], new[:64], moved[:32], more[:32]])
    q = (q + 0.05 * np.random.default_rng(9).normal(size=q.shape)).astype(np.float32)
    ivf_cuda.reset_launch_counts()
    dg, ig = eg.search_slots(q, 10)
    assert ivf_cuda.launch_counts[(32, 2)] == 1
    dc, ic = ec.search_slots(q, 10)
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-4)
    assert np.mean(ig == ic) >= 0.99


def test_queries_served_while_a_job_runs_on_the_maint_stream(cuda):
    """The main thread serves queries and writes while a refresh job runs on
    the maintenance stream (held after its staging layout is built):
    recall@10 >= 0.9 against the exact scan, no deleted slot returned; after
    the swap every row written during the job is found."""
    from quiver_tpu_torch import ExactIndex

    (eng,), centers, vecs = _blob_engines((cuda,), n=200_000, rebuild_growth=0.05)
    store = eng.store
    exact = ExactIndex(store)
    built, go = threading.Event(), threading.Event()
    make_staging = eng._make_staging

    def gated(kind):
        staging = make_staging(kind)
        refresh = staging.refresh

        def held():
            refresh()
            built.set()
            assert go.wait(120)

        staging.refresh = held
        return staging

    eng._make_staging = gated
    first = _blob_rows(centers, 12_000, 11)
    eng.on_insert(store.add_batch([f"a{i}" for i in range(len(first))], first), first)
    assert built.wait(120)
    assert eng.get_detailed_metrics()["maintenance"]["inflight"]
    during = _blob_rows(centers, 2000, 12)
    s_during = store.add_batch([f"d{i}" for i in range(2000)], during)
    eng.on_insert(s_during, during)
    dead_ids = [f"v{i}" for i in range(0, 4000, 2)]
    dead = np.asarray([store.slot_of(v) for v in dead_ids])
    store.delete_batch(dead_ids)
    eng.on_delete(dead)
    rng = np.random.default_rng(13)
    recalls = []
    for _ in range(8):
        q = (vecs[rng.integers(0, len(vecs), 256)] + 0.1 * rng.normal(size=(256, 32))).astype(np.float32)
        _, got = eng.search_slots(q, 10)
        _, truth = exact.search_slots(q, 10)
        recalls.append(np.mean([len(set(g) & set(t)) / 10 for g, t in zip(got, truth)]))
        assert not np.isin(got, dead).any()
    assert eng.get_detailed_metrics()["maintenance"]["inflight"]
    assert min(recalls) >= 0.9, recalls
    go.set()
    assert eng.wait_maintenance(timeout=120)
    m = eng.get_detailed_metrics()["maintenance"]
    assert m["error"] is None and m["swaps"] == 1
    _, got = eng.search_slots(during, 1)
    assert np.mean(got[:, 0] == s_during) >= 0.99
    _, got = eng.search_slots(vecs[:4000:2] + 0.01, 10)
    assert not np.isin(got, dead).any()


def test_server_on_cuda_serves_through_block_topw_f32(cuda):
    """The port's REST server over a DB on the card at its defaults (the
    hybrid over f32 IVF blocks): single searches over HTTP coalesce into
    batches that run ``block_topw_f32`` on the device's default stream,
    with recall@10 >= 0.9 against the exact scan."""
    from concurrent.futures import ThreadPoolExecutor

    from quiver_tpu_torch import DB, DBOptions, ExactIndex

    rng = np.random.default_rng(21)
    centers = rng.normal(size=(64, 32)).astype(np.float32)
    vecs = (centers[rng.integers(0, 64, 20_000)]
            + 0.2 * rng.normal(size=(20_000, 32))).astype(np.float32)
    db = DB(DBOptions(enable_persistence=False, device="cuda"))
    coll = db.create_collection("docs", 32, "euclidean", engine_config={
        "ivf": {"n_clusters": 64, "n_probe": 4, "build_threshold": 1024},
        "adaptive": {"exploration_factor": 0.0}})
    db.batch_insert("docs", [f"v{i}" for i in range(len(vecs))], vecs)
    assert coll.engine.ann._blocks_t.dtype == torch.float32 and coll.engine.ann._built
    streams = []
    search_batch = coll.search_batch

    def recorded(reqs):
        streams.append(torch.cuda.current_stream() == torch.cuda.default_stream())
        return search_batch(reqs)

    coll.search_batch = recorded
    queries = (vecs[rng.integers(0, len(vecs), 64)]
               + 0.05 * rng.normal(size=(64, 32))).astype(np.float32)
    f32 = [k for k in ivf_cuda.launch_counts if k[0] == ivf_cuda.F32]
    before = sum(ivf_cuda.launch_counts[k] for k in f32)
    st = chip_smoke.ServerThread(db, enable_metrics_server=False, coalesce_window_ms=20.0)

    def one(q):
        status, _, body = chip_smoke.http(st.port, "POST", "/api/v1/collections/docs/search",
                                          {"vector": q.tolist(), "top_k": 10})
        assert status == 200, body
        return [coll.store.slot_of(x["id"]) for x in body["results"]]

    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            got = np.asarray(list(ex.map(one, queries)))
    finally:
        st.stop(close_db=True)
    assert sum(ivf_cuda.launch_counts[k] for k in f32) > before
    assert streams and all(streams)
    _, truth = ExactIndex(coll.store).search_slots(queries, 10)
    recall = np.mean([len(set(g) & set(t)) / 10 for g, t in zip(got, truth)])
    assert recall >= 0.9, recall


def _hnsw_pair(devices, *, n=3000, d=32, seed=4, **cfg):
    """The same clustered rows in an HNSW index per device, built alike."""
    from quiver_tpu_torch.benches.common import make_clustered_corpus
    from quiver_tpu_torch.index.hnsw import HNSWIndex

    vecs, rng = make_clustered_corpus(n, d, seed=seed, n_centers=24)
    out = []
    for dev in devices:
        store = VectorStore(dim=d, metric="euclidean", device=dev)
        idx = HNSWIndex(store, build_batch=1024, **cfg)
        idx.on_insert(store.add_batch([f"v{i}" for i in range(n)], vecs), vecs)
        out.append(idx)
    q = (vecs[rng.integers(0, n, 64)] + 0.1 * rng.normal(size=(64, d))).astype(np.float32)
    return out, vecs, q


@pytest.mark.parametrize("visited", ["ring", "bitmap"])
def test_hnsw_search_on_cuda_matches_cpu_on_one_graph(cuda, visited):
    """The CPU build's graph imported on the card: one launch of the
    descent kernel and one of the beam kernel a call on the card, none on
    the CPU; the search gives the
    same ids (up to swaps of entries tied within 1e-4) and distances to
    atol 1e-4: the graph's affine f32 distance rounds by ~eps(|q|^2 +
    |v|^2) / d, which reaches ~2e-5 at the nearest rows here (|v|^2 ~ 34,
    d ~ 0.5), summed in another order on each device."""
    from quiver_tpu_torch.convert import hnsw_from_topology

    (ic,), vecs, q = _hnsw_pair(("cpu",), visited=visited)
    store = VectorStore(dim=vecs.shape[1], metric="euclidean", device=cuda)
    store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    ig = hnsw_from_topology(store, ic.export_topology(), visited=visited)
    from quiver_tpu_torch.ops import hnsw_cuda

    hnsw_cuda.reset_launch_counts()
    dc, sc = ic.search_slots(q, 10)
    assert hnsw_cuda.launch_counts == {"hnsw_beam": 0, "hnsw_descent": 0}
    assert ig.current_max_level >= 1
    dg, sg = ig.search_slots(q, 10)
    assert hnsw_cuda.launch_counts == {"hnsw_beam": 1, "hnsw_descent": 1}
    np.testing.assert_allclose(dg, dc, rtol=1e-5, atol=1e-4)
    assert chip_smoke.ids_agree(sg, dg, sc, dc, rel=1e-4) == 0


def test_hnsw_build_on_cuda_matches_cpu(cuda):
    """Builds of the same rows from the same seed on the card and on the
    CPU: the same levels and entry point, at least 95% of the layer-0 rows
    identical, recall within 0.02 of each other."""
    from quiver_tpu_torch.index.exact import ExactIndex

    (ic, ig), vecs, q = _hnsw_pair(("cpu", cuda))
    np.testing.assert_array_equal(ig.node_level, ic.node_level)
    assert ig.entry_point == ic.entry_point
    assert (ig.layer0.adj == ic.layer0.adj).all(axis=1).mean() >= 0.95
    chip_smoke.hnsw_invariants(torch, ig)
    _, truth = ExactIndex(ic.store).search_slots(q, 10)
    rec = [np.mean([len(set(s[b]) & set(truth[b])) / 10 for b in range(len(q))])
           for s in (ig.search_slots(q, 10)[1], ic.search_slots(q, 10)[1])]
    assert abs(rec[0] - rec[1]) <= 0.02 and rec[0] >= 0.9


def _beam_case(dev, *, n=3000, d=32, deg=32, seed=0, integer=True, B=37, aligned=True):
    """(queries, entries, vectors, valid, adj, pos_map) of a layer-0 graph on
    ``dev``: each row's ``deg`` nearest other rows (f64, stable order), 5%
    of the entries knocked out to -1, rows in a permuted order, 5% of the
    slots tombstoned, 3% of the slots with no row (pos_map -1), one query
    without an entry and one whose entry is tombstoned. ``integer``: small
    integer coordinates, so every f32 sum is exact in any order; else
    Gaussian clusters. ``aligned=False`` puts the vectors 4 bytes past a
    16-byte boundary (contiguous, so the wrapper passes them as they are)."""
    rng = np.random.default_rng(seed)
    if integer:
        vecs = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
        q = rng.integers(-3, 4, size=(B, d)).astype(np.float32)
    else:
        centers = rng.normal(size=(12, d))
        vecs = (centers[rng.integers(0, 12, n)] + 0.4 * rng.normal(size=(n, d))).astype(np.float32)
        q = (vecs[rng.integers(0, n, B)] + 0.3 * rng.normal(size=(B, d))).astype(np.float32)
    v = vecs.astype(np.float64)
    d2 = (v * v).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2 * v @ v.T
    np.fill_diagonal(d2, np.inf)
    adj = np.argsort(d2, axis=1, kind="stable")[:, :deg].astype(np.int32)
    adj[rng.random(adj.shape) < 0.05] = -1
    perm = rng.permutation(n)  # row r holds slot perm[r]
    pos_map = np.empty(n, np.int64)
    pos_map[perm] = np.arange(n)
    pos_map[rng.random(n) < 0.03] = -1
    valid = rng.random(n) >= 0.05
    entries = rng.integers(0, n, B).astype(np.int64)
    entries[0] = -1
    entries[1] = int(np.flatnonzero(~valid)[0])
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (q, entries, vecs, valid, adj[perm], pos_map)]
    if not aligned:
        flat = torch.empty(n * d + 1, dtype=torch.float32, device=dev)
        out[2] = flat[1:].view(n, d).copy_(out[2])
        assert out[2].is_contiguous() and out[2].data_ptr() % 16 == 4
    return tuple(out)


def _beam_both(monkeypatch, args, *, metric, ef, expand, visited, compute_dtype=torch.float32):
    """The kernel and its plain version ``_beam_rows`` on the card, over the
    same inputs: ((dist, ids, iters, accepted, loops) of each). The plain
    version tests "all done" every iteration, so its loop count is the
    kernel's."""
    from quiver_tpu_torch.ops import hnsw_cuda
    from quiver_tpu_torch.ops import hnsw_kernels as hk

    deg = args[4].shape[1]
    kw = dict(metric=hk.DistanceType.parse(metric), ef=ef, max_iters=int(1.5 * ef) + 8,
              compute_dtype=compute_dtype, expand=expand)
    monkeypatch.setattr(hk, "BEAM_CHECK_EVERY", 1)
    st = {}
    pd, pi = hk._beam_rows(*args, bitmap=visited == "bitmap", stats=st,
                           sizes=hk.beam_sizes(ef, deg, expand), **kw)
    before = hnsw_cuda.launch_counts["hnsw_beam"]
    sk = {}
    kd, ki = hk.beam_search(*args, visited=visited, stats=sk, **kw)
    assert hnsw_cuda.launch_counts["hnsw_beam"] == before + 1
    torch.cuda.synchronize()
    return ((kd, ki, sk["iters"], sk["accepted"], sk["loops"]),
            (pd, pi, st["_iters"][0], st["_accepted"][0], st["loops"]))


#: (visited, expand, deg, ef, metric, d, aligned) of the bitwise card test:
#: every mix at d=32 over aligned rows (the kernel's float4 loads), then
#: its scalar loads (``warp_rows<false>``), taken where d is not a multiple
#: of 4 or the vectors are not 16-byte aligned
BEAM_BITWISE_CASES = [
    (visited, expand, deg, ef, metric, 32, True)
    for visited in ("ring", "bitmap") for expand in (1, 4) for deg in (16, 32)
    for ef in (10, 100, 320)
    for metric in ("euclidean", "squared_euclidean", "dot_product", "manhattan")
] + [
    (visited, 4, 32, 100, metric, d, aligned)
    for visited in ("ring", "bitmap") for d, aligned in ((30, True), (37, True), (32, False))
    for metric in ("euclidean", "manhattan")
]


@pytest.mark.parametrize("visited,expand,deg,ef,metric,d,aligned", BEAM_BITWISE_CASES)
def test_hnsw_beam_kernel_matches_plain_bitwise(cuda, monkeypatch, visited, expand, deg, ef,
                                                metric, d, aligned):
    """csrc/hnsw_beam.cu against ``_beam_rows`` on the card, on integer
    coordinates (every sum exact in any order): distances, ids, each
    query's active iterations and accepted candidates, and the loop count
    equal bit for bit, the ties of the integer distances included (the
    merge's order on equal distances: the beam first, then the lower
    column)."""
    args = _beam_case(cuda, d=d, deg=deg, seed=deg + expand + ef, aligned=aligned)
    (kd, ki, kit, kacc, kl), (pd, pi, pit, pacc, pl) = _beam_both(
        monkeypatch, args, metric=metric, ef=ef, expand=expand, visited=visited)
    assert kd.shape == (37, ef) and ki.dtype == torch.int64
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(ki, pi)
    assert torch.equal(kit, pit) and torch.equal(kacc, pacc) and kl == pl
    assert (ki[:2] == -1).all() and int(kit.max()) > 8 and int(kacc.max()) > 0


@pytest.mark.parametrize("visited", ["ring", "bitmap"])
def test_hnsw_beam_kernel_cosine_bf16_matches_plain(cuda, monkeypatch, visited):
    """Gaussian clusters, cosine, bf16-rounded products (f32 norms): sums in
    another order, so distances to rtol 1e-5 and ids equal except swaps of
    entries within 1e-5 relative (the beam tests' tolerance)."""
    args = _beam_case(cuda, integer=False, seed=11)
    (kd, ki, *_), (pd, pi, *_) = _beam_both(
        monkeypatch, args, metric="cosine", ef=100, expand=4, visited=visited,
        compute_dtype=torch.bfloat16)
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    np.testing.assert_array_equal(ki < 0, pi < 0)
    np.testing.assert_allclose(kd[pi >= 0], pd[pi >= 0], rtol=1e-5, atol=1e-6)
    assert chip_smoke.ids_agree(ki, kd, pi, pd, rel=1e-5) == 0


def test_hnsw_beam_kernel_refuses_sizes_past_its_limits(cuda):
    """An ef whose beam does not fit a CTA's shared memory raises before
    any launch, on CUDA only: the CPU runs the plain version."""
    from quiver_tpu_torch.ops import hnsw_cuda
    from quiver_tpu_torch.ops import hnsw_kernels as hk

    args = _beam_case(cuda, n=600)
    before = hnsw_cuda.launch_counts["hnsw_beam"]
    with pytest.raises(ValueError, match="shared memory"):
        hk.beam_search(*args, metric="euclidean", ef=20_000, max_iters=8)
    assert hnsw_cuda.launch_counts["hnsw_beam"] == before


def _descent_case(dev, *, n=2000, d=32, deg=16, levels=4, seed=0, B=37, aligned=True):
    """(queries, entries, vectors, valid, layers) of an upper-layer graph on
    ``dev``, ``layers`` its (adj, pos_map) pairs top first. Small integer
    coordinates, so every f32 sum is exact in any order, and one row in ten
    a copy of another (equal distances on purpose: the lower column wins).
    Level l holds the first max(24, n 0.7**l) slots of a permutation, so
    each level's members are members of the level below (nested); a row is
    a member's ``deg`` nearest other members (f64, stable order), 5% of the
    entries knocked out to -1, rows in a permuted order, 3% of the members
    with no row (pos_map -1); 5% of the slots tombstoned. The queries start
    at top-level members, one at -1 and one at a tombstoned slot.
    ``aligned=False`` puts the vectors 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    twins = rng.choice(n, n // 10, replace=False)
    vecs[twins] = vecs[rng.integers(0, n, len(twins))]
    q = rng.integers(-3, 4, size=(B, d)).astype(np.float32)
    valid = rng.random(n) >= 0.05
    order = rng.permutation(n)
    layers = []
    for level in range(levels, 0, -1):
        members = order[:max(24, int(n * 0.7**level))]
        v = vecs[members].astype(np.float64)
        d2 = (v * v).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2 * v @ v.T
        np.fill_diagonal(d2, np.inf)
        sub = np.argsort(d2, axis=1, kind="stable")[:, :deg]
        adj = np.where(rng.random(sub.shape) < 0.05, -1, members[sub]).astype(np.int32)
        perm = rng.permutation(len(members))  # row r holds member perm[r]
        pos_map = np.full(n, -1, np.int64)
        pos_map[members[perm]] = np.arange(len(members))
        pos_map[members[rng.random(len(members)) < 0.03]] = -1
        layers.append((torch.from_numpy(adj[perm]).to(dev), torch.from_numpy(pos_map).to(dev)))
    top = order[:max(24, int(n * 0.7**levels))]
    entries = rng.choice(top, B).astype(np.int64)
    entries[0] = -1
    entries[1] = int(np.flatnonzero(~valid)[0])
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (q, entries, vecs, valid)]
    if not aligned:
        flat = torch.empty(n * d + 1, dtype=torch.float32, device=dev)
        out[2] = flat[1:].view(n, d).copy_(out[2])
        assert out[2].is_contiguous() and out[2].data_ptr() % 16 == 4
    return (*out, layers)


def _descent_both(args, *, metric, compute_dtype=torch.float32):
    """The kernel and its plain version ``_descend_chain`` on the card over
    the same inputs: ((dist, ids, steps), launches) of the kernel and
    (dist, ids, steps) of the chain."""
    from quiver_tpu_torch.ops import hnsw_cuda
    from quiver_tpu_torch.ops import hnsw_kernels as hk

    metric = hk.DistanceType.parse(metric)
    kw = dict(metric=metric, compute_dtype=compute_dtype, max_iters=hk.DESCENT_MAX_ITERS)
    sp = {}
    pd, pi = hk._descend_chain(*args, stats=sp, **kw)
    before = hnsw_cuda.launch_counts["hnsw_descent"]
    st = {}
    kd, ki = hnsw_cuda.descend(*args, stats=st, **kw)
    launches = hnsw_cuda.launch_counts["hnsw_descent"] - before
    torch.cuda.synchronize()
    return (kd, ki, st["descent_steps"]), launches, (pd, pi, sp["descent_steps"])


#: (metric, compute dtype, d, aligned, deg, levels) of the bitwise card
#: test: every metric in both dtypes over aligned rows at d=32 (the float4
#: loads), the scalar loads (d not a multiple of 4, or rows not 16-byte
#: aligned), degrees that take 4 and 1 lanes a neighbour and two passes of
#: a row (8, 32, 48), and a graph of 20 levels, past the 16 of one launch
DESCENT_BITWISE_CASES = [
    (metric, dtype, 32, True, 16, 4)
    for metric in ("euclidean", "squared_euclidean", "dot_product", "cosine", "manhattan")
    for dtype in ("float32", "bfloat16")
] + [
    (metric, "float32", d, aligned, 16, 4)
    for d, aligned in ((30, True), (37, True), (32, False)) for metric in ("euclidean", "manhattan")
] + [
    ("euclidean", "float32", 32, True, deg, 4) for deg in (8, 32, 48)
] + [
    (metric, "float32", 32, True, 16, 20) for metric in ("euclidean", "cosine")
]


@pytest.mark.parametrize("metric,dtype,d,aligned,deg,levels", DESCENT_BITWISE_CASES)
def test_hnsw_descent_kernel_matches_plain_bitwise(cuda, metric, dtype, d, aligned, deg, levels):
    """csrc/hnsw_beam.cu's descent against its plain version
    ``_descend_chain`` on the card, on integer coordinates (every sum exact
    in any order): each query's final distance, id and steps equal bit for
    bit, the ties included (the lower column wins); one launch per 16
    layers."""
    args = _descent_case(cuda, d=d, deg=deg, levels=levels, seed=deg + levels + d,
                         aligned=aligned)
    (kd, ki, ks), launches, (pd, pi, ps) = _descent_both(
        args, metric=metric, compute_dtype=getattr(torch, dtype))
    assert launches == -(-levels // 16)
    assert kd.dtype == torch.float32 and ki.dtype == torch.int64 and ks.dtype == torch.int64
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(ki, pi) and torch.equal(ks, ps)
    assert int(ks.min()) >= levels and int(ks.max()) > levels  # some query moved


def test_hnsw_descent_kernel_stops_at_the_step_cap(cuda):
    """A line of 200 nodes (i at i e_1), each linked to its two neighbours,
    walked from node 0 towards node 199 over the same layer three times:
    32 steps a layer, every one a move, so the walk ends at node 96 with 96
    steps, as the plain chain does."""
    n, d = 200, 32
    vecs = torch.zeros(n, d)
    vecs[:, 0] = torch.arange(n, dtype=torch.float32)
    adj = torch.full((n, 16), -1, dtype=torch.int32)
    adj[:-1, 0] = torch.arange(1, n, dtype=torch.int32)
    adj[1:, 1] = torch.arange(0, n - 1, dtype=torch.int32)
    layer = (adj.to(cuda), torch.arange(n, device=cuda))
    q = torch.zeros(4, d, device=cuda)
    q[:, 0] = float(n - 1)
    args = (q, torch.zeros(4, dtype=torch.int64, device=cuda), vecs.to(cuda),
            torch.ones(n, dtype=torch.bool, device=cuda), [layer] * 3)
    (kd, ki, ks), launches, (pd, pi, ps) = _descent_both(args, metric="euclidean")
    assert launches == 1
    assert ki.tolist() == pi.tolist() == [96] * 4 and ks.tolist() == ps.tolist() == [96] * 4
    assert kd.tolist() == pd.tolist() == [float(n - 1 - 96)] * 4


def test_hnsw_descend_on_cuda_makes_no_host_sync(cuda):
    """``hnsw_kernels.descend`` on CUDA tensors: one launch, no
    synchronisation with the host (``set_sync_debug_mode("error")`` raises
    on any), its steps on the card, the chain's ids."""
    from quiver_tpu_torch.ops import hnsw_cuda
    from quiver_tpu_torch.ops import hnsw_kernels as hk

    q, entries, vecs, valid, layers = _descent_case(cuda, seed=3)
    want = hk.descend(q, entries, vecs, valid, layers, metric="euclidean")  # builds, loads
    before = hnsw_cuda.launch_counts["hnsw_descent"]
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hk.descend(q, entries, vecs, valid, layers, metric="euclidean", stats=stats)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert hnsw_cuda.launch_counts["hnsw_descent"] == before + 1
    assert torch.equal(got, want) and stats["descent_steps"].device == cuda
    plain = {}
    _, pi = hk._descend_chain(q, entries, vecs, valid, layers, metric=hk.DistanceType.EUCLIDEAN,
                              compute_dtype=torch.float32, stats=plain)
    assert torch.equal(got, pi) and torch.equal(stats["descent_steps"], plain["descent_steps"])


def test_hnsw_descent_kernel_refuses_sizes_past_its_limits(cuda):
    """A query whose two copies (f32 and bf16-rounded) for four warps do not
    fit a CTA's shared memory, and an adjacency with no column, raise
    before any launch."""
    from quiver_tpu_torch.ops import hnsw_cuda
    from quiver_tpu_torch.ops import hnsw_kernels as hk

    before = hnsw_cuda.launch_counts["hnsw_descent"]
    n, d = 64, 7300
    args = (torch.zeros(2, d, device=cuda), torch.zeros(2, dtype=torch.int64, device=cuda),
            torch.zeros(n, d, device=cuda), torch.ones(n, dtype=torch.bool, device=cuda))
    layer = (torch.zeros((n, 4), dtype=torch.int32, device=cuda), torch.arange(n, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        hk.descend(*args, [layer], metric="euclidean", compute_dtype=torch.bfloat16)
    empty = (torch.zeros((n, 0), dtype=torch.int32, device=cuda), layer[1])
    with pytest.raises(ValueError, match="one column"):
        hk.descend(*args, [empty], metric="euclidean")
    assert hnsw_cuda.launch_counts["hnsw_descent"] == before


# ------------------------------------------------ meshes of distinct devices


def _pairs_call(dev, dtype):
    """One pairs-stage ``block_topw`` call's operands on ``dev``."""
    args, kw = chip_smoke.kernel_inputs(
        torch, dev, B=300, P=3, K=37, Cmax=384, d=100, metric="euclidean",
        variant="pairs", seed=3, dtype=getattr(torch, dtype),
    )
    W, pos_bits, sentinel = chip_smoke.variant_args("pairs", 32, 2, 5, 384)
    return args, dict(kw, W=W, R=2, pos_bits=pos_bits, sentinel=sentinel)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_block_topw_keeps_the_callers_current_device(cuda, dtype):
    """A launch leaves the calling thread's current device as it found it
    (the entry points restore it, ``csrc/device_guard.cuh``), whichever
    card is current and whichever card the tensors are on; the keys match
    the plain version's."""
    n = torch.cuda.device_count()
    try:
        for i in range(n):
            args, wkw = _pairs_call(torch.device("cuda", i), dtype)
            for cur in range(n):
                torch.cuda.set_device(cur)
                got = ivf_cuda.block_topw(*args, **wkw)
                assert torch.cuda.current_device() == cur
            torch.cuda.synchronize()
            chip_smoke.check_call(torch, args, wkw, got)
    finally:
        torch.cuda.set_device(0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_block_topw_on_a_second_card_leaves_card_0_current(cuda, dtype):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards: one card cannot tell a kept device from a set one")
    torch.cuda.set_device(0)
    args, wkw = _pairs_call(torch.device("cuda", 1), dtype)
    got = ivf_cuda.block_topw(*args, **wkw)
    assert torch.cuda.current_device() == 0
    assert torch.empty(1, device="cuda").device == torch.device("cuda", 0)
    torch.cuda.synchronize()
    chip_smoke.check_call(torch, args, wkw, got)


MESH_KINDS = ["exact", "ivf_bf16", "ivf_f32", "hnsw"]


def _mesh_twins(kind, mesh, twin_mesh, *, n=6000, d=32):
    """(engine over ``mesh``, its twin over ``twin_mesh``, the store on
    cuda:0, queries, the rows): one topology, the twin's built and the
    engine's imported from its sidecar."""
    from quiver_tpu_torch.benches.common import make_clustered_corpus
    from quiver_tpu_torch.parallel.sharded import ShardedExactIndex
    from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex
    from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    vecs, rng = make_clustered_corpus(n, d, seed=11, n_centers=24)
    store = VectorStore(dim=d, metric="euclidean", device="cuda:0")
    slots = store.add_batch([f"v{i}" for i in range(n)], vecs)
    q = (vecs[rng.integers(0, n, 128)] + 0.1 * rng.normal(size=(128, d))).astype(np.float32)
    if kind == "exact":
        return ShardedExactIndex(store, mesh), ShardedExactIndex(store, twin_mesh), store, q, vecs
    if kind == "hnsw":
        twin = ShardedHNSWIndex(store, twin_mesh, build_batch=1024, ef_search=64,
                                compute_dtype=torch.float32)
        eng = ShardedHNSWIndex(store, mesh, build_batch=1024, ef_search=64,
                               compute_dtype=torch.float32)
    else:
        dt = torch.bfloat16 if kind == "ivf_bf16" else torch.float32
        cfg = dict(n_probe=8, build_threshold=256, rescore=False, background_maintenance=False)
        twin = ShardedIVFIndex(store, twin_mesh, config=IVFConfig(**cfg), compute_dtype=dt)
        eng = ShardedIVFIndex(store, mesh, config=IVFConfig(**cfg), compute_dtype=dt)
    twin.on_insert(slots, vecs)
    eng.import_topology(twin.export_topology(), np.arange(store.capacity))
    return eng, twin, store, q, vecs


def _mesh_answers(eng, twin, store, q, vecs):
    """Searches, writes through both engines, searches again, a negative
    rerank: every answer pair held up to tie swaps; the current device and
    the store's view checked."""
    from quiver_tpu_torch.utils.memory import store_device_bytes

    rng = np.random.default_rng(2)
    with chip_smoke.LiveCheck() as live, chip_smoke.DeviceCheck() as dc:
        pairs = [(eng.search_slots(q, 10), twin.search_slots(q, 10))]
        new = (vecs[:64] + 0.01 * rng.normal(size=(64, vecs.shape[1]))).astype(np.float32)
        slots = store.add_batch([f"n{i}" for i in range(64)], new)
        moved = (vecs[64:96] + 0.02).astype(np.float32)
        store.update_batch([f"v{i}" for i in range(64, 96)], moved)
        gone = np.asarray([store.slot_of(f"v{i}") for i in range(96, 128)])
        store.delete_batch([f"v{i}" for i in range(96, 128)])
        for e in (eng, twin):
            if hasattr(e, "on_insert"):
                e.on_insert(slots, new)
                e.on_update(np.arange(64, 96), moved)
                e.on_delete(gone)
        pairs.append((eng.search_slots(new, 10), twin.search_slots(new, 10)))
        neg = q[::-1].copy()
        pairs.append((eng.search_slots(q, 5, negative=neg, negative_weight=1.0),
                      twin.search_slots(q, 5, negative=neg, negative_weight=1.0)))
    dc.verify(torch, "mesh engines")
    if live.calls:
        live.verify(torch, "mesh engines")
    for j, ((de, ie), (dt_, it)) in enumerate(pairs):
        assert chip_smoke.ids_agree(ie, de, it, dt_, rel=1e-4) == 0
        assert j == 0 or not np.isin(ie, gone).any()  # searched after the deletes
    assert store_device_bytes(store) == 0


@pytest.mark.parametrize("kind", MESH_KINDS)
def test_sharded_engine_on_mixed_mesh_matches_colocated_twin(cuda, kind):
    """A shard on the card and a shard on the CPU (the CPU's runs the plain
    versions) against two shards on the card, one topology."""
    eng, twin, store, q, vecs = _mesh_twins(kind, ("cuda:0", "cpu"), ("cuda:0", "cuda:0"))
    _mesh_answers(eng, twin, store, q, vecs)


def test_sharded_hnsw_mixed_mesh_serves_a_side_stream(cuda):
    """The mixed mesh's two beams run on the engine's pool threads: from a
    caller on a side stream, they search the query that stream wrote (held
    back behind a sleep) and answer as from the default stream; the pool is
    made once."""
    eng, _, _, q, _ = _mesh_twins("hnsw", ("cuda:0", "cpu"), ("cuda:0", "cuda:0"))
    want_d, want_i = eng.search_device(torch.from_numpy(q).to("cuda:0"), 64, 10)
    pool = eng._pool
    side = torch.cuda.Stream()
    host = torch.from_numpy(q).pin_memory()
    with torch.cuda.stream(side):
        qd = torch.zeros(q.shape, device="cuda:0")
        torch.cuda._sleep(100_000_000)
        qd.copy_(host, non_blocking=True)
        got_d, got_i = eng.search_device(qd, 64, 10)
    torch.cuda.synchronize()
    assert eng._pool is pool and pool is not None
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


@pytest.mark.parametrize("kind", MESH_KINDS)
def test_sharded_engine_across_every_card_matches_one_card(cuda, kind):
    """``mesh=None`` (one shard per card) against as many shards on cuda:0."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards: mesh=None is one shard on one card")
    eng, twin, store, q, vecs = _mesh_twins(kind, None, ("cuda:0",) * n)
    assert len(eng.mesh) == n and len(set(eng.mesh)) == n
    _mesh_answers(eng, twin, store, q, vecs)
