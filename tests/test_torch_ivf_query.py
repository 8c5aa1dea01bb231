"""``quiver_tpu_torch.ops.ivf_kernels.ivf_query`` against
``quiver_tpu.ops.ivf_kernels.ivf_query`` on identical block arrays.

The arrays follow the recipe of ``__graft_entry__.py:30-58`` at a small size
(K=16 clusters of Cmax=512, d=32, B=16, n_probe=4), built once in numpy,
rounded to bf16 by JAX and carried into torch by ``convert.py``; or, at
``compute_dtype=float32`` (the database's default), kept as f32 blocks in
both packages. The JAX side runs with exact top-k (``probe_approx=None``)
and its fused stage in Pallas interpret mode; ``formulation="einsum"`` runs
at ``q_cap=64``, where no pair drops.

Tolerances:
* ``rescore=True``: exact f32 distances, rtol/atol 1e-4 (summation order);
* ``rescore=False``: distances derive from the packed stage scores, which
  both packages quantize alike (2^-18 relative at 5 position bits, 2^-12 at
  11; einsum's f32 scores carry none) and sum in different orders, so the
  derived quantity (d^2 for L2, 1 - d for dot/cosine) agrees within two
  quanta of the score, plus 8 f32 ulps of it for the affine identity's
  rounding, plus 1e-4;
* ids agree wherever the reference's distances are separated from the k-th
  by more than the tolerance, and the tie-aware recall@k against an f64
  oracle agrees within 0.01.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops.ivf_kernels import ivf_query as jax_ivf_query
from quiver_tpu_torch.convert import bf16_to_torch, ivf_arrays_from_numpy
from quiver_tpu_torch.ops.ivf_kernels import ivf_query

from tests.test_torch_store_exact import assert_topk_agree

KTOP = 10


def graft_arrays(K=16, Cmax=512, d=32, B=16, seed=0, keep_frac=0.95):
    """The ivf_query operands of __graft_entry__.entry() at a chosen size,
    with a random keep mask so masked block entries are exercised."""
    rng = np.random.default_rng(seed)
    cap = K * Cmax
    centers = 4.0 * rng.normal(size=(K, d)).astype(np.float32)
    assign = np.arange(cap) % K
    vectors = (centers[assign] + 0.3 * rng.normal(size=(cap, d))).astype(np.float32)
    cents = np.stack([vectors[assign == c].mean(axis=0) for c in range(K)]).astype(np.float32)
    resid = vectors - cents[assign]
    order = np.argsort(assign, kind="stable")
    blocks_t = np.ascontiguousarray(resid[order].reshape(K, Cmax, d).transpose(0, 2, 1))
    block_slot = order.reshape(K, Cmax).astype(np.int32)
    block_rns = np.sum(resid[order].reshape(K, Cmax, d) ** 2, axis=2).astype(np.float32)
    ns = np.sum(vectors ** 2, axis=1)
    block_inv = (1.0 / np.sqrt(np.maximum(ns[order], 1e-30))).reshape(K, Cmax).astype(np.float32)
    keep = rng.random((K, Cmax)) < keep_frac
    queries = (vectors[:B] + 0.1 * rng.normal(size=(B, d))).astype(np.float32)
    ops = (cents, np.sum(cents ** 2, axis=1), blocks_t, block_slot, block_rns,
           block_inv, keep, vectors)
    return queries, ops


def run_both(queries, ops, *, metric, formulation, rescore, n_probe=4, seg_width=32,
             probe_sel_approx=None, k=KTOP, f32=False, q_cap=64):
    """Both packages' ivf_query on the same operands; ``f32``: f32 blocks
    and ``compute_dtype=float32`` (else bf16 blocks, the JAX default).
    ``q_cap`` (einsum only) 64 holds every pair of the default B*P = 64."""
    jops = [jnp.asarray(o) for o in ops]
    jops[2] = jops[2].astype(jnp.float32 if f32 else jnp.bfloat16)
    dj, ij = jax_ivf_query(
        jnp.asarray(queries), *jops, metric=metric, k=k, n_probe=n_probe,
        q_cap=q_cap, probe_approx=None, probe_sel_approx=probe_sel_approx,
        formulation=formulation, seg_width=seg_width, rescore=rescore,
        fused_interpret=True, compute_dtype=jnp.float32 if f32 else jnp.bfloat16,
    )
    tops = ivf_arrays_from_numpy(*[np.asarray(o) for o in jops], device="cpu",
                                 blocks_dtype=torch.float32 if f32 else torch.bfloat16)
    assert tops[2].dtype == (torch.float32 if f32 else torch.bfloat16)
    dt, it = ivf_query(
        torch.from_numpy(queries), *tops, metric=metric, k=k, n_probe=n_probe, q_cap=q_cap,
        probe_sel_approx=probe_sel_approx, formulation=formulation,
        seg_width=seg_width, rescore=rescore,
    )
    assert dt.dtype == torch.float32 and it.dtype == torch.int64
    return np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()


def oracle_dist(q, vectors, slots, metric):
    """f64 distances of the given slots (-1 -> inf)."""
    v = vectors[np.maximum(slots, 0)].astype(np.float64)
    qq = q.astype(np.float64)[:, None, :]
    if metric in ("euclidean", "squared_euclidean"):
        d = np.sum((v - qq) ** 2, axis=2)
    elif metric == "dot_product":
        d = -np.sum(v * qq, axis=2)
    else:
        d = -np.sum(v * qq, axis=2) / np.linalg.norm(v, axis=2)
    return np.where(slots >= 0, d, np.inf)


def tie_recall(slots, q, ops, metric):
    """Tie-aware recall@k (k = the slots' width) of ``slots`` against the
    exact f64 top-k over the kept rows: a hit is a returned row no farther
    than the true k-th."""
    vectors, keep, block_slot = ops[7], ops[6], ops[3]
    live = block_slot[keep]
    d_all = oracle_dist(q, vectors, np.broadcast_to(live, (len(q), len(live))), metric)
    kth = np.sort(d_all, axis=1)[:, slots.shape[1] - 1]
    d_got = oracle_dist(q, vectors, slots, metric)
    return float(np.mean(d_got <= kth[:, None] + 1e-9 * np.abs(kth[:, None])))


def caff_of(queries, ops, slots, metric):
    """|caff| of each returned slot: the per-pair constant of the affine
    identity at the slot's cluster (|q|^2 - |q-c|^2 for L2, q.c for dot; 0
    for cosine, which has none)."""
    block_slot, cents = ops[3], ops[0].astype(np.float64)
    cluster = np.zeros(int(block_slot.max()) + 1, np.int64)
    cluster[block_slot.reshape(-1)] = np.repeat(np.arange(block_slot.shape[0]), block_slot.shape[1])
    c = cents[cluster[np.maximum(slots, 0)]]
    q = queries.astype(np.float64)[:, None, :]
    if metric == "euclidean":
        caff = np.sum(q * q, axis=2) - np.sum((q - c) ** 2, axis=2)
    elif metric == "dot_product":
        caff = np.sum(q * c, axis=2)
    else:
        caff = np.zeros(slots.shape)
    return np.where(slots >= 0, np.abs(caff), 0.0)


def check(queries, ops, dj, ij, dt, it, *, metric, rescore, pos_bits, caff=None):
    """``caff``: |caff| per reference slot, where the port packs each score
    before caff is added (the per-pair branch) and the two may cancel: its
    quanta then count at |score| + |caff|, the bound of the packed one."""
    if rescore:
        assert_topk_agree(dt, it, dj, ij, rtol=1e-4, atol=1e-4)
    else:
        qns = np.sum(queries.astype(np.float64) ** 2, axis=1, keepdims=True)
        if metric == "euclidean":
            xg, xw = dt.astype(np.float64) ** 2, dj.astype(np.float64) ** 2
            s = qns - xw
        else:
            xg, xw = 1.0 - dt.astype(np.float64), 1.0 - dj.astype(np.float64)
            s = xw
        mag = np.abs(s) if caff is None else np.abs(s) + caff
        tol = (2.0 ** (pos_bits - 22) + 2.0 ** -20) * mag + 1e-4
        assert np.all(np.abs(xg - xw) <= tol), float(np.max(np.abs(xg - xw) - tol))
        # ids inside the k-th distance (beyond the tolerance) agree as sets
        for b in range(len(queries)):
            kth = xw[b, -1]
            sign = 1.0 if metric == "euclidean" else -1.0  # larger x = nearer
            inside_w = {int(i) for i, x in zip(ij[b], xw[b]) if sign * (kth - x) > tol[b].max()}
            assert inside_w <= set(it[b].tolist())
    assert np.all((it >= 0) == (ij >= 0))
    rj = tie_recall(ij, queries, ops, metric)
    rt = tie_recall(it, queries, ops, metric)
    assert abs(rt - rj) <= 0.01, (rt, rj)


CASES = [
    (m, f, r)
    for m in ("euclidean", "dot_product", "cosine")
    for f in ("pairs", "fused", "einsum")
    for r in (True, False)
    if not (f == "fused" and m == "cosine")
]
#: position bits in each formulation's stage scores (einsum's are plain f32)
POS_BITS = {"pairs": 5, "fused": 11, "einsum": 0}


@pytest.mark.parametrize("metric,formulation,rescore", CASES)
def test_ivf_query_matches_jax(metric, formulation, rescore):
    queries, ops = graft_arrays()
    dj, ij, dt, it = run_both(
        queries, ops, metric=metric, formulation=formulation, rescore=rescore)
    check(queries, ops, dj, ij, dt, it, metric=metric, rescore=rescore,
          pos_bits=POS_BITS[formulation])


@pytest.mark.parametrize("metric,formulation,rescore", CASES)
def test_ivf_query_f32_blocks_matches_jax(metric, formulation, rescore):
    """compute_dtype=float32: f32 blocks in both packages. Pairs takes the
    f32 query (the reference's f32 ragged_dot), fused the bf16-rounded one
    (its Pallas kernel's qtile.astype(bf16)); the same tolerances."""
    queries, ops = graft_arrays(seed=6)
    dj, ij, dt, it = run_both(
        queries, ops, metric=metric, formulation=formulation, rescore=rescore, f32=True)
    check(queries, ops, dj, ij, dt, it, metric=metric, rescore=rescore,
          pos_bits=POS_BITS[formulation])


@pytest.mark.parametrize("k", [10, 100])
def test_ivf_query_f32_blocks_per_pair_branch_matches_jax(k):
    """The per-pair branch over f32 blocks (row mode; k=100 is the DB's
    k=100 request path), against the reference's f32 per-pair top-R."""
    queries, ops = graft_arrays(K=32, Cmax=64, seed=7)
    dj, ij, dt, it = run_both(
        queries, ops, metric="euclidean", formulation="pairs", rescore=False, k=k, f32=True)
    check(queries, ops, dj, ij, dt, it, metric="euclidean", rescore=False, pos_bits=6,
          caff=caff_of(queries, ops, ij, "euclidean"))


@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_ivf_query_per_pair_fallback_matches_jax(metric):
    """Cmax=64 with 32-lane windows gives 2 windows < k: both packages take
    the per-pair top-R branch (the port through block_topw's row mode,
    whose keys carry 6 position bits)."""
    queries, ops = graft_arrays(K=32, Cmax=64, seed=1)
    dj, ij, dt, it = run_both(
        queries, ops, metric=metric, formulation="pairs", rescore=False)
    check(queries, ops, dj, ij, dt, it, metric=metric, rescore=False, pos_bits=6)


@pytest.mark.parametrize("k", [48, 100, 128, 160])
@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_ivf_query_per_pair_large_k_matches_jax(metric, k):
    """The per-pair branch at k=48 (R=48) and k=100 (R=Cmax=64), and over
    Cmax=256 at k=128 (R=128, the largest R the CUDA kernels keep in their
    running lists) and k=160 (R=160, above it: the whole row and
    torch.topk on the card), both sides of the cut."""
    Cmax = 64 if k <= 100 else 256
    queries, ops = graft_arrays(K=32 if Cmax == 64 else 8, Cmax=Cmax, seed=1)
    dj, ij, dt, it = run_both(
        queries, ops, metric=metric, formulation="pairs", rescore=False, k=k)
    assert dt.shape == (len(queries), k)
    check(queries, ops, dj, ij, dt, it, metric=metric, rescore=False,
          pos_bits=(Cmax - 1).bit_length(), caff=caff_of(queries, ops, ij, metric))


@pytest.mark.parametrize("d", [100, 768])
@pytest.mark.parametrize("rescore", [True, False])
def test_ivf_query_pairs_wide_d_matches_jax(d, rescore):
    """The pairs stage at d=100 (not a multiple of the kernel's 64-deep
    chunks) and d=768 (the reference deployment's width), tiny B and K."""
    queries, ops = graft_arrays(K=8, Cmax=256, d=d, B=8, seed=5)
    dj, ij, dt, it = run_both(
        queries, ops, metric="euclidean", formulation="pairs", rescore=rescore)
    check(queries, ops, dj, ij, dt, it, metric="euclidean", rescore=rescore, pos_bits=5)


def test_ivf_query_windowed_probe_selection_matches_jax():
    """K=256 with probe_sel_approx set: the packed top-2-per-128-id-window
    probe selection, ported as is."""
    queries, ops = graft_arrays(K=256, Cmax=128, d=16, B=32, seed=2)
    dj, ij, dt, it = run_both(
        queries, ops, metric="euclidean", formulation="pairs", rescore=True,
        n_probe=3, probe_sel_approx=0.99)
    check(queries, ops, dj, ij, dt, it, metric="euclidean", rescore=True, pos_bits=5)


def test_ivf_query_pads_when_k_exceeds_survivors():
    """k=40 over one probed 32-row cluster: 32 survivors, then -1 /
    MASKED_DIST padding, as in the reference."""
    queries, ops = graft_arrays(K=4, Cmax=32, d=8, B=4, seed=3)
    jops = [jnp.asarray(o) for o in ops]
    dj, ij = jax_ivf_query(
        jnp.asarray(queries), *jops, metric="euclidean", k=40, n_probe=1,
        q_cap=8, oversample=1, probe_approx=None, rescore=True)
    tops = ivf_arrays_from_numpy(*ops, device="cpu")
    dt, it = ivf_query(torch.from_numpy(queries), *tops, metric="euclidean",
                       k=40, n_probe=1, oversample=1, rescore=True)
    assert dt.shape == (4, 40)
    assert np.all(it[:, 32:].numpy() == -1)
    assert np.all(dt[:, 32:].numpy() >= 3.0e38)
    assert_topk_agree(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij),
                      rtol=1e-4, atol=1e-4)


def test_bf16_round_trip_is_bit_exact():
    """JAX bf16 -> numpy (ml_dtypes.bfloat16) -> torch bf16 keeps every bit,
    including signed zeros, infinities, NaN and subnormals; an f32 block
    array rounds to bf16 exactly as JAX's astype does."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 33)).astype(np.float32) * 100
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40]
    jb = jnp.asarray(x, jnp.bfloat16)
    want_bits = np.asarray(jb).view(np.int16)
    t = bf16_to_torch(np.asarray(jb))
    assert t.dtype == torch.bfloat16 and t.shape == (64, 33)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), want_bits)
    finite = np.isfinite(x)
    x = np.where(finite, x, 1.0).astype(np.float32)  # NaN payloads differ by framework
    jb = jnp.asarray(x, jnp.bfloat16)
    want_bits = np.asarray(jb).view(np.int16)
    carried = ivf_arrays_from_numpy(
        np.zeros((1, 33)), np.zeros(1), x[None], np.zeros((1, 64), np.int32),
        np.zeros((1, 64)), np.zeros((1, 64)), np.ones((1, 64), bool),
        np.zeros((4, 33)), device="cpu",
    )[2]
    np.testing.assert_array_equal(carried[0].view(torch.int16).numpy(), want_bits)
    with pytest.raises(TypeError):
        bf16_to_torch(x)
