"""IVF's ``formulation="einsum"`` in ``quiver_tpu_torch`` against the JAX
package's, on the same seeded numpy inputs.

* ``_einsum_candidates`` alone, fed identical probe-stage outputs and pair
  sorts: euclidean, dot and cosine; bf16 and f32 blocks; the windowed
  top-2 branch (``seg_width=32``) and the one top-k over ``[B, P*Cmax]``;
  a ``q_cap`` small enough that clusters drop pairs. ``best_s`` agrees to
  rtol 1e-5, atol 1e-4 (both GEMMs are f32 with f32 output; only the
  summation order differs); ``best_flat`` is equal up to ties.
* ``IVFIndex._q_cap`` equals the reference's over a grid, exactly.
* ``ivf_query(formulation="einsum")`` end to end at a ``q_cap`` that drops
  most pairs, with rescore and with score-derived distances (the
  tolerances of tests/test_torch_ivf_query.py, whose CASES hold einsum
  where nothing drops, with no lane bits in the scores).
* The port's counterpart of tests/test_ivf.py::
  test_fused_formulation_matches_einsum: two engines built from one seed,
  einsum and fused, overlap >= 0.9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.index.ivf import IVFConfig as JConfig
from quiver_tpu.index.ivf import IVFIndex as JIVF
from quiver_tpu.ops.ivf_kernels import _einsum_candidates as jax_einsum_candidates
from quiver_tpu.types import DistanceType as JMetric
from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
from quiver_tpu_torch.convert import ivf_arrays_from_numpy
from quiver_tpu_torch.ops.ivf_kernels import _einsum_candidates
from quiver_tpu_torch.ops.scan import NEG_BIG
from quiver_tpu_torch.types import DistanceType

from tests.test_torch_ivf_query import KTOP, check, graft_arrays, run_both

METRICS = ("euclidean", "dot_product", "cosine")


def stage_inputs(queries, ops, metric, P):
    """Probe-stage outputs and the stable pair sort, in numpy, identical
    for both packages: the top-P clusters by the metric's centroid score."""
    cents, cns = ops[0], ops[1]
    c_dots = (queries @ cents.T).astype(np.float32)
    c_aff = (2.0 * c_dots - cns[None, :]).astype(np.float32)
    c_scores = {"euclidean": c_aff, "dot_product": c_dots,
                "cosine": c_dots / np.sqrt(np.maximum(cns, 1e-30))[None, :]}[metric]
    probe = np.argsort(-c_scores, axis=1, kind="stable")[:, :P]
    flat_c = probe.reshape(-1)
    order = np.argsort(flat_c, kind="stable")
    return c_dots, c_aff, flat_c, order, flat_c[order], order // P


def run_stage(queries, ops, *, metric, P, q_cap, seg_width, f32, k=KTOP, oversample=3):
    """Both packages' einsum candidate stage on the same operands. Returns
    (best_s, best_flat) of each, numpy, and the pairs' cluster loads."""
    c_dots, c_aff, flat_c, order, sorted_c, b_of = stage_inputs(queries, ops, metric, P)
    cents, blocks, rns, inv, keep = ops[0], ops[2], ops[4], ops[5], ops[6]
    jblocks = jnp.asarray(blocks).astype(jnp.float32 if f32 else jnp.bfloat16)
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    sj, fj = jax_einsum_candidates(
        jnp.asarray(queries), jnp.asarray(cents), jnp.asarray(c_dots), jnp.asarray(c_aff),
        i32(order), i32(sorted_c), i32(b_of), i32(flat_c), jblocks,
        jnp.asarray(rns), jnp.asarray(inv), jnp.asarray(keep),
        metric=JMetric.parse(metric), k=k, q_cap=q_cap,
        compute_dtype=jnp.float32 if f32 else jnp.bfloat16, oversample=oversample,
        probe_approx=None, seg_width=seg_width)
    tops = ivf_arrays_from_numpy(*ops[:2], np.asarray(jblocks), *ops[3:], device="cpu",
                                 blocks_dtype=torch.float32 if f32 else torch.bfloat16)
    t64 = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    st, ft = _einsum_candidates(
        torch.from_numpy(queries), tops[0], torch.from_numpy(c_dots), torch.from_numpy(c_aff),
        t64(order), t64(sorted_c), t64(b_of), t64(flat_c), tops[2], tops[4], tops[5], tops[6],
        metric=DistanceType.parse(metric), k=k, q_cap=q_cap, oversample=oversample,
        seg_width=seg_width)
    loads = np.bincount(flat_c, minlength=len(cents))
    return (np.asarray(sj), np.asarray(fj)), (st.numpy(), ft.numpy()), loads


def assert_candidates_agree(got, want, rtol=1e-5, atol=1e-4):
    """Sorted scores agree elementwise; the valid flat positions agree up
    to ties: a reference candidate scoring clearly above the row's last
    valid score is among the port's, and shared positions score alike."""
    (st, ft), (sj, fj) = got, want
    assert st.shape == sj.shape and ft.shape == fj.shape
    np.testing.assert_allclose(st, sj, rtol=rtol, atol=atol)
    for b in range(len(sj)):
        vj, vt = sj[b] > NEG_BIG / 2, st[b] > NEG_BIG / 2
        assert vj.sum() == vt.sum()
        if not vj.any():
            continue
        tol = atol + rtol * np.abs(sj[b][vj]).max()
        floor = sj[b][vj].min()
        want_pos = {int(f) for f, s in zip(fj[b][vj], sj[b][vj]) if s > floor + tol}
        got_map = dict(zip(ft[b][vt].tolist(), st[b][vt].tolist()))
        assert want_pos <= set(got_map), (b, want_pos - set(got_map))
        for f, s in zip(fj[b][vj].tolist(), sj[b][vj].tolist()):
            if f in got_map:
                assert abs(got_map[f] - s) <= tol, (b, f, got_map[f], s)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("seg_width", [32, None], ids=["windowed", "flat"])
@pytest.mark.parametrize("metric", METRICS)
def test_einsum_candidates_match_jax(metric, seg_width, f32):
    """q_cap=8 against 64*4/16 = 16 pairs per cluster on average: clusters
    drop pairs, the same ones in both packages (the stable sort's ranks)."""
    queries, ops = graft_arrays(K=16, Cmax=512, d=32, B=64, seed=3)
    want, got, loads = run_stage(queries, ops, metric=metric, P=4, q_cap=8,
                                 seg_width=seg_width, f32=f32)
    assert loads.max() > 8  # a hot cluster drops pairs
    assert_candidates_agree(got, want)


def test_einsum_candidates_drop_the_same_pairs():
    """A cluster probed by every query keeps the first q_cap of them in the
    pair sort's order; the dropped pairs contribute no valid candidate, in
    both packages alike. Each query probes one cluster here, so a dropped
    query has no candidates at all."""
    queries, ops = graft_arrays(K=4, Cmax=128, d=16, B=32, seed=4)
    queries = np.repeat(queries[:1], 32, axis=0) + 0.01 * np.arange(32, dtype=np.float32)[:, None]
    want, got, loads = run_stage(queries, ops, metric="euclidean", P=1, q_cap=8,
                                 seg_width=32, f32=False, k=4)
    assert loads.max() == 32
    assert_candidates_agree(got, want)
    kept = (want[0] > NEG_BIG / 2).any(axis=1)
    np.testing.assert_array_equal(kept, np.arange(32) < 8)
    np.testing.assert_array_equal((got[0] > NEG_BIG / 2).any(axis=1), kept)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_q_cap_matches_jax(factor):
    eng = IVFIndex(VectorStore(dim=4, metric="euclidean", device="cpu"),
                   config=IVFConfig(q_cap_factor=factor))
    ref = JIVF.__new__(JIVF)  # _q_cap reads only the config
    ref.config = JConfig(q_cap_factor=factor)
    for B in (1, 7, 64, 1000, 4096, 65536):
        for P in (1, 2, 3, 8, 32):
            for K in (1, 16, 1024, 1405, 4096):
                assert eng._q_cap(B, P, K) == ref._q_cap(B, P, K), (B, P, K)


@pytest.mark.parametrize("rescore", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_query_einsum_drops_match_jax(metric, rescore):
    """q_cap=4 against 64 pairs over 16 clusters: most pairs drop, the same
    ones in both packages (tests/test_torch_ivf_query.py's CASES hold
    einsum at q_cap=64, where none drops)."""
    queries, ops = graft_arrays()
    dj, ij, dt, it = run_both(queries, ops, metric=metric, formulation="einsum",
                              rescore=rescore, q_cap=4)
    check(queries, ops, dj, ij, dt, it, metric=metric, rescore=rescore, pos_bits=0)


@pytest.mark.parametrize("metric", ["euclidean", "dot_product"])
def test_port_fused_formulation_matches_einsum(metric):
    """The port's counterpart of tests/test_ivf.py::
    test_fused_formulation_matches_einsum: the fused stage (block_topw at
    W=128, R=4; its plain version here) agrees with the einsum stage on
    final results."""
    rng = np.random.default_rng(5)
    n, dim, k = 8192, 32, 10
    vecs = (rng.normal(size=(n, dim)) + 2.0).astype(np.float32)
    q = (vecs[:24] + 0.05 * rng.normal(size=(24, dim))).astype(np.float32)
    got = {}
    for form in ("einsum", "fused"):
        store = VectorStore(dim=dim, metric=metric, capacity=n, device="cpu")
        store.add_batch([f"v{i}" for i in range(n)], vecs)
        eng = IVFIndex(store, config=IVFConfig(
            n_clusters=16, n_probe=8, build_threshold=256, formulation=form, rescore=True))
        eng.build()
        assert eng._block_slot.shape[1] % 128 == 0
        got[form] = eng.search_slots(q, k)
    d_e, i_e = got["einsum"]
    d_f, i_f = got["fused"]
    overlap = np.mean([len(set(i_e[b]) & set(i_f[b])) / k for b in range(len(q))])
    assert overlap >= 0.9, (metric, overlap)
    sel = i_e == i_f
    np.testing.assert_allclose(np.where(sel, d_e, 0), np.where(sel, d_f, 0),
                               rtol=1e-4, atol=1e-4)
