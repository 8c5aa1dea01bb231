"""``block_topw`` (its plain PyTorch version, which CPU tensors take) against
the JAX package's two candidate stages, plus the key helpers and the probe
selection.

Shapes are tiny (d=32, K=8, Cmax=256, B=16, P=2). The same seeded numpy
inputs feed both packages:

* fused variant (W=128, R=4, 11 position bits, KEY_MIN sentinel) against
  ``quiver_tpu.ops.ivf_pallas.fused_block_topw(..., interpret=True)``;
* pairs variant (W=32, R=2, 5 position bits) against the window winners of
  ``quiver_tpu.ops.ivf_kernels._pairs_candidates`` (every winner kept as a
  survivor, exact top-k: ``probe_approx=None``), at d=32, 100 and 768;
  and, on operands whose products and sums are exact in f32, bit for bit:
  the winners in the reference's lane order with ``caff`` re-keyed onto
  them inside ``block_topw``.

The f32-block kernel's 3xTF32 products, which no CPU can run, are emulated
in numpy and held against f64 in ``chip_smoke.py``'s units
(``test_f32_block_products_3xtf32_within_sum_err``).

Lanes: ``block_topw`` writes window w's r-th winner to lane ``r*S + w`` for
every variant; the Pallas kernel writes it to ``w*R + r``.

Tolerance: the packed keys quantize the score by the position bits, and the
two packages sum the bf16 products in different orders, so unpacked scores
agree within two quanta (2^(pos_bits-22) relative) plus 1e-4 x the score
scale, and winner positions agree wherever the competing scores are
separated by more than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import ivf_kernels as jk
from quiver_tpu.ops import ivf_pallas as jp
from quiver_tpu.types import DistanceType as JDT
from quiver_tpu_torch.ops import ivf_cuda as tc
from quiver_tpu_torch.ops import ivf_kernels as tk
from quiver_tpu_torch.types import DistanceType

D, K, CMAX, B, P = 32, 8, 256, 16, 2
NEG_BIG = -3.0e38


def _case(seed, d=D, dtype=jnp.bfloat16):
    """Operands shared by both packages (numpy; blocks rounded to bf16, or
    kept f32 with ``dtype=jnp.float32``)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cents = (0.5 * rng.normal(size=(K, d))).astype(np.float32)
    blocks = jnp.asarray(0.5 * rng.normal(size=(K, d, CMAX)), dtype)
    keep = rng.random((K, CMAX)) > 0.1
    keep[3, 128:] = False  # one fully masked window pair
    rns = np.sum(np.asarray(blocks, np.float32) ** 2, axis=1)
    inv = (0.5 + rng.random((K, CMAX))).astype(np.float32)
    probe = np.stack([rng.permutation(K)[:P] for _ in range(B)]).astype(np.int32)
    return q, cents, blocks, keep, rns, inv, probe


def _csr(probe):
    flat = probe.reshape(-1)
    order = np.argsort(flat, kind="stable").astype(np.int32)
    starts = np.searchsorted(flat[order], np.arange(K + 1), side="left").astype(np.int32)
    return order, starts


def _t(a, dtype=None):
    if isinstance(a, jnp.ndarray) and a.dtype == jnp.bfloat16:
        from quiver_tpu_torch.convert import bf16_to_torch

        return bf16_to_torch(np.asarray(a))
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _score_tol(s, pos_bits, scale):
    return 2.0 ** (pos_bits - 22) * np.abs(s) + 1e-4 * scale


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("metric", ["euclidean", "dot_product"])
def test_fused_variant_matches_pallas_kernel(metric, dtype):
    """bf16 blocks, or f32 ones (the Pallas kernel fed f32 blocks rounds
    only its query to bf16: block_topw's round_query, the default)."""
    q, cents, blocks, keep, rns, inv, probe = _case(1, dtype=dtype)
    order, starts = _csr(probe)
    l2 = metric == "euclidean"
    bias = np.where(keep, -rns if l2 else 0.0, NEG_BIG).astype(np.float32)
    scale = 2.0 if l2 else 1.0
    want = np.asarray(jp.fused_block_topw(
        jnp.asarray(starts), jnp.asarray(order), jnp.asarray(q)[None],
        blocks, jnp.asarray(cents), jnp.asarray(bias),
        K=K, Cmax=CMAX, P=P, KG=1, scale=scale, sub_cent=l2, interpret=True,
    ))[0]  # i32[BP, 128]
    got = tc.block_topw(
        _t(q), _t(cents), _t(starts), _t(order), _t(blocks), P=P, scale=scale,
        col_add=_t(bias), sub_cent=l2, W=128, R=4, pos_bits=11, sentinel=tc.KEY_MIN,
    ).numpy()
    S = CMAX // 128
    assert got.shape == (B * P, 4 * S)
    assert np.all(want[:, 4 * S:] == tc.KEY_MIN)  # the reference's empty lanes
    # the Pallas kernel's lane w*4 + r is block_topw's r*S + w
    want = want[:, :4 * S].reshape(B * P, S, 4).transpose(0, 2, 1).reshape(B * P, 4 * S)
    js, jpos, jvalid = (np.asarray(a) for a in jp.unpack_keys(jnp.asarray(want)))
    ts, tpos, tvalid = (a.numpy() for a in tc.unpack_keys(torch.from_numpy(got)))
    np.testing.assert_array_equal(tvalid, jvalid)
    real = js > NEG_BIG / 2
    assert np.all(np.abs(ts - js)[real] <= _score_tol(js, 11, scale)[real])
    np.testing.assert_array_equal(got[~real], want[~real])  # masked winners
    # positions: equal, or the twin's own scores at both positions are tied
    s_sorted = tc.pair_scores_reference(
        _t(q), _t(cents), _t(starts), _t(order), _t(blocks), P=P, scale=scale,
        col_add=_t(bias), sub_cent=l2,
    ).numpy()
    s_orig = np.empty_like(s_sorted)
    s_orig[order] = s_sorted
    rows, lanes = np.nonzero((tpos != jpos) & real)
    tol = _score_tol(js, 11, scale)
    for r, c in zip(rows, lanes):
        assert abs(s_orig[r, tpos[r, c]] - s_orig[r, jpos[r, c]]) <= 2 * tol[r, c]
    assert len(rows) <= 0.02 * real.sum()


def _both_pairs_candidates(q, cents, blocks, keep, rns, inv, metric):
    """(JAX, port) survivors of the pairs stage on the same operands, every
    window winner kept (k=8, oversample to 2*P*S); the blocks' dtype is the
    compute dtype (f32 blocks: the reference's f32 ragged_dot, the f32 query
    unrounded)."""
    jm = JDT.parse(metric)
    cns = np.sum(cents * cents, axis=1)
    c_dots, c_aff, probe, caff = jk.probe_stage(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(cns), jm, P, None
    )
    flat = probe.reshape(-1)
    order = jnp.argsort(flat).astype(jnp.int32)
    k, S = 8, CMAX // 32
    oversample = 2 * P * S // k  # every window winner survives
    want_s, want_f = jk._pairs_candidates(
        jnp.asarray(q), jnp.asarray(cents), c_dots, caff, probe, order,
        flat[order], (order // P).astype(jnp.int32), blocks, jnp.asarray(rns),
        jnp.asarray(inv), jnp.asarray(keep), metric=jm, k=k,
        compute_dtype=blocks.dtype, oversample=oversample, probe_approx=None,
        seg_width=32,
    )
    _, starts = _csr(np.asarray(probe))
    got_s, got_f = tk._pairs_candidates(
        _t(q), _t(cents), _t(c_dots), None if caff is None else _t(caff),
        _t(probe, torch.int64), _t(order), _t(starts), _t(blocks), _t(rns),
        _t(inv), _t(keep), metric=DistanceType.parse(metric), k=k,
        oversample=oversample, seg_width=32,
    )
    want_s, want_f = np.asarray(want_s), np.asarray(want_f)
    got_s, got_f = got_s.numpy(), got_f.numpy()
    assert got_s.shape == want_s.shape == (B, 2 * P * S)
    return want_s, want_f, got_s, got_f


def _check_pairs_against_jax(metric, d, dtype=jnp.bfloat16):
    q, cents, blocks, keep, rns, inv, _ = _case(2, d, dtype)
    want_s, want_f, got_s, got_f = _both_pairs_candidates(q, cents, blocks, keep, rns, inv, metric)
    scale = float(np.abs(want_s[want_s > NEG_BIG / 2]).max())
    n_moved = 0
    for b in range(B):
        wf, gf = np.argsort(want_f[b], kind="stable"), np.argsort(got_f[b], kind="stable")
        ws, gs = want_s[b][wf], got_s[b][gf]
        same = want_f[b][wf] == got_f[b][gf]
        n_moved += int((~same).sum())
        real = ws > NEG_BIG / 2
        tol = _score_tol(ws, 5, 1.0) + 1e-4 * scale
        ok = same & real
        assert np.all(np.abs(gs - ws)[ok] <= tol[ok])
    # a window winner moves only on a near-tie inside its window
    assert n_moved <= 0.02 * want_f.size


@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_pairs_variant_matches_pairs_candidates(metric):
    _check_pairs_against_jax(metric, D)


@pytest.mark.parametrize("d", [100, 768])
@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_pairs_variant_matches_pairs_candidates_wide_d(metric, d):
    """d=100 (not a multiple of the kernel's 64-deep chunks) and d=768 (12
    of them)."""
    _check_pairs_against_jax(metric, d)


@pytest.mark.parametrize("d", [32, 100])
@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_pairs_variant_f32_blocks_matches_ragged_dot(metric, d):
    """f32 blocks against the reference's f32 ragged_dot (``_pairs_candidates``
    at compute_dtype=float32), whose query is not rounded."""
    _check_pairs_against_jax(metric, d, jnp.float32)


def test_round_query_rounds_only_the_query():
    """pair_scores_reference over f32 blocks: round_query=False is the f32
    product of the centred query, True that of its bf16 rounding (the
    blocks stay f32 either way); bf16 blocks refuse an unrounded query."""
    q, cents, blocks, keep, rns, inv, probe = _case(9, dtype=jnp.float32)
    order, starts = _csr(probe)
    bias = np.where(keep, -rns, NEG_BIG).astype(np.float32)
    args = (_t(q), _t(cents), _t(starts), _t(order), _t(blocks))
    kw = dict(P=P, scale=2.0, col_add=_t(bias), sub_cent=True)
    flat = probe.reshape(-1)[order]
    a = (q[order // P] - cents[flat]).astype(np.float32)
    b = np.asarray(blocks, np.float32)[flat]
    for rq in (False, True):
        aa = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) if rq else a
        want = 2.0 * np.einsum("pd,pdc->pc", aa.astype(np.float64), b.astype(np.float64)) + bias[flat]
        got = tc.pair_scores_reference(*args, round_query=rq, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert not np.allclose(tc.pair_scores_reference(*args, round_query=True, **kw).numpy(),
                           tc.pair_scores_reference(*args, round_query=False, **kw).numpy(),
                           rtol=1e-6, atol=1e-6)
    q16 = _case(9)[2]
    with pytest.raises(ValueError, match="bf16 blocks take a bf16 query"):
        tc.block_topw(*args[:4], _t(q16), **kw, round_query=False, W=32, R=2, pos_bits=5,
                      sentinel=tc._mask_key(32))


#: chip_smoke.SUM_ERR, copied: the units of 2^-24 x |a| x max_j |b_j| by
#: which compare_keys lets the card's sums stray from f64
SUM_ERR = 16.0


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on the f32 bit pattern (the f32 kernel's tf32_rna):
    the low 13 mantissa bits rounded off, ties away from zero."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    """(hi, lo), both TF32: hi = rna(x), lo = rna(x - hi) (x - hi is exact)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


@pytest.mark.parametrize("d", [128, 768])
@pytest.mark.parametrize("form,products", [("pairs", 3), ("fused", 2), ("plain_tf32", 1)])
def test_f32_block_products_3xtf32_within_sum_err(form, products, d):
    """The products of csrc/ivf_block_topw_f32.cu emulated in numpy: the
    centred query (f32 for pairs, bf16-rounded for fused) and the f32 block
    split into TF32 high and low parts; lo_a*hi_b, hi_a*lo_b, hi_a*hi_b,
    each exact in f32, summed in f32 from zero over each 32-deep chunk of d
    (8-deep step by step, the small terms first) and the chunk's sum added
    to the running f32 sum, as the kernel takes them from its
    mma.sync.m16n8k8 (the bf16 query is exact in TF32, so its lo_a*hi_b is
    zero and dropped).
    The stray from f64 stays within SUM_ERR units of 2^-24 |a| max_j |b_j|,
    chip_smoke.compare_keys' tolerance on the card; plain 1xTF32 (hi_a*hi_b
    alone, on the f32 query) strays past it, which is why the kernel
    splits."""
    rng = np.random.default_rng(d + products)
    n, C = 256, 64
    q = rng.normal(size=(n, d)).astype(np.float32)
    cent = (0.5 * rng.normal(size=d)).astype(np.float32)
    a = q - cent  # f32, as the kernel's prologue subtracts it
    if form == "fused":
        a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    b = (0.5 * rng.normal(size=(d, C))).astype(np.float32)
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    if form == "fused":
        assert not al.any()
    terms = {3: [(al, bh), (ah, bl), (ah, bh)], 2: [(ah, bl), (ah, bh)], 1: [(ah, bh)]}[products]
    acc = np.zeros((n, C), np.float32)
    for k32 in range(0, d, 32):
        chunk = np.zeros((n, C), np.float32)
        for k8 in range(k32, min(k32 + 32, d), 8):
            for x, y in terms:
                for k in range(k8, k8 + 8):
                    chunk += x[:, k, None] * y[None, k, :]  # a TF32 product is exact in f32
        acc += chunk
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    unit = 2.0 ** -24 * np.linalg.norm(a64, axis=1)[:, None] * np.linalg.norm(b64, axis=0).max()
    stray = float((np.abs(acc - a64 @ b64) / unit).max())
    if products == 1:
        assert stray > SUM_ERR
    else:
        assert stray <= SUM_ERR


def test_pairs_variant_keys_against_packing_by_hand():
    """The twin's keys equal a direct numpy packing of its own f32 scores
    (window max, then the sentinel, then max again)."""
    q, cents, blocks, keep, rns, inv, probe = _case(3)
    order, starts = _csr(probe)
    bias = np.where(keep, -rns, NEG_BIG).astype(np.float32)
    args = (_t(q), _t(cents), _t(starts), _t(order), _t(blocks))
    kw = dict(P=P, scale=2.0, col_add=_t(bias), sub_cent=True)
    keys = tc.block_topw(*args, W=32, R=2, pos_bits=5, sentinel=tc._mask_key(32), **kw).numpy()
    s = tc.pair_scores_reference(*args, **kw).numpy()
    b = s.view(np.int32)
    key = (b ^ ((b >> 31) & 0x7FFFFFFF)) & ~31 | (np.arange(CMAX) & 31)
    win = key.reshape(B * P, CMAX // 32, 32)
    m1 = win.max(axis=2)
    m2 = np.where(win == m1[:, :, None], tc._mask_key(32), win).max(axis=2)
    want = np.empty_like(keys)
    want[order] = np.concatenate([m1, m2], axis=1)  # lane r*S + w
    np.testing.assert_array_equal(keys, want)


@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_pairs_survivors_bit_exact_against_pairs_candidates(metric):
    """Operands that are small multiples of powers of two make every product
    and sum exact in f32, so both packages score each pair alike bit for
    bit whatever their summation order. Then the port's survivors (window
    winners in lane r*S + w, caff added to each in f32 inside block_topw)
    equal the reference's (winners regrouped, transposed and re-keyed after
    its reduce) key for key and position for position."""
    rng = np.random.default_rng(8)
    q = (rng.integers(-8, 9, (B, D)) / 4).astype(np.float32)
    cents = (rng.integers(-4, 5, (K, D)) / 4).astype(np.float32)
    blocks_f = (rng.integers(-8, 9, (K, D, CMAX)) / 8).astype(np.float32)
    blocks = jnp.asarray(blocks_f, jnp.bfloat16)  # 4 significant bits: exact
    keep = rng.random((K, CMAX)) > 0.1
    rns = np.sum(blocks_f ** 2, axis=1).astype(np.float32)
    inv = (0.5 + rng.random((K, CMAX))).astype(np.float32)
    want_s, want_f, got_s, got_f = _both_pairs_candidates(q, cents, blocks, keep, rns, inv, metric)
    for b in range(B):  # every winner survives: compare as sets, by position
        wf, gf = np.argsort(want_f[b]), np.argsort(got_f[b])
        np.testing.assert_array_equal(got_f[b][gf], want_f[b][wf])
        np.testing.assert_array_equal(got_s[b][gf].view(np.int32), want_s[b][wf].view(np.int32))


def test_row_mode_keys_are_the_per_row_top_r():
    """W = Cmax (one window per row, not a power of two here): the R best
    packed keys of each pair's row, in descending order, at R=16 and at
    R=128 (the largest R the CUDA kernels keep in their running lists)."""
    q, cents, _, keep, _, inv, probe = _case(7)
    Cm = 384
    rng = np.random.default_rng(7)
    blocks = jnp.asarray(0.5 * rng.normal(size=(K, D, Cm)), jnp.bfloat16)
    col_add = np.where(rng.random((K, Cm)) > 0.1, 0.0, NEG_BIG).astype(np.float32)
    order, starts = _csr(probe)
    args = (_t(q), _t(cents), _t(starts), _t(order), _t(blocks))
    kw = dict(P=P, scale=1.0, col_add=_t(col_add), sub_cent=False)
    s = tc.pair_scores_reference(*args, **kw).numpy()
    b = s.view(np.int32)
    packed = (b ^ ((b >> 31) & 0x7FFFFFFF)) & ~511 | np.arange(Cm)
    for R in (16, 128):
        keys = tc.block_topw(*args, W=Cm, R=R, pos_bits=9, sentinel=tc.KEY_MIN, **kw).numpy()
        want = np.empty_like(keys)
        want[order] = -np.sort(-packed, axis=1)[:, :R]
        np.testing.assert_array_equal(keys, want)


@pytest.mark.parametrize("R,whole", [(1, False), (16, False), (100, False), (128, False),
                                     (129, True), (160, True)])
def test_variant_routes_row_mode_by_r(R, whole):
    """``_variant``'s routing of a CUDA launch (a stub in place of the
    library's row max, 128): row mode keeps the running top R in the kernel
    up to the row max, writes the whole row above it, counts each launch
    under ``row_key(R)``, and takes only the KEY_MIN sentinel; the windowed
    variants keep their (W, R) keys."""
    row_max = 128  # ivf_block_topw_row_max() of csrc/row_topr.cuh
    assert tc._variant(row_max, 1280, R, 1280, None, tc.KEY_MIN) == (tc.row_key(R), 0, whole)
    # the same routing at a smaller row max: the cut follows the library
    assert tc._variant(R - 1, 1280, R, 1280, None, tc.KEY_MIN)[2]
    assert tc._variant(32, 32, 2, 1280, None, tc._mask_key(32)) == ((32, 2), 32, False)
    with pytest.raises(ValueError, match="KEY_MIN"):
        tc._variant(row_max, 1280, R, 1280, None, int(tc._mask_key(32)))
    with pytest.raises(ValueError, match="no CUDA variant"):
        tc._variant(row_max, 1280, R, 1280, torch.zeros(1), tc.KEY_MIN)


def test_key_helpers_bit_exact():
    rng = np.random.default_rng(4)
    s = (rng.normal(size=(6, 64)) * 10.0 ** rng.integers(-3, 4, (6, 64))).astype(np.float32)
    s[0, :5] = [0.0, -0.0, np.inf, -np.inf, NEG_BIG]
    st, sj = torch.from_numpy(s), jnp.asarray(s)
    np.testing.assert_array_equal(tk._to_key(st).numpy(), np.asarray(jk._to_key(sj)))
    keys = np.asarray(jk._to_key(sj))
    np.testing.assert_array_equal(
        tk._from_key(torch.from_numpy(keys.copy())).numpy().view(np.int32), s.view(np.int32)
    )
    for lm in (31, 127):
        np.testing.assert_array_equal(
            tk._pack_lane(st, lm).numpy(), np.asarray(jk._pack_lane(sj, jnp.int32(lm)))
        )
    for w in (32, 128):
        assert tk._mask_key(w) == jk._mask_key(w)
    acc = keys.copy()
    acc[1, ::3] = tc.KEY_MIN
    for a, b_ in zip(tc.unpack_keys(torch.from_numpy(acc)), jp.unpack_keys(jnp.asarray(acc))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


@pytest.mark.parametrize(
    "regime,Kc,Pc,approx",
    [("windowed", 512, 4, 0.99), ("argmax", 64, 5, None), ("topk", 96, 20, None)],
)
def test_select_probes_matches_jax(regime, Kc, Pc, approx):
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(32, Kc)).astype(np.float32)
    if regime == "windowed":
        # the windowed top-2 drops two of these four from row 0
        scores[0, [5, 17, 33, 99]] = [50.0, 49.0, 48.0, 47.0]
    pj, sj = jk._select_probes(jnp.asarray(scores), Pc, Kc, approx)
    pt, st = tk._select_probes(torch.from_numpy(scores), Pc, Kc, approx)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if regime == "windowed":
        assert len(set(pt[0].tolist()) & {5, 17, 33, 99}) == 2


def test_block_topw_checks_its_inputs():
    q, cents, blocks, keep, rns, inv, probe = _case(6)
    order, starts = _csr(probe)
    bias = _t(np.where(keep, -rns, NEG_BIG).astype(np.float32))
    args = [_t(q), _t(cents), _t(starts), _t(order), _t(blocks)]
    kw = dict(P=P, scale=2.0, col_add=bias, sub_cent=True, W=32, R=2, pos_bits=5,
              sentinel=tc._mask_key(32))
    before = dict(tc.launch_counts)
    tc.block_topw(*args, **kw)
    assert tc.launch_counts == before  # the CPU twin is not a launch
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError, match="q must be"):
        tc.block_topw(*bad, **kw)
    bad = list(args)
    bad[3] = torch.cat([args[3], args[3][:1]])  # a truncated list may be shorter, not longer
    with pytest.raises(ValueError, match="order shape"):
        tc.block_topw(*bad, **kw)
    bad = list(args)
    bad[1] = torch.from_numpy(np.asfortranarray(cents))
    with pytest.raises(ValueError, match="contiguous"):
        tc.block_topw(*bad, **kw)
    with pytest.raises(ValueError, match="bad window"):
        tc.block_topw(*args, **dict(kw, W=48))
    with pytest.raises(ValueError, match="pos_bits"):
        tc.block_topw(*args, **dict(kw, pos_bits=4))


# ------------------------------------------------ a shard's truncated pairs


def _shard_pairs(probe, lo, KL, M):
    """One shard's truncated pair list, as ``sharded_ivf_query`` makes it
    (``quiver_tpu/parallel/sharded_ivf.py:151-172``): the M lowest-rank
    pairs whose cluster is in [lo, lo+KL), grouped by cluster; pad rows
    under the shard's last (reserved) id. Returns (order, sorted_c local,
    starts local)."""
    flat = probe.reshape(-1)
    rank = np.tile(np.arange(P), B)
    is_local = (flat >= lo) & (flat < lo + KL)
    ord1 = np.argsort(np.where(is_local, rank, P), kind="stable")[:M]
    kept = is_local[ord1]
    ord2 = np.argsort(np.where(kept, flat[ord1], 1 << 30), kind="stable")
    order = ord1[ord2].astype(np.int32)
    sorted_c = np.where(kept[ord2], flat[order] - lo, KL - 1).astype(np.int32)
    starts = np.searchsorted(sorted_c, np.arange(KL + 1), side="left").astype(np.int32)
    return order, sorted_c, starts


def _shard_case(seed, metric, exact):
    """Operands over K=8 clusters, the shard owning ids [4, 8), the last
    one reserved. ``exact``: small multiples of powers of two, so every
    product and sum is exact in f32 (ties abound); else normal draws,
    whose near-ties are rare."""
    rng = np.random.default_rng(seed)
    if exact:
        q = (rng.integers(-8, 9, (B, D)) / 4).astype(np.float32)
        cents = (rng.integers(-4, 5, (K, D)) / 4).astype(np.float32)
        blocks_f = (rng.integers(-8, 9, (K, D, CMAX)) / 8).astype(np.float32)
    else:
        q = rng.normal(size=(B, D)).astype(np.float32)
        cents = (0.5 * rng.normal(size=(K, D))).astype(np.float32)
        blocks_f = np.asarray(jnp.asarray(0.5 * rng.normal(size=(K, D, CMAX)), jnp.bfloat16),
                              np.float32)
    blocks = jnp.asarray(blocks_f, jnp.bfloat16)
    keep = rng.random((K, CMAX)) > 0.1
    keep[K - 1] = False  # the reserved id: an empty block
    rns = np.sum(blocks_f ** 2, axis=1).astype(np.float32)
    inv = (0.5 + rng.random((K, CMAX))).astype(np.float32)
    live = np.ones(K, bool)
    live[K - 1] = False
    jm = JDT.parse(metric)
    cns = np.sum(cents * cents, axis=1)
    c_dots, _, probe, caff = jk.probe_stage(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(cns), jm, P, None,
        cluster_live=jnp.asarray(live),
    )
    return q, cents, blocks, keep, rns, inv, c_dots, probe, caff


@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
@pytest.mark.parametrize("path,M", [("windowed", 8), ("windowed", 32), ("per_pair", 8),
                                    ("per_pair", 32)])
def test_truncated_pairs_candidates_match_reference(metric, path, M):
    """The port's ``_pairs_candidates`` on one shard's truncated pair list
    (M <= B*P rows, the shard's slice of the blocks, ``probe`` global)
    against the reference's with ``cluster_offset``: the valid survivors
    are the same global block positions with the same scores (bit for bit
    on the windowed path; on the per-pair path, whose packed keys the
    reference does not use, within two quanta of 2^(pos_bits-22) relative
    to the score before the per-pair constant plus 1e-4 x the score scale
    for the summation order, as ``_score_tol``; normal draws there, since
    its keys break exact ties by position the other way). Pairs absent
    from ``order`` never survive."""
    lo, KL = 4, 4
    q, cents, blocks, keep, rns, inv, c_dots, probe, caff = _shard_case(
        11, metric, exact=path == "windowed")
    order, sorted_c, starts = _shard_pairs(np.asarray(probe), lo, KL, M)
    k = 8 if path == "windowed" else 16  # 16 > Cmax // 32: the per-pair branch
    sl = slice(lo, lo + KL)
    want_s, want_f = jk._pairs_candidates(
        jnp.asarray(q), jnp.asarray(cents[sl]), c_dots, caff, probe, jnp.asarray(order),
        jnp.asarray(sorted_c), jnp.asarray(order // P), blocks[sl], jnp.asarray(rns[sl]),
        jnp.asarray(inv[sl]), jnp.asarray(keep[sl]), metric=JDT.parse(metric), k=k,
        compute_dtype=jnp.bfloat16, oversample=4, probe_approx=None, seg_width=32,
        cluster_offset=lo,
    )
    got_s, got_f = tk._pairs_candidates(
        _t(q), _t(cents[sl]), _t(c_dots), None if caff is None else _t(caff),
        _t(probe, torch.int64), _t(order), _t(starts), _t(blocks)[sl], _t(rns[sl]),
        _t(inv[sl]), _t(keep[sl]), metric=DistanceType.parse(metric), k=k,
        oversample=4, seg_width=32,
    )
    want_s, want_f = np.asarray(want_s), np.asarray(want_f)
    got_s, got_f = got_s.numpy(), got_f.numpy()
    present = np.zeros(B * P, bool)
    present[order[sorted_c < KL - 1]] = True
    for b in range(B):
        wv, gv = want_s[b] > NEG_BIG / 2, got_s[b] > NEG_BIG / 2
        assert wv.sum() == gv.sum()
        if not wv.any():  # none of b's pairs is on this shard
            continue
        wf, gf = want_f[b][wv], got_f[b][gv]
        # every valid survivor lies in a cluster this shard scored for b
        assert np.isin(gf // CMAX, np.asarray(probe)[b][present[b * P:(b + 1) * P]]).all()
        wo, go = np.argsort(wf, kind="stable"), np.argsort(gf, kind="stable")
        np.testing.assert_array_equal(gf[go], wf[wo])
        ws, gs = want_s[b][wv][wo], got_s[b][gv][go]
        if path == "windowed":
            np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))
        else:
            # the keys quantize the score before the per-pair constant is
            # added, so the quantum scales with |score| + |caff|
            pre = np.abs(ws) + (0.0 if caff is None else np.abs(np.asarray(caff)[b]).max())
            tol = _score_tol(pre, (CMAX - 1).bit_length(), np.abs(ws).max())
            assert np.all(np.abs(gs - ws) <= tol)


@pytest.mark.parametrize("W,R,sentinel", [(32, 2, "mask"), (128, 4, "min"), (CMAX, 16, "min")])
def test_block_topw_truncated_rows_hold_the_sentinel(W, R, sentinel):
    """``block_topw`` with M < B*P sorted pairs: the rows of the pairs it
    scored equal the full-list call's (a pair's keys depend only on its own
    row), and every other row holds the sentinel in every lane."""
    q, cents, blocks, keep, rns, inv, probe = _case(12)
    flat = probe.reshape(-1)
    sent = tc._mask_key(W) if sentinel == "mask" else tc.KEY_MIN
    pos_bits = max(5, (W - 1).bit_length())
    kw = dict(P=P, scale=2.0, col_add=_t(np.where(keep, -rns, NEG_BIG).astype(np.float32)),
              sub_cent=True, W=W, R=R, pos_bits=pos_bits, sentinel=sent)
    order, starts = _csr(probe)
    full = tc.block_topw(_t(q), _t(cents), _t(starts), _t(order), _t(blocks), **kw).numpy()
    sub = np.flatnonzero(flat[order] >= 3)[: B * P // 3]  # a prefix of clusters 3..
    t_order = order[sub]
    t_starts = np.searchsorted(flat[t_order], np.arange(K + 1), side="left").astype(np.int32)
    got = tc.block_topw(_t(q), _t(cents), _t(t_starts), _t(t_order), _t(blocks), **kw).numpy()
    assert got.shape == full.shape
    hit = np.zeros(B * P, bool)
    hit[t_order] = True
    np.testing.assert_array_equal(got[hit], full[hit])
    assert (got[~hit] == np.int32(sent)).all() and (~hit).any()


@pytest.mark.parametrize("seg_width", [32, 64, 128])
@pytest.mark.parametrize("metric", ["euclidean", "dot_product", "cosine"])
def test_ivf_query_seg_width_matches_jax(metric, seg_width):
    """``ivf_query``'s pairs stage at every window width the CUDA library
    instantiates, ``block_topw``'s (W, 2) variants (W = seg_width, log2(W)
    position bits, the ``_mask_key(W)`` sentinel, which equals the
    reference's), against the JAX package on the same operands (the
    arrays of tests/test_torch_ivf_query.py; Cmax=512 and k=4, so even
    W=128 keeps its windows)."""
    from quiver_tpu.ops.ivf_kernels import _mask_key as jax_mask_key
    from tests.test_torch_ivf_query import check, graft_arrays, run_both

    assert int(tc._mask_key(seg_width)) == int(jax_mask_key(seg_width))
    seen, real = [], tk.block_topw

    def spy(*args, **kw):
        seen.append((kw["W"], kw["R"], kw["pos_bits"], int(kw["sentinel"])))
        return real(*args, **kw)

    tk.block_topw = spy
    try:
        queries, ops = graft_arrays()
        dj, ij, dt, it = run_both(queries, ops, metric=metric, formulation="pairs",
                                  rescore=False, seg_width=seg_width, k=4)
    finally:
        tk.block_topw = real
    pos_bits = seg_width.bit_length() - 1
    assert seen == [(seg_width, 2, pos_bits, int(jax_mask_key(seg_width)))]
    check(queries, ops, dj, ij, dt, it, metric=metric, rescore=False, pos_bits=pos_bits)
