"""Row mode's running top-R (``quiver_tpu_torch/csrc/row_topr.cuh``),
emulated lane by lane in numpy, since no CPU runs the CUDA kernels.

The emulation follows the header: a half-warp of 16 lanes per row, 8 keys a
lane; the threshold filter with its per-row survivor counts (the larger of
the two rows' counts picks the path); survivors packed into the staged row
and inserted by a shift of the list (``E`` entries a lane, ``shfl_up`` of
width 16); or the bitonic sort of the row's 128 keys and its merge with the
list (``max(list[i], slab[127 - i])`` and seven half-cleaner stages); on a
row's first slab the sorted keys become the list. Over random rows, the
list's first R entries must equal the row's top R keys at every list width
the kernels build (C = 32, 64, 112, 128) and across the cut between
inserting and sorting. The staging swizzles of both kernels
(``stg_pos``) must permute each staged row and keep the epilogue's stores
free of bank conflicts. ``chip_smoke.topw_entries`` lists each row-mode R
that a path launched in the kernels line, with its own launch count.
"""

import numpy as np
import pytest

KEY_MIN = int(np.iinfo(np.int32).min)
KPL = 8  # keys per lane
T = np.arange(16)  # the lanes of one half-warp


def _stage(v, K, S):
    """One compare-exchange stage over [16, 8] keys (key i = 8t + j)."""
    v = v.copy()
    i = KPL * T[:, None] + np.arange(KPL)[None, :]
    if S >= KPL:
        o = v[T ^ (S // KPL)]  # __shfl_xor_sync within the half
        desc, lower = (i & K) == 0, (i & S) == 0
        return np.where(desc == lower, np.maximum(v, o), np.minimum(v, o))
    for j in range(KPL):
        if j & S:
            continue
        desc = ((KPL * T + j) & K) == 0
        hi, lo = np.maximum(v[:, j], v[:, j | S]), np.minimum(v[:, j], v[:, j | S])
        v[:, j], v[:, j | S] = np.where(desc, hi, lo), np.where(desc, lo, hi)
    return v


def _merge(v, K, S):
    while True:
        v = _stage(v, K, S)
        if S == 1:
            return v
        S //= 2


def _sort(v):
    K = 2
    while K <= 128:
        v = _merge(v, K, K // 2)
        K *= 2
    return v


def _insert(a, key):
    """row_insert: a [16, E], entry E*t + j in a[t, j], descending."""
    E = a.shape[1]
    up = np.concatenate([a[:1, E - 1], a[:-1, E - 1]])  # lane 0 keeps its own
    a = a.copy()
    for j in range(E - 1, -1, -1):
        prev = a[:, j - 1] if j > 0 else up
        prev_above = (prev > key) | ((T == 0) if j == 0 else False)
        a[:, j] = np.where(a[:, j] > key, a[:, j], np.where(prev_above, key, prev))
    return a


def _row_merge(keys, lst, r_keep, E, ins_max, n_other, first):
    """row_merge for one half's row: ``keys`` the staged row (packed in
    place), ``lst`` its list of 16*E entries; ``n_other`` the other half's
    survivor count. Returns the new list and the path taken."""
    C = 16 * E
    thr = lst[r_keep - 1]
    v = np.concatenate([keys[:64].reshape(16, 4), keys[64:].reshape(16, 4)], axis=1)
    above = v > thr
    n = int(above.sum())
    n_max = max(n, n_other)
    if n_max == 0:
        return lst, "none"
    if n_max <= ins_max:
        base = 0
        for j in range(KPL):
            for t in np.flatnonzero(above[:, j]):
                keys[base + above[:t, j].sum()] = v[t, j]
            base += above[:, j].sum()
        a = lst.reshape(16, E)
        for s in range(n_max):
            a = _insert(a, keys[s] if s < n else KEY_MIN)
        return a.reshape(-1), "insert"
    v = _sort(v)
    if first:
        return v.reshape(-1)[:C], "sort"
    w = np.concatenate([lst, np.full(128 - C, KEY_MIN)]).reshape(16, KPL)
    w = np.maximum(w, v[15 - T][:, ::-1])  # slab[127 - i] from lane 15 - t
    return _merge(w, 128, 64).reshape(-1)[:C], "sort"


def _row_epl(r):
    return 2 if r <= 32 else 4 if r <= 64 else 7 if r <= 112 else 8


def test_bitonic_network_sorts_descending():
    rng = np.random.default_rng(0)
    for _ in range(20):
        v = rng.integers(-1000, 1000, size=(16, KPL))
        np.testing.assert_array_equal(_sort(v).reshape(-1), -np.sort(-v.reshape(-1)))


@pytest.mark.parametrize("ins_max", [0, 24, 128])
@pytest.mark.parametrize("R", [1, 32, 33, 64, 112, 113, 128])
def test_merge_keeps_the_row_top_r(R, ins_max):
    """Slab by slab over rows of 1280 keys sorted ascending (every slab
    enters), 384 keys and a short row (8 or 132 keys), with the neighbour
    row forcing the other path at times: the list's first R entries are the
    top R."""
    rng = np.random.default_rng(R * 1000 + ins_max)
    E = _row_epl(R)
    paths = set()
    for trial, Cmax in enumerate((1280, 384, 8 if R <= 8 else 132)):
        keys = rng.permutation(np.arange(-10**6, 10**6))[:Cmax].astype(np.int64)
        if trial == 0:
            keys = np.sort(keys)
        lst = np.full(16 * E, KEY_MIN, dtype=np.int64)
        for c0 in range(0, Cmax, 128):
            slab = np.full(128, KEY_MIN, dtype=np.int64)
            part = keys[c0:c0 + 128]
            slab[:len(part)] = part
            slab = slab[rng.permutation(128)]  # the staging swizzle's any order
            n_other = int(rng.integers(0, 129)) if trial % 2 else 0
            lst, path = _row_merge(slab, lst, R, E, ins_max, n_other, first=c0 == 0)
            paths.add(path)
        np.testing.assert_array_equal(lst[:R], -np.sort(-keys)[:R])
    assert paths >= ({"insert"} if ins_max >= 128 else {"sort"})


def _stg_bf16(row, c):
    return c ^ ((row & 3) << 3)


def _stg_f32(row, c):
    return c ^ (((c >> 5) | ((row & 1) << 2)) << 2)


@pytest.mark.parametrize("kernel", ["bf16", "f32"])
def test_staging_swizzle_permutes_rows_without_bank_conflicts(kernel):
    """``stg_pos`` of each kernel permutes [0, 128) for every row (an
    involution), and each phase of the epilogue's staging stores (bf16: 16
    lanes of int2, rows g..g+3 and four column pairs; f32: 8 lanes of int4,
    rows g, g+1 and four 32-column spans) covers distinct banks, row stride
    128 ints."""
    pos = _stg_bf16 if kernel == "bf16" else _stg_f32
    c = np.arange(128)
    for row in range(64):
        p = pos(row, c)
        np.testing.assert_array_equal(np.sort(p), c)
        np.testing.assert_array_equal(pos(row, p), c)
    for warp in range(4):
        for h in range(2):
            if kernel == "bf16":  # lanes 16*ph .. 16*ph+15: g = lane >> 2, quad = lane & 3
                for i in range(16):
                    for ph in range(2):
                        lanes = np.arange(16 * ph, 16 * ph + 16)
                        row = warp * 16 + (lanes >> 2) + 8 * h
                        word = row * 128 + pos(row, 8 * i + 2 * (lanes & 3))
                        banks = np.concatenate([word % 32, (word + 1) % 32])
                        assert len(set(banks.tolist())) == 32
            else:  # quarter-warps of int4 stores: 8 lanes
                for m4 in range(8):
                    for ph in range(4):
                        lanes = np.arange(8 * ph, 8 * ph + 8)
                        row = warp * 16 + (lanes >> 2) + 8 * h
                        word = row * 128 + pos(row, 32 * (lanes & 3) + 4 * m4)
                        banks = np.concatenate([(word + e) % 32 for e in range(4)])
                        assert len(set(banks.tolist())) == 32


def _records(Cmax=1280):
    """Phase 3 records of every chip_smoke variant, with made-up times."""
    import chip_smoke

    recs = {}
    for variant, W, R, _, _ in chip_smoke.VARIANTS:
        recs[variant] = {"W": W or Cmax, "R": R, "max_abs_err": 0.001, "ms": 1.0,
                         "plain_ms": 50.0, "bound_ms": 0.2, "bound_by": "bytes"}
    return recs


def test_kernels_line_lists_each_row_mode_r_a_path_launched():
    """chip_smoke's kernels-line entries of block_topw from launch counts
    shaped like a run's: the main path launches bf16 row mode at R=100, the
    mesh at R=16; the DB launches f32 row mode at R=16 and R=100, the
    sharded and mesh legs at R=16. Each launched R gets its own entry with
    the first path's count; R=64, 128 and 160 (phase 3 only) get none."""
    import chip_smoke
    from quiver_tpu_torch.ops import ivf_cuda as ic

    row, f32 = ic.row_key, lambda k: (ic.F32, k)
    main = {(32, 2): 33, (128, 4): 24, row(100): 5}
    roof = {(32, 2): 13, (64, 2): 13, (128, 2): 13}
    db = {f32((32, 2)): 7, f32((128, 4)): 2, f32(row(16)): 20, f32(row(100)): 2}
    server = {f32((32, 2)): 50}
    sharded = {(32, 2): 16, f32(row(16)): 64}
    scale = {(32, 2): 41, (64, 2): 13, (128, 2): 13}
    mesh = {(32, 2): 18, row(16): 2, f32(row(16)): 14}
    entries = chip_smoke.topw_entries(
        ic, _records(), _records(), paths=(("main", main), ("roofline", roof)),
        paths_f32=(("db", db), ("server", server)),
        later=(("sharded", sharded), ("scale", scale), ("mesh", mesh)),
        errs=({f32(row(16)): 0.002}, {}, {}), db_err={f32(row(100)): 0.003})
    got = {e["key"]: (e["launches"], e["path"]) for e in entries}
    assert got == {
        (32, 2): (33, "main"), (128, 4): (24, "main"), row(16): (2, "mesh"),
        row(100): (5, "main"), (64, 2): (13, "roofline"), (128, 2): (13, "roofline"),
        f32((32, 2)): (7, "db"), f32((128, 4)): (2, "db"), f32(row(16)): (20, "db"),
        f32(row(100)): (2, "db"),
    }
    by_key = {e["key"]: e for e in entries}
    assert by_key[f32(row(16))]["max_abs_err"] == 0.002
    assert by_key[f32(row(100))]["max_abs_err"] == 0.003
    assert by_key[f32(row(16))]["sharded_launches"] == 64
    assert by_key[row(100)]["replaces"] == "quiver_tpu/ops/ivf_kernels.py:716"
    for e in entries:
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(e)
    # a required variant that no path launched fails the run
    with pytest.raises(AssertionError, match="row100 was not launched"):
        chip_smoke.topw_entries(
            ic, _records(), _records(), paths=(("main", {(32, 2): 1, (128, 4): 1}),
                                               ("roofline", roof)),
            paths_f32=(("db", db), ("server", server)), later=(), errs=(), db_err={})
