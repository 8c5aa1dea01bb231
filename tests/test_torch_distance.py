"""quiver_tpu_torch.ops.distance against quiver_tpu.ops.distance.

The same numpy inputs (seeded, zero rows included) go through both packages;
every comparison holds the port to the JAX package at rtol/atol 1e-5 (f32,
only the summation order differs). Both run full f32 products: the JAX side
at ``precision="highest"``, the port with TF32 off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import distance as jd
from quiver_tpu.types import DistanceType as JDistanceType
from quiver_tpu_torch.ops import distance as td
from quiver_tpu_torch.types import DistanceType

RTOL = ATOL = 1e-5
METRICS = [m.value for m in DistanceType]


def _rows(seed, n, d, zero_rows=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[list(zero_rows)] = 0.0
    return x


def test_distance_type_copy_matches():
    assert [m.value for m in DistanceType] == [m.value for m in JDistanceType]
    assert DistanceType.parse("EUCLIDEAN") is DistanceType.EUCLIDEAN
    with pytest.raises(ValueError):
        DistanceType.parse("hamming")


def test_norms_and_inverse_norms():
    x = _rows(0, 33, 24, zero_rows=(0, 7))
    got_ns = td.norms_sq(torch.from_numpy(x))
    want_ns = np.asarray(jd.norms_sq(jnp.asarray(x)))
    np.testing.assert_allclose(got_ns.numpy(), want_ns, rtol=RTOL, atol=ATOL)
    got_inv = td.inv_norms(got_ns).numpy()
    np.testing.assert_allclose(
        got_inv, np.asarray(jd.inv_norms(jnp.asarray(want_ns))), rtol=RTOL, atol=ATOL
    )
    assert got_inv[0] == 0.0 and got_inv[7] == 0.0  # zero-vector guard


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_matches_jax(metric):
    q = _rows(1, 6, 32, zero_rows=(2,))
    v = _rows(2, 41, 32, zero_rows=(5, 40))
    got = td.pairwise_distance(torch.from_numpy(q), torch.from_numpy(v), metric)
    want = jd.pairwise_distance(
        jnp.asarray(q), jnp.asarray(v), metric, precision="highest"
    )
    assert got.shape == (6, 41) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if metric == "cosine":
        # zero rows give distance exactly 1 (sim 0)
        assert np.all(got.numpy()[2] == 1.0)
        assert np.all(got.numpy()[:, 5] == 1.0)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_with_precomputed_stats(metric):
    q = _rows(3, 4, 16)
    v = _rows(4, 20, 16, zero_rows=(3,))
    vt = torch.from_numpy(v)
    ns = td.norms_sq(vt)
    got = td.pairwise_distance(
        torch.from_numpy(q), vt, metric, v_norms_sq=ns, v_inv_norms=td.inv_norms(ns)
    )
    plain = td.pairwise_distance(torch.from_numpy(q), vt, metric)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_distance_pairs_matches_jax(metric):
    a = _rows(5, 50, 32, zero_rows=(0, 9))
    b = _rows(6, 50, 32, zero_rows=(9, 20))
    b[30] = a[30]  # identical pair: the direct (a-b)^2 form gives exactly 0
    got = td.distance_pairs(torch.from_numpy(a), torch.from_numpy(b), metric).numpy()
    want = np.asarray(jd.distance_pairs(jnp.asarray(a), jnp.asarray(b), metric))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if metric in ("euclidean", "squared_euclidean", "manhattan"):
        assert got[30] == 0.0
    if metric == "cosine":
        assert got[0] == 1.0 and got[9] == 1.0 and got[20] == 1.0
