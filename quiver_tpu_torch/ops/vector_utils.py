"""Vector utility surface — normalize / arithmetic / magnitude / predicates
(a copy of ``quiver_tpu/ops/vector_utils.py``, which imports no JAX but
cannot be imported without it: ``quiver_tpu/__init__.py`` imports JAX).

Capability parity with the reference's vector helpers
(reference: pkg/vectortypes/distances.go:116-199 — NormalizeVector,
VectorAdd, VectorSubtract, VectorMultiplyScalar, VectorMagnitude,
CreateZeroVector, CreateRandomVector, CloneVector; and
pkg/vectortypes/types.go:77-109 — IsNormalized with 1e-6 tolerance).

Re-designed batch-first: every function accepts a single vector ``[d]`` or
a batch ``[n, d]`` and vectorizes over the batch. These are host-side
utilities (numpy): one small vector op per call would waste a device
dispatch; the device path uses the fused kernels in ops/distance.py and
ops/scan.py. Accumulation is float64, matching the reference's
``float64``-accumulate-then-truncate behavior.

Deliberately NOT reproduced: the reference's IsNormalized special-cases
3-d vectors whose components are all ~1/sqrt(3) with a 1e-3 tolerance
(types.go:88-102) — that case is already covered by the magnitude check.
"""

from __future__ import annotations

import numpy as np

#: tolerance for IsNormalized (reference types.go:22
#: IsNormalizedPrecisionTolerance)
IS_NORMALIZED_TOL = 1e-6


def _as_f32(v) -> np.ndarray:
    a = np.asarray(v, dtype=np.float32)
    if a.ndim not in (1, 2):
        raise ValueError(f"expected [d] or [n, d] vector(s), got shape {a.shape}")
    return a


def magnitude(v) -> "np.floating | np.ndarray":
    """Euclidean norm; float for ``[d]``, float32[n] for ``[n, d]``
    (reference VectorMagnitude, distances.go:171-178)."""
    a = _as_f32(v)
    m = np.sqrt(np.sum(a.astype(np.float64) ** 2, axis=-1))
    return m.astype(np.float32)


def normalize(v) -> np.ndarray:
    """Unit-normalize; zero vectors pass through unchanged (reference
    NormalizeVector zero-guard, distances.go:116-134)."""
    a = _as_f32(v)
    m = np.sqrt(np.sum(a.astype(np.float64) ** 2, axis=-1, keepdims=True))
    return np.where(m == 0.0, a, a / np.maximum(m, np.finfo(np.float64).tiny)).astype(
        np.float32
    )


def is_normalized(v, tol: float = IS_NORMALIZED_TOL) -> "bool | np.ndarray":
    """|‖v‖ − 1| <= tol; empty vectors are not normalized (reference
    IsNormalized, types.go:77-109)."""
    a = _as_f32(v)
    if a.shape[-1] == 0:
        ok = np.zeros(a.shape[:-1], bool)
    else:
        m = np.sqrt(np.sum(a.astype(np.float64) ** 2, axis=-1))
        ok = np.abs(m - 1.0) <= tol
    return bool(ok) if a.ndim == 1 else ok


def _pair(a, b) -> tuple[np.ndarray, np.ndarray]:
    x, y = _as_f32(a), _as_f32(b)
    if x.shape[-1] != y.shape[-1]:
        raise ValueError(
            f"vectors must have the same length: {x.shape[-1]} != {y.shape[-1]}"
        )
    return x, y


def add(a, b) -> np.ndarray:
    """Elementwise sum; dims must match (reference VectorAdd,
    distances.go:137-148)."""
    x, y = _pair(a, b)
    return x + y


def subtract(a, b) -> np.ndarray:
    """a − b; dims must match (reference VectorSubtract,
    distances.go:151-161)."""
    x, y = _pair(a, b)
    return x - y


def scale(v, scalar: float) -> np.ndarray:
    """v × scalar (reference VectorMultiplyScalar, distances.go:164-170)."""
    return _as_f32(v) * np.float32(scalar)


def zeros(dimension: int) -> np.ndarray:
    """(reference CreateZeroVector, distances.go:181-183)."""
    return np.zeros(int(dimension), np.float32)


def random_vector(dimension: int, seed: int | None = None) -> np.ndarray:
    """A random unit-range vector. The reference's "random" is actually
    deterministic sin(i) (distances.go:186-192); here a real PRNG with an
    optional seed for reproducibility."""
    rng = np.random.default_rng(seed)
    return rng.random(int(dimension), dtype=np.float32)


def clone(v) -> np.ndarray:
    """Deep copy (reference CloneVector, distances.go:195-199)."""
    return np.array(_as_f32(v), copy=True)
