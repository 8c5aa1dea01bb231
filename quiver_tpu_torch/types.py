"""Core wire/value types for quiver-tpu (PyTorch port).

A copy of ``quiver_tpu/types.py``: that module is jax-free, but
``quiver_tpu/__init__.py`` imports jax eagerly, so the port cannot import
it and carries its own copy.

Capability parity with the reference's ``pkg/types/search.go`` and
``pkg/vectortypes/types.go`` (the Go reference), re-expressed as plain
Python dataclasses. Distance identity is an enum (fixing the reference's
function-pointer-name anti-pattern, ``pkg/core/db.go:326-334``, and its
hardcoded-"cosine" reload bug, ``pkg/core/db.go:266-270``).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


class DistanceType(str, enum.Enum):
    """Distance metrics (reference: pkg/vectortypes/types.go:14-26).

    All distances are "smaller is better"; ``score = 1 - distance``
    (reference: pkg/types/search.go:89-95).
    """

    COSINE = "cosine"
    EUCLIDEAN = "euclidean"
    SQUARED_EUCLIDEAN = "squared_euclidean"
    DOT_PRODUCT = "dot_product"
    MANHATTAN = "manhattan"

    @classmethod
    def parse(cls, s: "str | DistanceType") -> "DistanceType":
        if isinstance(s, DistanceType):
            return s
        try:
            return cls(s.lower())
        except ValueError as e:
            raise ValueError(f"unknown distance type: {s!r}") from e


# Operators supported by request-level filters
# (reference: pkg/core/collection.go:532-575 matchesFilter).
FILTER_OPERATORS = ("=", "!=", ">", ">=", "<", "<=", "in", "not_in")


@dataclass
class Filter:
    """Request-level metadata filter (reference: pkg/types/search.go:64-72)."""

    field: str
    operator: str
    value: Any

    def validate(self) -> None:
        if not self.field:
            raise ValueError("filter field must not be empty")
        if self.operator not in FILTER_OPERATORS:
            raise ValueError(
                f"unsupported filter operator {self.operator!r}; "
                f"expected one of {FILTER_OPERATORS}"
            )


@dataclass
class SearchOptions:
    """Search options (reference: pkg/types/search.go:74-86)."""

    include_vectors: bool = False
    include_metadata: bool = False
    exact_search: bool = False


@dataclass
class SearchRequest:
    """A search request (reference: pkg/types/search.go:44-62)."""

    vector: Any  # array-like, float32[d]
    top_k: int = 10
    filters: list[Filter] = field(default_factory=list)
    options: SearchOptions = field(default_factory=SearchOptions)
    namespace_id: str = ""
    negative_example: Any = None  # optional array-like, float32[d]
    negative_weight: float = 0.5
    strategy: Optional[str] = None  # force exact|hnsw on hybrid engines


@dataclass
class BasicSearchResult:
    """Minimal (id, distance) result (reference: pkg/types/search.go:9-14)."""

    id: str
    distance: float


@dataclass
class SearchResultItem:
    """A full result row (reference: pkg/types/search.go:31-42).

    ``score = 1 - distance`` (reference: pkg/types/search.go:89-95).
    """

    id: str
    distance: float
    score: float = 0.0
    vector: Optional[np.ndarray] = None
    metadata: Optional[dict] = None

    def __post_init__(self):
        if not self.score:
            self.score = 1.0 - self.distance


@dataclass
class SearchResponseMetadata:
    """Response metadata (reference: pkg/types/search.go:17-28)."""

    total_count: int = 0
    search_time_ms: float = 0.0
    index_size: int = 0
    index_name: str = ""
    timestamp: float = field(default_factory=time.time)
    strategy: str = ""  # which engine served the query (exact|hnsw)
    engine_stats: Optional[dict] = None  # attached by fluent include_stats


@dataclass
class SearchResponse:
    """Search response (reference: pkg/types/search.go:54-62)."""

    results: list[SearchResultItem] = field(default_factory=list)
    metadata: SearchResponseMetadata = field(default_factory=SearchResponseMetadata)
    query: Optional[np.ndarray] = None


@dataclass
class VectorRecord:
    """A stored vector (reference: pkg/vectortypes/types.go:29-33)."""

    id: str
    values: np.ndarray
    metadata: Optional[dict] = None


def as_f32_matrix(vectors, dim: int | None = None) -> np.ndarray:
    """Coerce a vector batch to a contiguous float32 [B, d] matrix."""
    arr = np.asarray(vectors, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"expected 1-D or 2-D vector input, got shape {arr.shape}")
    if dim is not None and arr.shape[1] != dim:
        raise ValueError(f"vector dimension mismatch: got {arr.shape[1]}, want {dim}")
    return np.ascontiguousarray(arr)
