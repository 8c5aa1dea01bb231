"""Facet filters — host-side predicate semantics.

A copy of ``quiver_tpu/facets/filters.py`` for the PyTorch port (pure
Python; the JAX package cannot be imported without JAX).

Capability parity with the reference's four filter types
(reference: pkg/facets/facets.go:27-473):
  EqualityFilter — case-insensitive strings, cross-type numeric coercion,
                   deep-equal fallback (facets.go:39-91)
  RangeFilter    — min/max with inclusive flags, numeric paths (facets.go:94-262)
  SetFilter      — membership; an array value matches if ANY element is in the
                   set (facets.go:265-338)
  ExistsFilter   — presence; empty string/list/dict counts as absent
                   (facets.go:341-388)
plus dot-notation facet extraction (facets.go:397-429) and AND-combination
(facets.go:432-459).

These host predicates are the semantic oracle; the device path compiles the
same predicates to columnar bitmasks (facets/columns.py) fused into the scan
kernel, and tests assert host/device equivalence.
"""

from __future__ import annotations

import numbers
from dataclasses import dataclass, field as dc_field
from typing import Any, Iterable, Optional


def _as_number(v: Any) -> Optional[float]:
    """Numeric coercion matching the reference's float64 unification
    (facets.go:60-78); bools are not numbers."""
    if isinstance(v, bool):
        return None
    if isinstance(v, numbers.Real):
        return float(v)
    return None


def _is_empty(v: Any) -> bool:
    """Empty string/slice/map counts as absent (facets.go:341-388)."""
    if v is None:
        return True
    if isinstance(v, (str, list, tuple, dict)) and len(v) == 0:
        return True
    return False


@dataclass(frozen=True)
class FacetValue:
    """An extracted (field, value) pair (reference: pkg/facets/facets.go:14-24)."""

    field: str
    value: Any


class FacetFilter:
    """Base filter interface {type, field, match} (facets.go:27-36)."""

    type: str = ""
    field: str = ""

    def match(self, value: Any) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def __str__(self) -> str:
        return f"{self.type}({self.field})"


@dataclass(frozen=True)
class EqualityFilter(FacetFilter):
    field: str = ""
    value: Any = None
    type: str = dc_field(default="equality", init=False)

    def match(self, value: Any) -> bool:
        if isinstance(self.value, str) and isinstance(value, str):
            return self.value.lower() == value.lower()
        a, b = _as_number(self.value), _as_number(value)
        if a is not None and b is not None:
            return a == b
        return self.value == value


@dataclass(frozen=True)
class RangeFilter(FacetFilter):
    field: str = ""
    min: Any = None
    max: Any = None
    min_inclusive: bool = True
    max_inclusive: bool = True
    type: str = dc_field(default="range", init=False)

    def match(self, value: Any) -> bool:
        x = _as_number(value)
        if x is None:
            return False
        if self.min is not None:
            lo = _as_number(self.min)
            if lo is None:
                return False
            if self.min_inclusive:
                if x < lo:
                    return False
            elif x <= lo:
                return False
        if self.max is not None:
            hi = _as_number(self.max)
            if hi is None:
                return False
            if self.max_inclusive:
                if x > hi:
                    return False
            elif x >= hi:
                return False
        return True


@dataclass(frozen=True)
class SetFilter(FacetFilter):
    field: str = ""
    values: tuple = ()
    type: str = dc_field(default="set", init=False)

    def __init__(self, field: str, values: Iterable[Any]):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "values", tuple(values))

    def _contains(self, v: Any) -> bool:
        for allowed in self.values:
            if EqualityFilter(self.field, allowed).match(v):
                return True
        return False

    def match(self, value: Any) -> bool:
        # Array value: matches if ANY element is in the set (facets.go:265-338).
        if isinstance(value, (list, tuple)):
            return any(self._contains(v) for v in value)
        return self._contains(value)


@dataclass(frozen=True)
class ExistsFilter(FacetFilter):
    field: str = ""
    type: str = dc_field(default="exists", init=False)

    def match(self, value: Any) -> bool:
        return not _is_empty(value)


def extract_path(metadata: Optional[dict], path: str) -> Any:
    """Dot-notation nested lookup (facets.go:397-429). Returns None if absent."""
    if not metadata:
        return None
    cur: Any = metadata
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def extract_facets(metadata: Optional[dict], fields: Iterable[str]) -> list[FacetValue]:
    """Extract configured facet fields from a metadata dict (facets.go:397-429)."""
    out = []
    for f in fields:
        v = extract_path(metadata, f)
        if v is not None:
            out.append(FacetValue(field=f, value=v))
    return out


def matches_all(filters: Iterable[FacetFilter], metadata: Optional[dict]) -> bool:
    """AND over all filters against a metadata dict (facets.go:432-459)."""
    for flt in filters:
        v = extract_path(metadata, flt.field)
        if isinstance(flt, ExistsFilter):
            if not flt.match(v):
                return False
        else:
            if v is None or not flt.match(v):
                return False
    return True


def _go_format(v: Any) -> str:
    """Go fmt.Sprintf(\"%v\") analogue for the values JSON decoding produces
    (floats that are integral print without the trailing .0)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def values_equal(a: Any, b: Any) -> bool:
    """Request-filter equality (reference valuesEqual,
    pkg/core/collection.go:600-607): numeric pairs compare with 1e-9
    tolerance; everything else compares by formatted string (case-SENSITIVE)."""
    af, bf = _as_number(a), _as_number(b)
    if af is not None and bf is not None:
        return abs(af - bf) <= 1e-9
    return _go_format(a) == _go_format(b)


def compare_values(a: Any, b: Any) -> int:
    """Request-filter ordering (reference compareValues,
    collection.go:609-633): numeric if both coerce, else lexicographic."""
    af, bf = _as_number(a), _as_number(b)
    if af is not None and bf is not None:
        return (af > bf) - (af < bf)
    as_, bs = _go_format(a), _go_format(b)
    return (as_ > bs) - (as_ < bs)


def matches_request_filter(metadata: Optional[dict], flt) -> bool:
    """One operator filter against a metadata dict (reference matchesFilter,
    collection.go:532-575). Unlike the reference (literal top-level keys
    only), dotted field names resolve through nested paths — matching the
    device-compiled path (columns.compile_request_filters indexes facet
    columns via extract_path), so results don't depend on whether a field
    happens to be facet-tracked. Absent field -> False."""
    if not metadata:
        return False
    value = extract_path(metadata, flt.field)
    if value is None:
        # extract_path returns None both for "absent" and for a stored
        # null; either way no operator matches (reference: absent -> False)
        return False
    op, fv = flt.operator, flt.value
    if op == "=":
        return values_equal(value, fv)
    if op == "!=":
        return not values_equal(value, fv)
    if op == ">":
        return compare_values(value, fv) > 0
    if op == ">=":
        return compare_values(value, fv) >= 0
    if op == "<":
        return compare_values(value, fv) < 0
    if op == "<=":
        return compare_values(value, fv) <= 0
    if op == "in":
        if isinstance(fv, (list, tuple)):
            return any(values_equal(value, v) for v in fv)
        return False
    if op == "not_in":
        if isinstance(fv, (list, tuple)):
            return not any(values_equal(value, v) for v in fv)
        return True
    return False


def matches_request_filters(metadata: Optional[dict], filters) -> bool:
    return all(matches_request_filter(metadata, f) for f in filters)


def filter_from_dict(d: dict) -> FacetFilter:
    """Build a filter from a JSON dict (the REST API's facet filter codec)."""
    t = d.get("type")
    f = d.get("field", "")
    if t == "equality":
        return EqualityFilter(f, d.get("value"))
    if t == "range":
        return RangeFilter(
            f,
            min=d.get("min"),
            max=d.get("max"),
            min_inclusive=d.get("min_inclusive", True),
            max_inclusive=d.get("max_inclusive", True),
        )
    if t == "set":
        return SetFilter(f, d.get("values", []))
    if t == "exists":
        return ExistsFilter(f)
    raise ValueError(f"unknown facet filter type: {t!r}")
