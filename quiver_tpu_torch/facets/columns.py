"""Facet compiler — metadata -> typed columns -> device bitmasks.

A copy of ``quiver_tpu/facets/columns.py`` for the PyTorch port, with its
imports pointed at ``quiver_tpu_torch`` (the JAX package cannot be imported
without JAX). Masks stay numpy ``bool[cap]``; the engine moves them to its
device.

The reference evaluates filters by unmarshalling each candidate's metadata
JSON per query (reference: pkg/core/collection.go:704-753) and brute-forces
searchK = Size() when filters are present (collection.go:679-682). Here facet
fields compile ONCE at write time into columnar form:

  str_code  i32[cap]      dictionary code of a scalar string value (-1 none)
  num_val   f32[cap]      numeric value (+has_num validity bit)
  set_words u32[cap, W]   vocab bitset over ALL values in the row (scalars are
                          singleton sets) — powers SetFilter's any-element
                          semantics (facets.go:265-338)
  present   bool[cap]     field key present in metadata
  exists    bool[cap]     present AND non-empty (facets.go:341-388)

A filter list then compiles to one bool[cap] mask (numpy, vectorized) that the
scan kernel fuses as +inf distances — filtered search costs the same as
unfiltered. Filters that can't compile (untracked field, exotic types) return
None and the collection falls back to the reference-style host post-filter.
"""

from __future__ import annotations

import math
import numbers
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from quiver_tpu_torch.facets.filters import (
    EqualityFilter,
    ExistsFilter,
    FacetFilter,
    RangeFilter,
    SetFilter,
    _as_number,
    _go_format,
    _is_empty,
    extract_path,
)
from quiver_tpu_torch.types import Filter


def _canon(v: Any):
    """Canonical vocab key: case-folded strings; numbers unified to float
    (so 5 == 5.0 matches, mirroring the reference's coercion)."""
    if isinstance(v, str):
        return ("s", v.lower())
    n = _as_number(v)
    if n is not None:
        return ("n", n)
    return None


class _FieldColumns:
    """Columnar representation of one facet field."""

    def __init__(self, capacity: int):
        # scalar string vocab (case-folded) -> str_code column; numbers
        # never enter it — numeric equality/membership compares num_val
        # directly, so a high-cardinality numeric field (prices, ids)
        # costs one f32 column, not a per-distinct-value bitset
        self.vocab: dict = {}
        # go-format vocab for request-level operator filters, whose
        # equality is Sprintf-style (collection.go:600-607): EVERY scalar
        # (string, number, bool) indexes its _go_format string, so a
        # numeric filter value matches a numeric-looking string row and
        # vice versa, exactly like the host oracle's values_equal
        self.gofmt_vocab: dict[str, int] = {}
        self.gofmt_code = np.full(capacity, -1, np.int32)
        self.str_code = np.full(capacity, -1, np.int32)
        self.num_val = np.zeros(capacity, np.float32)
        self.has_num = np.zeros(capacity, bool)
        self.present = np.zeros(capacity, bool)
        self.exists = np.zeros(capacity, bool)
        # bitset vocab for ARRAY elements only (multi-valued rows are the
        # one case scalar columns can't express); scalars stay out of it —
        # the former every-scalar bitset made set_words O(cap x distinct/32)
        # and each new code an O(cap x words) np.pad copy, which blew up to
        # minutes and gigabytes on a 100k-row float field
        self.arr_vocab: dict = {}
        self.set_words = np.zeros((capacity, 1), np.uint32)
        # any row ever held a list/tuple: request-operator compiles punt
        # to the host path (Sprintf of a sequence is not representable)
        self.any_nonscalar = False

    def _arr_code(self, key, create: bool) -> Optional[int]:
        code = self.arr_vocab.get(key)
        if code is None and create:
            code = len(self.arr_vocab)
            self.arr_vocab[key] = code
            needed_words = (code // 32) + 1
            if needed_words > self.set_words.shape[1]:
                # pow2 column growth: O(log V) copies over a vocab's life
                new_words = max(needed_words, 2 * self.set_words.shape[1])
                self.set_words = np.pad(
                    self.set_words,
                    ((0, 0), (0, new_words - self.set_words.shape[1])),
                )
        return code

    def grow(self, capacity: int) -> None:
        extra = capacity - self.str_code.shape[0]
        if extra <= 0:
            return
        self.str_code = np.concatenate([self.str_code, np.full(extra, -1, np.int32)])
        self.gofmt_code = np.concatenate(
            [self.gofmt_code, np.full(extra, -1, np.int32)]
        )
        self.num_val = np.concatenate([self.num_val, np.zeros(extra, np.float32)])
        self.has_num = np.concatenate([self.has_num, np.zeros(extra, bool)])
        self.present = np.concatenate([self.present, np.zeros(extra, bool)])
        self.exists = np.concatenate([self.exists, np.zeros(extra, bool)])
        self.set_words = np.concatenate(
            [self.set_words, np.zeros((extra, self.set_words.shape[1]), np.uint32)]
        )

    def clear_row(self, slot: int) -> None:
        self.str_code[slot] = -1
        self.gofmt_code[slot] = -1
        self.num_val[slot] = 0.0
        self.has_num[slot] = False
        self.present[slot] = False
        self.exists[slot] = False
        self.set_words[slot] = 0

    def index_row(self, slot: int, present: bool, value: Any) -> None:
        self.clear_row(slot)
        self.present[slot] = present
        if not present:
            return
        self.exists[slot] = not _is_empty(value)
        scalar = not isinstance(value, (list, tuple))
        if not scalar:
            for el in value:
                key = _canon(el)
                if key is None:
                    continue
                code = self._arr_code(key, create=True)
                self.set_words[slot, code // 32] |= np.uint32(1 << (code % 32))
        if scalar:
            key = _canon(value)
            if key is not None and key[0] == "s":
                self.str_code[slot] = self.vocab.setdefault(
                    key, len(self.vocab)
                )
            if value is not None:
                fmt = _go_format(value)
                code = self.gofmt_vocab.setdefault(fmt, len(self.gofmt_vocab))
                self.gofmt_code[slot] = code
            n = _as_number(value)
            if n is not None:
                self.num_val[slot] = np.float32(n)
                self.has_num[slot] = True
        else:
            self.any_nonscalar = True

    # -------------------------------------------------------------- compile

    def mask_equality(self, value: Any) -> Optional[np.ndarray]:
        if isinstance(value, str):
            code = self.vocab.get(("s", value.lower()))
            if code is None:
                return np.zeros_like(self.present)
            return self.str_code == code
        n = _as_number(value)
        if n is not None:
            return self.has_num & (self.num_val == np.float32(n))
        return None  # exotic type -> host fallback

    def mask_range(self, flt: RangeFilter) -> Optional[np.ndarray]:
        m = self.has_num.copy()
        if flt.min is not None:
            lo = _as_number(flt.min)
            if lo is None:
                return np.zeros_like(self.present)
            m &= (
                self.num_val >= np.float32(lo)
                if flt.min_inclusive
                else self.num_val > np.float32(lo)
            )
        if flt.max is not None:
            hi = _as_number(flt.max)
            if hi is None:
                return np.zeros_like(self.present)
            m &= (
                self.num_val <= np.float32(hi)
                if flt.max_inclusive
                else self.num_val < np.float32(hi)
            )
        return m

    def mask_set(self, values: Sequence[Any]) -> Optional[np.ndarray]:
        """Membership = scalar-column equality (strings by case-folded
        code, numbers by num_val) OR'd with the array-element bitset —
        matching the reference's any-element-in-set semantics
        (facets.go:265-338) without giving every scalar a bitset bit."""
        m = np.zeros_like(self.present)
        word_mask = np.zeros(self.set_words.shape[1], np.uint32)
        any_arr = False
        for v in values:
            key = _canon(v)
            if key is None:
                continue
            if key[0] == "s":
                code = self.vocab.get(key)
                if code is not None:
                    m |= self.str_code == code
            else:
                m |= self.has_num & (self.num_val == np.float32(key[1]))
            acode = self.arr_vocab.get(key)
            if acode is not None:
                any_arr = True
                word_mask[acode // 32] |= np.uint32(1 << (acode % 32))
        if any_arr:
            m |= (self.set_words & word_mask[None, :]).any(axis=1)
        return m

    def mask_equality_cs(self, value: Any) -> Optional[np.ndarray]:
        """Request-level '=' equality mirroring the host oracle's
        values_equal (reference valuesEqual, collection.go:600-607):
        numeric row vs numeric filter compares numerically; every other
        scalar pairing compares by go-format string — so a numeric filter
        value matches a numeric-LOOKING string row, and a string filter
        matches a numeric row, exactly like the Sprintf fallthrough."""
        if isinstance(value, (list, tuple, dict)):
            return None  # host fallback
        code = self.gofmt_vocab.get(_go_format(value))
        fmt_m = (
            self.gofmt_code == code
            if code is not None
            else np.zeros_like(self.present)
        )
        n = _as_number(value)
        if n is not None:
            return (self.has_num & (self.num_val == np.float32(n))) | (
                ~self.has_num & fmt_m
            )
        return fmt_m

    def has_value(self) -> np.ndarray:
        """Rows holding a non-null scalar value: the host oracle returns
        False for stored nulls under EVERY operator (a bare ``present``
        bit would let '!='/'not_in' match them)."""
        return self.gofmt_code >= 0

    def mask_exists(self) -> np.ndarray:
        return self.exists


class FacetColumns:
    """All facet columns for a collection, keyed by field path."""

    def __init__(self, capacity: int, fields: Iterable[str] = ()):
        self.capacity = capacity
        self.fields: dict[str, _FieldColumns] = {}
        for f in fields:
            self.fields[f] = _FieldColumns(capacity)

    def configured_fields(self) -> list[str]:
        return list(self.fields.keys())

    def set_fields(self, fields: Iterable[str]) -> list[str]:
        """Reconfigure tracked fields; returns fields needing re-index
        (reference SetFacetFields re-indexes existing metadata,
        pkg/core/collection.go:1111-1130)."""
        new = [f for f in fields if f not in self.fields]
        keep = set(fields)
        for f in list(self.fields):
            if f not in keep:
                del self.fields[f]
        for f in new:
            self.fields[f] = _FieldColumns(self.capacity)
        return new

    def grow(self, capacity: int) -> None:
        self.capacity = capacity
        for col in self.fields.values():
            col.grow(capacity)

    def index_rows(self, slots, metadatas) -> None:
        for field, col in self.fields.items():
            for slot, md in zip(slots, metadatas):
                v = extract_path(md, field)
                present = _field_present(md, field)
                col.index_row(int(slot), present, v)

    def clear_rows(self, slots) -> None:
        for col in self.fields.values():
            for slot in slots:
                col.clear_row(int(slot))

    def compile_facet_filters(
        self, filters: Sequence[FacetFilter]
    ) -> Optional[np.ndarray]:
        """AND of facet filters -> bool[cap] mask, or None for host fallback."""
        mask: Optional[np.ndarray] = None
        for flt in filters:
            col = self.fields.get(flt.field)
            if col is None:
                return None
            if isinstance(flt, EqualityFilter):
                m = col.mask_equality(flt.value)
                if m is None:
                    return None
            elif isinstance(flt, RangeFilter):
                m = col.mask_range(flt)
            elif isinstance(flt, SetFilter):
                m = col.mask_set(flt.values)
            elif isinstance(flt, ExistsFilter):
                m = col.mask_exists()
            else:
                return None
            if m is None:
                return None
            # Non-exists filters require the value to be present
            # (matches_all returns False on absent fields, facets.go:432-459).
            if not isinstance(flt, ExistsFilter):
                m = m & col.present
            mask = m if mask is None else (mask & m)
        return mask

    def compile_request_filters(
        self, filters: Sequence[Filter]
    ) -> Optional[np.ndarray]:
        """Operator filters {=, !=, >, >=, <, <=, in, not_in}
        (reference: pkg/core/collection.go:532-575) -> bool[cap] mask."""
        mask: Optional[np.ndarray] = None
        for flt in filters:
            col = self.fields.get(flt.field)
            if col is None or col.any_nonscalar:
                # list/tuple rows only compare via the host's Sprintf path
                return None
            op, val = flt.operator, flt.value
            if op == "=":
                m = col.mask_equality_cs(val)
            elif op == "!=":
                e = col.mask_equality_cs(val)
                m = None if e is None else (col.has_value() & ~e)
            elif op in (">", ">=", "<", "<="):
                if _as_number(val) is None:
                    return None  # lexicographic compare -> host fallback
                if bool(np.any(col.present & ~col.has_num)):
                    # some rows hold non-numeric values: the reference
                    # compares those lexicographically (collection.go:609-633)
                    # which the numeric column can't express -> host fallback
                    return None
                rf = RangeFilter(
                    flt.field,
                    min=val if op in (">", ">=") else None,
                    max=val if op in ("<", "<=") else None,
                    min_inclusive=(op == ">="),
                    max_inclusive=(op == "<="),
                )
                m = col.mask_range(rf)
            elif op == "in":
                if not isinstance(val, (list, tuple)):
                    return None
                m = _or_masks([col.mask_equality_cs(v) for v in val], col)
            elif op == "not_in":
                # non-list value matches every valued row (collection.go:560-570)
                if not isinstance(val, (list, tuple)):
                    m = col.has_value()
                else:
                    s = _or_masks([col.mask_equality_cs(v) for v in val], col)
                    m = None if s is None else (col.has_value() & ~s)
            else:
                return None
            if m is None:
                return None
            if op not in ("!=", "not_in"):
                m = m & col.present
            mask = m if mask is None else (mask & m)
        return mask


def _or_masks(masks, col) -> Optional[np.ndarray]:
    out = np.zeros_like(col.present)
    for m in masks:
        if m is None:
            return None
        out |= m
    return out


def _field_present(md: Optional[dict], path: str) -> bool:
    """Whether the (possibly nested) field KEY is present, even if empty."""
    if not md:
        return False
    cur: Any = md
    parts = path.split(".")
    for part in parts[:-1]:
        if not isinstance(cur, dict) or part not in cur:
            return False
        cur = cur[part]
    return isinstance(cur, dict) and parts[-1] in cur
