"""The port's facet filters and columns against the JAX package's.

``quiver_tpu_torch/facets`` is a copy of ``quiver_tpu/facets`` with its
imports swapped; these tests hold it to the original on the cases of
tests/test_facets.py: every host predicate returns the same answer, and
every compiled mask (``compile_facet_filters``, ``compile_request_filters``)
is bit-equal to the JAX package's — or None in both, where a filter cannot
compile and the collection falls back to the host post-filter.
"""

import numpy as np
import pytest

from quiver_tpu.facets import columns as jcols
from quiver_tpu.facets import filters as jflt
from quiver_tpu import types as jtypes
from quiver_tpu_torch.facets import columns as tcols
from quiver_tpu_torch.facets import filters as tflt
from quiver_tpu_torch import types as ttypes

from tests.test_facets import FIELDS, MD

PKGS = ((jflt, jcols, jtypes), (tflt, tcols, ttypes))

#: (filter class, args, kwargs): built in each package
FACET_CASES = [
    [("EqualityFilter", ("category", "ELECTRONICS"), {})],
    [("EqualityFilter", ("price", 150), {})],
    [("RangeFilter", ("price",), dict(min=15, max=100, max_inclusive=False))],
    [("RangeFilter", ("price",), dict(min=15))],
    [("RangeFilter", ("price",), dict(max=10, min_inclusive=False))],
    [("SetFilter", ("tags", ["sale"]), {})],
    [("SetFilter", ("tags", ["rare", "used"]), {})],
    [("ExistsFilter", ("brand",), {})],
    [("ExistsFilter", ("nested.a.b",), {})],
    [("EqualityFilter", ("category", "electronics"), {}),
     ("RangeFilter", ("price",), dict(max=120))],
    [("EqualityFilter", ("nested.a.b", 7), {})],
    [("EqualityFilter", ("unknown", 1), {})],
]

REQUEST_CASES = [
    [("category", "=", "Electronics")],
    [("category", "=", "electronics")],
    [("category", "!=", "books")],
    [("price", ">", 50)],
    [("price", ">=", 99.5)],
    [("price", "<", 100)],
    [("price", "<=", 15)],
    [("stock", "in", [5, 9])],
    [("stock", "not_in", [5])],
    [("stock", "in", 5)],
    [("stock", "not_in", 5)],
    [("category", "=", "Electronics"), ("price", "<", 100)],
    [("category", ">", "a")],
    [("unknown", "=", 1)],
    [("nested.a.b", "=", 7)],
]

VALUES = ["Electronics", "electronics", "books", 150, 150.0, 151, True, 99.5, 15, 100,
          "99", "SALE", ["new", "sale"], ["used"], [], {}, "", None, 0, 1e9, -1e9]


def facet_filters(flt, case):
    return [getattr(flt, cls)(*args, **kw) for cls, args, kw in case]


def request_filters(types, case):
    return [types.Filter(f, op, v) for f, op, v in case]


def both_columns(fields=FIELDS, cap=8, rows=MD):
    out = []
    for _, cols, _ in PKGS:
        c = cols.FacetColumns(capacity=cap, fields=fields)
        c.index_rows(range(len(rows)), rows)
        out.append(c)
    return out


def assert_masks_equal(mj, mt):
    assert (mj is None) == (mt is None)
    if mj is not None:
        assert mt.dtype == mj.dtype == bool
        np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("case", FACET_CASES, ids=[repr(c) for c in FACET_CASES])
def test_facet_filters_match_jax(case):
    (jf, jc, _), (tf, tc, _) = PKGS
    fj, ft = facet_filters(jf, case), facet_filters(tf, case)
    for v in VALUES:
        assert [f.match(v) for f in ft] == [f.match(v) for f in fj], v
    for md in MD:
        assert tf.matches_all(ft, md) == jf.matches_all(fj, md)
    cj, ct = both_columns()
    assert_masks_equal(cj.compile_facet_filters(fj), ct.compile_facet_filters(ft))


@pytest.mark.parametrize("case", REQUEST_CASES, ids=[repr(c) for c in REQUEST_CASES])
def test_request_filters_match_jax(case):
    (jf, _, jt), (tf, _, tt) = PKGS
    rj, rt = request_filters(jt, case), request_filters(tt, case)
    for md in MD + [{"a": {"b": 5}}, {"nested": {"a": {"b": 7}}}]:
        assert tf.matches_request_filters(md, rt) == jf.matches_request_filters(md, rj)
    cj, ct = both_columns()
    mj, mt = cj.compile_request_filters(rj), ct.compile_request_filters(rt)
    assert_masks_equal(mj, mt)
    if mt is not None:  # and the compiled mask is the host oracle
        want = [tf.matches_request_filters(md, rt) for md in MD]
        assert mt[: len(MD)].tolist() == want


def test_extraction_and_values_match_jax():
    (jf, _, _), (tf, _, _) = PKGS
    for md in MD:
        for path in ("category", "nested.a.b", "nested.a.missing", "x"):
            assert tf.extract_path(md, path) == jf.extract_path(md, path)
        got = [(f.field, f.value) for f in tf.extract_facets(md, FIELDS)]
        assert got == [(f.field, f.value) for f in jf.extract_facets(md, FIELDS)]
    for a, b in [(5, 5.0 + 1e-12), ("5", 5), (True, 1), (None, None), ("a", "A")]:
        assert tf.values_equal(a, b) == jf.values_equal(a, b)
    for a, b in [(1, 2), ("b", "a"), (2.5, 2.5)]:
        assert tf.compare_values(a, b) == jf.compare_values(a, b)
    d = {"type": "range", "field": "p", "min": 1, "max": 2}
    assert type(tf.filter_from_dict(d)).__name__ == type(jf.filter_from_dict(d)).__name__
    for bad in ({"type": "bogus"},):
        for flt in (jf, tf):
            with pytest.raises(ValueError):
                flt.filter_from_dict(bad)


def test_mixed_type_grid_matches_jax():
    """tests/test_facets.py's device/host grid: mixed types, numeric-looking
    strings, bools, nulls, absent fields; and a list-valued row forcing the
    host fallback."""
    rows = [{"v": "5"}, {"v": 5}, {"v": 5.0}, {"v": 7}, {"v": "hello"},
            {"v": "Hello"}, {"v": None}, {"v": True}, {"v": ""}, {}]
    cj, ct = both_columns(["v"], 16, rows)
    cases = [("=", 5), ("=", "5"), ("=", 5.0), ("=", "hello"), ("=", "Hello"),
             ("=", True), ("=", ""), ("!=", 5), ("!=", "hello"), ("!=", True),
             ("in", [5, "hello"]), ("in", ["5"]), ("not_in", [5]),
             ("not_in", ["hello", 7]), ("not_in", "notalist")]
    for op, val in cases:
        mj = cj.compile_request_filters([jtypes.Filter("v", op, val)])
        mt = ct.compile_request_filters([ttypes.Filter("v", op, val)])
        assert mt is not None, (op, val)
        assert_masks_equal(mj, mt)
    cj, ct = both_columns(["v"], 8, [{"v": [1, 2]}, {"v": 3}])
    assert ct.compile_request_filters([ttypes.Filter("v", "=", 3)]) is None
    assert cj.compile_request_filters([jtypes.Filter("v", "=", 3)]) is None


def test_set_membership_forms_match_jax():
    rows = [{"v": 5}, {"v": 5.0}, {"v": "SALE"}, {"v": [5, 9]}, {"v": ["sale"]}, {"v": 7}]
    cj, ct = both_columns(["v"], 16, rows)
    for vals in ([5, "sale"], [9], ["SALE"], [7.0]):
        assert_masks_equal(cj.compile_facet_filters([jflt.SetFilter("v", vals)]),
                           ct.compile_facet_filters([tflt.SetFilter("v", vals)]))


def test_reindex_grow_clear_and_vocab_match_jax():
    out = []
    for flt, cols, _ in PKGS:
        c = cols.FacetColumns(capacity=4, fields=["a"])
        c.index_rows([0, 1], [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}])
        added = c.set_fields(["a", "b"])
        c.index_rows([0, 1], [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}])
        m1 = c.compile_facet_filters([flt.EqualityFilter("b", "x")])
        c.grow(130)
        mds = [{"b": f"tag{i}"} for i in range(100)]
        c.index_rows(range(20, 120), mds)
        m2 = c.compile_facet_filters([flt.SetFilter("b", ["tag37", "tag99", "x"])])
        c.clear_rows([0, 57])
        m3 = c.compile_facet_filters([flt.SetFilter("b", ["tag37", "x"])])
        out.append((added, c.configured_fields(), m1, m2, m3))
    (aj, fj, *mj), (at, ft, *mt) = out
    assert at == aj == ["b"] and ft == fj
    for a, b in zip(mj, mt):
        assert_masks_equal(a, b)
    assert mt[1].shape == (130,) and mt[1].sum() == 3


def test_high_cardinality_field_matches_jax():
    n = 5000
    mds = [{"price": float(i) + 0.5} for i in range(n)]
    cj, ct = both_columns(["price"], n, mds)
    assert ct.fields["price"].set_words.shape == cj.fields["price"].set_words.shape
    assert_masks_equal(
        cj.compile_facet_filters([jflt.SetFilter("price", [17.5, 4999.5])]),
        ct.compile_facet_filters([tflt.SetFilter("price", [17.5, 4999.5])]))
    assert_masks_equal(
        cj.compile_facet_filters([jflt.RangeFilter("price", min=100, max=200)]),
        ct.compile_facet_filters([tflt.RangeFilter("price", min=100, max=200)]))
