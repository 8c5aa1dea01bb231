"""The plain reference against a brute-force loop at tiny sizes, in both
metrics, and the judge against answers that are wrong in each way it
names."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from qbench.reference import exact, judge


def brute(corpus: np.ndarray, q: np.ndarray, metric: str) -> list:
    out = []
    for v in corpus:
        if metric == "euclidean":
            out.append(math.sqrt(sum((float(a) - float(b)) ** 2 for a, b in zip(q, v))))
        else:
            dot = sum(float(a) * float(b) for a, b in zip(q, v))
            nq = math.sqrt(sum(float(a) ** 2 for a in q))
            nv = math.sqrt(sum(float(b) ** 2 for b in v))
            out.append(1.0 if nq == 0 or nv == 0 else 1.0 - max(-1.0, min(1.0, dot / (nq * nv))))
    return out


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_topk_is_the_brute_force_answer(metric):
    g = torch.Generator().manual_seed(3)
    corpus = torch.randn(300, 7, generator=g)
    corpus[17] = 0.0  # the zero-vector guard
    queries = torch.randn(9, 7, generator=g)
    ids, dists = exact.topk(corpus, queries, 5, metric, block=64)
    for i in range(len(queries)):
        d = brute(corpus.numpy(), queries[i].numpy(), metric)
        order = np.argsort(d, kind="stable")[:5]
        assert ids[i].tolist() == order.tolist()
        np.testing.assert_allclose(dists[i].numpy(), np.asarray(d)[order], rtol=1e-12, atol=1e-12)
    d_of = exact.distances(corpus, queries, ids, metric)
    np.testing.assert_allclose(d_of.numpy(), dists.numpy(), rtol=1e-12, atol=1e-12)


def _answers(ids, dists, query=None, missing=None):
    ids = np.asarray(ids, np.int64)
    return judge.Answers(np.arange(len(ids)) if query is None else np.asarray(query),
                         ids, np.asarray(dists, np.float64),
                         np.zeros(len(ids), bool) if missing is None else np.asarray(missing))


def _problem():
    g = torch.Generator().manual_seed(5)
    corpus = torch.randn(200, 6, generator=g)
    corpus[101] = corpus[100]  # a tie at the boundary
    queries = corpus[[100, 3, 50]] + 0.01 * torch.randn(3, 6, generator=g)
    ids, dists = exact.topk(corpus, queries, 4, "euclidean")
    return corpus, queries, ids.numpy(), dists.numpy()


def test_judge_reads_the_exact_answer_as_perfect_and_counts_ties():
    corpus, queries, ids, dists = _problem()
    nums = judge.numbers(corpus, queries, _answers(ids, dists), 4, "euclidean")
    assert nums == {"recall": 1.0, "dist_gap": 0.0, "bad_answers": 0, "dist_gap_max": 0.0}
    # at k=1 the tied twin of the nearest row is as near: a hit, tie-aware
    assert set(ids[0, :2]) == {100, 101}
    twin = 201 - ids[:, :1]
    twin[1:] = ids[1:, :1]
    nums = judge.numbers(corpus, queries, _answers(twin, dists[:, :1]), 1, "euclidean")
    assert nums["recall"] == 1.0 and nums["bad_answers"] == 0


@pytest.mark.parametrize("fault", ["duplicate", "not_a_row", "unsorted", "nan", "missing"])
def test_judge_counts_each_kind_of_bad_answer(fault):
    corpus, queries, ids, dists = _problem()
    ids, dists = ids.copy(), dists.copy()
    missing = np.zeros(len(ids), bool)
    if fault == "duplicate":
        ids[1, 3] = ids[1, 0]
    elif fault == "not_a_row":
        ids[1, 3] = 10_000
    elif fault == "unsorted":
        dists[1, [0, 3]] = dists[1, [3, 0]]
    elif fault == "nan":
        dists[1, 2] = np.nan
    else:
        missing[1] = True
    nums = judge.numbers(corpus, queries, _answers(ids, dists, missing=missing), 4, "euclidean")
    assert nums["bad_answers"] == 1
    ok, _ = judge.verdict(nums, {"recall_min": 0.5, "dist_gap_max": 1.0, "bad_answers_max": 0})
    assert not ok


def test_judge_reads_a_distance_that_is_not_its_ids():
    corpus, queries, ids, dists = _problem()
    far = ids.copy()
    far[:, 3] = (far[:, 3] + 97) % 200  # another row, the old distance kept
    nums = judge.numbers(corpus, queries, _answers(far, dists), 4, "euclidean")
    assert nums["dist_gap"] > 0.1 and nums["recall"] < 1.0


def test_recall_is_the_share_of_true_neighbours():
    corpus, queries, ids, dists = _problem()
    worse = ids.copy()
    worse[0] = [190, 191, 192, 193]
    d = exact.distances(corpus, queries, torch.as_tensor(worse), "euclidean").numpy()
    d[0] = np.sort(d[0])
    nums = judge.numbers(corpus, queries, _answers(worse, d), 4, "euclidean")
    expect = sum(float(x) <= dists[0, 3] * (1 + exact.REL_TOL) for x in d[0])
    assert nums["recall"] == pytest.approx((8 + expect) / 12)


@pytest.mark.parametrize("rounding,bits", [("tf32", 10), ("bf16", 7)])
def test_rounding_keeps_the_format_s_mantissa(rounding, bits):
    x = torch.tensor([1.0 + 2.0 ** -(bits + 1) * 1.5, 3.0, -1.2345678])
    r = exact.round_to(x, rounding)
    mant = (r.float().view(torch.int32) & 0x7FFFFF).numpy()
    assert np.all(mant % (1 << (23 - bits)) == 0)
    assert torch.allclose(r.float(), x, rtol=2.0 ** -bits)
    assert torch.equal(exact.round_to(x, "fp8").float(), x.to(torch.float8_e4m3fn).float())
