"""The comparison that decides ``correct``.

A run hands over, for a sample of the requests its window answered, each
answer as the caller received it: the ids (corpus rows, -1 for an empty
place) and distances of one query, or the mark that it never came. The
reference computes the exact top-k of the sampled queries and the exact
distance of every returned id, from the corpus the benchmark made, and
reads three numbers:

* ``recall``: tie-aware recall@k, the share of returned ids whose exact
  distance is within the true k-th (``exact.REL_TOL``), at most k a query;
  the configuration's guarantee is its lower limit;
* ``dist_gap``: the 99th percentile, over every returned id, of the gap
  between the returned distance and the exact distance of the id it
  names, over the query's true k-th distance; it reads the precision the
  program computed in, and distances that do not belong to their ids (the
  widest gap is no steady number: a row far from its IVF centroid loses
  most to bf16 residuals, and a few such rows set it);
* ``bad_answers``: answers that never came, hold an id that is no corpus
  row or twice the same id, a distance that is not finite, or distances
  out of order; the limit is 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from qbench.reference import exact


@dataclass
class Answers:
    """What a window returned for its sampled requests: ``query`` i64[A]
    indexes the judged queries, ``ids`` i64[A, k], ``dists`` f64[A, k]
    (NaN where absent), ``missing`` bool[A] for answers that never came."""

    query: np.ndarray
    ids: np.ndarray
    dists: np.ndarray
    missing: np.ndarray

    @staticmethod
    def concat(parts: list["Answers"], k: int) -> "Answers":
        if not parts:
            return Answers(np.zeros(0, np.int64), np.zeros((0, k), np.int64),
                           np.zeros((0, k)), np.zeros(0, bool))
        return Answers(*(np.concatenate([getattr(p, f) for p in parts])
                         for f in ("query", "ids", "dists", "missing")))


def numbers(corpus: torch.Tensor, queries: torch.Tensor, ans: Answers, k: int,
            metric: str) -> dict:
    """{"recall", "dist_gap", "bad_answers", "dist_gap_max"} of ``ans``
    against the exact answers for ``queries`` (f32[J, d]) over ``corpus``
    (f32[n, d]), on the corpus's device."""
    dev = corpus.device
    n = corpus.shape[0]
    _, d_true = exact.topk(corpus, queries, k, metric)
    kth = d_true[:, k - 1]
    hits, gaps, bad = 0, [], int(ans.missing.sum())
    chunk = max(1, (1 << 19) // k)
    for s in range(0, len(ans.query), chunk):
        qi = torch.as_tensor(ans.query[s:s + chunk], device=dev)
        ids = torch.as_tensor(ans.ids[s:s + chunk], device=dev)
        got = torch.as_tensor(ans.dists[s:s + chunk], device=dev, dtype=torch.float64)
        came = ~torch.as_tensor(ans.missing[s:s + chunk], device=dev)
        d_ex = exact.distances(corpus, queries[qi], ids, metric)
        thr = kth[qi] * (1 + exact.REL_TOL) + exact.ABS_TOL
        hit = (d_ex <= thr[:, None]) & came[:, None]
        hits += int(torch.clamp(hit.sum(1), max=k).sum())
        valid = (ids >= 0) & (ids < n)
        srt = ids.sort(1).values
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        finite = torch.isfinite(got)
        order = (got[:, 1:] >= got[:, :-1]) | ~finite[:, 1:] | ~finite[:, :-1]
        wrong = came & (~valid.all(1) | dup.any(1) | ~finite.all(1) | ~order.all(1))
        bad += int(wrong.sum())
        both = came[:, None] & valid & finite
        rel = (got - d_ex).abs() / kth[qi].clamp_min(1e-9)[:, None]
        gaps.append(rel[both].float().cpu().numpy())
    gap = np.concatenate(gaps) if gaps else np.zeros(0, np.float32)
    return {"recall": hits / max(len(ans.query) * k, 1),
            "dist_gap": float(np.quantile(gap, 0.99)) if len(gap) else 0.0,
            "bad_answers": bad, "dist_gap_max": float(gap.max()) if len(gap) else 0.0}


def verdict(nums: dict, check: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "min" | "max"}}) of ``nums`` against the
    configuration's limits ``check``: ``recall_min``, ``dist_gap_max``,
    ``bad_answers_max``."""
    lines = {
        "recall": {"value": nums["recall"], "min": check["recall_min"]},
        "dist_gap": {"value": nums["dist_gap"], "max": check["dist_gap_max"]},
        "bad_answers": {"value": nums["bad_answers"], "max": check["bad_answers_max"]},
    }
    ok = (nums["recall"] >= check["recall_min"]
          and nums["dist_gap"] <= check["dist_gap_max"]
          and nums["bad_answers"] <= check["bad_answers_max"])
    return bool(ok), lines
