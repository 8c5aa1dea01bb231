"""Exact k-nearest neighbours in float64, in blocks of corpus rows.

Metrics as the program defines them: ``euclidean`` is the square root of
the summed squared differences; ``cosine`` is ``1 - cos``, the cosine
clamped to [-1, 1], and 1 where either vector is zero. Smaller is nearer.

``rounding`` puts the reference in a lower precision for the control
("fp8": float8 e4m3, "tf32": 10 explicit mantissa bits, "bf16"): each
input is rounded before the float64 arithmetic, as a tensor core rounds
its operands and keeps the products exact.
"""

from __future__ import annotations

import torch

#: a returned id counts as a true neighbour when its exact distance is
#: within the true k-th one by this relative tolerance (the rule of
#: ``quiver_tpu_torch/benches/truth.py``)
REL_TOL = 1e-6
ABS_TOL = 1e-12


def round_to(x: torch.Tensor, rounding: str | None) -> torch.Tensor:
    """``x`` rounded to ``rounding`` (None: as it is), as float64."""
    if rounding is None:
        return x.double()
    if rounding == "fp8":
        return x.float().to(torch.float8_e4m3fn).double()
    if rounding == "bf16":
        return x.float().to(torch.bfloat16).double()
    if rounding == "tf32":
        # round to nearest even at 13 dropped mantissa bits of float32
        b = x.float().contiguous().view(torch.int32)
        b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32).double()
    raise ValueError(f"unknown rounding {rounding!r}")


def _prep(x: torch.Tensor, metric: str, rounding: str | None):
    """(rows in float64, their squared norms or inverse norms)."""
    x = round_to(x, rounding)
    ns = (x * x).sum(1)
    if metric == "cosine":
        n = ns.sqrt()
        return x, torch.where(n > 0, 1.0 / n.clamp_min(1e-300), 0.0)
    if metric == "euclidean":
        return x, ns
    raise ValueError(f"unknown metric {metric!r}")


def _dist(q, q_aux, v, v_aux, metric: str) -> torch.Tensor:
    dots = q @ v.T
    if metric == "cosine":
        return 1.0 - (dots * q_aux[:, None] * v_aux[None, :]).clamp(-1.0, 1.0)
    return (q_aux[:, None] + v_aux[None, :] - 2.0 * dots).clamp_min(0.0).sqrt()


def topk(corpus: torch.Tensor, queries: torch.Tensor, k: int, metric: str, *,
         rounding: str | None = None, block: int = 65536):
    """(ids i64[m, k], distances f64[m, k]) of the k nearest corpus rows to
    each query, nearest first, on the corpus's device."""
    q, q_aux = _prep(queries.to(corpus.device), metric, rounding)
    m = q.shape[0]
    best = torch.full((m, k), float("inf"), dtype=torch.float64, device=corpus.device)
    best_i = torch.full((m, k), -1, dtype=torch.int64, device=corpus.device)
    for s in range(0, corpus.shape[0], block):
        v, v_aux = _prep(corpus[s:s + block], metric, rounding)
        d = _dist(q, q_aux, v, v_aux, metric)
        ids = torch.arange(s, s + v.shape[0], device=corpus.device).expand(m, -1)
        best, pos = torch.topk(torch.cat([best, d], 1), k, dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, pos)
    return best_i, best


def distances(corpus: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
              metric: str) -> torch.Tensor:
    """f64[m, j] exact distance of query i to corpus row ``ids[i, j]``;
    NaN where the id is not a corpus row."""
    n = corpus.shape[0]
    ok = (ids >= 0) & (ids < n)
    q, q_aux = _prep(queries.to(corpus.device), metric, None)
    v, v_aux = _prep(corpus[ids.clamp(0, n - 1).reshape(-1)], metric, None)
    v = v.reshape(*ids.shape, -1)
    v_aux = v_aux.reshape(ids.shape)
    dots = (v * q[:, None, :]).sum(-1)
    if metric == "cosine":
        d = 1.0 - (dots * q_aux[:, None] * v_aux).clamp(-1.0, 1.0)
    else:
        d = (q_aux[:, None] + v_aux - 2.0 * dots).clamp_min(0.0).sqrt()
    return torch.where(ok, d, float("nan"))
