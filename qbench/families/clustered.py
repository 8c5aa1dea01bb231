"""Isotropic Gaussian blobs, queries jittered from corpus rows.

The port's headline corpus (``quiver_tpu_torch/benches/common.py::clustered``,
``bench.py::make_queries``): ``n_centers`` standard-normal centres in d
dimensions, each row a uniformly drawn centre plus ``spread`` times a
standard-normal draw; each query a uniformly drawn corpus row plus
``jitter`` times a standard-normal draw. Drawn on the generator's device in
a few large calls: the corpus from ``corpus_gen``, the queries from
``query_gen``.
"""

from __future__ import annotations

import torch


def make(params: dict, n: int, d: int, m: int, corpus_gen: torch.Generator,
         query_gen: torch.Generator):
    """(corpus f32[n, d], queries f32[m, d]) on the generators' device."""
    dev, g = corpus_gen.device, corpus_gen
    centers = torch.randn(params["n_centers"], d, generator=g, device=dev)
    which = torch.randint(0, params["n_centers"], (n,), generator=g, device=dev)
    corpus = centers[which] + params["spread"] * torch.randn(n, d, generator=g, device=dev)
    rows = torch.randint(0, n, (m,), generator=query_gen, device=dev)
    queries = corpus[rows] + params["jitter"] * torch.randn(m, d, generator=query_gen, device=dev)
    return corpus, queries
