"""The HNSW engine alone: a ``VectorStore`` holding the corpus and an
``HNSWIndex`` fed by its own write hook (``on_insert`` over the stored
rows, as ``Collection`` feeds it), with the configuration's
``HNSWConfig`` fields and construction dtype. ``info`` carries what the
beam's roofline counts (``layers/hnsw.beam.roofline.py``): the width, the
layer-0 degree and the entries the beam expands an iteration."""

from __future__ import annotations

import inspect

import numpy as np
import torch

from qbench.system import System


def build(config: dict, corpus: np.ndarray, device, rec) -> System:
    from quiver_tpu_torch import VectorStore
    from quiver_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
    from quiver_tpu_torch.ops.hnsw_kernels import beam_search

    serving = config["serving"]
    n, d = corpus.shape
    store = VectorStore(dim=d, metric=config["metric"], capacity=n, device=device)
    slots = store.add_batch([f"v{i}" for i in range(n)], corpus)
    eng = HNSWIndex(store, config=HNSWConfig(**serving["hnsw"]),
                    compute_dtype=getattr(torch, serving["build_dtype"]))
    eng.on_insert(slots, corpus)
    rec.wrap(eng, "search_slots", "engine.search_slots", size=lambda a, kw: len(a[0]))
    m = eng.get_detailed_metrics()
    return System(engine=eng, info={
        "ef_search": eng.config.ef_search, "d": d, "m0": eng.config.m0,
        "expand": inspect.signature(beam_search).parameters["expand"].default,
        "max_level": m["max_level"], "layer_nodes": m["layer_nodes"],
        "reverse_edges_spilled": m["reverse_edges_spilled"]})
