"""The IVF engine alone: a ``VectorStore`` holding the corpus and an
``IVFIndex`` built over it by the engine's own ``build()`` (which tunes
``n_probe`` when the configuration sets ``recall_target``), with the
configuration's block dtype and ``IVFConfig`` fields."""

from __future__ import annotations

import numpy as np
import torch

from qbench.system import System


def build(config: dict, corpus: np.ndarray, device, rec) -> System:
    from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore

    serving = config["serving"]
    n, d = corpus.shape
    store = VectorStore(dim=d, metric=config["metric"], capacity=n, device=device)
    store.add_batch([f"v{i}" for i in range(n)], corpus)
    eng = IVFIndex(store, config=IVFConfig(**serving["ivf"]),
                   compute_dtype=getattr(torch, serving["block_dtype"]))
    eng.build()
    rec.wrap(eng, "search_slots", "engine.search_slots",
             size=lambda a, kw: len(a[0]), record=lambda a, kw, out: (a[0], a[1]))
    return System(engine=eng, ivf=eng, ivf_span="engine.search_slots",
                  info={"n_probe": eng.config.n_probe, "rescore": eng.config.rescore,
                        "n_clusters": eng.n_clusters})
