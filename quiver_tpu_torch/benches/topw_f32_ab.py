"""``block_topw`` over f32 blocks: this checkout's kernel against another
checkout's, timed on one card in turns.

    python -m quiver_tpu_torch.benches.topw_f32_ab OTHER_ROOT

``OTHER_ROOT`` is another checkout of the repository, for example the
parent commit unpacked with ``git archive``. One process runs each turn,
in the order other, this, this, other; each imports ``quiver_tpu_torch``
and ``chip_smoke`` from its own root and builds its own kernels there. A
turn times with CUDA events (``benches/common.py::cuda_ms``) every f32
variant of ``chip_smoke.py`` phase 3 on its L2 operands, at B=65536,
K=1405, Cmax=1280, d=128 with P in {2, 3} and at d=768 (B=16384, K=1024)
with P=3; then the database's f32 slice: the 1M headline corpus in an IVF
engine with f32 blocks (the headline config at n_probe=2, the value the
database's tuner picks), ms per B=65536 batch of ``search_slots_device``,
pairs and fused. Each turn prints one JSON line; the last line holds each
measurement's times in turn order and the card's name and power limit.
Without CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import json
import sys

#: (shape name, chip_smoke shape attribute, P values)
SHAPES = (("d128", "KERNEL_SHAPE", (2, 3)), ("d768", "WIDE_SHAPE", (3,)))


def turn(root: str) -> dict:
    """One turn's times, with ``quiver_tpu_torch`` and ``chip_smoke``
    imported from ``root`` (in place of this file's directory, the
    process's first import path)."""
    sys.path[0] = root
    import torch

    import chip_smoke
    from quiver_tpu_torch import IVFConfig, IVFIndex, VectorStore
    from quiver_tpu_torch.bench import B, make_queries
    from quiver_tpu_torch.benches.common import N, clustered, cuda_ms
    from quiver_tpu_torch.ops import ivf_cuda

    dev = torch.device("cuda", 0)
    times = {}
    for name, attr, probes in SHAPES:
        shape = getattr(chip_smoke, attr)
        for variant, W, R, pos_bits, _ in chip_smoke.VARIANTS:
            W, pos_bits, sentinel = chip_smoke.variant_args(variant, W, R, pos_bits, shape["Cmax"])
            for P in probes:
                args, kw = chip_smoke.kernel_inputs(
                    torch, dev, P=P, metric="euclidean", variant=variant,
                    seed=1000 * P + len("euclidean"), dtype=torch.float32, **shape)
                kw.update(W=W, R=R, pos_bits=pos_bits, sentinel=sentinel)
                times[f"{variant} {name} P={P}"] = cuda_ms(
                    lambda: ivf_cuda.block_topw(*args, **kw), 10)
                del args, kw
                torch.cuda.empty_cache()
    vecs = clustered(N)
    store = VectorStore(dim=vecs.shape[1], metric="euclidean", capacity=N, device=dev)
    store.add_batch([f"v{i}" for i in range(N)], vecs)
    eng = IVFIndex(store, config=IVFConfig(
        n_clusters=1024, n_probe=2, q_cap_factor=2, kmeans_iters=8, build_threshold=1024,
        rescore=False), compute_dtype=torch.float32)
    eng.build()
    qdev = torch.from_numpy(make_queries(vecs, B, 2048)[1]).to(dev)
    for form in ("pairs", "fused"):
        eng.config.formulation = form
        times[f"slice {form} P=2"] = cuda_ms(lambda: eng.search_slots_device(qdev, 10), 10)
    return {"root": root, "ms": times}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2])), flush=True)
    else:
        from quiver_tpu_torch.benches.common import ab_main

        sys.exit(ab_main(sys.argv[1:], __file__, __doc__))
