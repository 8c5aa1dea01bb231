"""Carry state from the JAX package into the port.

The JAX package's state reaches this module as numpy arrays (``np.asarray``
of its device arrays, or its ``export_topology()`` dict). Two routes:

* :func:`ivf_arrays_from_numpy` turns the ``ivf_query`` operands into
  tensors on a device, so both packages' query functions run on identical
  block arrays;
* an index: ``IVFIndex.import_topology(jax_index.export_topology(), remap)``
  on a port store holding the same ids lays out the same blocks; an HNSW
  graph crosses the same way, or through :func:`hnsw_from_topology`;
* a collection: :func:`collection_from_snapshot` loads the rows of a JAX
  ``Collection.store.snapshot()`` into a port ``Collection`` and installs
  its engine's topology, the route the JAX DB takes on reload
  (``quiver_tpu/core/db.py:204-237``).

One trap: ``np.asarray`` of a JAX bf16 array gives an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` rejects. It crosses as its int16 bit
pattern (:func:`bf16_to_torch`), bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch


def bf16_to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy bf16 array (``ml_dtypes.bfloat16``) as a torch bf16 tensor
    with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name != "bfloat16":
        raise TypeError(f"expected a bfloat16 array, got {a.dtype}")
    bits = torch.from_numpy(a.view(np.int16).copy())
    return bits.view(torch.bfloat16).to(device)


def _blocks_to_torch(blocks_t: np.ndarray, device, dtype) -> torch.Tensor:
    if dtype == torch.bfloat16 and blocks_t.dtype.name == "bfloat16":
        return bf16_to_torch(blocks_t, device)
    return torch.tensor(np.asarray(blocks_t, np.float32), device=device).to(dtype)


def ivf_arrays_from_numpy(
    centroids, cent_norms_sq, blocks_t, block_slot, block_rns, block_inv,
    block_keep, store_vectors, *, device, blocks_dtype=torch.bfloat16,
):
    """The ``ivf_query`` operands after ``q``, as tensors on ``device`` in
    ``ivf_query``'s positional order: (centroids f32, cent_norms_sq f32,
    blocks_t, block_slot i32, block_rns f32, block_inv f32, block_keep
    bool, store_vectors f32). ``blocks_t`` becomes ``blocks_dtype``: bf16
    from a bf16 array is carried bit-exact and from an f32 one rounded to
    nearest even, as JAX's astype does; f32 is carried exactly."""

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return (
        f32(centroids),
        f32(cent_norms_sq),
        _blocks_to_torch(np.asarray(blocks_t), device, blocks_dtype),
        torch.tensor(np.asarray(block_slot, np.int32), device=device),
        f32(block_rns),
        f32(block_inv),
        torch.tensor(np.asarray(block_keep, bool), device=device),
        f32(store_vectors),
    )


def hnsw_from_topology(store, topology, *, slot_remap=None, **cfg):
    """A port ``HNSWIndex`` over ``store`` holding the graph of a JAX
    ``HNSWIndex.export_topology()``. ``slot_remap[old_slot]`` is the slot
    of that row in ``store`` (-1: gone); without it the store holds the
    rows at the JAX store's slots. ``cfg``: the engine's keywords (its
    ``HNSWConfig`` fields, ``compute_dtype``)."""
    from quiver_tpu_torch.index.hnsw import HNSWIndex

    index = HNSWIndex(store, **cfg)
    if slot_remap is None:
        slot_remap = np.arange(len(np.asarray(topology["node_level"])), dtype=np.int64)
    index.import_topology(topology, slot_remap)
    return index


def collection_from_snapshot(
    snapshot, *, name: str, metric, facet_fields=(), topology=None,
    snapshot_slots=None, engine_factory=None, device,
):
    """A port ``Collection`` holding a JAX collection's rows.

    ``snapshot`` is ``(ids, vectors f32[n, d], metadata)`` from the JAX
    ``Collection.store.snapshot()``; the rows load through ``load_rows``
    (no engine or WAL notification). With ``topology`` (the JAX engine's
    ``export_topology()``) and ``snapshot_slots`` (the JAX store's
    ``live_slots()``, the slot of each snapshot row), the engine imports the
    topology with the old-slot -> new-slot remap; without it, the engine
    indexes the rows as fresh inserts."""
    from quiver_tpu_torch.core.collection import Collection

    ids, vectors, metadatas = snapshot
    vectors = np.asarray(vectors, np.float32)
    coll = Collection(
        name, vectors.shape[1], metric, facet_fields=facet_fields,
        engine_factory=engine_factory, device=device,
    )
    if not len(ids):
        return coll
    slots = coll.load_rows(list(ids), vectors, list(metadatas))
    engine = coll.engine
    if topology is not None:
        if snapshot_slots is None:
            raise ValueError("a topology needs the snapshot's slots (live_slots())")
        old = np.asarray(snapshot_slots, np.int64)
        remap = np.full(int(old.max(initial=-1)) + 1, -1, np.int64)
        remap[old] = slots
        engine.import_topology(topology, remap)
    elif hasattr(engine, "on_insert"):
        engine.on_insert(slots, vectors)
    return coll
