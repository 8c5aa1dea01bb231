"""Device-memory accounting (PyTorch port of ``quiver_tpu/utils/memory.py``).

``device_bytes(obj)`` walks an object's attributes and sums the bytes of
every tensor it owns; engines report it through
``get_detailed_metrics()["device_bytes"]``. The port keeps its host mirrors
in numpy, so the tensors an engine holds are the ones on its device.
Aliases count once: tensors that share one storage are one allocation,
keyed by ``untyped_storage().data_ptr()`` and counted at the storage's
size. Whole-card figures (allocator caches, scratch inside a call) come
from ``torch.cuda.max_memory_allocated()`` instead.

Sharded engines (``parallel/``) hold their shards' tensors on the devices
of their mesh. :func:`device_bytes_by_device` reports the bytes on each
device, so a placement can be checked; ``device_bytes`` reports bytes per
device, the whole divided by the number of distinct devices the tensors
live on (:func:`_per_chip_nbytes`, the counterpart of
``memory.py:48-63``). Shards placed together on one device share it, so
there the per-device figure is the whole.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

#: walk depth bound — engines nest at most (engine -> layers[list] ->
#: _Layer -> tensors); anything deeper is a cycle or a foreign object
_MAX_DEPTH = 5


def _per_chip_nbytes(per_device: dict) -> int:
    """Bytes per device of tensors spread over a shard list: the sum over
    ``per_device`` (device -> bytes) divided by the number of distinct
    devices. Evenly sharded tensors report the global size over n; shards
    placed together on one device report their whole."""
    return int(sum(per_device.values()) / max(len(per_device), 1))


def device_bytes(obj: Any, *, skip: tuple = ()) -> int:
    """Bytes per device of the tensors reachable from ``obj``'s attributes
    (:func:`_per_chip_nbytes` of :func:`device_bytes_by_device`; one
    device: their total)."""
    return _per_chip_nbytes(device_bytes_by_device(obj, skip=skip))


def device_bytes_by_device(obj: Any, *, skip: tuple = ()) -> dict:
    """``{device name: bytes}`` of the tensors reachable from ``obj``'s
    attributes, on each device they live on.

    Follows objects of this package, lists/tuples/sets/dicts; stops at any
    object whose type is in ``skip`` (e.g. VectorStore, so an engine's own
    footprint excludes the store it shares). Tensors sharing a storage
    count once, at the storage's size.
    """
    seen_objs: set[int] = set()
    seen_bufs: set = set()
    per_device: dict = {}

    def walk(x, depth):
        if x is None or depth > _MAX_DEPTH:
            return
        if isinstance(x, torch.Tensor):
            storage = x.untyped_storage()
            dev = str(x.device)
            # meta tensors hold no data: every one reports address 0
            key = (dev, storage.data_ptr() or id(x))
            if key not in seen_bufs:
                seen_bufs.add(key)
                per_device[dev] = per_device.get(dev, 0) + int(storage.nbytes())
            return
        if isinstance(x, (str, bytes, int, float, bool, np.ndarray)):
            return
        if isinstance(x, dict):
            for v in x.values():
                walk(v, depth + 1)
            return
        if isinstance(x, (list, tuple, set)):
            for v in x:
                walk(v, depth + 1)
            return
        mod = type(x).__module__ or ""
        if not mod.startswith("quiver_tpu_torch"):
            return
        if isinstance(x, skip) or id(x) in seen_objs:
            return
        seen_objs.add(id(x))
        for v in vars(x).values():
            walk(v, depth + 1)

    walk(obj, 0)
    return per_device


def store_device_bytes(store) -> int:
    """Bytes of a VectorStore's device view (vectors + valid + norms), 0
    if the view was never materialized."""
    view = store._device
    if view is None:
        return 0
    return int(sum(
        t.numel() * t.element_size()
        for t in (view.vectors, view.valid, view.norms_sq, view.inv_norms)
    ))
