"""Columnar vector store — one device-resident matrix per collection
(PyTorch port of ``quiver_tpu/core/store.py``).

A collection owns exactly one store: a host-authoritative numpy mirror (for
persistence and growth) plus a lazily-synced device view — ``vectors
f32[cap, d]`` padded to a {2^k, 3*2^(k-1)} ladder capacity with a ``valid``
occupancy mask (deletes are cleared bits) and precomputed row stats.

Mutations accumulate as pending slot updates and are applied to the device
tensors with one in-place scatter per sync; capacity growth re-uploads.

The device is explicit: ``VectorStore(..., device=...)``. Every tensor of the
view lives there, and a CUDA device with no card raises instead of falling
back to the CPU.

Not ported yet: the change feed (``store.py:292-326``), which only the
background maintenance and the sharded engines read, and the rest of the
store's API (metadata, id lookups, update, snapshots), which the write
path, Collection and persistence use — later items in ROADMAP.md. Not ported: the pow2 padding
of the pending scatter (``store.py:345-350``), which exists only to bound
XLA's compiled shapes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from quiver_tpu_torch.ops.distance import inv_norms, norms_sq
from quiver_tpu_torch.types import DistanceType

_MIN_CAPACITY = 1024


def _next_pow2(n: int) -> int:
    c = _MIN_CAPACITY
    while c < n:
        c *= 2
    return c


def _next_cap(n: int) -> int:
    """Capacity ladder {2^k, 3*2^(k-1)}: padding waste capped at 25%
    instead of a pure pow2 ladder's 100%."""
    p = _next_pow2(n)
    three_q = 3 * (p // 4)
    return three_q if three_q >= n else p


def resolve_device(device) -> torch.device:
    """A torch.device for ``device``; a CUDA device with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


@dataclass(frozen=True)
class StoreDeviceView:
    """Device-side view used by search kernels. A full resync replaces
    its tensors; an incremental sync updates them in place."""

    vectors: torch.Tensor  # f32[cap, d]
    valid: torch.Tensor  # bool[cap]
    norms_sq: torch.Tensor  # f32[cap]
    inv_norms: torch.Tensor  # f32[cap]
    capacity: int


class VectorStore:
    """Slot-addressed columnar vector store.

    Thread-safety: a single re-entrant writer lock guards mutations and
    device syncs.
    """

    def __init__(
        self,
        dim: int,
        metric: DistanceType | str = DistanceType.COSINE,
        capacity: int = _MIN_CAPACITY,
        *,
        device,
    ):
        if dim <= 0:
            raise ValueError(f"dimension must be positive, got {dim}")
        self.dim = int(dim)
        self.metric = DistanceType.parse(metric)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        cap = _next_cap(capacity)
        self._np_vectors = np.zeros((cap, dim), dtype=np.float32)
        self._np_valid = np.zeros((cap,), dtype=bool)
        self._id_to_slot: dict[str, int] = {}
        self._free: list[int] = []
        self._high_water = 0  # first never-used slot
        self._count = 0
        self._device: Optional[StoreDeviceView] = None
        self._pending_slots: list[int] = []
        self._full_resync = True

    # ------------------------------------------------------------------ host

    @property
    def size(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._np_vectors.shape[0]

    def _alloc_slots(self, n: int) -> np.ndarray:
        slots = []
        while self._free and len(slots) < n:
            slots.append(self._free.pop())
        remaining = n - len(slots)
        if remaining:
            needed = self._high_water + remaining
            if needed > self.capacity:
                self._grow(needed)
            slots.extend(range(self._high_water, self._high_water + remaining))
            self._high_water += remaining
        return np.asarray(slots, dtype=np.int64)

    def _grow(self, needed: int) -> None:
        new_cap = _next_cap(needed)
        old_cap = self.capacity
        grown = np.zeros((new_cap, self.dim), dtype=np.float32)
        grown[:old_cap] = self._np_vectors
        self._np_vectors = grown
        self._np_valid = np.concatenate(
            [self._np_valid, np.zeros(new_cap - old_cap, dtype=bool)]
        )
        self._full_resync = True

    def add_batch(self, ids: Sequence[str], vectors) -> np.ndarray:
        """Insert a batch; returns assigned slots. All-or-nothing validation."""
        vecs = np.asarray(vectors, dtype=np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape != (len(ids), self.dim):
            raise ValueError(
                f"vector batch shape {vecs.shape} != ({len(ids)}, {self.dim})"
            )
        with self._lock:
            seen = set()
            for vid in ids:
                if not vid:
                    raise ValueError("vector ID must not be empty")
                if vid in self._id_to_slot or vid in seen:
                    raise ValueError(f"vector with ID {vid} already exists")
                seen.add(vid)
            slots = self._alloc_slots(len(ids))
            self._np_vectors[slots] = vecs
            self._np_valid[slots] = True
            for s, vid in zip(slots, ids):
                self._id_to_slot[vid] = int(s)
            self._count += len(ids)
            self._pending_slots.extend(int(s) for s in slots)
            return slots

    def delete_batch(self, ids: Iterable[str]) -> int:
        with self._lock:
            removed = 0
            for vid in ids:
                slot = self._id_to_slot.pop(vid, None)
                if slot is None:
                    continue
                self._np_valid[slot] = False
                self._np_vectors[slot] = 0.0
                self._free.append(slot)
                self._pending_slots.append(slot)
                removed += 1
            self._count -= removed
            return removed

    # ---------------------------------------------------------------- device

    def device_view(self) -> StoreDeviceView:
        """Sync pending mutations to the device and return the view."""
        with self._lock:
            if self._device is None or self._full_resync:
                vecs = torch.from_numpy(self._np_vectors).to(self.device, copy=True)
                valid = torch.from_numpy(self._np_valid).to(self.device, copy=True)
                ns = norms_sq(vecs)
                self._device = StoreDeviceView(
                    vecs, valid, ns, inv_norms(ns), self.capacity
                )
                self._full_resync = False
                self._pending_slots.clear()
            elif self._pending_slots:
                slots = np.unique(np.asarray(self._pending_slots, dtype=np.int64))
                view = self._device
                idx = torch.from_numpy(slots).to(self.device)
                new_vecs = torch.from_numpy(self._np_vectors[slots]).to(self.device)
                # per-row stats for the scattered rows only: a full norms
                # pass would re-read the whole [cap, d] matrix per sync
                row_ns = norms_sq(new_vecs)
                view.vectors.index_copy_(0, idx, new_vecs)
                view.valid.index_copy_(
                    0, idx, torch.from_numpy(self._np_valid[slots]).to(self.device)
                )
                view.norms_sq.index_copy_(0, idx, row_ns)
                view.inv_norms.index_copy_(0, idx, inv_norms(row_ns))
                self._pending_slots.clear()
            return self._device
