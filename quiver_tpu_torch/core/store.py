"""Columnar vector store — one device-resident matrix per collection
(PyTorch port of ``quiver_tpu/core/store.py``).

A collection owns exactly one store: a host-authoritative numpy mirror (for
persistence and growth) plus a lazily-synced device view — ``vectors
f32[cap, d]`` padded to a {2^k, 3*2^(k-1)} ladder capacity with a ``valid``
occupancy mask (deletes are cleared bits) and precomputed row stats — and
the rows' ids and metadata on the host.

Mutations accumulate as pending slot updates and are applied to the device
tensors with one in-place scatter per sync; capacity growth re-uploads.
Every mutation is also logged to a slot-level change feed
(:meth:`VectorStore.changes_since`), which the IVF engine's background
maintenance replays onto its staging layout.

The device is explicit: ``VectorStore(..., device=...)``. Every tensor of the
view lives there, and a CUDA device with no card raises instead of falling
back to the CPU.

Streams. The reference's view is a fresh immutable value per sync
(``store.py:80-83``); here an incremental sync updates the view's tensors
in place, so a reader on another CUDA stream could race it. Every sync is
therefore issued on one stream, the device's default stream, and
:meth:`VectorStore.device_view` orders the caller's current stream after it
(``wait_stream``) and marks the view's tensors as used by that stream
(``record_stream``), so a full resync that replaces them cannot hand their
memory to a new allocation while the caller's queued reads are pending.

Not ported: the pow2 padding of the pending scatter (``store.py:345-350``),
which exists only to bound XLA's compiled shapes.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from quiver_tpu_torch.ops.distance import inv_norms, norms_sq
from quiver_tpu_torch.types import DistanceType, VectorRecord

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
    """A torch.device for ``device``; a CUDA device with no card raises.
    ``"cuda"`` resolves to the current card's index, so the tensors the
    store makes (``cuda:N``) compare equal to its device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class StoreDeviceView:
    """Device-side view used by search kernels. A full resync replaces
    its tensors; an incremental sync updates them in place (and returns a
    new view object over the same tensors)."""

    vectors: torch.Tensor  # f32[cap, d]
    valid: torch.Tensor  # bool[cap]
    norms_sq: torch.Tensor  # f32[cap]
    inv_norms: torch.Tensor  # f32[cap]
    capacity: int
    generation: int  # bumps on every sync


class VectorStore:
    """Slot-addressed columnar vector + metadata store.

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
        self._ids: list[Optional[str]] = [None] * cap
        self._metadata: list[Optional[dict]] = [None] * cap
        self._id_to_slot: dict[str, int] = {}
        self._free: list[int] = []
        self._high_water = 0  # first never-used slot
        self._count = 0
        self._device: Optional[StoreDeviceView] = None
        self._pending_slots: list[int] = []
        self._full_resync = True
        self._generation = 0
        # change feed: slot-level mutation log + an epoch that bumps
        # whenever incremental replay is impossible (growth, log overflow)
        self._change_epoch = 0
        self._change_log: list[int] = []

    # ------------------------------------------------------------------ host

    @property
    def size(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._np_vectors.shape[0]

    def __contains__(self, vec_id: str) -> bool:
        return vec_id in self._id_to_slot

    def slot_of(self, vec_id: str) -> int:
        return self._id_to_slot[vec_id]

    def id_of(self, slot: int) -> Optional[str]:
        if 0 <= slot < len(self._ids):
            return self._ids[slot]
        return None

    def get(self, vec_id: str) -> VectorRecord:
        with self._lock:
            slot = self._id_to_slot.get(vec_id)
            if slot is None:
                raise KeyError(f"vector not found: {vec_id}")
            md = self._metadata[slot]
            return VectorRecord(
                id=vec_id,
                values=self._np_vectors[slot].copy(),
                metadata=copy.deepcopy(md) if md is not None else None,
            )

    def ids(self) -> list[str]:
        return list(self._id_to_slot.keys())

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
        self._ids.extend([None] * (new_cap - old_cap))
        self._metadata.extend([None] * (new_cap - old_cap))
        self._full_resync = True
        self._change_epoch += 1
        self._change_log.clear()

    def add_batch(
        self,
        ids: Sequence[str],
        vectors,
        metadata: Optional[Sequence[Optional[dict]]] = None,
    ) -> np.ndarray:
        """Insert a batch; returns assigned slots. All-or-nothing validation."""
        vecs = np.asarray(vectors, dtype=np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape != (len(ids), self.dim):
            raise ValueError(
                f"vector batch shape {vecs.shape} != ({len(ids)}, {self.dim})"
            )
        if metadata is None:
            metadata = [None] * len(ids)
        if len(metadata) != len(ids):
            raise ValueError("metadata length mismatch")
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
            for s, vid, md in zip(slots, ids, metadata):
                self._ids[s] = vid
                # deep copy: stored metadata must not alias the caller's
                # dict in either direction
                self._metadata[s] = copy.deepcopy(md) if md is not None else None
                self._id_to_slot[vid] = int(s)
            self._count += len(ids)
            self._pending_slots.extend(int(s) for s in slots)
            self._log_changes(slots)
            return slots

    def add(self, vec_id: str, vector, metadata: Optional[dict] = None) -> int:
        return int(self.add_batch([vec_id], [vector], [metadata])[0])

    def update_batch(
        self,
        ids: Sequence[str],
        vectors=None,
        metadata: Optional[Sequence[Optional[dict]]] = None,
    ) -> None:
        """In-place update: the rows keep their slots."""
        with self._lock:
            slots = []
            for vid in ids:
                if vid not in self._id_to_slot:
                    raise KeyError(f"vector not found: {vid}")
                slots.append(self._id_to_slot[vid])
            if vectors is not None:
                vecs = np.asarray(vectors, dtype=np.float32)
                if vecs.ndim == 1:
                    vecs = vecs[None, :]
                if vecs.shape != (len(ids), self.dim):
                    raise ValueError("update vector shape mismatch")
                self._np_vectors[slots] = vecs
                self._pending_slots.extend(slots)
                self._log_changes(slots)
            if metadata is not None:
                for s, md in zip(slots, metadata):
                    self._metadata[s] = copy.deepcopy(md) if md is not None else None

    def delete(self, vec_id: str) -> bool:
        return self.delete_batch([vec_id]) == 1

    def delete_batch(self, ids: Iterable[str]) -> int:
        with self._lock:
            removed = 0
            for vid in ids:
                slot = self._id_to_slot.pop(vid, None)
                if slot is None:
                    continue
                self._np_valid[slot] = False
                self._np_vectors[slot] = 0.0
                self._ids[slot] = None
                self._metadata[slot] = None
                self._free.append(slot)
                self._pending_slots.append(slot)
                self._change_log.append(int(slot))
                removed += 1
            self._count -= removed
            self._trim_change_log()
            return removed

    def metadata_of_slot(self, slot: int) -> Optional[dict]:
        return self._metadata[slot]

    def vector_of_slot(self, slot: int) -> np.ndarray:
        return self._np_vectors[slot]

    def snapshot(self):
        """(ids, vectors f32[n,d], metadata) of live rows, slot-ordered —
        the persistence source of truth."""
        with self._lock:
            live = np.flatnonzero(self._np_valid)
            ids = [self._ids[s] for s in live]
            mds = [self._metadata[s] for s in live]
            return ids, self._np_vectors[live].copy(), mds

    def live_slots(self) -> np.ndarray:
        """Slots of live rows in snapshot order (topology sidecar remap)."""
        with self._lock:
            return np.flatnonzero(self._np_valid)

    # ----------------------------------------------------------- change feed

    def _log_changes(self, slots) -> None:
        self._change_log.extend(int(s) for s in slots)
        self._trim_change_log()

    def _trim_change_log(self) -> None:
        # replaying more rows than the capacity is worse than a full
        # resync — overflow bumps the epoch so lagging consumers resync
        if len(self._change_log) > self.capacity:
            self._change_epoch += 1
            self._change_log.clear()

    def changes_since(self, cursor):
        """Incremental change feed for device-state consumers.

        ``cursor`` is an opaque token from a previous call (or None). Returns
        ``(new_cursor, slots)`` where ``slots`` is a unique np.int64 array of
        mutated slots since the cursor — or ``None`` when incremental replay
        is impossible (first call, capacity growth, or log overflow) and the
        consumer must resync its full view.
        """
        with self._lock:
            new_cursor = (self._change_epoch, len(self._change_log))
            if cursor is None or cursor[0] != self._change_epoch:
                return new_cursor, None
            slots = self._change_log[cursor[1]:]
            return new_cursor, np.unique(np.asarray(slots, np.int64))

    def read_rows(self, slots: np.ndarray):
        """(vectors f32[m, d], valid bool[m]) copies for the given slots —
        a consistent host read for incremental device scatters."""
        with self._lock:
            return self._np_vectors[slots].copy(), self._np_valid[slots].copy()

    # ---------------------------------------------------------------- device

    def sync_stream(self) -> Optional[torch.cuda.Stream]:
        """The stream every device sync is issued on (CUDA: the device's
        default stream; None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.default_stream(self.device)

    def device_view(self) -> StoreDeviceView:
        """Sync pending mutations to the device and return the view, ready
        to read on the caller's current stream."""
        with self._lock:
            sync = self.sync_stream()
            if sync is None:
                return self._sync()
            with torch.cuda.stream(sync):
                view = self._sync()
            cur = torch.cuda.current_stream(self.device)
            if cur != sync:
                cur.wait_stream(sync)
                for t in (view.vectors, view.valid, view.norms_sq, view.inv_norms):
                    t.record_stream(cur)
            return view

    def _sync(self) -> StoreDeviceView:
        if self._device is None or self._full_resync:
            vecs = torch.from_numpy(self._np_vectors).to(self.device, copy=True)
            valid = torch.from_numpy(self._np_valid).to(self.device, copy=True)
            ns = norms_sq(vecs)
            self._generation += 1
            self._device = StoreDeviceView(
                vecs, valid, ns, inv_norms(ns), self.capacity, self._generation
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
            self._generation += 1
            self._device = StoreDeviceView(
                view.vectors, view.valid, view.norms_sq, view.inv_norms,
                self.capacity, self._generation,
            )
            self._pending_slots.clear()
        return self._device
