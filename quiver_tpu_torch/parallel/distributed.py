"""The multi-process sharded scan over ``torch.distributed``: each rank owns
a contiguous run of the corpus's shards (on its own card, or on the CPU),
scans them as ``parallel/sharded.py`` does, and the ranks' ``[B, kk]``
results meet in one ``all_gather`` and a re-top-k. The counterpart of the
reference's multi-host claim (``quiver_tpu/parallel/sharded.py:14-15``:
the same program under ``jax.distributed.initialize``), tested by
``tests/torch_dcn_worker.py``.

The backend is gloo for CPU tensors and NCCL for CUDA tensors. NCCL
refuses two ranks on one GPU, so on one card only the in-process shard
list runs; this path needs a card per rank. Nothing here discovers a
cluster: :func:`init` takes the rendezvous address
(``tcp://localhost:<port>``), the world size and the rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from quiver_tpu_torch.core.store import resolve_device
from quiver_tpu_torch.parallel.sharded import merge_topk, sharded_scan_topk
from quiver_tpu_torch.types import DistanceType


def init(init_method: str, world_size: int, rank: int, device="cuda") -> None:
    """Join the process group: NCCL for a card (the default; with no card
    it raises, as ``core/store.py::resolve_device`` does), gloo for a rank
    that asks for the CPU."""
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def all_gather_topk(dist_loc: torch.Tensor, idx_loc: torch.Tensor, k: int, group=None):
    """Merge every rank's ascending ``[B, kk]`` (distance, global id) into
    the global top ``k``, the same on every rank: an ``all_gather`` of both
    tensors, then :func:`merge_topk` over the ranks in rank order (ties keep
    the lower rank first)."""
    n = dist.get_world_size(group)
    all_d = [torch.empty_like(dist_loc) for _ in range(n)]
    all_i = [torch.empty_like(idx_loc) for _ in range(n)]
    dist.all_gather(all_d, dist_loc.contiguous(), group=group)
    dist.all_gather(all_i, idx_loc.contiguous(), group=group)
    return merge_topk(all_d, all_i, k)


def dist_scan_topk(
    queries: torch.Tensor,
    shards: Sequence[tuple],
    first_row: int,
    *,
    metric: DistanceType | str,
    k: int,
    tile: int = 8192,
    mask: Optional[Sequence[torch.Tensor]] = None,
    group=None,
):
    """The exact scan over this rank's shards (``shards`` as in
    ``sharded_scan_topk``; ``first_row`` the global row of its first
    shard's first row), merged with every other rank's. Every rank passes
    the same queries and gets the same (dist f32[B, k], id i64[B, k])."""
    d_loc, i_loc = sharded_scan_topk(queries, shards, mask, metric=metric, k=k, tile=tile)
    i_loc = torch.where(i_loc >= 0, i_loc + first_row, -1)
    return all_gather_topk(d_loc, i_loc, k, group=group)
