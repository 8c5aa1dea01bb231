"""A plain HNSW search, one query at a time: the greedy walk through an
upper layer and the layer-0 beam, with the semantics the port documents
(``quiver_tpu_torch/ops/hnsw_kernels.py``), for tests that hold the
program's batched search to it on the same graph. Plain PyTorch in
float64; it imports nothing of the program.

A graph layer is given as the program stores it: ``adj`` int[rows, deg]
(global slot ids, -1 where a row has no edge there), ``pos_map`` int[cap]
(a slot's row, -1 where the slot is not in the layer), and ``valid``
bool[cap] (tombstoned slots are False).

Published HNSW (Malkov and Yashunin, TPAMI 2020, algorithms 2 and 5)
searches an upper layer greedily with ef=1 and layer 0 with a candidate
heap, a result heap of ef entries and a set of every visited node, taking
the one nearest candidate per step and stopping once it is farther than
the ef-th result. What the port does otherwise, and this reference with
it:

* the walk on an upper layer moves to the nearest valid neighbour while
  that is strictly closer, for at most ``max_steps`` (32) steps;
* the beam expands the ``expand`` (4) nearest unexpanded entries a step,
  not one; the neighbours of all of them form one block (``deg *
  expand`` ids padded with -1 to a power of two) whose repeats are dropped
  (the first place of an id is kept);
* candidates and results are one sorted beam of ``beam_len`` entries (ef
  and more, the rest of the next power of two above ef + block): a
  neighbour that does not fit is dropped, not kept for later; a merge
  keeps earlier entries before new ones at equal distance;
* the visited set is ``"ring"``, a rolling window of the ids seen in the
  last ``ring_len / block`` steps (the entry is its first; each step
  overwrites one block of it with the step's new ids), so a node evicted
  from both the beam and the ring can be taken again; or ``"bitmap"``,
  the published set;
* a neighbour is new when it is valid, not a repeat, not in the beam and
  not in the visited set (``"ring"``), or valid, not a repeat and not
  visited (``"bitmap"``);
* the search stops when no unexpanded entry is left, or the beam's ef-th
  place holds an entry and the nearest unexpanded entry is farther than
  it, or after ``max_iters`` steps (the engine's 1.5 ef + 8);
* tombstoned nodes are never walked through or returned (the paper has
  no deletes); the beam from an invalid entry gives an empty answer, and
  the walk starts from a valid one (the engine's entry point).

Distances are the program's metrics in float64: ``euclidean`` the square
root of the summed squared differences, ``cosine`` 1 - cos (1 where either
vector is zero). Empty places are id -1 and distance ``inf``.
"""

from __future__ import annotations

import math

import torch

INF = math.inf


def beam_sizes(ef: int, deg: int, expand: int) -> tuple[int, int, int]:
    """(block, beam_len, ring_len): the neighbour block padded to a power of
    two, the beam as the rest of the next power of two above ef + block,
    the ring a multiple of the block of at least max(2 ef, 128) ids."""
    block = 1 << max(deg * expand - 1, 0).bit_length()
    total = 1 << max(ef + block - 1, 0).bit_length()
    return block, total - block, -(-max(2 * ef, 128) // block) * block


def distance(q: torch.Tensor, v: torch.Tensor, metric: str) -> float:
    """The program's distance between two vectors, in float64."""
    q, v = q.double(), v.double()
    if metric == "euclidean":
        return float(((q - v) ** 2).sum().sqrt())
    if metric == "cosine":
        nq, nv = float(q.norm()), float(v.norm())
        if nq == 0.0 or nv == 0.0:
            return 1.0
        return 1.0 - max(-1.0, min(1.0, float(q @ v) / (nq * nv)))
    raise ValueError(f"unknown metric {metric!r}")


def neighbours(node: int, adj: torch.Tensor, pos_map: torch.Tensor) -> list:
    """The ids in ``node``'s row (-1 included), or none where the node is
    not in the layer."""
    row = int(pos_map[node])
    return [] if row < 0 else [int(x) for x in adj[row]]


def greedy(query, entry: int, vectors, valid, adj, pos_map, *, metric: str,
           max_steps: int = 32) -> tuple[float, int]:
    """(distance, id) where the walk from ``entry``, a valid node, stops on
    one layer."""
    if entry < 0 or not bool(valid[entry]):
        raise ValueError(f"the walk starts from a valid node, not {entry}")
    cur, cur_d = entry, distance(query, vectors[entry], metric)
    for _ in range(max_steps):
        best, best_d = -1, INF
        for x in neighbours(cur, adj, pos_map):
            if x >= 0 and bool(valid[x]):
                d = distance(query, vectors[x], metric)
                if d < best_d:
                    best, best_d = x, d
        if not best_d < cur_d:
            break
        cur, cur_d = best, best_d
    return cur_d, cur


def beam(query, entry: int, vectors, valid, adj, pos_map, *, metric: str, ef: int,
         max_iters: int, expand: int = 4, visited: str = "ring") -> tuple[list, list, int]:
    """(distances, ids, steps): the ef nearest entries the beam from
    ``entry`` ends with, nearest first, padded with (inf, -1), and the
    steps it took before it was done."""
    if visited not in ("ring", "bitmap"):
        raise ValueError(f"visited must be 'ring' or 'bitmap', got {visited!r}")
    deg = adj.shape[1]
    block, beam_len, ring_len = beam_sizes(ef, deg, expand)
    ok_entry = entry >= 0 and bool(valid[entry])
    # the beam: [distance, id, expanded], sorted by distance
    items = [[distance(query, vectors[entry], metric), entry, False]] if ok_entry else []
    seen = {entry} if ok_entry else set()  # the bitmap
    ring = [-1] * ring_len
    ring[0] = entry if ok_entry else -1
    steps = 0
    for i in range(max_iters):
        unexp = [it for it in items if not it[2]]
        full = len(items) >= ef
        if not unexp or (full and unexp[0][0] > items[ef - 1][0]):
            break
        steps += 1
        block_ids = []
        for it in unexp[:expand]:
            it[2] = True
            block_ids += neighbours(it[1], adj, pos_map) or [-1] * deg
        block_ids += [-1] * (block - len(block_ids))
        in_beam = {it[1] for it in items}
        in_ring = set(ring)
        new = []
        for j, x in enumerate(block_ids):
            ok = x >= 0 and bool(valid[x]) and x not in block_ids[:j]
            if visited == "bitmap":
                ok = ok and x not in seen
            else:
                ok = ok and x not in in_beam and x not in in_ring
            new.append(x if ok else -1)
        if visited == "bitmap":
            seen.update(x for x in new if x >= 0)
        else:
            off = (i * block) % ring_len
            ring[off:off + block] = new
        cands = [[distance(query, vectors[x], metric), x, False] for x in new if x >= 0]
        items = sorted(items + cands, key=lambda it: it[0])[:beam_len]
    out = items[:ef]
    dists = [it[0] for it in out] + [INF] * (ef - len(out))
    ids = [it[1] for it in out] + [-1] * (ef - len(out))
    return dists, ids, steps


def search(query, entry: int, upper: list, layer0: tuple, vectors, valid, *, metric: str,
           ef: int, k: int, expand: int = 4, visited: str = "ring") -> tuple[list, list]:
    """(distances, ids) of the k nearest a whole search returns: the walk
    from ``entry`` down the ``upper`` layers (top first, each ``(adj,
    pos_map)``), then the beam on ``layer0`` with ``max_iters`` 1.5 ef + 8."""
    for adj, pos_map in upper:
        _, entry = greedy(query, entry, vectors, valid, adj, pos_map, metric=metric)
    adj, pos_map = layer0
    d, i, _ = beam(query, entry, vectors, valid, adj, pos_map, metric=metric, ef=ef,
                   max_iters=int(1.5 * ef) + 8, expand=expand, visited=visited)
    return d[:k], i[:k]
