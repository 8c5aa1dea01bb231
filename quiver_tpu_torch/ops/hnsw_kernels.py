"""Batched HNSW programs: beam search, greedy descent, neighbour selection
and the level connect (PyTorch port of ``quiver_tpu/ops/hnsw_kernels.py``).

Queries are a leading batch dimension: each iteration of the beam expands
the ``expand`` nearest unexpanded beam entries of every query at once (a
gather of neighbour rows, one batched distance, a sorted merge into the
beam). Every function takes its device from its inputs. The reference's
are XLA programs (``lax.while_loop``, ``lax.scan``, ``lax.cond``), none of
them Pallas. On CUDA tensors :func:`beam_search` launches one hand-written
kernel (``ops/hnsw_cuda.py``, ``csrc/hnsw_beam.cu``: a CTA per query, each
looping on the card until it is done); on CPU tensors it runs the plain
version :func:`_beam_rows`, which the kernel computes step for step.
:func:`descend` likewise launches one kernel on CUDA tensors (a warp per
query, walking every upper layer on the card) and runs its plain version
:func:`_descend_chain`, a chain of :func:`greedy_descent` calls, on CPU
tensors. The other programs run as torch ops on either device.

What changes against the reference, each with the lines it replaces:

* the bitonic networks (``_compare_exchange``, ``bitonic_merge``,
  ``bitonic_sort``, ``:44-93``) exist because ``lax.top_k`` is a full sort
  on a TPU; the beam merges its candidate block with one
  ``torch.sort(stable=True)`` over the concatenation, carrying ids and
  expanded flags (``:278-284``). Ties between equal distances may come out
  in another order;
* ``lax.top_k``'s ordering of ties (``:529``, ``:563``, ``:568``) is
  reproduced by ``torch.sort(stable=True)``: the lower index first;
* the ``lax.while_loop`` conditions (``:189-191``, ``:315-317``) cost a
  host read in torch, so the loops test them every
  :data:`BEAM_CHECK_EVERY` / :data:`DESCENT_CHECK_EVERY` iterations: an
  iteration after a query is done leaves its beam as it is, so the results
  are the same (the kernels test each query every iteration, on the
  card);
* the ``.at[...].set/add(mode="drop")`` writes of :func:`connect_level`
  aim dropped writes at one scratch row past the end, sliced off
  afterwards; nothing reads it, so the order of the writes that land there
  does not matter;
* the ``lax.cond`` that skips empty overflow chunks (``:446-451``) becomes
  one host read of the overflow-row count per call and a loop over only
  the live chunks;
* :func:`connect_level` drops a reverse edge whose source the target row
  already holds, where the reference appends it into a row with room (an
  id twice in one row; see its docstring);
* the visited bitmap is ``int32`` words (torch's ``uint32`` lacks most
  ops); the bit of a discovered node is added once, while it is clear, so
  the add is an OR, as in the reference (``:249-261``).

The sizes that change results are kept exactly: ``block``, ``beam_len``,
``ring_len`` and the ring's write offset (``:141-158``, ``:268``),
``e_budget`` and the overflow numbering of :func:`connect_level`.
"""

from __future__ import annotations

import torch

from quiver_tpu_torch.ops import hnsw_cuda
from quiver_tpu_torch.ops.distance import inv_norms, norms_sq
from quiver_tpu_torch.ops.scan import MASKED_DIST, require_ieee_f32
from quiver_tpu_torch.types import DistanceType

#: bytes of per-iteration temporaries one beam chunk may hold (the gather
#: [b, block, d] f32 and the [b, block, ring] / [b, block, beam] compares;
#: on CUDA, the bitsets of one launch of the kernel)
BEAM_CHUNK_BYTES = 1 << 30
#: iterations between the host reads of "every query done" (beam) and
#: "no query moved" (greedy descent)
BEAM_CHECK_EVERY, DESCENT_CHECK_EVERY = 8, 4
#: a greedy walk's step cap on one layer (the reference's ``max_iters``)
DESCENT_MAX_ITERS = 32


def _rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x`` as f32 values of ``compute_dtype`` (bf16 products of such
    values are exact in f32, as the reference's bf16 matmul with f32
    accumulation)."""
    x = x.float()
    if compute_dtype == torch.float32:
        return x
    return x.to(compute_dtype).float()


def _from_dots(dots, q_ns, v_ns, metric):
    """The reference's ``pairwise_distance`` (``distance.py``) from the
    products: ``q_ns`` broadcasts against ``v_ns``."""
    if metric == DistanceType.DOT_PRODUCT:
        return 1.0 - dots
    if metric == DistanceType.COSINE:
        sim = torch.clamp(dots * inv_norms(q_ns) * inv_norms(v_ns), -1.0, 1.0)
        return 1.0 - sim
    d2 = torch.clamp(q_ns + v_ns - 2.0 * dots, min=0.0)
    if metric == DistanceType.SQUARED_EUCLIDEAN:
        return d2
    return torch.sqrt(d2)


def _batched_distance(q, vecs, metric, compute_dtype=torch.float32):
    """q f32[B, d] vs vecs [B, K, d] -> f32[B, K] (``:35-41``): one
    batched matmul, the metric of ``pairwise_distance``; norms from the f32
    values, products from the ``compute_dtype``-rounded ones."""
    metric = DistanceType.parse(metric)
    q = q.float()
    vecs = vecs.float()
    if metric == DistanceType.MANHATTAN:
        return (q[:, None, :] - vecs).abs().sum(-1)
    if compute_dtype == torch.float32:
        require_ieee_f32()
    dots = torch.bmm(_rounded(vecs, compute_dtype), _rounded(q, compute_dtype)[:, :, None])[..., 0]
    return _from_dots(dots, norms_sq(q)[:, None], norms_sq(vecs), metric)


def _self_distance(v, metric, compute_dtype=torch.float32):
    """v [B, C, d] -> f32[B, C, C] pairwise distances within each row
    (the reference's vmapped ``pairwise_distance(v, v)``, ``:536-538``)."""
    v = v.float()
    if metric == DistanceType.MANHATTAN:
        return torch.cdist(v, v, p=1.0)
    if compute_dtype == torch.float32:
        require_ieee_f32()
    r = _rounded(v, compute_dtype)
    ns = norms_sq(v)
    return _from_dots(torch.bmm(r, r.transpose(1, 2)), ns[:, :, None], ns[:, None, :], metric)


def pairwise_block(q, v, metric, compute_dtype=torch.float32):
    """f32[B, N] distances with the reference's ``compute_dtype``
    (``distance.py::pairwise_distance``): the bootstrap's exact kNN."""
    metric = DistanceType.parse(metric)
    q = q.float()
    v = v.float()
    if metric == DistanceType.MANHATTAN:
        return torch.cdist(q, v, p=1.0)
    if compute_dtype == torch.float32:
        require_ieee_f32()
    dots = _rounded(q, compute_dtype) @ _rounded(v, compute_dtype).T
    return _from_dots(dots, norms_sq(q)[:, None], norms_sq(v)[None, :], metric)


def beam_sizes(ef: int, deg: int, expand: int) -> tuple[int, int, int, int]:
    """(block, pad_cols, beam_len, ring_len) exactly as the reference
    computes them (``:141-158``): the candidate block padded to a power of
    two, the beam as the rest of the next power of two above ef + block,
    the ring a multiple of the block."""
    block = deg * expand
    while block & (block - 1):
        block += 1
    total = 1
    while total < ef + block:
        total *= 2
    return block, block - deg * expand, total - block, -(-max(2 * ef, 128) // block) * block


def beam_search(
    queries: torch.Tensor,  # f32[B, d]
    entries: torch.Tensor,  # i64[B] start nodes (global slots)
    vectors: torch.Tensor,  # f32[cap, d]
    valid: torch.Tensor,  # bool[cap] live-slot mask
    adj: torch.Tensor,  # i32[rows, deg] adjacency (global slot ids, -1 pad)
    pos_map: torch.Tensor,  # i64[cap] global slot -> adj row (-1 absent)
    *,
    metric,
    ef: int,
    max_iters: int,
    compute_dtype=torch.float32,
    expand: int = 4,
    visited: str = "ring",
    stats: dict | None = None,
):
    """Batched best-first beam search over one graph layer (``:102-290``).

    ``visited`` is ``"ring"`` (a rolling window of recently visited ids;
    a node evicted from both beam and ring can be expanded again) or
    ``"bitmap"`` (a per-query bitset over the capacity: discovery sets
    the bit, so no node is expanded twice).

    The path follows the inputs' device alone. CUDA tensors launch the
    hand-written kernel (``ops/hnsw_cuda.py``), which raises a
    ``ValueError`` where a size is past its limits (shared memory a query,
    a capacity of 2**31 or more). CPU tensors run :func:`_beam_rows` in row
    chunks, as many rows as :data:`BEAM_CHUNK_BYTES` of temporaries allow;
    each query's result does not depend on its chunk.

    ``stats``, when given, receives ``"iters"`` (i64[B], the iterations in
    which each query was active), ``"accepted"`` (i64[B], the candidates
    that passed the visited test, whose distances each query computed) and
    ``"loops"``: on CUDA the longest query's loop iterations, the one that
    found it done included (read back at the end, so the call waits for
    the card); on the CPU the loop iterations run, summed over chunks.

    Returns (dist f32[B, ef], ids i64[B, ef]) sorted ascending; empty
    entries have id -1 and dist MASKED_DIST.
    """
    if visited not in ("ring", "bitmap"):
        raise ValueError(f"visited must be 'ring' or 'bitmap', got {visited!r}")
    metric = DistanceType.parse(metric)
    B, d = queries.shape
    cap = vectors.shape[0]
    deg = adj.shape[1]
    block, pad_cols, beam_len, ring_len = beam_sizes(ef, deg, expand)
    if queries.device.type == "cuda":
        return hnsw_cuda.beam_search(
            queries, entries, vectors, valid, adj, pos_map, metric=metric, ef=ef,
            max_iters=max_iters, compute_dtype=compute_dtype, expand=expand,
            bitmap=visited == "bitmap", sizes=(block, pad_cols, beam_len, ring_len),
            chunk_bytes=BEAM_CHUNK_BYTES, stats=stats)
    per_query = block * (4 * d + ring_len + beam_len + block)
    if visited == "bitmap":
        per_query += 4 * ((cap + 31) // 32)
    chunk = max(1, BEAM_CHUNK_BYTES // per_query)
    kw = dict(metric=metric, ef=ef, max_iters=max_iters, compute_dtype=compute_dtype,
              expand=expand, bitmap=visited == "bitmap",
              sizes=(block, pad_cols, beam_len, ring_len))
    outs = [
        _beam_rows(queries[lo:lo + chunk], entries[lo:lo + chunk], vectors, valid, adj,
                   pos_map, stats=stats, **kw)
        for lo in range(0, B, chunk)
    ]
    if stats is not None:
        for key in ("iters", "accepted"):
            parts = stats.pop("_" + key)
            stats[key] = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _beam_rows(queries, entries, vectors, valid, adj, pos_map, *, metric, ef, max_iters,
               compute_dtype, expand, bitmap, sizes, stats):
    """:func:`beam_search` over one chunk of rows: the plain version, which
    ``csrc/hnsw_beam.cu`` computes step for step on the card and the card
    tests hold it to."""
    dev = queries.device
    B = queries.shape[0]
    cap = vectors.shape[0]
    deg = adj.shape[1]
    block, pad_cols, beam_len, ring_len = sizes
    entries = entries.long()
    rows_b = torch.arange(B, device=dev)

    # initial beam: the entry point, then MASKED fill (:160-187)
    e_c = entries.clamp_min(0)
    e_valid = (entries >= 0) & valid[e_c]
    e_dist = _batched_distance(queries, vectors[e_c][:, None, :], metric, compute_dtype)[:, 0]
    bd = torch.full((B, beam_len), MASKED_DIST, device=dev)
    bd[:, 0] = torch.where(e_valid, e_dist, MASKED_DIST)
    bi = torch.full((B, beam_len), -1, dtype=torch.int64, device=dev)
    bi[:, 0] = torch.where(e_valid, entries, -1)
    bexp = torch.zeros((B, beam_len), dtype=torch.bool, device=dev)
    if bitmap:
        ring = torch.zeros((B, (cap + 31) // 32), dtype=torch.int32, device=dev)
        e0 = bi[:, 0].clamp_min(0)
        ring[rows_b, e0 >> 5] = torch.where(
            bi[:, 0] >= 0, torch.bitwise_left_shift(torch.ones_like(e0), e0 & 31), 0
        ).to(torch.int32)
    else:
        ring = torch.full((B, ring_len), -1, dtype=torch.int64, device=dev)
        ring[:, 0] = bi[:, 0]
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev) if stats is not None else None
    accepted = torch.zeros_like(iters) if stats is not None else None
    kk_t = min(ef, beam_len)
    later = torch.ones(block, block, dtype=torch.bool, device=dev).tril(-1)  # col < row

    loops = 0
    for i in range(max_iters):
        if i % BEAM_CHECK_EVERY == 0 and bool(done.all()):
            break
        loops += 1
        # 1. the `expand` nearest unexpanded entries; termination reads
        # beam column ef-1 (:199-216)
        unexp = ~bexp & (bi >= 0)
        rank = torch.cumsum(unexp, dim=1) - 1
        sel = unexp & (rank < expand)
        cur_d0 = torch.where(unexp, bd, MASKED_DIST).amin(dim=1)
        newly_done = (cur_d0 >= MASKED_DIST) | ((bi[:, kk_t - 1] >= 0) & (cur_d0 > bd[:, kk_t - 1]))
        done = done | newly_done
        active = ~done
        if iters is not None:
            iters += active

        # 2. mark them expanded; their ids as a dense [B, expand], column
        # `expand` a scratch column for the unselected positions (:218-228)
        bexp = bexp | (sel & active[:, None])
        curs = torch.full((B, expand + 1), -1, dtype=torch.int64, device=dev)
        curs.scatter_(1, torch.where(sel, rank, expand), torch.where(sel, bi, -1))
        curs = curs[:, :expand]

        # 3. neighbour rows of the expanded entries (:230-240)
        rows = pos_map[curs.clamp_min(0)]
        rows_ok = (curs >= 0) & (rows >= 0) & active[:, None]
        nbrs = adj[rows.clamp_min(0)].long()
        nbrs = torch.where(rows_ok[:, :, None], nbrs, -1).reshape(B, deg * expand)
        if pad_cols:
            nbrs = torch.cat([nbrs, nbrs.new_full((B, pad_cols), -1)], dim=1)
        n_c = nbrs.clamp_min(0)
        ok = (nbrs >= 0) & valid[n_c]

        # 4. drop repeats within the block, then the visited (:242-271)
        dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & later).any(dim=2)
        if bitmap:
            w_idx = n_c >> 5
            bit = torch.bitwise_left_shift(torch.ones_like(n_c), n_c & 31).to(torch.int32)
            seen = (torch.gather(ring, 1, w_idx) & bit) != 0
            ok = ok & ~dup & ~seen
            ring.scatter_add_(1, w_idx, torch.where(ok, bit, 0))
        else:
            in_beam = (nbrs[:, :, None] == bi[:, None, :]).any(dim=2)
            in_ring = (nbrs[:, :, None] == ring[:, None, :]).any(dim=2)
            ok = ok & ~dup & ~in_beam & ~in_ring
            offset = (i * block) % ring_len
            ring[:, offset:offset + block] = torch.where(ok, nbrs, -1)

        # 6. distances to the gathered neighbours (:273-276)
        n_dist = _batched_distance(queries, vectors[n_c], metric, compute_dtype)
        n_dist = torch.where(ok, n_dist, MASKED_DIST)
        if accepted is not None:
            accepted += ok.sum(1)

        # 7. merge into the sorted beam (:278-284): one stable sort
        md, order = torch.sort(torch.cat([bd, n_dist], dim=1), dim=1, stable=True)
        order = order[:, :beam_len]
        bd = md[:, :beam_len]
        bi = torch.where(bd >= MASKED_DIST, -1, torch.gather(torch.cat([bi, nbrs], dim=1), 1, order))
        bexp = torch.gather(torch.cat([bexp, torch.zeros_like(ok)], dim=1), 1, order)
    if stats is not None:
        stats["loops"] = stats.get("loops", 0) + loops
        stats.setdefault("_iters", []).append(iters)
        stats.setdefault("_accepted", []).append(accepted)
    return bd[:, :ef], bi[:, :ef]


def greedy_descent(
    queries: torch.Tensor,  # f32[B, d]
    entries: torch.Tensor,  # i64[B]
    vectors: torch.Tensor,
    valid: torch.Tensor,
    adj: torch.Tensor,  # i32[rows, deg] layer adjacency
    pos_map: torch.Tensor,  # i64[cap]
    *,
    metric,
    max_iters: int = DESCENT_MAX_ITERS,
    compute_dtype=torch.float32,
    steps: torch.Tensor | None = None,
):
    """Batched ef=1 greedy walk on one upper layer (``:294-338``). Returns
    (dist f32[B], ids i64[B]) of the local minimum. A query that stopped
    moving stays where it is, so the ``any(moved)`` test runs every
    :data:`DESCENT_CHECK_EVERY` iterations. ``steps`` (i64[B]), when given,
    gains each query's steps: the iterations it began still moving, the one
    that found no better neighbour included."""
    metric = DistanceType.parse(metric)
    entries = entries.long()
    e_c = entries.clamp_min(0)
    e_ok = (entries >= 0) & valid[e_c]
    e_dist = _batched_distance(queries, vectors[e_c][:, None, :], metric, compute_dtype)[:, 0]
    cd = torch.where(e_ok, e_dist, MASKED_DIST)
    ci = torch.where(e_ok, entries, -1)
    moved = torch.ones(queries.shape[0], dtype=torch.bool, device=queries.device)
    for i in range(max_iters):
        if i % DESCENT_CHECK_EVERY == 0 and not bool(moved.any()):
            break
        if steps is not None:
            steps += moved
        row = pos_map[ci.clamp_min(0)]
        nbrs = adj[row.clamp_min(0)].long()
        n_c = nbrs.clamp_min(0)
        ok = (row >= 0)[:, None] & (nbrs >= 0) & valid[n_c] & moved[:, None]
        n_dist = _batched_distance(queries, vectors[n_c], metric, compute_dtype)
        n_dist = torch.where(ok, n_dist, MASKED_DIST)
        best_d, best = n_dist.min(dim=1)
        best_i = torch.gather(nbrs, 1, best[:, None])[:, 0]
        moved = best_d < cd
        cd = torch.where(moved, best_d, cd)
        ci = torch.where(moved, best_i, ci)
    return cd, ci


def descend(queries, entries, vectors, valid, layers, *, metric, compute_dtype=torch.float32,
            stats: dict | None = None):
    """The search's way down: :func:`greedy_descent` from ``entries``
    (i64[B]) over each upper layer of ``layers`` ((adj, pos_map) pairs, top
    first), each from where the one above stopped. Returns the layer-0
    entries.

    The path follows the inputs' device alone. CUDA tensors launch the
    hand-written kernel (``ops/hnsw_cuda.py``: every layer in one launch,
    no host read), which raises a ``ValueError`` where a size is past its
    limits; CPU tensors run its plain version :func:`_descend_chain`, which
    the kernel computes step for step. ``stats``, when given, receives
    ``"descent_steps"`` (i64[B], on the inputs' device): each query's steps
    summed over the layers, the step that found no better neighbour
    included."""
    metric = DistanceType.parse(metric)
    run = hnsw_cuda.descend if queries.device.type == "cuda" and layers else _descend_chain
    _, entries = run(queries, entries, vectors, valid, layers, metric=metric,
                     compute_dtype=compute_dtype, max_iters=DESCENT_MAX_ITERS, stats=stats)
    return entries


def _descend_chain(queries, entries, vectors, valid, layers, *, metric, compute_dtype,
                   max_iters=DESCENT_MAX_ITERS, stats=None):
    """The descent kernel's plain version, on either device and with its
    arguments (``hnsw_cuda.descend``): :func:`greedy_descent` over each of
    ``layers`` in turn. Returns (dist f32[B], ids i64[B]) of the last
    layer's local minimum, dist None where ``layers`` is empty; ``stats``
    receives ``"descent_steps"`` as the kernel's does."""
    steps = None
    if stats is not None:
        steps = torch.zeros(queries.shape[0], dtype=torch.int64, device=queries.device)
        stats["descent_steps"] = steps
    dist = None
    for adj, pos_map in layers:
        dist, entries = greedy_descent(queries, entries, vectors, valid, adj, pos_map,
                                       metric=metric, max_iters=max_iters,
                                       compute_dtype=compute_dtype, steps=steps)
    return dist, entries


def beam_max_iters(ef: int) -> int:
    """The layer-0 beam's iteration cap at ``ef`` (the reference's
    ``max_iters``, ``quiver_tpu/index/hnsw.py:901``)."""
    return int(1.5 * ef) + 8


def connect_level(
    adj: torch.Tensor,  # i32[rows, deg] layer adjacency
    fill: torch.Tensor,  # i32[rows] live-edge counts
    pos_map: torch.Tensor,  # i64[cap]
    vectors: torch.Tensor,  # f32[cap, d]
    slots: torch.Tensor,  # i64[B] new node slots (-1 pad)
    connect: torch.Tensor,  # bool[B] node connects at this level
    sel: torch.Tensor,  # i64[B, deg] selected forward neighbours (-1 pad)
    *,
    metric,
    u_budget: int,
    e_budget: int,
    compute_dtype=torch.float32,
    keep_pruned: bool = True,
):
    """One layer's mutation for one insert batch (``:341-491``): the
    forward rows, the reverse edges grouped by target row (appended where
    the row has room), and the rows that overflow re-selected over (their
    row + the appended sources) in chunks of ``u_budget`` rows. A row keeps
    at most ``e_budget`` appended sources per call; the rest are counted as
    spilled.

    One change: a reverse edge whose source the target row already holds
    (new A selects new B and B selects A) is dropped before the grouping.
    The reference drops it only in an overflowing row (``:459-464``); into
    a row with room it appends the id a second time, which small upper
    layers hit (ROADMAP.md section 3). Where no such pair occurs, the
    result is the reference's.

    ``adj`` and ``fill`` are not written: the result is new tensors, so
    the changed-row mask compares against the old adjacency as the
    reference's does on its donated input (``index/hnsw.py:164-167``).
    Returns (adj', fill', spilled i64[] on the device, changed bool[rows])."""
    metric = DistanceType.parse(metric)
    rows_cap, deg = adj.shape
    B = slots.shape[0]
    dev = adj.device
    slots = slots.long()
    sel = sel.long()
    # one scratch row at index rows_cap takes every dropped write
    new_adj = torch.cat([adj, adj.new_full((1, deg), -1)])
    new_fill = torch.cat([fill, fill.new_zeros(1)])

    def drop(idx, keep):
        return torch.where(keep & (idx >= 0) & (idx < rows_cap), idx, rows_cap)

    # ---- forward rows
    row_of_new = drop(pos_map[slots.clamp_min(0)], connect & (slots >= 0))
    new_adj[row_of_new] = sel.to(adj.dtype)
    new_fill[row_of_new] = (sel >= 0).sum(dim=1).to(fill.dtype)

    # ---- reverse edges, grouped by target row (a stable sort)
    tgt = sel.reshape(-1)
    src = slots.repeat_interleave(deg)
    ok = connect.repeat_interleave(deg) & (tgt >= 0) & (src >= 0)
    row = drop(pos_map[tgt.clamp_min(0)], ok)
    # a source the target row already holds (a mutual pair of batch-mates)
    # is not appended again; the reference appends it into a row with room
    held = (row < rows_cap) & (new_adj[row.clamp_max(rows_cap - 1)] == src[:, None]).any(dim=1)
    row = torch.where(held, rows_cap, row)
    order = torch.argsort(row, stable=True)
    srow, ssrc, stgt = row[order], src[order], tgt[order]
    sok = srow < rows_cap
    E = srow.shape[0]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), srow[1:] != srow[:-1]])
    pos_e = torch.arange(E, device=dev)
    rank = pos_e - torch.cummax(torch.where(is_start, pos_e, 0), dim=0).values
    col = new_fill[srow.clamp_max(rows_cap - 1)].long() + rank
    fits = sok & (col < deg)
    new_adj[drop(srow, fits), torch.where(fits, col, 0)] = ssrc.to(adj.dtype)
    new_fill.index_put_((drop(srow, fits),), torch.ones_like(srow, dtype=fill.dtype),
                        accumulate=True)

    # ---- overflow rows: numbered in sort order, processed in chunks
    over = sok & ~fits
    orank = col - deg
    first_over = over & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                   ~over[:-1] | is_start[1:]])
    n_chunks = max(1, -(-(B * deg) // u_budget))
    U = n_chunks * u_budget
    ouidx = torch.cumsum(first_over, dim=0) - 1
    keep_e = over & (orank < e_budget)
    extras = torch.full((U + 1, e_budget), -1, dtype=torch.int64, device=dev)
    extras[torch.where(keep_e, ouidx, U), torch.where(keep_e, orank, 0)] = ssrc
    head = torch.where(first_over, ouidx, U)
    orows = torch.full((U + 1,), rows_cap, dtype=torch.int64, device=dev)
    orows[head] = srow
    otgts = torch.full((U + 1,), -1, dtype=torch.int64, device=dev)
    otgts[head] = stgt
    n_over = int(first_over.sum())  # the one host read: live chunks only
    for lo in range(0, -(-n_over // u_budget) * u_budget, u_budget):
        orows_c = orows[lo:lo + u_budget]
        extras_c = extras[lo:lo + u_budget]
        live_o = orows_c < rows_cap
        cur = new_adj[orows_c.clamp_max(rows_cap - 1)].long()
        # a mutual pair would repeat an id already in the row: drop it
        dup = (extras_c[:, :, None] == cur[:, None, :]).any(dim=2) & (extras_c >= 0)
        c_ids = torch.cat([cur, torch.where(dup, -1, extras_c)], dim=1)
        c_ids = torch.where(live_o[:, None], c_ids, -1)
        q_vecs = vectors[otgts[lo:lo + u_budget].clamp_min(0)].float()
        c_d = _batched_distance(q_vecs, vectors[c_ids.clamp_min(0)], metric, compute_dtype)
        c_d = torch.where(c_ids >= 0, c_d, MASKED_DIST)
        sel_o, _ = select_neighbors(q_vecs, c_ids, c_d, vectors, metric=metric, m=deg,
                                    compute_dtype=compute_dtype, keep_pruned=keep_pruned)
        w = torch.where(live_o, orows_c, rows_cap)
        new_adj[w] = sel_o.to(adj.dtype)
        new_fill[w] = (sel_o >= 0).sum(dim=1).to(fill.dtype)

    new_adj, new_fill = new_adj[:rows_cap], new_fill[:rows_cap]
    spilled = (over & ~keep_e).sum()
    changed = (new_adj != adj).any(dim=1)
    return new_adj, new_fill, spilled, changed


def select_neighbors(
    query_vecs: torch.Tensor,  # f32[B, d] the points being connected (unused, as in the reference)
    cand_ids: torch.Tensor,  # i64[B, C] candidates (-1 pad)
    cand_dist: torch.Tensor,  # f32[B, C] distance(query, candidate)
    vectors: torch.Tensor,  # f32[cap, d]
    *,
    metric,
    m: int,
    compute_dtype=torch.float32,
    keep_pruned: bool = True,
):
    """Batched occlusion heuristic with pruned back-fill (``:496-576``).

    Over the candidates in ascending distance: accept c unless some
    accepted s has d(c, s) < d(c, query). With ``keep_pruned`` the
    remaining slots fill with the nearest rejected candidates. The
    reference's C-step ``lax.scan`` is a loop of C steps over [B, C]
    tensors; its ``lax.top_k`` tie order (the lower index first) is
    ``torch.sort(stable=True)``'s. Returns (ids i64[B, m], dist f32[B, m])
    with -1 padding."""
    metric = DistanceType.parse(metric)
    B, C = cand_ids.shape
    cand_ids = cand_ids.long()
    ok = cand_ids >= 0
    cand_dist, order = torch.sort(torch.where(ok, cand_dist, MASKED_DIST), dim=1, stable=True)
    cand_ids = torch.gather(cand_ids, 1, order)
    ok = cand_ids >= 0

    pair = _self_distance(vectors[cand_ids.clamp_min(0)], metric, compute_dtype)
    pair = torch.where(ok[:, :, None] & ok[:, None, :], pair, MASKED_DIST)
    # occluder[b, j, s]: s, once accepted, occludes candidate j
    occluder = pair < cand_dist[:, :, None]
    usable = ok & (cand_dist < MASKED_DIST)
    sel_mask = torch.zeros((B, C), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros(B, dtype=torch.int64, device=cand_ids.device)
    for j in range(C):
        occ = (sel_mask & occluder[:, j, :]).any(dim=1)
        accept = usable[:, j] & ~occ & (count < m)
        sel_mask[:, j] = accept
        count += accept

    kk = min(m, C)
    if keep_pruned:
        # the offset puts pruned candidates after every selected one and
        # keeps both groups in distance order (offset << MASKED_DIST)
        sel_d = torch.where(sel_mask, cand_dist, cand_dist + 1e30)
        sel_d = torch.where(usable, sel_d, MASKED_DIST)
        top, sel_order = torch.sort(sel_d, dim=1, stable=True)
        top, sel_order = top[:, :kk], sel_order[:, :kk]
        out_d = torch.where(top >= MASKED_DIST, MASKED_DIST, torch.gather(cand_dist, 1, sel_order))
    else:
        sel_d = torch.where(sel_mask, cand_dist, MASKED_DIST)
        out_d, sel_order = torch.sort(sel_d, dim=1, stable=True)
        out_d, sel_order = out_d[:, :kk], sel_order[:, :kk]
    out_i = torch.where(out_d >= MASKED_DIST, -1, torch.gather(cand_ids, 1, sel_order))
    if kk < m:
        out_d = torch.cat([out_d, out_d.new_full((B, m - kk), MASKED_DIST)], dim=1)
        out_i = torch.cat([out_i, out_i.new_full((B, m - kk), -1)], dim=1)
    return out_i, out_d
