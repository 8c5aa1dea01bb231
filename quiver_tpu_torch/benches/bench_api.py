"""HTTP serving-path load test of the port on one CUDA card
(``benches/bench_api.py``).

    python -m quiver_tpu_torch.benches.bench_api

The port's aiohttp ``Server`` runs in-process on loopback over a ``DB``
collection of the headline corpus (1M x 128-d clustered, L2), served by an
IVF engine at the reference bench's config (``n_clusters=1024``,
``n_probe=3``, ``rescore=False``; the DB's compute dtype, f32, so f32
blocks and ``block_topw_f32``), its topology from the headline bench's
build cache (``quiver_tpu_torch.bench``). ``C`` concurrent aiohttp clients
on the same event loop issue single-search POSTs. Rounds, each of
``REQUESTS`` searches after a warm round:

* the coalesce window in {0, 1, 2, 5} ms at 64 clients;
* 16, 64 and 256 clients at the default window (2 ms);
* 256 clients with the search backlog off and at 128 (the load-shed axis).

Each round emits QPS (completed searches over the round's wall), the
admitted requests' p50/p95/p99, the 429s (``shed_429``) and the shed rate
(429s over attempts), the requests given up after ``MAX_RETRIES`` refusals
and the mean batch the coalescer dispatched, with the card's name and power
limit. Without CUDA it exits non-zero before printing a result.

A refused client waits the server's ``Retry-After`` (capped at 1 s for
the bench's wall, as in the reference) and retries, at most
``MAX_RETRIES`` times. The reference's client (``bench_api.py:56``) parses
only the delta-seconds form, so an HTTP-date raises, and retries without a
cap; :func:`retry_after_s` reads both forms (RFC 9110, section 10.2.3).
Not ported: the ``QUIVER_BENCH_API_*`` overrides (the server binds a free
port; ``run_async`` takes the sizes).
"""

from __future__ import annotations

import asyncio
import email.utils
import socket
import time
from datetime import timezone
from typing import Optional

import numpy as np

from quiver_tpu_torch.benches.common import K, N, card, clustered, emit, require_cuda

REQUESTS = 2000
WINDOWS_MS = (0.0, 1.0, 2.0, 5.0)
CONCURRENCY = (16, 64, 256)
BACKLOGS = (0, 128)
#: refusals of one request before the client gives it up
MAX_RETRIES = 20
#: the reference bench's engine (``bench_api.py:96-103``)
ENGINE_CONFIG = {"n_clusters": 1024, "n_probe": 3, "q_cap_factor": 2, "kmeans_iters": 8,
                 "build_threshold": 1024, "rescore": False}


def retry_after_s(value: Optional[str], now: Optional[float] = None) -> float:
    """Seconds a ``Retry-After`` header asks to wait: delta-seconds or an
    HTTP-date; 1 s when it is absent or unreadable, never negative."""
    if value is None:
        return 1.0
    value = value.strip()
    if value.isdigit():
        return float(value)
    try:
        when = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return 1.0
    if when.tzinfo is None:  # an HTTP-date is GMT
        when = when.replace(tzinfo=timezone.utc)
    return max(0.0, when.timestamp() - (time.time() if now is None else now))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def load_round(url, payloads, concurrency, n_requests, *, max_retries=MAX_RETRIES):
    """``n_requests`` single-search POSTs from ``concurrency`` clients, one
    outstanding request each. A 429 is honoured (wait, retry the same
    request) up to ``max_retries`` times. Returns QPS over completed
    searches, the admitted requests' latency percentiles, the 429 count
    and the requests given up."""
    import aiohttp

    lat, shed, gave_up = [], 0, 0
    nxt = 0

    async def worker(session):
        nonlocal nxt, shed, gave_up
        while nxt < n_requests:
            payload = payloads[nxt % len(payloads)]
            nxt += 1
            for _ in range(max_retries + 1):
                t0 = time.perf_counter()
                async with session.post(url, json=payload) as r:
                    if r.status == 429:
                        shed += 1
                        wait = retry_after_s(r.headers.get("Retry-After"))
                        await r.read()
                        await asyncio.sleep(min(wait, 1.0))
                        continue
                    if r.status != 200:
                        raise RuntimeError(f"search answered {r.status}: {await r.text()}")
                    await r.json()
                lat.append((time.perf_counter() - t0) * 1e3)
                break
            else:
                gave_up += 1

    conn = aiohttp.TCPConnector(limit=concurrency)
    async with aiohttp.ClientSession(connector=conn) as session:
        t0 = time.perf_counter()
        await asyncio.gather(*(worker(session) for _ in range(concurrency)))
        wall = time.perf_counter() - t0
    lat.sort()
    n = len(lat)
    return {
        "qps": n / wall,
        "p50_ms": lat[n // 2] if n else float("nan"),
        "p95_ms": lat[min(n - 1, int(0.95 * n))] if n else float("nan"),
        "p99_ms": lat[min(n - 1, int(0.99 * n))] if n else float("nan"),
        "completed": n,
        "shed": shed,
        "gave_up": gave_up,
    }


def build_db(device, vecs, *, n_clusters=1024, cache=None):
    """A ``DB`` (persistence off) with collection "api": ``vecs`` loaded as
    the database loads a persisted collection, the IVF topology from
    ``cache`` (or built, and cached)."""
    from quiver_tpu_torch import DB, DBOptions
    from quiver_tpu_torch.bench import save_cache
    from quiver_tpu_torch.benches.bench_latency import load_serving_rows

    db = DB(DBOptions(enable_persistence=False, default_engine="ivf", device=str(device),
                      engine_config=dict(ENGINE_CONFIG, n_clusters=n_clusters)))
    coll = db.create_collection("api", vecs.shape[1], "euclidean")
    load_serving_rows(coll, vecs, cache=cache)
    if cache is not None and not cache.exists():
        save_cache(coll.engine, cache)
    return db


async def run_async(db, vecs, *, requests=REQUESTS, windows=WINDOWS_MS,
                    concurrency=CONCURRENCY, backlogs=BACKLOGS, shed_clients=256, warm=200,
                    seed=7, emit_rows=True) -> list[dict]:
    """The rounds of the module docstring over ``db``'s collection "api";
    returns the rows (and emits them)."""
    from quiver_tpu_torch.api.server import Server, ServerConfig

    coll = db.get_collection("api")
    dev = coll.store.device
    cuda = dev.type == "cuda"
    card_line = card() if cuda else None
    n = len(vecs)
    rng = np.random.default_rng(seed)
    queries = (vecs[rng.integers(0, n, 512)]
               + 0.1 * rng.normal(size=(512, vecs.shape[1]))).astype(np.float32)
    payloads = [{"vector": q.tolist(), "top_k": K} for q in queries]
    rounds = ([(w, 64, None) for w in windows]
              + [(None, c, None) for c in concurrency]
              + [(None, shed_clients, b) for b in backlogs])
    rows = []
    for window, clients, backlog in rounds:
        cfg = dict(host="127.0.0.1", port=free_port(), enable_metrics_server=False)
        if window is not None:
            cfg["coalesce_window_ms"] = window
        if backlog is not None:
            cfg["search_backlog"] = backlog
        server = Server(db, ServerConfig(**cfg))
        url = f"http://127.0.0.1:{server.config.port}/api/v1/collections/api/search"
        await server.start_async()
        try:
            await load_round(url, payloads, min(16, clients), warm)
            co = server._coalescer
            before = (co.dispatches, co.dispatched) if co else (0, 0)
            st = await load_round(url, payloads, clients, requests)
            batches = (co.dispatches - before[0], co.dispatched - before[1]) if co else (0, 0)
        finally:
            await server.stop_listeners()  # the DB outlives this server
        c = server.config
        row = dict(
            metric=(f"api loopback search, coalesce={c.coalesce_window_ms}ms, {clients} clients, "
                    f"backlog={c.search_backlog or 'off'} ({n:,} x {vecs.shape[1]}-d IVF "
                    f"n_probe={coll.engine.config.n_probe}, {coll.engine._blocks_t.dtype})"
                    + ("" if cuda else ", CPU host clock (tests only)")),
            value=st["qps"], unit="qps",
            p50_ms=round(st["p50_ms"], 3), p95_ms=round(st["p95_ms"], 3),
            p99_ms=round(st["p99_ms"], 3), requests=requests, completed=st["completed"],
            shed_429=st["shed"], shed_rate=round(st["shed"] / (st["shed"] + requests), 4),
            gave_up=st["gave_up"],
            mean_dispatch_batch=round(batches[1] / batches[0], 2) if batches[0] else None,
            backend=f"torch-{dev.type}", card=card_line,
        )
        rows.append(row)
        if emit_rows:
            emit(**row)
    return rows


def main() -> None:
    from quiver_tpu_torch.bench import N_CLUSTERS, cache_path

    dev = require_cuda("quiver_tpu_torch.benches.bench_api")
    vecs = clustered(N)
    db = build_db(dev, vecs, cache=cache_path(N, N_CLUSTERS))
    try:
        asyncio.run(run_async(db, vecs))
    finally:
        db.close()


if __name__ == "__main__":
    main()
