"""Where the server's time goes: one ``bench_api`` round (64 clients, the
default 2 ms window) over the 1M collection on one CUDA card, profiled.

    python -m quiver_tpu_torch.benches.profile_api

Runs of the same round, one JSON line each:

1. a stack sampler: every 1 ms a thread reads ``sys._current_frames()``
   and counts, per thread role (the event loop, the engine's worker
   threads), each sample's innermost function in this repo, aiohttp,
   asyncio, the JSON codec, ``socket`` or ``selectors`` (the loop idle in
   ``select``; a loop thread found in asyncio's socket writes is in the
   call or, after it, waiting for the interpreter lock); the round's QPS
   beside it;
2. the card's busy share: ``torch.profiler`` (CUDA activity) over the
   round, the kernels' intervals summed over the round's wall;
3. four variants of the round, each run twice in turns (A B C D D C B A):
   the defaults; the interpreter's switch interval at 0.5 ms instead of
   5 ms (it bounds how long a thread waits for the lock a busy thread
   holds); the server's request log off (the structured logger at
   "warning": ``log_mw`` writes one JSON line per request at "info"); and
   the floor: the same clients against a bare aiohttp route that parses
   the body and answers a fixed 10-result body, no engine and no
   middlewares (:func:`_floor_round`).

Without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import asyncio
import collections
import sys
import threading
import time

import numpy as np
import torch

from quiver_tpu_torch.benches.common import K, N, card, clustered, emit, require_cuda

#: the packages whose frames name a sample (the innermost one wins)
_OWNERS = ("quiver_tpu_torch", "aiohttp", "asyncio", "json", "socket", "selectors")


def _frame_key(frame):
    """(owner, function) of the innermost frame of ``_OWNERS``."""
    f = frame
    while f is not None:
        path = f.f_code.co_filename
        for owner in _OWNERS:
            if f"/{owner}/" in path or path.endswith(f"/{owner}.py"):
                return owner, f.f_code.co_name
        f = f.f_back
    return "other", frame.f_code.co_name


class StackSampler:
    """Counts, every ``period_s``, each live thread's innermost frame of
    interest, by thread role: "loop" (the thread running the event loop)
    or "worker" (``asyncio.to_thread``'s pool threads)."""

    def __init__(self, loop_thread: int, period_s: float = 1e-3):
        self.loop_thread = loop_thread
        self.period_s = period_s
        self.counts = {"loop": collections.Counter(), "worker": collections.Counter()}
        self.samples = collections.Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        me = threading.get_ident()
        names = {}
        while not self._stop.is_set():
            for th in threading.enumerate():
                names[th.ident] = th.name
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                if tid == self.loop_thread:
                    role = "loop"
                elif names.get(tid, "").startswith("asyncio_"):
                    role = "worker"
                else:
                    continue
                key = _frame_key(frame)
                if role == "worker" and key[1] in ("_worker", "wait"):
                    continue  # an idle pool thread
                self.counts[role][key] += 1
                self.samples[role] += 1
            time.sleep(self.period_s)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)

    def top(self, role: str, n: int = 12) -> list:
        total = max(1, self.samples[role])
        return [(f"{o}:{f}", round(c / total, 4)) for (o, f), c in self.counts[role].most_common(n)]


async def _round(db, payloads, *, clients, requests, window_ms=2.0, sampler=None):
    """The measured round after a warm one (200 requests, 16 clients);
    ``sampler`` samples the measured round only."""
    from quiver_tpu_torch.api.server import Server, ServerConfig
    from quiver_tpu_torch.benches.bench_api import free_port, load_round

    server = Server(db, ServerConfig(host="127.0.0.1", port=free_port(),
                                     enable_metrics_server=False, coalesce_window_ms=window_ms))
    url = f"http://127.0.0.1:{server.config.port}/api/v1/collections/api/search"
    await server.start_async()
    try:
        await load_round(url, payloads, 16, 200)
        if sampler is not None:
            sampler.start()
        try:
            return await load_round(url, payloads, clients, requests)
        finally:
            if sampler is not None:
                sampler.stop()
    finally:
        await server.stop_listeners()


async def _floor_round(payloads, *, clients, requests):
    """The same clients against a bare aiohttp route that parses the body
    and answers a fixed 10-result body: the HTTP stack's own ceiling."""
    from aiohttp import web

    from quiver_tpu_torch.benches.bench_api import free_port, load_round

    body = {"results": [{"id": f"v{i}", "distance": 0.0, "score": 1.0} for i in range(K)],
            "metadata": {"total_count": K, "search_time_ms": 0.0, "index_size": 0,
                         "index_name": "api", "strategy": "ivf"}}

    async def search(request):
        await request.json()
        return web.json_response(body)

    app = web.Application()
    app.router.add_post("/search", search)
    runner = web.AppRunner(app)
    await runner.setup()
    port = free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    url = f"http://127.0.0.1:{port}/search"
    try:
        await load_round(url, payloads, 16, 200)
        return await load_round(url, payloads, clients, requests)
    finally:
        await runner.cleanup()


async def _variant_round(variant, db, payloads, *, clients, requests):
    """One round of ``variant``: "default", the switch interval at 0.5 ms,
    the request log off, or the HTTP floor (:func:`_floor_round`)."""
    from quiver_tpu_torch.observability import logging as qlog

    if variant.startswith("floor"):
        return await _floor_round(payloads, clients=clients, requests=requests)
    interval, level = sys.getswitchinterval(), qlog.get_logger().level
    if variant.startswith("switch"):
        sys.setswitchinterval(5e-4)
    elif variant.startswith("request log off"):
        qlog.set_level("warning")
    try:
        return await _round(db, payloads, clients=clients, requests=requests)
    finally:
        sys.setswitchinterval(interval)
        qlog.get_logger().setLevel(level)


def run(db, vecs, *, clients=64, requests=2000, seed=7) -> list[dict]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)
    queries = (vecs[rng.integers(0, len(vecs), 512)]
               + 0.1 * rng.normal(size=(512, vecs.shape[1]))).astype(np.float32)
    payloads = [{"vector": q.tolist(), "top_k": K} for q in queries]
    card_line = card()
    rows = []

    async def sampled():
        s = StackSampler(threading.get_ident())
        return await _round(db, payloads, clients=clients, requests=requests, sampler=s), s

    st, s = asyncio.run(sampled())
    rows.append(dict(
        metric=f"api round profile, {clients} clients, coalesce=2.0ms: stack samples by thread",
        value=st["qps"], unit="qps", p50_ms=round(st["p50_ms"], 3),
        p99_ms=round(st["p99_ms"], 3), loop_samples=s.samples["loop"],
        worker_samples=s.samples["worker"], loop_top=s.top("loop"),
        worker_top=s.top("worker"), card=card_line))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = asyncio.run(_round(db, payloads, clients=clients, requests=requests))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e3
    rows.append(dict(
        metric=f"api round profile, {clients} clients, coalesce=2.0ms: card busy share",
        value=busy / wall_ms, unit="share of wall", kernel_ms=round(busy, 3),
        wall_ms=round(wall_ms, 3), qps=round(st["qps"], 1), card=card_line))

    variants = ("default", "switch interval 0.5 ms", "request log off (level warning)",
                "floor: no engine, no middlewares")
    qps = {v: [] for v in variants}
    for v in variants + variants[::-1]:  # in turns: A B C D D C B A
        st = asyncio.run(_variant_round(v, db, payloads, clients=clients, requests=requests))
        qps[v].append(round(st["qps"], 1))
    for v in variants:
        rows.append(dict(
            metric=f"api round, {clients} clients, coalesce=2.0ms, {v}",
            value=float(np.mean(qps[v])), unit="qps (mean of two, in turns)", runs=qps[v],
            card=card_line))
    for r in rows:
        emit(**r)
    return rows


def main() -> None:
    from quiver_tpu_torch.bench import N_CLUSTERS, cache_path
    from quiver_tpu_torch.benches.bench_api import build_db

    dev = require_cuda("quiver_tpu_torch.benches.profile_api")
    vecs = clustered(N)
    db = build_db(dev, vecs, cache=cache_path(N, N_CLUSTERS))
    try:
        run(db, vecs)
    finally:
        db.close()


if __name__ == "__main__":
    main()
