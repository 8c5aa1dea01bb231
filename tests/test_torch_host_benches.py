"""The port's host-path benches, small on the CPU: ``bench_api`` (the REST
server under load, its ``Retry-After`` parse and capped retries),
``bench_filtered``, ``bench_persistence``, ``bench_latency``'s host rows
through ``Collection`` and ``profile_api``'s stack sampler (that each
refuses to run without CUDA is in tests/test_torch_bench.py).
"""

import pytest

from quiver_tpu_torch.benches import bench_latency
from quiver_tpu_torch.benches.common import clustered

N_SMALL, K_SMALL = 8192, 64


def test_host_path_latency_rows_small_on_cpu():
    vecs = clustered(N_SMALL)
    coll = bench_latency.serving_collection("cpu", vecs, n_clusters=K_SMALL)
    assert coll.engine._built and coll.size == N_SMALL
    rows = bench_latency.host_rows(coll, vecs, calls=4, emit_rows=False)
    assert [f"B={b} " in r["metric"] for r, b in zip(rows, (1, 128))] == [True, True]
    for r in rows:
        assert "CPU host clock" in r["metric"] and r["card"] is None
        assert r["unit"] == "ms p50" and 0 < r["value"] <= r["p95_ms"] <= r["p99_ms"]
        assert r["calls"] == 4 and r["wall_qps"] > 0


def test_filtered_and_persistence_small_on_cpu():
    from quiver_tpu_torch.benches import bench_filtered, bench_persistence

    rows = bench_filtered.run("cpu", n=2048, b=32, reps=1, emit_rows=False)
    assert [r["metric"].split("(")[1].split(")")[0] for r in rows] == ["equality", "range x2"]
    for r in rows:
        assert r["unit"] == "qps" and r["value"] > 0 and r["overhead_vs_unfiltered"] > 0
    rows = bench_persistence.run("cpu", n=2048, b=32, reps=1, emit_rows=False)
    names = [r["metric"].split(",")[0] for r in rows]
    assert names == ["parquet snapshot write", "parquet snapshot read", "arrow ipc write",
                     "arrow ipc read (mmap)",
                     "exact index rebuild after an arrow load (store on the device",
                     "negative-example rerank QPS"]
    assert all(r["value"] > 0 for r in rows) and rows[0]["mb"] > 0


def test_bench_api_small_on_cpu():
    import asyncio

    from quiver_tpu_torch.benches import bench_api

    vecs = clustered(4096)
    db = bench_api.build_db("cpu", vecs, n_clusters=32)
    try:
        rows = asyncio.run(bench_api.run_async(
            db, vecs, requests=32, windows=(0.0, 2.0), concurrency=(8,), backlogs=(0,),
            shed_clients=8, warm=4, emit_rows=False))
    finally:
        db.close()
    assert len(rows) == 4
    for r in rows:
        assert r["unit"] == "qps" and r["value"] > 0 and r["completed"] == 32
        assert r["shed_429"] == 0 and r["gave_up"] == 0 and r["card"] is None
    assert rows[0]["mean_dispatch_batch"] is None  # window 0: no coalescer
    assert 1 <= rows[1]["mean_dispatch_batch"] <= 64


def test_bench_api_retry_after_forms():
    from email.utils import format_datetime
    from datetime import datetime, timezone

    from quiver_tpu_torch.benches.bench_api import retry_after_s

    assert retry_after_s("3") == 3.0 and retry_after_s(" 0 ") == 0.0
    assert retry_after_s(None) == 1.0 and retry_after_s("soon") == 1.0
    now = 1_700_000_000.0
    date = format_datetime(datetime.fromtimestamp(now + 7, timezone.utc), usegmt=True)
    assert retry_after_s(date, now=now) == pytest.approx(7.0)
    assert retry_after_s(date, now=now + 60) == 0.0  # a date in the past: no wait


def test_bench_api_caps_retries():
    """A server that refuses every request with an HTTP-date Retry-After:
    the client gives each request up after MAX_RETRIES refusals."""
    import asyncio
    import socket

    from aiohttp import web

    from quiver_tpu_torch.benches.bench_api import load_round

    async def main():
        async def refuse(request):
            return web.json_response({"error": "search backlog full, retry later"}, status=429,
                                     headers={"Retry-After": "Wed, 21 Oct 2015 07:28:00 GMT"})

        app = web.Application()
        app.router.add_post("/s", refuse)
        runner = web.AppRunner(app)
        await runner.setup()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            return await load_round(f"http://127.0.0.1:{port}/s", [{}], 2, 3, max_retries=4)
        finally:
            await runner.cleanup()

    st = asyncio.run(main())
    assert st["completed"] == 0 and st["gave_up"] == 3 and st["shed"] == 3 * 5


def test_profile_api_samples_the_server_round():
    """profile_api's sampler counts the event loop's and the workers'
    frames over one round of single searches (small, on the CPU)."""
    import asyncio
    import threading

    from quiver_tpu_torch.benches import bench_api, profile_api

    vecs = clustered(4096)
    db = bench_api.build_db("cpu", vecs, n_clusters=32)
    payloads = [{"vector": q.tolist(), "top_k": 10} for q in vecs[:32]]

    async def sampled():
        s = profile_api.StackSampler(threading.get_ident())
        return await profile_api._round(db, payloads, clients=8, requests=48, sampler=s), s

    try:
        st, s = asyncio.run(sampled())
    finally:
        db.close()
    assert st["completed"] == 48 and s.samples["loop"] > 0
    assert sum(share for _, share in s.top("loop", n=100)) == pytest.approx(1.0, abs=1e-3)
    assert not s._thread.is_alive()


def test_profile_api_variants_restore_the_settings():
    """Each variant round completes its requests (the floor without the
    engine) and leaves the switch interval and the log level as it found
    them."""
    import asyncio
    import sys

    from quiver_tpu_torch.benches import bench_api, profile_api
    from quiver_tpu_torch.observability import logging as qlog

    vecs = clustered(2048)
    db = bench_api.build_db("cpu", vecs, n_clusters=16)
    payloads = [{"vector": q.tolist(), "top_k": 10} for q in vecs[:16]]
    before = (sys.getswitchinterval(), qlog.get_logger().level)
    try:
        for v in ("switch interval 0.5 ms", "request log off (level warning)",
                  "floor: no engine, no middlewares"):
            st = asyncio.run(profile_api._variant_round(v, db, payloads, clients=4, requests=16))
            assert st["completed"] == 16 and st["gave_up"] == 0, v
            assert (sys.getswitchinterval(), qlog.get_logger().level) == before, v
    finally:
        db.close()
