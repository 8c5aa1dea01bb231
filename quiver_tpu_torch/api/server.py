"""REST API server (aiohttp) — the reference's full route surface.

Parity with the reference's Gin server (reference: pkg/api/server.go:152-184
route table, handlers.go:36-680 handler semantics): health; collections CRUD
+ stats; vector add / batch add / get / update / delete / batch delete;
search (TopK defaults to 10, dimension mismatches map to 400,
handlers.go:523-567); JSON metrics; backup/restore. Middleware: CORS, JWT
auth (optional), per-IP rate limiting, request logging, centralized error
mapping. A separate Prometheus exposition server mirrors the reference's
dedicated metrics listener (server.go:136-143); graceful shutdown mirrors
server.go:206-229.

Search handlers run the (blocking) device call in a worker thread so the
event loop keeps serving; batched requests hit the collection's vectorized
search_batch — the kernel-level replacement for goroutine fan-out.

PyTorch port of ``quiver_tpu/api/server.py``; the routes, bodies and status
codes are the reference's, with these differences:

* the worker threads (``asyncio.to_thread``) issue CUDA work on the
  device's default stream, the one the store's sync and the engines' write
  path and maintenance swap order themselves against
  (``core/store.py::VectorStore.sync_stream``); no handler makes a stream;
* results reach :meth:`Server._response_json` as host values: every engine
  returns its distances and slots as numpy after one device-to-host copy
  per ``search_batch``, and result vectors come from the store's host
  mirror, so building the JSON reads no CUDA tensor;
* a request body may hold up to :data:`MAX_BODY_BYTES` (the reference
  keeps aiohttp's 1 MiB, so its ``vectors/batch`` refuses a few hundred
  128-d rows with 413);
* the shutdown's ``db.close()`` (the flush: seconds at real sizes on the
  card) runs in a worker thread and is awaited to its end outside the
  shutdown timeout, so every acknowledged write is on disk when
  :meth:`Server.run` returns; the reference's blocking call on the loop
  could not be cancelled either.
"""

from __future__ import annotations

import asyncio
import signal
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from aiohttp import web

from quiver_tpu_torch.core.db import DB
from quiver_tpu_torch.facets.filters import filter_from_dict
from quiver_tpu_torch.observability import logging as qlog
from quiver_tpu_torch.observability.metrics import global_metrics
from quiver_tpu_torch.api.auth import RateLimiter, jwt_decode, parse_bearer
from quiver_tpu_torch.types import Filter, SearchOptions, SearchRequest


#: the largest request body: a ``vectors/batch`` of 8,192 128-d rows is
#: ~21 MB of JSON. aiohttp's default, 1 MiB, which the reference keeps,
#: refuses more than ~400 such rows with 413; the Go reference sets none.
MAX_BODY_BYTES = 256 * 1024 * 1024


@dataclass
class ServerConfig:
    """(reference ServerConfig, server.go:20-59)."""

    host: str = "0.0.0.0"
    port: int = 8080
    metrics_port: int = 9090
    enable_metrics_server: bool = True
    cors_origins: list[str] = field(default_factory=lambda: ["*"])
    enable_auth: bool = False
    jwt_secret: str = ""
    rate_limit: float = 0.0  # requests/s per client; 0 disables
    shutdown_timeout_s: float = 10.0
    #: micro-batch window for concurrent single-search requests: the first
    #: arrival waits up to this long for companions, then every pending
    #: request for that collection dispatches as ONE batched engine call —
    #: queries are a batch dimension of one kernel launch, the TPU-native
    #: replacement for the reference's goroutine-per-query fan-out
    #: (pkg/hnsw/adapter.go:238-290). 0 disables (direct per-request path).
    coalesce_window_ms: float = 2.0
    #: flush immediately once this many requests are pending
    coalesce_max_batch: int = 256
    #: load shed: max queued + in-flight search requests per collection;
    #: past it new searches get 429 + Retry-After instead of unbounded
    #: queueing (VERDICT r4 #8: at 256 clients p95 blew to 1.2-2.9 s of
    #: pure backlog — the per-IP rate limiter can't see aggregate load,
    #: reference middleware.go:79-139 has the same blind spot). Sized so
    #: the shed point is ~4 dispatch batches of latency. 0 disables.
    search_backlog: int = 1024

    def validate(self) -> None:
        if self.enable_auth and not self.jwt_secret:
            raise ValueError("jwt_secret required when auth is enabled")
        if self.coalesce_window_ms < 0 or self.coalesce_max_batch < 1:
            raise ValueError("invalid search-coalescing configuration")
        if self.search_backlog < 0:
            raise ValueError("search_backlog must be >= 0")


class Overloaded(Exception):
    """Raised when a collection's search backlog is full; the handler
    maps it to 429 + Retry-After (bounded-latency refusal instead of
    unbounded queueing)."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__("search backlog full")


class _SearchCoalescer:
    """Micro-batches concurrent single-search requests per collection.

    Bookkeeping runs on the event loop (no locks needed); the batched
    engine call runs in a worker thread like every other blocking handler.
    ``Collection.search_batch`` already groups mixed k/options internally
    and returns responses in request order.

    ``backlog`` bounds queued + in-flight requests per collection; past
    it ``submit`` raises :class:`Overloaded` with a Retry-After estimated
    from the observed batch service time."""

    def __init__(self, window_s: float, max_batch: int, backlog: int = 0):
        self.window_s = window_s
        self.max_batch = max_batch
        self.backlog = backlog
        self._pending: dict[str, list] = {}
        self._inflight: dict[str, int] = {}
        self._service_s: dict[str, float] = {}  # EWMA batch service time
        self._tasks: set = set()  # dispatches in flight (the loop holds tasks weakly)
        self.shed_count = 0
        #: engine calls dispatched and the requests they carried
        self.dispatches = 0
        self.dispatched = 0

    def depth(self, name: str) -> int:
        return len(self._pending.get(name, ())) + self._inflight.get(name, 0)

    async def submit(self, coll, req):
        loop = asyncio.get_running_loop()
        if self.backlog and self.depth(coll.name) >= self.backlog:
            self.shed_count += 1
            svc = self._service_s.get(coll.name, 0.05)
            # time to drain the backlog at the observed service rate
            batches = max(1, self.depth(coll.name) // self.max_batch)
            raise Overloaded(max(svc * batches, 0.05))
        fut = loop.create_future()
        q = self._pending.setdefault(coll.name, [])
        q.append((coll, req, fut))
        if len(q) >= self.max_batch:
            self._flush(coll.name)
        elif len(q) == 1:
            loop.call_later(self.window_s, self._flush, coll.name)
        return await fut

    def _flush(self, name: str) -> None:
        batch = self._pending.pop(name, [])
        if not batch:  # already flushed by the max_batch trigger
            return
        coll = batch[0][0]
        reqs = [r for _c, r, _f in batch]
        self._inflight[name] = self._inflight.get(name, 0) + len(batch)
        self.dispatches += 1
        self.dispatched += len(batch)

        async def run():
            t0 = asyncio.get_running_loop().time()
            try:
                resps = await asyncio.to_thread(coll.search_batch, reqs)
                for (_c, _r, fut), resp in zip(batch, resps):
                    if not fut.done():
                        fut.set_result(resp)
            except Exception as e:
                for _c, _r, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                self._inflight[name] -= len(batch)
                dt = asyncio.get_running_loop().time() - t0
                prev = self._service_s.get(name)
                self._service_s[name] = (
                    dt if prev is None else 0.7 * prev + 0.3 * dt
                )

        task = asyncio.get_running_loop().create_task(run())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


class Server:
    def __init__(self, db: DB, config: Optional[ServerConfig] = None):
        self.db = db
        self.config = config or ServerConfig()
        self.config.validate()
        self._coalescer = (
            _SearchCoalescer(
                self.config.coalesce_window_ms / 1e3,
                self.config.coalesce_max_batch,
                backlog=self.config.search_backlog,
            )
            if self.config.coalesce_window_ms > 0
            else None
        )
        self.app = web.Application(
            middlewares=self._middlewares(), client_max_size=MAX_BODY_BYTES
        )
        self._routes()
        self._runner: Optional[web.AppRunner] = None
        self._metrics_runner: Optional[web.AppRunner] = None

    # ------------------------------------------------------------ middleware

    def _middlewares(self):
        cfg = self.config
        limiter = RateLimiter(rate=cfg.rate_limit, capacity=max(cfg.rate_limit * 2, 1)) \
            if cfg.rate_limit > 0 else None

        @web.middleware
        async def error_mw(request, handler):
            try:
                return await handler(request)
            except web.HTTPException:
                raise
            except (KeyError,) as e:
                return _json_error(404, str(e).strip("'\""))
            except ValueError as e:
                return _json_error(400, str(e))
            except Exception as e:  # centralized error handler
                qlog.error("request failed", path=request.path, error=str(e))
                return _json_error(500, "internal error")

        @web.middleware
        async def auth_mw(request, handler):
            if cfg.enable_auth and request.path != "/health":
                try:
                    token = parse_bearer(request.headers.get("Authorization"))
                    request["claims"] = jwt_decode(token, cfg.jwt_secret)
                except ValueError as e:
                    return _json_error(401, str(e))
            return await handler(request)

        @web.middleware
        async def ratelimit_mw(request, handler):
            if limiter is not None:
                client = request.remote or "unknown"
                if not limiter.allow(client):
                    return _json_error(429, "rate limit exceeded")
            return await handler(request)

        @web.middleware
        async def log_mw(request, handler):
            t0 = time.perf_counter()
            resp = await handler(request)
            qlog.info(
                "request",
                method=request.method,
                path=request.path,
                status=resp.status,
                ms=round((time.perf_counter() - t0) * 1e3, 2),
            )
            return resp

        @web.middleware
        async def cors_mw(request, handler):
            if request.method == "OPTIONS":
                resp = web.Response()
            else:
                resp = await handler(request)
            origin = cfg.cors_origins[0] if cfg.cors_origins else "*"
            resp.headers["Access-Control-Allow-Origin"] = origin
            resp.headers["Access-Control-Allow-Methods"] = "GET,POST,PUT,DELETE,OPTIONS"
            resp.headers["Access-Control-Allow-Headers"] = "Content-Type,Authorization"
            return resp

        return [error_mw, cors_mw, log_mw, ratelimit_mw, auth_mw]

    # ---------------------------------------------------------------- routes

    def _routes(self) -> None:
        r = self.app.router
        r.add_get("/health", self.health)
        v1 = "/api/v1"
        r.add_get(f"{v1}/collections", self.list_collections)
        r.add_post(f"{v1}/collections", self.create_collection)
        r.add_get(f"{v1}/collections/{{name}}", self.get_collection)
        r.add_delete(f"{v1}/collections/{{name}}", self.delete_collection)
        r.add_get(f"{v1}/collections/{{name}}/stats", self.collection_stats)
        r.add_post(f"{v1}/collections/{{name}}/vectors", self.add_vector)
        r.add_post(f"{v1}/collections/{{name}}/vectors/batch", self.add_vectors_batch)
        r.add_post(f"{v1}/collections/{{name}}/vectors/batch/delete", self.delete_vectors_batch)
        r.add_get(f"{v1}/collections/{{name}}/vectors/{{id}}", self.get_vector)
        r.add_put(f"{v1}/collections/{{name}}/vectors/{{id}}", self.update_vector)
        r.add_delete(f"{v1}/collections/{{name}}/vectors/{{id}}", self.delete_vector)
        r.add_post(f"{v1}/collections/{{name}}/search", self.search)
        r.add_post(f"{v1}/collections/{{name}}/search/batch", self.batch_search)
        r.add_post(f"{v1}/collections/{{name}}/search/facets", self.search_facets)
        r.add_get(f"{v1}/metrics", self.metrics_json)
        r.add_post(f"{v1}/backup", self.backup)
        r.add_post(f"{v1}/restore", self.restore)

    # -------------------------------------------------------------- handlers

    async def health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def list_collections(self, request: web.Request) -> web.Response:
        return web.json_response({"collections": self.db.list_collections()})

    async def create_collection(self, request: web.Request) -> web.Response:
        body = await request.json()
        name = body.get("name")
        dim = body.get("dimension")
        if not name or not isinstance(dim, int) or dim <= 0:
            return _json_error(400, "name and positive integer dimension required")
        engine_config = body.get("engine_config")
        if engine_config is not None and not isinstance(engine_config, dict):
            return _json_error(400, "engine_config must be an object")
        coll = self.db.create_collection(
            name,
            dim,
            body.get("distance_function", "cosine"),
            engine=body.get("engine"),
            engine_config=engine_config,
            facet_fields=body.get("facet_fields", ()),
        )
        return web.json_response(
            {"name": coll.name, "dimension": coll.dim, "metric": coll.metric.value},
            status=201,
        )

    async def get_collection(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        return web.json_response(vars(coll.stats()))

    async def delete_collection(self, request: web.Request) -> web.Response:
        self.db.delete_collection(request.match_info["name"])
        return web.json_response({"deleted": request.match_info["name"]})

    async def collection_stats(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        stats = vars(coll.stats())
        if hasattr(coll.engine, "stats"):
            stats["engine"] = coll.engine.stats()
        return web.json_response(stats)

    async def add_vector(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        body = await request.json()
        vid, vec = body.get("id"), body.get("vector")
        if not vid or vec is None:
            return _json_error(400, "id and vector required")
        await asyncio.to_thread(coll.add, vid, vec, body.get("metadata"))
        return web.json_response({"id": vid}, status=201)

    async def add_vectors_batch(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        body = await request.json()
        vectors = body.get("vectors", [])
        if not vectors:
            return _json_error(400, "vectors list required")
        ids = [v.get("id") for v in vectors]
        vecs = [v.get("vector") for v in vectors]
        mds = [v.get("metadata") for v in vectors]
        if any(not i or v is None for i, v in zip(ids, vecs)):
            return _json_error(400, "every item needs id and vector")
        await asyncio.to_thread(coll.add_batch, ids, np.asarray(vecs, np.float32), mds)
        return web.json_response({"inserted": len(ids)}, status=201)

    async def get_vector(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        rec = coll.get(request.match_info["id"])
        return web.json_response(
            {"id": rec.id, "vector": rec.values.tolist(), "metadata": rec.metadata}
        )

    async def update_vector(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        body = await request.json()
        await asyncio.to_thread(
            coll.update, request.match_info["id"],
            body.get("vector"), body.get("metadata"),
        )
        return web.json_response({"id": request.match_info["id"]})

    async def delete_vector(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        if not coll.delete(request.match_info["id"]):
            return _json_error(404, "vector not found")
        return web.json_response({"deleted": request.match_info["id"]})

    async def delete_vectors_batch(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        body = await request.json()
        ids = body.get("ids", [])
        n = await asyncio.to_thread(coll.delete_batch, ids)
        return web.json_response({"deleted": n})

    def _parse_search_request(self, body: dict) -> SearchRequest:
        vec = body.get("vector")
        if vec is None:
            raise ValueError("vector required")
        opts = body.get("options", {})
        # malformed filter dicts are a CLIENT error: a bare KeyError here
        # would ride the middleware's not-found mapping out as a 404
        filters = []
        for f in body.get("filters", []):
            if "field" not in f or "operator" not in f:
                raise ValueError(
                    "every filter needs 'field' and 'operator'"
                )
            filters.append(Filter(f["field"], f["operator"], f.get("value")))
        return SearchRequest(
            vector=np.asarray(vec, np.float32),
            top_k=int(body.get("top_k", 10)),  # default 10 (handlers.go:523)
            filters=filters,
            options=SearchOptions(
                include_vectors=opts.get("include_vectors", False),
                include_metadata=opts.get("include_metadata", False),
                exact_search=opts.get("exact_search", False),
            ),
            namespace_id=body.get("namespace_id", ""),
            negative_example=(
                np.asarray(body["negative_example"], np.float32)
                if body.get("negative_example") is not None
                else None
            ),
            negative_weight=float(body.get("negative_weight", 0.5)),
        )

    @staticmethod
    def _response_json(resp) -> dict:
        return {
            "results": [
                {
                    "id": r.id,
                    "distance": r.distance,
                    "score": r.score,
                    **({"vector": r.vector.tolist()} if r.vector is not None else {}),
                    **({"metadata": r.metadata} if r.metadata is not None else {}),
                }
                for r in resp.results
            ],
            "metadata": {
                "total_count": resp.metadata.total_count,
                "search_time_ms": resp.metadata.search_time_ms,
                "index_size": resp.metadata.index_size,
                "index_name": resp.metadata.index_name,
                "strategy": resp.metadata.strategy,
            },
        }

    async def search(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        req = self._parse_search_request(await request.json())
        if self._coalescer is not None:
            try:
                resp = await self._coalescer.submit(coll, req)
            except Overloaded as e:
                r = web.json_response(
                    {"error": "search backlog full, retry later"},
                    status=429,
                )
                r.headers["Retry-After"] = str(
                    max(1, int(round(e.retry_after_s)))
                )
                return r
        else:
            resp = await asyncio.to_thread(coll.search, req)
        return web.json_response(self._response_json(resp))

    async def batch_search(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        body = await request.json()
        reqs = [self._parse_search_request(r) for r in body.get("requests", [])]
        if not reqs:
            return _json_error(400, "requests list required")
        resps = await asyncio.to_thread(coll.search_batch, reqs)
        return web.json_response({"responses": [self._response_json(r) for r in resps]})

    async def search_facets(self, request: web.Request) -> web.Response:
        coll = self.db.get_collection(request.match_info["name"])
        body = await request.json()
        vec = body.get("vector")
        if vec is None:
            return _json_error(400, "vector required")
        filters = [filter_from_dict(f) for f in body.get("filters", [])]
        items = await asyncio.to_thread(
            coll.search_with_facets,
            np.asarray(vec, np.float32), int(body.get("top_k", 10)), filters,
        )
        return web.json_response(
            {"results": [
                {"id": i.id, "distance": i.distance, "score": i.score}
                for i in items
            ]}
        )

    async def metrics_json(self, request: web.Request) -> web.Response:
        return web.json_response(global_metrics().summary())

    async def backup(self, request: web.Request) -> web.Response:
        body = await request.json()
        path = body.get("path")
        if not path:
            return _json_error(400, "path required")
        await asyncio.to_thread(self.db.backup, path)
        return web.json_response({"backup": path})

    async def restore(self, request: web.Request) -> web.Response:
        body = await request.json()
        path = body.get("path")
        if not path:
            return _json_error(400, "path required")
        await asyncio.to_thread(self.db.restore, path)
        return web.json_response({"restored": path})

    # -------------------------------------------------------------- lifecycle

    async def start_async(self) -> None:
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.config.host, self.config.port)
        await site.start()
        if self.config.enable_metrics_server:
            metrics_app = web.Application()

            async def prom(request):
                return web.Response(
                    body=global_metrics().prometheus_text(),
                    content_type="text/plain",
                )

            metrics_app.router.add_get("/metrics", prom)
            self._metrics_runner = web.AppRunner(metrics_app)
            await self._metrics_runner.setup()
            await web.TCPSite(
                self._metrics_runner, self.config.host, self.config.metrics_port
            ).start()
        qlog.info(
            "server started",
            host=self.config.host,
            port=self.config.port,
            metrics_port=self.config.metrics_port
            if self.config.enable_metrics_server
            else None,
        )

    async def stop_listeners(self) -> None:
        """Close both listeners (in-flight requests drain first); the DB
        stays open."""
        if self._runner:
            await self._runner.cleanup()
        if self._metrics_runner:
            await self._metrics_runner.cleanup()

    async def stop_async(self) -> None:
        await self.stop_listeners()
        await self._close_db()

    async def _close_db(self) -> None:
        t0 = time.perf_counter()
        await asyncio.to_thread(self.db.close)  # flushes; not cancellable
        qlog.info("server stopped", close_s=round(time.perf_counter() - t0, 3))

    def run(self) -> None:
        """Blocking serve with graceful SIGINT/SIGTERM shutdown
        (server.go:206-229)."""
        loop = asyncio.new_event_loop()
        stop = asyncio.Event()

        def _signal():
            stop.set()

        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, _signal)

        async def main():
            await self.start_async()
            await stop.wait()
            try:
                await asyncio.wait_for(
                    self.stop_listeners(), timeout=self.config.shutdown_timeout_s
                )
            finally:
                # the flush runs to its end, past the timeout if it must
                await self._close_db()

        try:
            loop.run_until_complete(main())
        finally:
            loop.close()
