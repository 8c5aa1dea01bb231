"""The port's REST API (``quiver_tpu_torch/api``) on the CPU.

Part one runs every scenario of tests/test_api.py on the port's ``Server``
over a ``DB(DBOptions(device="cpu"))``. Its coalescing and load-shed cases
depend on no clock: the burst forms one batch because ``coalesce_max_batch``
equals the number of clients and the window is a minute long, and the
backlog is full because the engine call is held on a ``threading.Event``
until the refused requests have been answered.

Part two serves the same seeded rows and metadata from a JAX-package DB and
a port DB and sends both the same requests. On the exact engine the ids are
equal (ties aside) and the distances within rtol=1e-5, atol=1e-5 (f32 in
both, another summation order); on the default hybrid engine over IVF the
port's recall@10 against the exact answer is at least the reference's less
0.02 (ROADMAP.md's expected divergences). Status codes and error bodies are
equal: 400 (a dimension mismatch, a malformed filter), 404, 401 and the
rate limiter's 429. HNSW collections (``engine: "hnsw"`` and a hybrid's
``hnsw`` block) answer on both, and so do the sharded kinds (a
``sharded_ivf`` collection).

Every server binds a free ephemeral port (tests/test_api.py binds
18080-18086 and 19090, and may run at the same time on another worker).
"""

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import requests

from quiver_tpu.api.server import Server as JServer
from quiver_tpu.api.server import ServerConfig as JServerConfig
from quiver_tpu.core.db import DB as JDB
from quiver_tpu.core.db import DBOptions as JDBOptions
from quiver_tpu_torch.api.auth import RateLimiter, jwt_decode, jwt_encode, parse_bearer
from quiver_tpu_torch.api.server import Server, ServerConfig
from quiver_tpu_torch.benches.bench_api import free_port
from quiver_tpu_torch.core.db import DB, DBOptions

D = 8
TOL = dict(rtol=1e-5, atol=1e-5)


class ServerThread:
    """A server of either package on its own event-loop thread; ``start``
    returns once the listeners are bound (no HTTP poll, so a rate limiter
    sees only the test's own requests)."""

    def __init__(self, server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.base = f"http://127.0.0.1:{server.config.port}"

    def start(self):
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start_async(), self.loop).result(timeout=30)
        return self

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.server.stop_async(), self.loop).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        self.loop.close()


def port_db(**kw):
    kw.setdefault("device", "cpu")
    return DB(DBOptions(**kw))


def serve(db, **cfg):
    cfg.setdefault("enable_metrics_server", False)
    return ServerThread(Server(db, ServerConfig(host="127.0.0.1", port=free_port(), **cfg))).start()


# --------------------------------------------- the scenarios of test_api.py


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    db = port_db(storage_path=str(tmp_path_factory.mktemp("api-data")),
                 default_engine="exact", flush_interval_s=0)
    metrics_port = free_port()
    st = serve(db, enable_metrics_server=True, metrics_port=metrics_port)
    st.metrics_port = metrics_port
    yield st
    st.stop()


def test_health(api):
    r = requests.get(f"{api.base}/health")
    assert r.status_code == 200 and r.json()["status"] == "ok"


def test_collection_lifecycle_and_vectors(api):
    api = api.base
    r = requests.post(f"{api}/api/v1/collections", json={
        "name": "c1", "dimension": D, "distance_function": "euclidean",
    })
    assert r.status_code == 201, r.text
    r = requests.post(f"{api}/api/v1/collections", json={"name": "c1", "dimension": D})
    assert r.status_code == 400
    r = requests.post(f"{api}/api/v1/collections", json={"name": "x"})
    assert r.status_code == 400

    assert "c1" in requests.get(f"{api}/api/v1/collections").json()["collections"]

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(20, D)).astype(np.float32)
    r = requests.post(f"{api}/api/v1/collections/c1/vectors", json={
        "id": "v0", "vector": vecs[0].tolist(), "metadata": {"cat": "a"},
    })
    assert r.status_code == 201
    r = requests.post(f"{api}/api/v1/collections/c1/vectors/batch", json={
        "vectors": [
            {"id": f"v{i}", "vector": vecs[i].tolist(),
             "metadata": {"cat": "a" if i % 2 else "b"}}
            for i in range(1, 20)
        ],
    })
    assert r.status_code == 201 and r.json()["inserted"] == 19

    r = requests.get(f"{api}/api/v1/collections/c1/vectors/v3")
    assert r.status_code == 200
    assert np.allclose(r.json()["vector"], vecs[3], atol=1e-6)
    r = requests.put(f"{api}/api/v1/collections/c1/vectors/v3", json={"metadata": {"cat": "z"}})
    assert r.status_code == 200
    assert requests.get(f"{api}/api/v1/collections/c1/vectors/v3").json()["metadata"] == {"cat": "z"}
    r = requests.get(f"{api}/api/v1/collections/c1/vectors/missing")
    assert r.status_code == 404

    r = requests.post(f"{api}/api/v1/collections/c1/search", json={
        "vector": vecs[5].tolist(), "options": {"include_metadata": True},
    })
    body = r.json()
    assert r.status_code == 200
    assert body["results"][0]["id"] == "v5"
    assert len(body["results"]) == 10
    assert body["metadata"]["index_size"] == 20

    r = requests.post(f"{api}/api/v1/collections/c1/search", json={"vector": [1, 2]})
    assert r.status_code == 400

    r = requests.post(f"{api}/api/v1/collections/c1/search", json={
        "vector": vecs[5].tolist(), "top_k": 20,
        "filters": [{"field": "cat", "operator": "=", "value": "b"}],
        "options": {"include_metadata": True},
    })
    assert all(x["metadata"]["cat"] == "b" for x in r.json()["results"])

    r = requests.post(f"{api}/api/v1/collections/c1/search/batch", json={
        "requests": [
            {"vector": vecs[1].tolist(), "top_k": 2},
            {"vector": vecs[2].tolist(), "top_k": 2},
        ],
    })
    rs = r.json()["responses"]
    assert rs[0]["results"][0]["id"] == "v1"
    assert rs[1]["results"][0]["id"] == "v2"

    r = requests.post(f"{api}/api/v1/collections/c1/search/facets", json={
        "vector": vecs[5].tolist(), "top_k": 20,
        "filters": [{"type": "equality", "field": "cat", "value": "a"}],
    })
    assert r.status_code == 200 and len(r.json()["results"]) > 0

    r = requests.post(f"{api}/api/v1/collections/c1/search", json={
        "vector": vecs[5].tolist(),
        "negative_example": vecs[6].tolist(),
        "negative_weight": 1.0,
    })
    assert r.status_code == 200

    assert requests.delete(f"{api}/api/v1/collections/c1/vectors/v9").status_code == 200
    assert requests.delete(f"{api}/api/v1/collections/c1/vectors/v9").status_code == 404
    r = requests.post(f"{api}/api/v1/collections/c1/vectors/batch/delete", json={
        "ids": ["v10", "v11", "nope"],
    })
    assert r.json()["deleted"] == 2

    r = requests.get(f"{api}/api/v1/collections/c1/stats")
    assert r.json()["vector_count"] == 17

    assert requests.get(f"{api}/api/v1/collections/nope").status_code == 404


def test_metrics_endpoints(api):
    r = requests.get(f"{api.base}/api/v1/metrics")
    assert r.status_code == 200 and "qps" in r.json()
    r = requests.get(f"http://127.0.0.1:{api.metrics_port}/metrics")
    assert r.status_code == 200
    assert b"quiver_search" in r.content


def test_backup_restore_roundtrip(api, tmp_path):
    api = api.base
    dest = str(tmp_path / "api-backup")
    r = requests.post(f"{api}/api/v1/backup", json={"path": dest})
    assert r.status_code == 200
    requests.delete(f"{api}/api/v1/collections/c1")
    assert "c1" not in requests.get(f"{api}/api/v1/collections").json()["collections"]
    r = requests.post(f"{api}/api/v1/restore", json={"path": dest})
    assert r.status_code == 200
    assert "c1" in requests.get(f"{api}/api/v1/collections").json()["collections"]


def test_cors_headers(api):
    r = requests.options(f"{api.base}/api/v1/collections")
    assert r.headers.get("Access-Control-Allow-Origin")


def test_jwt_roundtrip():
    tok = jwt_encode({"sub": "x", "exp": time.time() + 60}, "s3cret")
    assert jwt_decode(tok, "s3cret")["sub"] == "x"
    with pytest.raises(ValueError, match="signature"):
        jwt_decode(tok, "wrong")
    expired = jwt_encode({"exp": time.time() - 1}, "s3cret")
    with pytest.raises(ValueError, match="expired"):
        jwt_decode(expired, "s3cret")
    with pytest.raises(ValueError, match="malformed"):
        jwt_decode("nope", "s3cret")


def test_parse_bearer():
    assert parse_bearer("Bearer abc") == "abc"
    with pytest.raises(ValueError):
        parse_bearer(None)
    with pytest.raises(ValueError):
        parse_bearer("Basic abc")


def test_rate_limiter():
    rl = RateLimiter(rate=0.0001, capacity=2)
    assert rl.allow("a") and rl.allow("a")
    assert not rl.allow("a")
    assert rl.allow("b")


def test_auth_enforced():
    st = serve(port_db(enable_persistence=False, default_engine="exact"),
               enable_auth=True, jwt_secret="topsecret")
    base = st.base
    try:
        assert requests.get(f"{base}/health").status_code == 200
        assert requests.get(f"{base}/api/v1/collections").status_code == 401
        tok = jwt_encode({"sub": "t", "exp": time.time() + 60}, "topsecret")
        r = requests.get(f"{base}/api/v1/collections", headers={"Authorization": f"Bearer {tok}"})
        assert r.status_code == 200
        bad = requests.get(f"{base}/api/v1/collections", headers={"Authorization": "Bearer bogus"})
        assert bad.status_code == 401
    finally:
        st.stop()


def test_rate_limit_enforced():
    st = serve(port_db(enable_persistence=False, default_engine="exact"), rate_limit=0.0001)
    try:
        codes = [requests.get(f"{st.base}/health").status_code for _ in range(5)]
        assert 429 in codes
    finally:
        st.stop()


def _searchable(st, db, name, n, seed, scale=1.0):
    requests.post(f"{st.base}/api/v1/collections", json={
        "name": name, "dimension": D, "distance_function": "euclidean",
    })
    vecs = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32) * scale
    r = requests.post(f"{st.base}/api/v1/collections/{name}/vectors/batch", json={
        "vectors": [{"id": f"v{i}", "vector": vecs[i].tolist()} for i in range(n)],
    })
    assert r.status_code == 201
    return vecs, db.get_collection(name)


def test_concurrent_searches_coalesce(tmp_path):
    """Twelve concurrent single searches dispatch as ONE batched engine call
    (the batch is complete when the twelfth arrives: max batch 12, a window
    of a minute), and every caller gets its own result."""
    db = port_db(storage_path=str(tmp_path / "co-data"), default_engine="exact",
                 flush_interval_s=0)
    st = serve(db, coalesce_window_ms=60_000.0, coalesce_max_batch=12)
    try:
        vecs, coll = _searchable(st, db, "co", 32, seed=1, scale=10.0)
        calls = []
        orig = coll.search_batch
        coll.search_batch = lambda reqs: (calls.append(len(reqs)), orig(reqs))[1]

        def one(i):
            r = requests.post(f"{st.base}/api/v1/collections/co/search",
                              json={"vector": vecs[i].tolist(), "top_k": 1})
            assert r.status_code == 200, r.text
            return r.json()["results"][0]["id"]

        with ThreadPoolExecutor(max_workers=12) as ex:
            got = list(ex.map(one, range(12)))
        assert got == [f"v{i}" for i in range(12)]
        assert calls == [12]
        assert st.server._coalescer.dispatches == 1 and st.server._coalescer.dispatched == 12
    finally:
        st.stop()


def test_search_backlog_shed(tmp_path):
    """With the backlog (4) full of one held dispatch, every further search
    is refused at once with 429 and a Retry-After; the held ones then
    complete with 200."""
    db = port_db(storage_path=str(tmp_path / "shed-data"), default_engine="exact",
                 flush_interval_s=0)
    st = serve(db, coalesce_window_ms=60_000.0, coalesce_max_batch=4, search_backlog=4)
    held, entered = threading.Event(), threading.Event()
    try:
        vecs, coll = _searchable(st, db, "sh", 16, seed=2)
        orig = coll.search_batch

        def held_batch(reqs):
            entered.set()
            assert held.wait(timeout=60)
            return orig(reqs)

        coll.search_batch = held_batch

        def one(i):
            return requests.post(f"{st.base}/api/v1/collections/sh/search",
                                 json={"vector": vecs[i].tolist(), "top_k": 1})

        with ThreadPoolExecutor(max_workers=4) as ex:
            admitted = [ex.submit(one, i) for i in range(4)]
            assert entered.wait(timeout=60)
            shed = [one(i) for i in range(4, 16)]
            held.set()
            admitted = [f.result(timeout=60) for f in admitted]
        assert [r.status_code for r in admitted] == [200] * 4
        assert [r.json()["results"][0]["id"] for r in admitted] == [f"v{i}" for i in range(4)]
        assert [r.status_code for r in shed] == [429] * 12
        for r in shed:
            assert int(r.headers["Retry-After"]) >= 1
            assert "retry" in r.json()["error"]
        assert st.server._coalescer.shed_count == 12
    finally:
        held.set()
        st.stop()


def test_large_batch_body_is_accepted(api):
    """A ``vectors/batch`` body past aiohttp's default 1 MiB (which the
    reference keeps, answering 413) is accepted."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(1500, 64)).astype(np.float32)
    body = {"vectors": [{"id": f"b{i}", "vector": v.tolist()} for i, v in enumerate(vecs)]}
    requests.post(f"{api.base}/api/v1/collections", json={"name": "big", "dimension": 64})
    r = requests.post(f"{api.base}/api/v1/collections/big/vectors/batch", json=body)
    assert len(r.request.body) > 1024 * 1024
    assert r.status_code == 201 and r.json()["inserted"] == 1500


def test_engine_config_create_and_validation(api):
    api = api.base
    r = requests.post(f"{api}/api/v1/collections", json={
        "name": "ec1", "dimension": D, "distance_function": "euclidean",
        "engine": "ivf",
        "engine_config": {"n_probe": 4, "build_threshold": 64},
    })
    assert r.status_code == 201, r.text
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(96, D)).astype(np.float32)
    r = requests.post(f"{api}/api/v1/collections/ec1/vectors/batch", json={
        "vectors": [{"id": f"e{i}", "vector": vecs[i].tolist()} for i in range(96)],
    })
    assert r.status_code == 201
    r = requests.post(f"{api}/api/v1/collections/ec1/search", json={
        "vector": vecs[7].tolist(), "top_k": 3,
    })
    assert r.status_code == 200
    assert r.json()["results"][0]["id"] == "e7"
    r = requests.post(f"{api}/api/v1/collections", json={
        "name": "ec2", "dimension": D, "engine": "ivf",
        "engine_config": {"no_such_knob": 1},
    })
    assert r.status_code == 400, r.text
    r = requests.post(f"{api}/api/v1/collections", json={
        "name": "ec3", "dimension": D, "engine_config": 5,
    })
    assert r.status_code == 400
    r = requests.post(f"{api}/api/v1/collections", json={
        "name": "ec4", "dimension": D, "engine": "hybrid",
        "engine_config": {"recall_target": 0.9},
    })
    assert r.status_code == 400
    r = requests.post(f"{api}/api/v1/collections", json={
        "name": "ec5", "dimension": D, "engine": "hybrid",
        "engine_config": {"ivf": {"n_probe": 2, "build_threshold": 64},
                          "adaptive": {"exploration_factor": 0.0}},
    })
    assert r.status_code == 201, r.text


# ------------------------------------------- both packages, same requests

N_PAR, D_PAR, K = 2000, 16, 10
#: the hybrid's IVF side, built at insert (the corpus passes the threshold)
HYBRID_CFG = {"ivf": {"n_clusters": 16, "n_probe": 3, "build_threshold": 512}}


def _corpus():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(40, D_PAR)).astype(np.float32)
    vecs = (centers[rng.integers(0, 40, N_PAR)]
            + 0.3 * rng.normal(size=(N_PAR, D_PAR))).astype(np.float32)
    mds = [{"cat": int(c), "price": round(float(p), 3), "tag": f"t{i % 3}"}
           for i, (c, p) in enumerate(zip(rng.integers(0, 5, N_PAR), rng.random(N_PAR) * 100))]
    queries = (vecs[rng.integers(0, N_PAR, 48)]
               + 0.05 * rng.normal(size=(48, D_PAR))).astype(np.float32)
    return vecs, mds, queries


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The same rows, written through REST, in a JAX-package server and a
    port server (exact collection "ex", default-engine collection "hy")."""
    vecs, mds, queries = _corpus()
    jdb = JDB(JDBOptions(storage_path=str(tmp_path_factory.mktemp("jax-data")),
                         flush_interval_s=0))
    tdb = port_db(storage_path=str(tmp_path_factory.mktemp("torch-data")), flush_interval_s=0)
    servers = {
        "jax": ServerThread(JServer(jdb, JServerConfig(
            host="127.0.0.1", port=free_port(), enable_metrics_server=False))).start(),
        "torch": ServerThread(Server(tdb, ServerConfig(
            host="127.0.0.1", port=free_port(), enable_metrics_server=False))).start(),
    }
    rows = [{"id": f"v{i}", "vector": v.tolist(), "metadata": md}
            for i, (v, md) in enumerate(zip(vecs, mds))]
    for st in servers.values():
        for name, extra in (("ex", {"engine": "exact"}), ("hy", {"engine_config": HYBRID_CFG})):
            r = requests.post(f"{st.base}/api/v1/collections", json={
                "name": name, "dimension": D_PAR, "distance_function": "euclidean", **extra})
            assert r.status_code == 201, r.text
            r = requests.post(f"{st.base}/api/v1/collections/{name}/vectors/batch",
                              json={"vectors": rows})
            assert r.status_code == 201, r.text
    yield servers, vecs, queries
    for st in servers.values():
        st.stop()


def both(servers, method, path, body=None):
    """(jax response, port response) to the same request."""
    return tuple(requests.request(method, f"{servers[p].base}{path}", json=body)
                 for p in ("jax", "torch"))


def assert_same_results(rj, rt):
    """ids equal position by position, except where the reference's
    distances tie; distances to TOL; vectors and metadata equal."""
    assert len(rj) == len(rt) > 0
    dj = np.array([x["distance"] for x in rj])
    np.testing.assert_allclose([x["distance"] for x in rt], dj, **TOL)
    for j, (a, b) in enumerate(zip(rj, rt)):
        if a["id"] != b["id"]:
            near = [i for i in (j - 1, j + 1) if 0 <= i < len(dj)]
            assert any(abs(dj[i] - dj[j]) <= 1e-5 for i in near), (j, a, b)
        if "vector" in a:
            np.testing.assert_array_equal(b["vector"], a["vector"])
        assert b.get("metadata") == a.get("metadata")
        assert b["score"] == pytest.approx(a["score"], rel=TOL["rtol"], abs=TOL["atol"])


@pytest.mark.parametrize("body", [
    {"top_k": K},
    {"top_k": 5, "options": {"include_vectors": True, "include_metadata": True}},
    {"top_k": K, "filters": [{"field": "cat", "operator": "=", "value": 2}],
     "options": {"include_metadata": True}},
    {"top_k": K, "filters": [{"field": "price", "operator": ">", "value": 25.0},
                             {"field": "price", "operator": "<", "value": 75.0}]},
    {"top_k": K, "filters": [{"field": "tag", "operator": "in", "value": ["t0", "t2"]}]},
    {"top_k": K, "negative_weight": 0.7},
], ids=["plain", "vectors-metadata", "eq-filter", "range-filter", "in-filter", "negative"])
def test_exact_search_parity(pair, body):
    servers, vecs, queries = pair
    for i in range(4):
        req = {"vector": queries[i].tolist(), **body}
        if "negative_weight" in body:
            req["negative_example"] = queries[i + 1].tolist()
        rj, rt = both(servers, "POST", "/api/v1/collections/ex/search", req)
        assert rj.status_code == rt.status_code == 200
        assert_same_results(rj.json()["results"], rt.json()["results"])
        mj, mt = rj.json()["metadata"], rt.json()["metadata"]
        for key in ("total_count", "index_size", "index_name", "strategy"):
            assert mt[key] == mj[key], key


def test_exact_batch_and_facet_parity(pair):
    servers, vecs, queries = pair
    body = {"requests": [{"vector": q.tolist(), "top_k": K} for q in queries[:8]]
            + [{"vector": queries[8].tolist(), "top_k": 3,
                "filters": [{"field": "cat", "operator": "!=", "value": 1}]}]}
    rj, rt = both(servers, "POST", "/api/v1/collections/ex/search/batch", body)
    assert rj.status_code == rt.status_code == 200
    for a, b in zip(rj.json()["responses"], rt.json()["responses"], strict=True):
        assert_same_results(a["results"], b["results"])
    for flt in ([{"type": "equality", "field": "cat", "value": 3}],
                [{"type": "range", "field": "price", "min": 10.0, "max": 40.0}]):
        rj, rt = both(servers, "POST", "/api/v1/collections/ex/search/facets",
                      {"vector": queries[9].tolist(), "top_k": K, "filters": flt})
        assert rj.status_code == rt.status_code == 200
        assert_same_results(rj.json()["results"], rt.json()["results"])


def test_hybrid_recall_parity(pair):
    """The default engine (hybrid over IVF): each package's recall@10
    through single-search POSTs against the exact collection's answers."""
    servers, vecs, queries = pair
    recall = {}
    for pkg, st in servers.items():
        hits = 0
        for q in queries:
            got = requests.post(f"{st.base}/api/v1/collections/hy/search",
                                json={"vector": q.tolist(), "top_k": K})
            truth = requests.post(f"{st.base}/api/v1/collections/ex/search",
                                  json={"vector": q.tolist(), "top_k": K})
            assert got.status_code == truth.status_code == 200
            hits += len({x["id"] for x in got.json()["results"]}
                        & {x["id"] for x in truth.json()["results"]})
        recall[pkg] = hits / (K * len(queries))
    stats = requests.get(f"{servers['torch'].base}/api/v1/collections/hy/stats").json()
    assert stats["engine"]["per_strategy_queries"].get("ivf", 0) > 0, stats
    assert recall["torch"] >= recall["jax"] - 0.02, recall


def test_write_and_stats_parity(pair):
    servers, vecs, queries = pair
    v = queries[0].tolist()
    for method, path, body in (
            ("PUT", "/api/v1/collections/ex/vectors/v5", {"vector": v, "metadata": {"cat": 9}}),
            ("GET", "/api/v1/collections/ex/vectors/v5", None),
            ("DELETE", "/api/v1/collections/ex/vectors/v6", None),
            ("POST", "/api/v1/collections/ex/vectors/batch/delete", {"ids": ["v7", "v8", "zz"]}),
            ("POST", "/api/v1/collections/ex/vectors", {"id": "new", "vector": v})):
        rj, rt = both(servers, method, path, body)
        assert rt.status_code == rj.status_code and rt.json() == rj.json(), (method, path)
    rj, rt = both(servers, "POST", "/api/v1/collections/ex/search", {"vector": v, "top_k": 3})
    assert_same_results(rj.json()["results"], rt.json()["results"])
    rj, rt = both(servers, "GET", "/api/v1/collections/ex/stats")
    for key in ("name", "dimension", "metric", "vector_count", "index"):
        assert rt.json()[key] == rj.json()[key], key
    assert rt.json()["vector_count"] == N_PAR - 2


@pytest.mark.parametrize("method,path,body,status", [
    ("POST", "/api/v1/collections/ex/search", {"vector": [1.0, 2.0]}, 400),
    ("POST", "/api/v1/collections/ex/search",
     {"vector": [0.0] * D_PAR, "filters": [{"field": "cat"}]}, 400),
    ("POST", "/api/v1/collections/ex/search", {"top_k": 3}, 400),
    ("POST", "/api/v1/collections/ex/search/batch", {"requests": []}, 400),
    ("POST", "/api/v1/collections", {"name": "bad", "dimension": -1}, 400),
    ("POST", "/api/v1/collections", {"name": "ex", "dimension": D_PAR}, 400),
    ("GET", "/api/v1/collections/nope", None, 404),
    ("POST", "/api/v1/collections/nope/search", {"vector": [0.0] * D_PAR}, 404),
    ("GET", "/api/v1/collections/ex/vectors/missing", None, 404),
    ("DELETE", "/api/v1/collections/ex/vectors/missing", None, 404),
], ids=["dim-mismatch", "malformed-filter", "no-vector", "empty-batch", "bad-dimension",
        "duplicate", "no-collection", "search-no-collection", "no-vector-id", "delete-missing"])
def test_error_parity(pair, method, path, body, status):
    servers, _, _ = pair
    rj, rt = both(servers, method, path, body)
    assert rj.status_code == rt.status_code == status
    assert rt.json() == rj.json()


def test_auth_and_rate_limit_parity():
    """401 without a token and the rate limiter's 429: the same bodies from
    both packages' servers. The order of the two depends on the clock in
    both (a new client's bucket is made after ``allow`` reads the time, so
    at capacity 1 its first request may be refused), so each server is
    asked until it has given both."""
    cfg = dict(host="127.0.0.1", enable_metrics_server=False, enable_auth=True,
               jwt_secret="s3cret", rate_limit=0.0001)
    servers = {
        "jax": ServerThread(JServer(JDB(JDBOptions(enable_persistence=False)),
                                    JServerConfig(port=free_port(), **cfg))).start(),
        "torch": ServerThread(Server(port_db(enable_persistence=False),
                                     ServerConfig(port=free_port(), **cfg))).start(),
    }
    try:
        bodies = {}
        for pkg, st in servers.items():
            seen = bodies[pkg] = {}
            for _ in range(6):
                r = requests.get(f"{st.base}/api/v1/collections")
                seen.setdefault(r.status_code, r.json())
        assert set(bodies["jax"]) == {401, 429}
        assert bodies["torch"] == bodies["jax"]
    finally:
        for st in servers.values():
            st.stop()


def test_hnsw_engine_is_501_on_the_port(pair):
    """Both servers serve HNSW now: an ``engine: "hnsw"`` collection and a
    hybrid with an ``hnsw`` block answer create (201), insert and search
    (200) on both, with the same top hit for each query (at this size each
    query's own row is its top hit in both). The sharded kinds, once 501
    on the port, answer as the reference's: a ``sharded_ivf`` collection
    is created (201), takes rows (201) and answers searches (200) with
    the same top hit on both servers."""
    servers, vecs, queries = pair
    n = 400
    rows = [{"id": f"v{i}", "vector": v.tolist()} for i, v in enumerate(vecs[:n])]
    graph = {"build_batch": 512}  # one build batch, the same shapes in both collections
    for name, extra in (
            ("graph", {"engine": "hnsw", "engine_config": {"hnsw": graph}}),
            ("graph2", {"engine": "hybrid", "engine_config": {
                "hnsw": graph,
                "adaptive": {"exploration_factor": 0.0, "initial_exact_threshold": 10}}})):
        body = {"name": name, "dimension": D_PAR, "distance_function": "euclidean", **extra}
        rj, rt = both(servers, "POST", "/api/v1/collections", body)
        assert rj.status_code == rt.status_code == 201, (rj.text, rt.text)
        rj, rt = both(servers, "POST", f"/api/v1/collections/{name}/vectors/batch",
                      {"vectors": rows})
        assert rj.status_code == rt.status_code == 201
        for b in range(8):
            rj, rt = both(servers, "POST", f"/api/v1/collections/{name}/search",
                          {"vector": vecs[b].tolist(), "top_k": K})
            assert rj.status_code == rt.status_code == 200
            assert rt.json()["results"][0]["id"] == rj.json()["results"][0]["id"] == f"v{b}"
    stats = requests.get(f"{servers['torch'].base}/api/v1/collections/graph2/stats").json()
    assert stats["engine"]["per_strategy_queries"].get("hnsw", 0) > 0, stats
    body = {"name": "sharded", "dimension": D_PAR, "distance_function": "euclidean",
            "engine": "sharded_ivf"}
    rj, rt = both(servers, "POST", "/api/v1/collections", body)
    assert rj.status_code == rt.status_code == 201, (rj.text, rt.text)
    rj, rt = both(servers, "POST", "/api/v1/collections/sharded/vectors/batch", {"vectors": rows})
    assert rj.status_code == rt.status_code == 201
    for b in range(4):
        rj, rt = both(servers, "POST", "/api/v1/collections/sharded/search",
                      {"vector": vecs[b].tolist(), "top_k": K})
        assert rj.status_code == rt.status_code == 200
        assert rt.json()["results"][0]["id"] == rj.json()["results"][0]["id"] == f"v{b}"
    listed = requests.get(f"{servers['torch'].base}/api/v1/collections").json()["collections"]
    assert "sharded" in listed


def test_ivf_einsum_collection_on_both_servers(pair):
    """An IVF collection whose ``engine_config`` selects
    ``formulation: "einsum"`` (once 501 on the port) answers create (201),
    insert (201) and search (200) on both servers with the same results."""
    servers, vecs, queries = pair
    cfg = {"n_clusters": 16, "n_probe": 3, "build_threshold": 512, "formulation": "einsum"}
    body = {"name": "einsum", "dimension": D_PAR, "distance_function": "euclidean",
            "engine": "ivf", "engine_config": cfg}
    rj, rt = both(servers, "POST", "/api/v1/collections", body)
    assert rj.status_code == rt.status_code == 201, (rj.text, rt.text)
    rows = [{"id": f"v{i}", "vector": v.tolist()} for i, v in enumerate(vecs)]
    rj, rt = both(servers, "POST", "/api/v1/collections/einsum/vectors/batch", {"vectors": rows})
    assert rj.status_code == rt.status_code == 201
    for q in queries[:16]:
        rj, rt = both(servers, "POST", "/api/v1/collections/einsum/search",
                      {"vector": q.tolist(), "top_k": K})
        assert rj.status_code == rt.status_code == 200, (rj.text, rt.text)
        assert_same_results(rj.json()["results"], rt.json()["results"])
    engine = servers["torch"].server.db.get_collection("einsum").engine
    assert engine.name == "ivf" and engine._built and engine.config.formulation == "einsum"
