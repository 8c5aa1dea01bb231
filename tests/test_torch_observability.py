"""The port's observability (``quiver_tpu_torch/observability/``,
``utils/profiling.py``) held to the JAX package's, with the 8 scenarios of
tests/test_observability.py run through both packages on the same inputs:
the latency ring's percentiles and its window, search counts and QPS, the
Prometheus text, the disable gate, the JSON log record, span nesting and
timing (with the port's ``trace_span``, which also marks a
``torch.profiler`` range while a profiler runs, and costs no range and no
uuid when nothing listens), and idempotent logger handlers.

The two packages must give equal stats dicts and equal Prometheus sample
sets (names, labels, values; the clock-dependent QPS and time fields
aside), and JSON records with the same keys and values but the logger's
name and the time.
"""

import json
import logging as std_logging

import pytest
import torch

from quiver_tpu.observability import logging as jlog
from quiver_tpu.observability import metrics as jmet
from quiver_tpu_torch.observability import logging as tlog
from quiver_tpu_torch.observability import metrics as tmet
from quiver_tpu_torch.utils import profiling as tprof

PKGS = [pytest.param((jmet, jlog), id="jax"), pytest.param((tmet, tlog), id="torch")]


def both(fn):
    """fn(metrics module, logging module) for each package -> (jax, torch)."""
    return fn(jmet, jlog), fn(tmet, tlog)


def test_port_latency_ring_percentiles_and_window():
    def ring(met, _):
        r = met._LatencyRing(size=100)
        for i in range(1, 101):
            r.record(float(i))
        w = met._LatencyRing(size=10)
        for i in range(25):
            w.record(1000.0 if i < 15 else 1.0)
        return r.stats(), w.stats()

    (jr, jw), (tr, tw) = both(ring)
    assert tr == jr and tw == jw
    assert tr["count"] == 100 and tr["avg_ms"] == pytest.approx(50.5)
    assert tr["p50_ms"] == pytest.approx(50, abs=2) and tr["p99_ms"] == pytest.approx(99, abs=2)
    assert tw["count"] == 10 and tw["avg_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_port_search_stats_and_qps(pkg):
    met, _ = pkg
    m = met.Metrics()
    m.enable()
    for _ in range(5):
        m.record_search("docs", 2.0, stages={"traversal": 1.5})
    st = m.latency_stats("docs")
    assert st["count"] == 5 and st["avg_ms"] == pytest.approx(2.0)
    assert m.current_qps(window_s=60.0) > 0
    assert "docs" in json.dumps(m.summary())


def _samples(text: bytes) -> dict:
    """Prometheus sample lines -> {name{labels}: value}, clock-free."""
    out = {}
    for line in text.decode().splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        assert name, line
        if "qps" in name or "timestamp" in name or "_created" in name:
            continue
        out[name] = float(value)
    return out


def test_port_prometheus_text_matches_reference():
    def text(met, _):
        m = met.Metrics()
        m.enable()
        m.record_search("docs", 1.0)
        m.record_insert("docs", 0.5, n=4)
        m.record_error("docs", "search")
        m.set_index_size("docs", 42, nbytes=1024)
        return m.prometheus_text()

    jt, tt = both(text)
    for needle in (b"quiver_search_duration_ms", b"quiver_index_size"):
        assert needle in tt
    assert _samples(tt) == _samples(jt)
    helps = [line for line in tt.decode().splitlines() if line.startswith("# TYPE")]
    assert helps == [line for line in jt.decode().splitlines() if line.startswith("# TYPE")]


def test_port_disable_gate():
    def gate(met, _):
        m = met.Metrics()
        m.enable(False)
        m.record_search("docs", 1.0)
        off = m.latency_stats("docs")["count"]
        m.enable(True)
        m.record_search("docs", 1.0)
        return off, m.latency_stats("docs")["count"]

    assert both(gate) == ((0, 1), (0, 1))


def test_port_json_log_format():
    def fmt(_, log):
        rec = std_logging.LogRecord("quiver", std_logging.INFO, __file__, 1, "hello", None, None)
        rec.fields = {"collection": "docs", "n": 3}
        return json.loads(log.JSONFormatter().format(rec))

    jo, to = both(fmt)
    assert to["msg"] == "hello" and to["level"].lower() == "info"
    assert to["collection"] == "docs" and to["n"] == 3 and "time" in to and "source" in to
    assert set(to) == set(jo)
    assert {k: v for k, v in to.items() if k != "time"} == {
        k: v for k, v in jo.items() if k != "time"}


@pytest.mark.parametrize("pkg", PKGS)
def test_port_tracer_spans_nest_and_time(pkg):
    _, log = pkg
    t = log.Tracer(enabled=True)
    with t.span("outer", a=1) as s:
        s.set(b=2)
        with t.span("inner"):
            pass
    assert t.start_span("solo").end() >= 0.0


def test_port_trace_span_marks_a_profiler_range():
    def work():
        with tprof.trace_span("quiver_inner"):
            return torch.ones(4).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.trace_span("quiver_outer", n=1):
            work()
    names = {e.name for e in prof.events()}
    assert {"quiver_outer", "quiver_inner"} <= names


def test_port_trace_span_makes_no_range_and_no_uuid_when_nothing_listens(monkeypatch):
    import uuid

    def refuse(*a, **kw):
        raise AssertionError("called with the tracer off and no profiler")

    monkeypatch.setattr(uuid, "uuid4", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(tlog, "_range", refuse)
    assert not tlog.global_tracer().enabled and not torch.autograd._profiler_enabled()
    with tprof.trace_span("quiver_quiet", 3) as outer:
        with tprof.trace_span("quiver_quiet_inner", collection="docs"):
            pass
    assert outer.end() >= 0.0
    got = tlog.global_tracer().spans(names=["quiver_quiet", "quiver_quiet_inner"],
                                     lo=outer.start)
    assert list(got["name"]) == ["quiver_quiet_inner", "quiver_quiet"]


@pytest.mark.parametrize("pkg", PKGS)
def test_port_get_logger_idempotent_handlers(pkg):
    _, log = pkg
    l1, l2 = log.get_logger(), log.get_logger()
    assert l1 is l2 and len(l1.handlers) == len(l2.handlers)
    assert l1.name == ("quiver_tpu_torch" if log is tlog else "quiver_tpu")
