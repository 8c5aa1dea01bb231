"""Structured JSON logging + log-based span tracing.

Parity with the reference's slog JSON logger with atomic level and source
annotation (reference: pkg/observability/logging.go:24-109) and its
Tracer/Span log-based tracing (logging.go:111-247). A copy of
``quiver_tpu/observability/logging.py`` for the PyTorch port, under its own
logger name; device timelines come from ``torch.profiler`` traces, where
``utils.profiling.trace_span`` marks the same spans.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Optional


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "time": self.formatTime(record, "%Y-%m-%dT%H:%M:%S%z"),
            "level": record.levelname,
            "msg": record.getMessage(),
            "source": f"{record.module}:{record.lineno}",
        }
        extra = getattr(record, "fields", None)
        if extra:
            entry.update(extra)
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, default=str)


_LOGGER_NAME = "quiver_tpu_torch"
_setup_lock = threading.Lock()
_configured = False


def get_logger() -> logging.Logger:
    global _configured
    with _setup_lock:
        logger = logging.getLogger(_LOGGER_NAME)
        if not _configured:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(JSONFormatter())
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            logger.propagate = False
            _configured = True
        return logger


def set_level(level: str) -> None:
    get_logger().setLevel(level.upper())


def log(level: str, msg: str, **fields: Any) -> None:
    get_logger().log(
        logging.getLevelName(level.upper()), msg, extra={"fields": fields}
    )


def debug(msg: str, **fields):
    log("debug", msg, **fields)


def info(msg: str, **fields):
    log("info", msg, **fields)


def warn(msg: str, **fields):
    log("warning", msg, **fields)


def error(msg: str, **fields):
    log("error", msg, **fields)


class Span:
    """A traced operation (reference Span, logging.go:111-180)."""

    def __init__(self, tracer: "Tracer", name: str, trace_id: str):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.start = time.perf_counter()
        self.fields: dict[str, Any] = {}

    def set(self, **fields: Any) -> "Span":
        self.fields.update(fields)
        return self

    def end(self) -> float:
        ms = (time.perf_counter() - self.start) * 1e3
        if self.tracer.enabled:
            debug(
                "span",
                span=self.name,
                trace_id=self.trace_id,
                span_id=self.span_id,
                duration_ms=round(ms, 3),
                **self.fields,
            )
        return ms


class Tracer:
    """Log-based tracer (reference Tracer, logging.go:182-247); disabled by
    default."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled

    def start_span(self, name: str, trace_id: Optional[str] = None) -> Span:
        return Span(self, name, trace_id or uuid.uuid4().hex[:16])

    @contextmanager
    def span(self, name: str, **fields):
        s = self.start_span(name).set(**fields)
        try:
            yield s
        finally:
            s.end()


_global_tracer = Tracer()


def global_tracer() -> Tracer:
    return _global_tracer
