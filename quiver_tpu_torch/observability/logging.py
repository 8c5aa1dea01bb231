"""Structured JSON logging + span tracing.

Parity with the reference's slog JSON logger with atomic level and source
annotation (reference: pkg/observability/logging.go:24-109) and its
Tracer/Span tracing (logging.go:111-247), under the port's own logger name.

Beyond the reference, the port's :class:`Tracer` keeps every span it ends
in a ring of fixed size (:meth:`Tracer.spans`), whether or not it logs
them: a benchmark or an operator reads the program's own phases from it
after the fact. A span also marks a ``torch.profiler`` range while a
profiler runs, so a device trace shows it beside the kernels it enqueued.
``utils.profiling.trace_span`` opens spans on the global tracer.
"""

from __future__ import annotations

import array
import itertools
import json
import logging
import sys
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


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


#: the spans' clock, the one ``torch.profiler`` traces are mapped onto
_clock = time.perf_counter
_profiling = torch.autograd._profiler_enabled
#: a span's profiler range: a host-side range of the profiler's function
#: scope. ``torch.profiler.record_function`` opens a user-scope range, for
#: which the profiler also draws an annotation on the device's timeline
#: over the kernels it launched, and a device trace would count that
#: annotation as device activity
_range = torch._C._profiler._RecordFunctionFast

#: spans the global tracer's ring holds before the oldest are dropped
RING_SPANS = 131_072
#: the ring's columns: (name, array typecode, initial value); 60 bytes a
#: span. ``seq`` (the order spans ended in) is written last, so a row is
#: whole once its ``seq`` is set
_COLUMNS = (
    ("id", "q", 0), ("parent", "q", -1), ("root", "q", 0),
    ("start", "d", 0.0), ("end", "d", 0.0),
    ("name", "i", 0), ("thread", "i", 0), ("n", "i", 0), ("seq", "q", -1),
)


class Span:
    """A traced operation (reference Span, logging.go:111-180), open from
    its construction to :meth:`end` (or the end of its ``with`` block), on
    one thread. ``n`` is the work it covers (queries, rows), settable while
    it is open."""

    __slots__ = ("tracer", "name", "n", "fields", "span_id", "parent_id", "trace_id",
                 "start", "stop", "_range", "_opened")

    def __init__(self, tracer: "Tracer", name: str, n: int = 0,
                 fields: Optional[dict] = None):
        self.tracer = tracer
        self.name = name
        self.n = n
        self.fields = fields if tracer.enabled else None
        self.stop = None
        self._opened = opened = tracer._opened
        stack = opened.stack
        self.span_id = sid = next(tracer._ids)
        if stack:
            top = stack[-1]
            self.parent_id, self.trace_id = top.span_id, top.trace_id
        else:
            self.parent_id, self.trace_id = -1, sid
        stack.append(self)
        if _profiling():
            self._range = _range(name)
            self._range.__enter__()
        else:
            self._range = None
        self.start = _clock()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        if self.stop is None:
            self._close()

    def set(self, **fields: Any) -> "Span":
        if self.tracer.enabled:
            self.fields = dict(self.fields or (), **fields)
        return self

    @property
    def seconds(self) -> float:
        """Its duration; up to now while it is open."""
        return (self.stop if self.stop is not None else _clock()) - self.start

    def end(self) -> float:
        """Close the span (once): its ms."""
        if self.stop is None:
            self._close()
        return (self.stop - self.start) * 1e3

    def _close(self) -> None:
        """Stop the clock, leave the thread's stack and write the ring's row
        (and the log line when the tracer is enabled)."""
        self.stop = stop = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        opened = self._opened
        stack = opened.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        tr = self.tracer
        nid = tr._name_ids.get(self.name)
        if nid is None:
            nid = tr._intern(self.name)
        ring = tr._ring
        seq = next(tr._seq)
        i = seq % tr.capacity
        ring.id[i] = self.span_id
        ring.parent[i] = self.parent_id
        ring.root[i] = self.trace_id
        ring.start[i] = self.start
        ring.end[i] = stop
        ring.name[i] = nid
        ring.thread[i] = opened.thread
        ring.n[i] = self.n
        ring.seq[i] = seq
        if tr.enabled:
            debug(
                "span",
                span=self.name,
                trace_id=self.trace_id,
                span_id=self.span_id,
                parent_id=self.parent_id,
                n=self.n,
                duration_ms=round((stop - self.start) * 1e3, 3),
                **(self.fields or {}),
            )


class _Opened(threading.local):
    """The spans open on one thread, innermost last, and its native id."""

    def __init__(self):
        self.stack: list = []
        self.thread = threading.get_native_id()


class _Ring:
    """The ring's preallocated columns, one ``array.array`` each."""

    def __init__(self, capacity: int):
        for col, typecode, init in _COLUMNS:
            setattr(self, col, array.array(typecode, [init]) * capacity)


class Tracer:
    """Span tracer (reference Tracer, logging.go:182-247).

    Every span that ends is written to a ring of ``capacity`` rows: its id
    (a counter, in the order spans opened), its parent's id (-1 for none),
    its root's id (the outermost span open on its thread when it opened, so
    all spans of one top-level call share it), start and end on
    ``time.perf_counter()``, its name, thread (the native id) and ``n``.
    When the ring is full the oldest rows are overwritten (``dropped``
    counts them). ``enabled`` (off by default) also logs each span as a
    JSON debug line."""

    def __init__(self, enabled: bool = False, capacity: int = RING_SPANS):
        if capacity < 1:
            raise ValueError("capacity must be positive")
        self.enabled = enabled
        self.capacity = capacity
        self._ids = itertools.count()
        self._opened = _Opened()
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        """Empty the ring (spans still open are written when they end)."""
        with self._lock:
            self._ring = _Ring(self.capacity)
            self._seq = itertools.count()

    def _columns(self) -> dict:
        return {col: getattr(self._ring, col) for col, _, _ in _COLUMNS}

    @property
    def nbytes(self) -> int:
        """Bytes the ring's columns hold."""
        return sum(len(a) * a.itemsize for a in self._columns().values())

    def start_span(self, name: str, n: int = 0) -> Span:
        return Span(self, name, n)

    def span(self, name: str, n: int = 0, **fields) -> Span:
        """A span for a ``with`` block."""
        return Span(self, name, n, fields)

    def _intern(self, name: str) -> int:
        with self._lock:
            if name not in self._name_ids:
                self._name_ids[name] = len(self._names)
                self._names.append(name)
            return self._name_ids[name]

    @property
    def dropped(self) -> int:
        """Spans overwritten since the last :meth:`clear`."""
        seq = np.frombuffer(self._ring.seq, np.int64)
        return max(0, int(seq.max()) + 1 - self.capacity)

    def spans(self, names=None, lo: Optional[float] = None,
              hi: Optional[float] = None) -> dict:
        """The ring's spans named in ``names`` (all by default) that started
        in [lo, hi], in the order they ended: a dict of equal-length numpy
        columns ``id``, ``parent``, ``root``, ``start``, ``end``, ``thread``,
        ``n`` and ``name`` (strings). Spans still open are not in it."""
        cols = {c: np.frombuffer(a, a.typecode).copy() for c, a in self._columns().items()}
        keep = cols["seq"] >= 0
        if names is not None:
            keep &= np.isin(cols["name"], [self._name_ids[x] for x in names
                                           if x in self._name_ids])
        if lo is not None:
            keep &= cols["start"] >= lo
        if hi is not None:
            keep &= cols["start"] <= hi
        order = np.argsort(cols.pop("seq")[keep], kind="stable")
        out = {c: a[keep][order] for c, a in cols.items()}
        out["name"] = np.asarray(self._names, object)[out["name"]]
        return out


_global_tracer = Tracer()


def global_tracer() -> Tracer:
    return _global_tracer
