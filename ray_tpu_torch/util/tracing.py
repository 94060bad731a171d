"""Tracing: user spans and explicit span emission, process-local.

The engine's part of the reference package's tracing module: an ambient
trace context (`span()` opens a span under it, `capture_context()` reads
it at request submission), `emit_span()` for background threads that emit
phase spans against a captured context, and `traces()` over this process's
finished spans. The reference's task-span assembly from its actor runtime
is not part of the port: there is no runtime here yet.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random as _random
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Span/trace ids need uniqueness, not unpredictability: one urandom seed,
# then PRNG draws (uuid4 per call is too slow for per-request emission).
# Re-seeded after fork so a child never mints the parent's id stream.
_ID_RNG = _random.Random(uuid.uuid4().int)
_ID_LOCK = threading.Lock()

if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _ID_RNG.seed(uuid.uuid4().int))


def _fast_id() -> str:
    with _ID_LOCK:
        return f"{_ID_RNG.getrandbits(64):016x}"


_ambient: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_trace", default=None
)


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: str

    def as_tuple(self) -> tuple:
        return (self.trace_id, self.span_id)


def capture_context() -> Optional[tuple]:
    """The (trace_id, span_id) to parent new spans under, or None when
    nothing is being traced here (the caller becomes a trace root)."""
    ctx = _ambient.get()
    return ctx.as_tuple() if ctx is not None else None


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_span_id: Optional[str]
    name: str
    start_s: float
    end_s: Optional[float] = None
    kind: str = "user"
    attributes: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "start_s": self.start_s,
            "end_s": self.end_s,
            "duration_s": (self.end_s - self.start_s) if self.end_s else None,
            "kind": self.kind,
            "attributes": dict(self.attributes),
        }


class SpanBuffer:
    """Process-local bounded store of finished spans."""

    def __init__(self, capacity: int = 10_000):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._capacity = capacity

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._capacity:
                self._spans = self._spans[-self._capacity:]

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)


_buffer = SpanBuffer()


@contextlib.contextmanager
def span(name: str, attributes: Optional[dict] = None):
    """Open a span under the ambient context; requests submitted inside it
    are parented to it."""
    parent = _ambient.get()
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = _fast_id(), None
    record = Span(
        trace_id=trace_id,
        span_id=_fast_id(),
        parent_span_id=parent_id,
        name=name,
        start_s=time.time(),
        attributes=dict(attributes or {}),
    )
    token = _ambient.set(TraceContext(trace_id, record.span_id))
    try:
        yield record
    finally:
        _ambient.reset(token)
        record.end_s = time.time()
        _buffer.add(record)


def new_span_id() -> str:
    return _fast_id()


def emit_span(
    name: str,
    start_s: float,
    end_s: float,
    *,
    parent: Optional[tuple] = None,
    trace_id: Optional[str] = None,
    parent_span_id: Optional[str] = None,
    span_id: Optional[str] = None,
    attributes: Optional[dict] = None,
) -> Span:
    """Record a finished span with an EXPLICIT context instead of the
    ambient one: the emission path for the engine's step-loop thread,
    which runs outside any caller's context. The engine captures
    `capture_context()` once at request submission and later emits phase
    spans against it.

    `parent` is a (trace_id, span_id) tuple as returned by
    `capture_context()`; `trace_id`/`parent_span_id` override it piecewise.
    With neither, the span becomes its own trace root."""
    if parent is not None:
        trace_id = trace_id or parent[0]
        if parent_span_id is None:
            parent_span_id = parent[1]
    record = Span(
        trace_id=trace_id or _fast_id(),
        span_id=span_id or _fast_id(),
        parent_span_id=parent_span_id,
        name=name,
        start_s=start_s,
        end_s=end_s,
        attributes=dict(attributes or {}),
    )
    _buffer.add(record)
    return record


def traces(trace_id: Optional[str] = None) -> List[dict]:
    """Finished spans recorded in this process, oldest first, optionally
    of one trace."""
    rows = [s.to_dict() for s in _buffer.snapshot()]
    if trace_id is not None:
        rows = [r for r in rows if r["trace_id"] == trace_id]
    rows.sort(key=lambda r: r["start_s"])
    return rows
