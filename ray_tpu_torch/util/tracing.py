"""Distributed tracing: task-span propagation + user spans.

Reference: ray/util/tracing/tracing_helper.py:289,322 — OpenTelemetry
contexts are serialized into task metadata on submit and re-entered around
execution, so spans nest across process boundaries. The sealed image has no
opentelemetry, so this is the same propagation contract on a lean native
span model:

  * every task IS a span: span_id derives from the task id, the parent is
    the ambient span (enclosing task or user span) at submission, and the
    trace_id flows through TaskSpec.trace_ctx across workers and nodes;
  * `with tracing.span("name"):` opens a user span under the ambient one —
    inside tasks too (the worker re-enters the task's context before user
    code runs);
  * task spans are assembled head-side from the task-event buffer (state
    transitions already carry start/end/node); user spans record into a
    process-local buffer. `traces()` merges both views.
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

# Span/trace ids need uniqueness, not unpredictability; uuid4 reads
# /dev/urandom per call (tens of µs on some kernels), which is too slow for
# per-round/per-request emission paths. One urandom seed, then PRNG draws.
# Re-seeded after fork (same hazard as _private/ids.py): a forked child
# inheriting the parent's PRNG state would mint the parent's exact id stream.
_ID_RNG = _random.Random(uuid.uuid4().int)
_ID_LOCK = threading.Lock()

if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _ID_RNG.seed(uuid.uuid4().int))


def _fast_id() -> str:
    with _ID_LOCK:
        return f"{_ID_RNG.getrandbits(64):016x}"

_ambient: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace", default=None
)
# Task id (bytes) whose execution context this is — span ownership for the
# worker's per-task drain (set by activate_task, never by user spans).
_ambient_task: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace_task", default=None
)


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: str

    def as_tuple(self) -> tuple:
        return (self.trace_id, self.span_id)


def task_span_id(task_id) -> str:
    """Stable span id for a task (reused on retries: a retry is the same
    logical span re-executed)."""
    return task_id.hex()[:16]


def capture_context() -> Optional[tuple]:
    """The (trace_id, span_id) to parent a new task under, or None when
    nothing is being traced here (the submission becomes a trace root)."""
    ctx = _ambient.get()
    return ctx.as_tuple() if ctx is not None else None


def activate_task(spec):
    """Enter a task's trace context around its execution (the execution-side
    half of tracing_helper's _inject/_extract pair). The task's own span id
    becomes the ambient parent for everything inside. Also pins the ambient
    task identity so spans opened here are attributed to THIS task when a
    worker ships them home (concurrent tasks in one worker must not leak
    spans into each other's done frames)."""
    trace_ctx = getattr(spec, "trace_ctx", None)
    trace_id = trace_ctx[0] if trace_ctx else task_span_id(spec.task_id)
    return (
        _ambient.set(TraceContext(trace_id, task_span_id(spec.task_id))),
        _ambient_task.set(spec.task_id.binary()),
    )


def deactivate(token) -> None:
    try:
        if isinstance(token, tuple):
            _ambient.reset(token[0])
            _ambient_task.reset(token[1])
        else:
            _ambient.reset(token)
    except Exception:
        pass


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_span_id: Optional[str]
    name: str
    start_s: float
    end_s: Optional[float] = None
    kind: str = "user"  # "user" | "task"
    attributes: Dict[str, Any] = field(default_factory=dict)
    # Task (id bytes) whose execution context opened this span; selects which
    # task's done frame carries it home. None for driver-/background spans.
    owner_task: Optional[bytes] = None

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
    """Process-local bounded store of finished user spans."""

    def __init__(self, capacity: int = 10_000):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._capacity = capacity

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._capacity:
                self._spans = self._spans[-self._capacity:]

    def drain(self, owner: Optional[bytes] = None) -> List[Span]:
        """Pop finished spans; with `owner`, only that task's spans leave the
        buffer (other tasks' spans await their own done frames). Ownerless
        spans (helper threads, anything outside a task context) ride with
        whichever done frame drains first — they match no task, and
        stranding them here would drop them from head-side traces."""
        with self._lock:
            if owner is None:
                out, self._spans = self._spans, []
                return out
            take = lambda s: s.owner_task == owner or s.owner_task is None
            out = [s for s in self._spans if take(s)]
            self._spans = [s for s in self._spans if not take(s)]
            return out

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)


_buffer = SpanBuffer()


@contextlib.contextmanager
def span(name: str, attributes: Optional[dict] = None):
    """Open a user span under the ambient context (task or enclosing span);
    new tasks submitted inside it are parented to it."""
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
        owner_task=_ambient_task.get(),
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
    ambient one. This is the emission path for background threads that run
    outside any task context (e.g. the LLM engine step loop): the component
    captures `capture_context()` once at request submission and later emits
    phase spans against it from whatever thread does the work, with no
    contextvar churn and no allocation until the phase actually ends.

    `parent` is a (trace_id, span_id) tuple as returned by
    `capture_context()`; `trace_id`/`parent_span_id` override it piecewise
    (pass `parent_span_id` to chain emitted spans under each other). With
    neither, the span becomes its own trace root."""
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
        owner_task=_ambient_task.get(),
    )
    _buffer.add(record)
    return record


def local_spans() -> List[dict]:
    """Finished user spans recorded in THIS process."""
    return [s.to_dict() for s in _buffer.snapshot()]


def chrome_spans(runtime=None) -> List[dict]:
    """Buffered tracing spans as chrome-trace events, one pid row group per
    trace so serving (`llm.*`) and training (`train.*`) spans land on the
    same timeline as the task events (`ray_tpu_torch.timeline()` merges both).
    Task-kind spans are excluded — the task-event buffer already renders
    those rows; duplicating them would double every task.

    Each trace's pid row carries a `process_name` metadata event naming it
    after the trace's ROOT span (e.g. `llm.request`, `train.step`) so the
    timeline reads as labeled request/step groups instead of bare trace-id
    prefixes. For a single request's connected cross-actor view with flow
    events, use `ray_tpu_torch.timeline(filename, trace_id=...)`
    (observability.perfetto)."""
    rows: List[dict] = []
    # trace pid -> (root-most span name, earliest start) for labeling.
    roots: dict = {}
    for s in traces(runtime=runtime):
        if s.get("kind") != "user" or s.get("end_s") is None:
            continue
        pid = f"trace:{s['trace_id'][:8]}"
        root = roots.get(pid)
        if (
            root is None
            or (s.get("parent_span_id") is None and root[2] is not None)
            or (
                (s.get("parent_span_id") is None) == (root[2] is None)
                and s["start_s"] < root[1]
            )
        ):
            roots[pid] = (s["name"], s["start_s"], s.get("parent_span_id"))
        rows.append(
            {
                "cat": "span",
                "name": s["name"],
                "ph": "X",
                "ts": s["start_s"] * 1e6,
                "dur": max(0.0, s["end_s"] - s["start_s"]) * 1e6,
                "pid": f"trace:{s['trace_id'][:8]}",
                "tid": s["name"],
                "args": {
                    "span_id": s["span_id"],
                    "parent_span_id": s["parent_span_id"],
                    "trace_id": s["trace_id"],
                    **(s.get("attributes") or {}),
                },
            }
        )
    for pid, (name, _start, _parent) in roots.items():
        rows.append(
            {
                "ph": "M",
                "cat": "__metadata",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"{name} ({pid})"},
            }
        )
    return rows


def traces(trace_id: Optional[str] = None, runtime=None) -> List[dict]:
    """All spans the head can see: task spans assembled from the task-event
    buffer (cross-node — events flow back with task completion), user spans
    workers shipped with their results, and this process's local user
    spans. Filterable by trace_id. In a worker (or before init) this
    degrades to the process-local user spans."""
    rows: List[dict] = []
    if runtime is None:
        try:
            from ray_tpu_torch._private.runtime import get_runtime

            runtime = get_runtime()
        except Exception:
            runtime = None
    events = getattr(runtime, "task_events", None)
    if events is not None and hasattr(events, "list_events"):
        for ev in events.list_events():
            start = ev.state_times.get("RUNNING") or ev.state_times.get(
                "PENDING_NODE_ASSIGNMENT"
            )
            end = ev.state_times.get("FINISHED") or ev.state_times.get("FAILED")
            if start is None:
                continue
            rows.append(
                Span(
                    trace_id=getattr(ev, "trace_id", "") or task_span_id(ev.task_id),
                    span_id=task_span_id(ev.task_id),
                    parent_span_id=getattr(ev, "parent_span_id", None),
                    name=ev.name,
                    start_s=start,
                    end_s=end,
                    kind="task",
                    attributes={
                        "state": ev.state,
                        "node_id": ev.node_id.hex() if ev.node_id else None,
                        "task_id": ev.task_id.hex(),
                    },
                ).to_dict()
            )
    remote = getattr(runtime, "user_spans", None)
    if remote:
        rows.extend(dict(r) for r in list(remote))
    rows.extend(local_spans())
    if trace_id is not None:
        rows = [r for r in rows if r["trace_id"] == trace_id]
    rows.sort(key=lambda r: r["start_s"])
    return rows
