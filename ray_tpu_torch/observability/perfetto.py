"""Perfetto/Chrome-trace export of one request's connected timeline.

`ray_tpu_torch.timeline()` already dumps the whole cluster's task events as a
chrome-trace array; this module is the per-request view: given a
trace_id (e.g. captured from a `tracing.span()` around one serve handle
call), it gathers every span of that trace — the handle's `serve.retry`
attempts, router/ingress task spans, the replica's
`serve.replica.request`/`serve.replica.stream` spans, and the engine's
`llm.queue`/`llm.prefill`/`llm.decode`/`llm.preempt`/`llm.request`
phase spans — and renders a single Perfetto-loadable JSON object
(`{"traceEvents": [...]}`) where:

- each actor/component gets its OWN process row (synthetic integer pid
  + `process_name`/`process_sort_index` metadata events), so the
  request reads top-to-bottom as handle → router → ingress → engine;
- each span name gets a thread row within its process (synthetic tid +
  `thread_name` metadata);
- parent→child links that CROSS process rows become flow events
  (`ph:"s"` at the parent slice, `ph:"f", bp:"e"` at the child), the
  arrows that stitch the cross-actor span ids into one visible request
  path — retries, preemptions, and chunked prefills included.

Load the output at https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.util import tracing

# Process-row labels in display order (process_sort_index).
_ROW_ORDER = (
    "serve.handle",
    "serve.router",
    "serve.replica",
    "llm.engine",
    "train",
    "driver",
)


def _row_label(span: dict) -> str:
    """Which process row a span belongs on — the actor/component that
    executed it, recovered from the span's name (user spans follow the
    `<component>.<phase>` convention) or, for task spans, the actor
    class the task ran on."""
    name = span.get("name") or ""
    if span.get("kind") == "task":
        # Task names are "ActorClass.method" (or a bare function name for
        # stateless tasks): group by the executing actor.
        head = name.split(".", 1)[0]
        if "Router" in head:
            return "serve.router"
        if "Replica" in head:
            return "serve.replica"
        return f"actor:{head}" if head else "driver"
    if name == "serve.retry" or name.startswith("serve.handle"):
        return "serve.handle"
    if name.startswith("serve.router"):
        return "serve.router"
    if name.startswith("serve.replica"):
        return "serve.replica"
    if name.startswith("llm."):
        return "llm.engine"
    if name.startswith("train."):
        return "train"
    return "driver"


def _sort_index(label: str) -> int:
    try:
        return _ROW_ORDER.index(label)
    except ValueError:
        return len(_ROW_ORDER)


def perfetto_trace(
    trace_id: Optional[str] = None, runtime=None
) -> dict:
    """Render the trace's spans as a Perfetto-loadable trace object.

    With `trace_id=None` every buffered trace is exported (rows then
    group all traffic per component — useful, but the per-request view
    is the point)."""
    spans = [
        s
        for s in tracing.traces(trace_id=trace_id, runtime=runtime)
        if s.get("end_s") is not None and s.get("start_s") is not None
    ]

    pids: Dict[str, int] = {}
    tids: Dict[Tuple[int, str], int] = {}
    events: List[dict] = []

    # Stable row numbering: known components in display order first,
    # then any actor:* rows in first-seen order.
    labels = []
    for s in spans:
        label = _row_label(s)
        if label not in labels:
            labels.append(label)
    labels.sort(key=lambda lb: (_sort_index(lb), lb))
    for label in labels:
        pid = len(pids) + 1
        pids[label] = pid
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": label},
            }
        )
        events.append(
            {
                "ph": "M",
                "name": "process_sort_index",
                "pid": pid,
                "tid": 0,
                "args": {"sort_index": _sort_index(label)},
            }
        )

    def _tid(pid: int, name: str) -> int:
        key = (pid, name)
        if key not in tids:
            tid = len([k for k in tids if k[0] == pid]) + 1
            tids[key] = tid
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
        return tids[key]

    by_id: Dict[str, dict] = {}
    placed: Dict[str, Tuple[int, int, float]] = {}
    for s in spans:
        sid = s.get("span_id")
        if sid:
            by_id[sid] = s

    for s in spans:
        pid = pids[_row_label(s)]
        tid = _tid(pid, s["name"])
        ts = s["start_s"] * 1e6
        dur = max(0.0, s["end_s"] - s["start_s"]) * 1e6
        events.append(
            {
                "ph": "X",
                "cat": s.get("kind", "user"),
                "name": s["name"],
                "pid": pid,
                "tid": tid,
                "ts": ts,
                "dur": dur,
                "args": {
                    "span_id": s.get("span_id"),
                    "parent_span_id": s.get("parent_span_id"),
                    "trace_id": s.get("trace_id"),
                    **(s.get("attributes") or {}),
                },
            }
        )
        if s.get("span_id"):
            placed[s["span_id"]] = (pid, tid, ts)

    # Flow arrows for parent→child links that cross process rows — the
    # stitching that turns per-actor rows back into one request path.
    for s in spans:
        parent_id = s.get("parent_span_id")
        child_id = s.get("span_id")
        if not parent_id or not child_id or parent_id not in placed:
            continue
        ppid, ptid, _pts = placed[parent_id]
        cpid, ctid, cts = placed[child_id]
        if (ppid, ptid) == (cpid, ctid):
            continue  # same row: nesting is already visible
        parent = by_id[parent_id]
        # The flow's source point must lie inside the parent slice.
        src_ts = min(
            max(s["start_s"], parent["start_s"]), parent["end_s"]
        ) * 1e6
        flow = {"cat": "flow", "name": "request", "id": child_id}
        events.append(
            {**flow, "ph": "s", "pid": ppid, "tid": ptid, "ts": src_ts}
        )
        events.append(
            {**flow, "ph": "f", "bp": "e", "pid": cpid, "tid": ctid,
             "ts": cts}
        )

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto_trace(
    filename: str, trace_id: Optional[str] = None, runtime=None
) -> dict:
    """Export to a file and return the trace object (the
    `ray_tpu_torch.timeline(filename, trace_id=...)` backend)."""
    trace = perfetto_trace(trace_id=trace_id, runtime=runtime)
    with open(filename, "w") as f:
        json.dump(trace, f)
    return trace
