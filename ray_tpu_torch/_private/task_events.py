"""Task-event sink — bounded in-memory store of task state transitions.

Reference: core_worker/task_event_buffer.h:193 (per-worker TaskEventBuffer)
flushed to gcs/gcs_task_manager.h:61 (bounded GCS store) powering the state
API, `ray list tasks` and `ray.timeline()`. The in-process runtime writes
transitions straight into one bounded store; the surface (state API /
timeline export) matches.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TaskEvent:
    task_id: Any
    name: str = ""
    kind: str = "NORMAL_TASK"  # NORMAL_TASK | ACTOR_CREATION_TASK | ACTOR_TASK
    job_id: Any = None
    actor_id: Any = None
    node_id: Any = None
    state_times: Dict[str, float] = field(default_factory=dict)
    last_state: str = "NIL"
    error_type: str = ""
    error_message: str = ""
    required_resources: Dict[str, float] = field(default_factory=dict)
    # Trace linkage (util/tracing.py): which trace this task-span belongs to
    # and the span it nests under.
    trace_id: str = ""
    parent_span_id: Optional[str] = None

    @property
    def state(self) -> str:
        return self.last_state


# Canonical transition order (reference: src/ray/design_docs/task_states.rst).
STATES = (
    "PENDING_ARGS_AVAIL",
    "PENDING_NODE_ASSIGNMENT",
    "RUNNING",
    "FINISHED",
    "FAILED",
)


class TaskEventBuffer:
    """Thread-safe bounded store; oldest finished events evicted first."""

    def __init__(self, max_events: int = 10_000):
        self._lock = threading.Lock()
        self._events: "OrderedDict[Any, TaskEvent]" = OrderedDict()
        self._max = max_events
        self.num_dropped = 0
        # FIFO of task_ids that reached a terminal state: eviction pops from
        # here in O(1) instead of scanning the whole store per insert — with
        # >max live tasks (a 1M-task pile-up) a scan made every submission
        # O(max_events).
        self._finished: deque = deque()

    def record(
        self,
        task_id,
        state: str,
        *,
        name: str = "",
        kind: str = "",
        job_id=None,
        actor_id=None,
        node_id=None,
        error_type: str = "",
        error_message: str = "",
        required_resources: Optional[dict] = None,
        trace_id: str = "",
        parent_span_id: Optional[str] = None,
    ) -> None:
        now = time.time()
        with self._lock:
            ev = self._events.get(task_id)
            if ev is None:
                ev = TaskEvent(task_id=task_id)
                self._events[task_id] = ev
                if len(self._events) > self._max:
                    self._evict_one_locked()
            ev.state_times[state] = now
            ev.last_state = state
            if state in ("FINISHED", "FAILED"):
                self._finished.append(task_id)
            if name:
                ev.name = name
            if kind:
                ev.kind = kind
            if job_id is not None:
                ev.job_id = job_id
            if actor_id is not None:
                ev.actor_id = actor_id
            if node_id is not None:
                ev.node_id = node_id
            if trace_id:
                ev.trace_id = trace_id
            if parent_span_id is not None:
                ev.parent_span_id = parent_span_id
            if error_type:
                ev.error_type = error_type
            if error_message:
                ev.error_message = error_message
            if required_resources:
                ev.required_resources = dict(required_resources)

    def _evict_one_locked(self) -> None:
        """Oldest finished/failed event first; live tasks survive until only
        live tasks remain (then oldest-inserted goes — the store is bounded).
        O(1) amortized: terminal ids queue in `_finished`; stale entries
        (already evicted, or a retry revived the task) are skipped."""
        while self._finished:
            task_id = self._finished.popleft()
            ev = self._events.get(task_id)
            if ev is not None and ev.last_state in ("FINISHED", "FAILED"):
                del self._events[task_id]
                self.num_dropped += 1
                return
        self._events.popitem(last=False)
        self.num_dropped += 1

    def list_events(self, limit: int = 10_000) -> List[TaskEvent]:
        with self._lock:
            return list(self._events.values())[-limit:]

    def get(self, task_id) -> Optional[TaskEvent]:
        with self._lock:
            return self._events.get(task_id)

    def chrome_trace(self) -> List[dict]:
        """Chrome trace-event JSON records (ray.timeline(),
        _private/state.py:831 equivalent)."""
        out: List[dict] = []
        with self._lock:
            events = list(self._events.values())
        for ev in events:
            start = ev.state_times.get("RUNNING")
            end = ev.state_times.get("FINISHED") or ev.state_times.get("FAILED")
            if start is None or end is None:
                continue
            node = ev.node_id.hex()[:8] if ev.node_id is not None else "?"
            out.append(
                {
                    "cat": "task",
                    "name": ev.name,
                    "ph": "X",
                    "ts": start * 1e6,
                    "dur": max(0.0, (end - start)) * 1e6,
                    "pid": f"node:{node}",
                    "tid": ev.kind,
                    "args": {
                        "task_id": ev.task_id.hex(),
                        "state": ev.state,
                        "error": ev.error_type,
                    },
                }
            )
        return out
