"""Task specifications (reference: src/ray/common/task/task_spec.h).

One spec type covers normal tasks, actor-creation tasks and actor method calls,
discriminated by `kind` — matching the reference's TaskSpecification proto. Return
ObjectIDs are computed deterministically from the TaskID at submission time
(design_docs/id_specification.md), which is what lets the owner register and hand
out refs before the task runs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID


class TaskKind(enum.Enum):
    NORMAL = "normal"
    ACTOR_CREATION = "actor_creation"
    ACTOR_TASK = "actor_task"


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    name: str
    kind: TaskKind
    func: Optional[Callable] = None  # function, or the class for actor creation
    method_name: Optional[str] = None  # actor tasks
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    num_returns: int = 1
    streaming: bool = False  # num_returns="streaming": generator task
    resources: dict[str, float] = field(default_factory=dict)
    scheduling_strategy: Any = None
    max_retries: int = 0
    retry_exceptions: Any = False  # bool | list[type]
    actor_id: Optional[ActorID] = None
    max_concurrency: int = 1
    max_restarts: int = 0
    max_task_retries: int = 0
    runtime_env: Optional[dict] = None
    concurrency_groups: dict[str, int] = field(default_factory=dict)
    # Per-actor engine override (None = node default, "process" = own OS
    # process regardless of the runtime's isolation mode).
    isolation: Optional[str] = None
    # Filled at submission:
    return_ids: list[ObjectID] = field(default_factory=list)
    # Owner context (the submitting task), for lineage:
    parent_task_id: Optional[TaskID] = None
    # Trace propagation (util/tracing.py, the tracing_helper metadata
    # analog): (trace_id, parent_span_id) captured at submission so spans
    # nest across workers and nodes. None = this task roots a new trace.
    trace_ctx: Optional[tuple] = None

    def compute_return_ids(self) -> list[ObjectID]:
        self.return_ids = [
            ObjectID.of(self.task_id, i + 1) for i in range(self.num_returns)
        ]
        return self.return_ids

    def should_retry(self, exc: BaseException, system_failure: bool) -> bool:
        """System failures (worker/node death) always consume a retry; user
        exceptions only when retry_exceptions allows (ray_option_utils.py:168)."""
        if system_failure:
            return True
        if self.retry_exceptions is True:
            return True
        if isinstance(self.retry_exceptions, (list, tuple)):
            return isinstance(exc, tuple(self.retry_exceptions))
        return False
