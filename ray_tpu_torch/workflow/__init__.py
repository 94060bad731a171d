"""Durable workflows: DAG execution with storage-backed checkpoints.

Reference: python/ray/workflow/ (10,160 LoC — api.py, workflow_executor.py:32,
workflow_storage.py, workflow_state_from_dag.py). A workflow is a ray_tpu_torch.dag
graph executed step-by-step with every step's output checkpointed to durable
storage; `resume` reloads the DAG and skips completed steps, so a crashed
driver continues where it left off.
"""

from ray_tpu_torch.workflow.api import (
    Continuation,
    EventListener,
    TimerListener,
    continuation,
    delete,
    get_metadata,
    get_output,
    get_status,
    init,
    list_all,
    resume,
    run,
    run_async,
    sleep,
    wait_for_event,
)

__all__ = [
    "Continuation",
    "EventListener",
    "TimerListener",
    "continuation",
    "delete",
    "get_metadata",
    "get_output",
    "get_status",
    "init",
    "list_all",
    "resume",
    "run",
    "run_async",
    "sleep",
    "wait_for_event",
]
