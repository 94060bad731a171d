"""Workflow public API + executor.

Reference: workflow/api.py (run/resume/get_output/get_status/list_all) and
workflow/workflow_executor.py:32,56,92 (the asyncio controller loop polling
queued steps). Here the executor walks the DAG topologically, submits every
step whose deps are met as a normal task (so independent steps run in
parallel through the scheduler), and checkpoints each step's result before
moving on — making any crash point resumable.
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.dag_node import (
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    _InputValue,
)
from ray_tpu_torch.workflow import storage as storage_mod
from ray_tpu_torch.workflow.storage import WorkflowStorage, list_workflows

_running: Dict[str, Future] = {}
_lock = threading.Lock()
_max_running: Optional[int] = None
_queued: List[tuple] = []  # (workflow_id, dag, args, kwargs, Future)


def init(
    storage: Optional[str] = None,
    max_running_workflows: Optional[int] = None,
) -> None:
    """Set the durable storage base path and (optionally) the async
    executor's concurrency cap — excess run_async workflows queue with
    status PENDING and start as slots free (reference: workflow.init
    max_running_workflows + workflow_executor.py's queued loop)."""
    global _max_running
    if storage is not None:
        storage_mod.set_base(storage)
    if max_running_workflows is not None:
        _max_running = max_running_workflows


class Continuation:
    """A step's returned sub-workflow: the executor runs the wrapped DAG in
    the step's place and the step's checkpointed value becomes the sub-DAG's
    output (reference: workflow.continuation — dynamic workflows, loops,
    recursion)."""

    __slots__ = ("dag",)

    def __init__(self, dag: DAGNode):
        self.dag = dag


def continuation(dag: DAGNode) -> Continuation:
    return Continuation(dag)


class EventListener:
    """Event-provider ABC (reference: workflow/event_listener.py). poll()
    blocks until the event arrives and returns its payload; the resolved
    payload checkpoints like any step, so a resumed workflow does not
    re-wait a delivered event."""

    def poll(self) -> Any:
        raise NotImplementedError


class TimerListener(EventListener):
    def __init__(self, duration_s: float):
        self.duration_s = duration_s

    def poll(self) -> Any:
        time.sleep(self.duration_s)
        return None


def wait_for_event(listener_cls, *args, **kwargs) -> DAGNode:
    """DAG node that resolves when the listener's event arrives (runs as a
    normal task, so it occupies a worker while polling — match the
    reference's event semantics without a separate event loop)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0)
    def __wait_for_event__():
        listener = listener_cls(*args, **kwargs)
        return listener.poll()

    return __wait_for_event__.bind()


def sleep(duration_s: float) -> DAGNode:
    """Durable timer step (reference: workflow.sleep)."""
    return wait_for_event(TimerListener, duration_s)


def _step_ids(dag: DAGNode) -> Dict[str, str]:
    """Deterministic step ids: topological index + function name — stable
    across process restarts so resume can match checkpoints to steps
    (reference: workflow_state_from_dag.py name generation)."""
    ids = {}
    for i, node in enumerate(dag.topological_order()):
        if isinstance(node, FunctionNode):
            name = node._remote_fn._function.__qualname__
        else:
            name = type(node).__name__
        ids[node._stable_uuid] = f"{i:03d}_{name}"
    return ids


def _execute_workflow(
    workflow_id: str, dag: DAGNode, args: tuple, kwargs: dict
) -> Any:
    store = WorkflowStorage(workflow_id)
    store.save_status("RUNNING")
    try:
        result = _execute_dag(store, dag, args, kwargs, prefix="")
    except BaseException:
        store.save_status("RESUMABLE")
        raise
    store.save_status("SUCCESSFUL")
    return result


# Workflow-level step options stripped before the task layer sees them
# (fn.options validates task options strictly).
_WORKFLOW_OPTIONS = ("catch_exceptions",)


def _execute_dag(
    store: WorkflowStorage,
    dag: DAGNode,
    args: tuple,
    kwargs: dict,
    prefix: str,
) -> Any:
    """Run one DAG level; `prefix` namespaces checkpoint ids so continuation
    sub-DAGs nest durably under their producing step."""
    import ray_tpu_torch

    ids = {k: prefix + v for k, v in _step_ids(dag).items()}
    cache: Dict[str, Any] = {}
    input_value = _InputValue(args, kwargs)
    order = dag.topological_order()
    # Submit pass: completed steps load from checkpoint; steps whose deps
    # are all resolvable submit eagerly with upstream ObjectRefs so
    # independent chains overlap; steps behind a pending continuation
    # resume (or anything unresolved) are DEFERRED to the checkpoint pass.
    pending: List[tuple] = []  # (sid, nuid, ref|None, wf_opts, node)
    unsubmitted: set = set()  # uuids whose value is not in cache yet
    for node in order:
        sid = ids[node._stable_uuid]
        nuid = node._stable_uuid
        if isinstance(node, (InputNode, InputAttributeNode)):
            cache[nuid] = node._execute_node(cache, input_value)
            continue
        if store.has_step_result(sid):
            cache[nuid] = store.load_step_result(sid)
            continue
        if not isinstance(node, FunctionNode):
            raise TypeError(
                f"Workflows support task DAGs (FunctionNode); got {type(node)}"
            )
        wf_opts = {
            k: node._options.pop(k)
            for k in _WORKFLOW_OPTIONS
            if k in (node._options or {})
        }
        deps = {c._stable_uuid for c in node._children()}
        if store.has_continuation(sid) or deps & unsubmitted:
            # A durable continuation must resume WITHOUT re-running its
            # producing step; a dep that isn't materialized yet means this
            # step executes in the checkpoint pass, after it is.
            unsubmitted.add(nuid)
            pending.append((sid, nuid, None, wf_opts, node))
            continue
        ref = node._execute_node(cache, input_value)
        cache[nuid] = ref
        pending.append((sid, nuid, ref, wf_opts, node))
    # Checkpoint pass, topological order. `dirty` marks steps whose FINAL
    # value differs from the ref eagerly handed downstream (continuation
    # outputs, catch_exceptions wrapping): consumers that captured the
    # stale ref re-execute against the resolved cache.
    dirty: set = set()
    for sid, nuid, ref, wf_opts, node in pending:
        deps = {c._stable_uuid for c in node._children()}
        resumed_continuation = ref is None and store.has_continuation(sid)
        if resumed_continuation:
            value = Continuation(store.load_continuation(sid))
        else:
            if ref is None or deps & dirty:
                if ref is not None:
                    try:
                        ray_tpu_torch.cancel(ref)
                    except Exception:
                        pass
                    dirty.add(nuid)  # consumers hold the cancelled ref
                ref = node._execute_node(cache, input_value)
            if wf_opts.get("catch_exceptions"):
                # Reference contract: the step's value becomes
                # (result, None) or (None, exception) and the DAG proceeds.
                try:
                    value = (ray_tpu_torch.get(ref), None)
                except Exception as exc:  # noqa: BLE001 — delivered downstream
                    value = (None, exc)
                dirty.add(nuid)
            else:
                value = ray_tpu_torch.get(ref)
        while isinstance(value, Continuation):
            store.save_continuation(sid, value.dag)
            value = _execute_dag(store, value.dag, (), {}, prefix=f"{sid}.")
            dirty.add(nuid)
        store.save_step_result(sid, value)
        cache[nuid] = value
    return cache[dag._stable_uuid]


def run(
    dag: DAGNode,
    *args,
    workflow_id: Optional[str] = None,
    **kwargs,
) -> Any:
    """Run a workflow to completion, checkpointing each step."""
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"
    store = WorkflowStorage(workflow_id)
    store.save_dag(dag)
    store.save_input(args, kwargs)
    store.save_metadata({"workflow_id": workflow_id, "start_time": time.time()})
    return _execute_workflow(workflow_id, dag, args, kwargs)


_active: set = set()


def run_async(
    dag: DAGNode, *args, workflow_id: Optional[str] = None, **kwargs
) -> Future:
    """Run a workflow on a background thread. With init(max_running_workflows=N)
    set, excess submissions QUEUE (status PENDING) and start as running
    workflows finish — the reference's queued executor loop
    (workflow_executor.py:32)."""
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"
    store = WorkflowStorage(workflow_id)
    store.save_dag(dag)
    store.save_input(args, kwargs)
    store.save_metadata({"workflow_id": workflow_id, "start_time": time.time()})
    fut: Future = Future()
    with _lock:
        _running[workflow_id] = fut
        if _max_running is not None and len(_active) >= _max_running:
            store.save_status("PENDING")
            _queued.append((workflow_id, dag, args, kwargs, fut))
            return fut
        _active.add(workflow_id)
    _start_workflow(workflow_id, dag, args, kwargs, fut)
    return fut


def _start_workflow(
    workflow_id: str, dag: DAGNode, args: tuple, kwargs: dict, fut: Future
) -> None:
    def runner():
        try:
            fut.set_result(_execute_workflow(workflow_id, dag, args, kwargs))
        except BaseException as e:
            fut.set_exception(e)
        finally:
            with _lock:
                _active.discard(workflow_id)
            _dispatch_queued()

    threading.Thread(
        target=runner, daemon=True, name=f"wf-{workflow_id}"
    ).start()


def _dispatch_queued() -> None:
    while True:
        with _lock:
            if not _queued:
                return
            if _max_running is not None and len(_active) >= _max_running:
                return
            workflow_id, dag, args, kwargs, fut = _queued.pop(0)
            _active.add(workflow_id)
        _start_workflow(workflow_id, dag, args, kwargs, fut)


def resume(workflow_id: str) -> Any:
    """Reload the stored DAG and continue from the last checkpoint."""
    store = WorkflowStorage(workflow_id)
    dag = store.load_dag()
    args, kwargs = store.load_input()
    return _execute_workflow(workflow_id, dag, args, kwargs)


def get_status(workflow_id: str) -> Optional[str]:
    return WorkflowStorage(workflow_id).load_status()


def get_metadata(workflow_id: str) -> dict:
    return WorkflowStorage(workflow_id).load_metadata()


def get_output(workflow_id: str, timeout_s: Optional[float] = None) -> Any:
    with _lock:
        fut = _running.get(workflow_id)
    if fut is not None and not fut.done():
        return fut.result(timeout=timeout_s)
    store = WorkflowStorage(workflow_id)
    status = store.load_status()
    if status != "SUCCESSFUL":
        raise ValueError(
            f"Workflow {workflow_id!r} status={status}; resume() it first"
        )
    dag = store.load_dag()
    ids = _step_ids(dag)
    return store.load_step_result(ids[dag._stable_uuid])


def list_all() -> List[tuple]:
    out = []
    for wid in list_workflows():
        out.append((wid, WorkflowStorage(wid).load_status()))
    return out


def delete(workflow_id: str) -> None:
    WorkflowStorage(workflow_id).delete()
