"""Per-node execution engine (threaded backend).

Plays the role of the reference's worker pool + task execution path
(raylet/worker_pool.h, _raylet.pyx:1293 execute_task): a node's granted tasks run
on pooled threads; actors get a dedicated executor enforcing the reference's
actor semantics (transport/: ordered execution for sync actors via per-actor
submit queues, thread pools for max_concurrency>1, an asyncio loop for async
actors — fiber.h / concurrency_group_manager.h analogs).

Concurrency is gated by *resource accounting* (the scheduler only dispatches
what fits the node), not by pool size, matching the lease model.
"""

from __future__ import annotations

import asyncio
import inspect
import queue
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from ray_tpu_torch._private.controller import NodeState
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.task_spec import TaskSpec, TaskKind
from ray_tpu_torch.exceptions import ActorDiedError, TaskCancelledError


class WorkerContext(threading.local):
    """Thread-local execution context (reference: WorkerContext in core_worker)."""

    def __init__(self):
        self.task_id = None
        self.job_id = None
        self.node_id = None
        self.actor_id = None
        self.task_name = None
        self.resource_grant: dict[str, float] = {}
        self.put_counter = 0
        self.cancel_flag: Optional[threading.Event] = None


CONTEXT = WorkerContext()

# Sentinel result value: the driver already sealed the bytes a worker
# process returned (process_engine), so _seal_returns must skip it.
SEALED_EXTERNALLY = object()

# Cancel requests for RUNNING streaming tasks (ray.cancel on a live
# generator). A thread can't be preempted, but the stream drivers below check
# this registry between yields, so an abandoned generator stops producing at
# its next item instead of running to completion (reference: the proxy/router
# cancel path on client disconnect). Process-global: both the in-process
# engine and worker subprocesses (each its own process) consult it. Bounded
# FIFO: an entry can outlive its task in the process that didn't run the
# stream (driver-side marks, late frames), so age out the oldest instead of
# growing forever; 4096 outstanding cancels is far past any real backlog.
_stream_cancel_lock = threading.Lock()
_stream_cancels: "dict" = {}  # task_id -> None, insertion-ordered
_STREAM_CANCEL_CAP = 4096


def request_stream_cancel(task_id) -> None:
    with _stream_cancel_lock:
        _stream_cancels[task_id] = None
        while len(_stream_cancels) > _STREAM_CANCEL_CAP:
            _stream_cancels.pop(next(iter(_stream_cancels)))


def _stream_cancel_requested(task_id) -> bool:
    with _stream_cancel_lock:
        return task_id in _stream_cancels


def _clear_stream_cancel(task_id) -> None:
    with _stream_cancel_lock:
        _stream_cancels.pop(task_id, None)


class TaskResult:
    __slots__ = ("value", "exc", "traceback_str", "cancelled")

    def __init__(self, value=None, exc=None, traceback_str="", cancelled=False):
        self.value = value
        self.exc = exc
        self.traceback_str = traceback_str
        self.cancelled = cancelled


def _activate_runtime_env(spec: TaskSpec, fallback: Optional[dict] = None):
    """Scoped runtime-env application for one execution (env_vars + staged
    sys.path dirs). Actor tasks fall back to the actor's creation env."""
    from contextlib import nullcontext

    from ray_tpu_torch._private.runtime import get_runtime

    env_spec = spec.runtime_env or fallback
    if not env_spec:
        return nullcontext()
    try:
        manager = get_runtime().runtime_env_manager
    except Exception:
        return nullcontext()
    ctx = manager.get_or_create(env_spec)
    return manager.activate(ctx)


def _run_callable(fn: Callable, args: tuple, kwargs: dict) -> TaskResult:
    try:
        value = fn(*args, **kwargs)
        if inspect.iscoroutine(value):
            value = asyncio.run(value)
        return TaskResult(value=value)
    except TaskCancelledError as exc:
        return TaskResult(exc=exc, cancelled=True)
    except BaseException as exc:  # noqa: BLE001 — user code may raise anything
        return TaskResult(exc=exc, traceback_str=traceback.format_exc())


def _maybe_consume_stream(
    spec: TaskSpec, result: TaskResult, should_abort: Optional[Callable] = None
) -> TaskResult:
    """For streaming tasks whose function returned a generator: drive it on
    this worker thread (resources stay held), sealing each yielded item as its
    own object via the owner (reference: execute_task's generator path,
    _raylet.pyx:1293 + ReportGeneratorItemReturns). The completion value is
    the item count; mid-generator errors become the failing item."""
    if not spec.streaming or result.exc is not None:
        return result
    gen = result.value
    if not inspect.isgenerator(gen):
        # A streaming task returning a plain value: one-item stream.
        gen = iter([gen] if gen is not None else [])
    from ray_tpu_torch._private.runtime import get_runtime

    runtime = get_runtime()
    i = 0
    try:
        for item in gen:
            # Abort between yields when the hosting actor was killed or the
            # caller cancelled the stream — the thread can't be interrupted,
            # but the stream must not keep producing items nobody will read.
            if (should_abort is not None and should_abort()) or (
                _stream_cancel_requested(spec.task_id)
            ):
                gen.close()
                break
            runtime.report_stream_item(spec, i, value=item)
            i += 1
    except BaseException as exc:  # noqa: BLE001
        runtime.report_stream_item(
            spec, i, error=exc, traceback_str=traceback.format_exc()
        )
        i += 1
    finally:
        _clear_stream_cancel(spec.task_id)
    return TaskResult(value=i)


async def _consume_async_stream(spec: TaskSpec, agen) -> TaskResult:
    """Async-generator variant of _maybe_consume_stream for async actors."""
    from ray_tpu_torch._private.runtime import get_runtime

    runtime = get_runtime()
    i = 0
    try:
        async for item in agen:
            if _stream_cancel_requested(spec.task_id):
                await agen.aclose()
                break
            runtime.report_stream_item(spec, i, value=item)
            i += 1
    except BaseException as exc:  # noqa: BLE001
        runtime.report_stream_item(
            spec, i, error=exc, traceback_str=traceback.format_exc()
        )
        i += 1
    finally:
        _clear_stream_cancel(spec.task_id)
    return TaskResult(value=i)


class NodeEngine:
    """Runs normal tasks and hosts actors for one logical node."""

    def __init__(self, node: NodeState, on_task_done: Callable):
        self.node = node
        self._on_task_done = on_task_done
        # Worker threads are pooled and unbounded: the scheduler's resource
        # accounting is the actual concurrency limiter (lease model).
        self._pool = ThreadPoolExecutor(
            max_workers=256, thread_name_prefix=f"worker-{node.node_id.hex()[:6]}"
        )
        self._actors: dict[ActorID, ActorExecutor] = {}
        self._lock = threading.Lock()
        self.alive = True

    # -- normal tasks --------------------------------------------------------

    def execute_task(
        self,
        spec: TaskSpec,
        grant: dict[str, float],
        resolve_args: Callable[[TaskSpec], tuple[tuple, dict]],
    ) -> None:
        def run():
            from ray_tpu_torch.util import tracing

            CONTEXT.task_id = spec.task_id
            CONTEXT.job_id = spec.job_id
            CONTEXT.node_id = self.node.node_id
            CONTEXT.actor_id = None
            CONTEXT.task_name = spec.name
            CONTEXT.resource_grant = grant
            CONTEXT.put_counter = 0
            # Re-enter the submitter's trace so user spans and nested
            # submits nest under this task (tracing_helper's execution half).
            _trace_token = tracing.activate_task(spec)
            try:
                try:
                    args, kwargs = resolve_args(spec)
                    # Env staging can fail (missing working_dir): must
                    # surface as the task's failure, never escape into the
                    # pool and hang the caller with the grant leaked.
                    env_cm = _activate_runtime_env(spec)
                except BaseException as exc:  # dep was freed/lost, bad env
                    self._on_task_done(
                        spec,
                        self.node,
                        grant,
                        TaskResult(exc=exc, traceback_str=traceback.format_exc()),
                    )
                    return
                with env_cm:
                    result = _run_callable(spec.func, args, kwargs)
                    result = _maybe_consume_stream(spec, result)
                self._on_task_done(spec, self.node, grant, result)
            finally:
                tracing.deactivate(_trace_token)

        self._pool.submit(run)

    # -- actors --------------------------------------------------------------

    def create_actor(
        self,
        spec: TaskSpec,
        grant: dict[str, float],
        resolve_args: Callable[[TaskSpec], tuple[tuple, dict]],
    ) -> "ActorExecutor":
        executor = ActorExecutor(
            node=self,
            creation_spec=spec,
            grant=grant,
            resolve_args=resolve_args,
            on_task_done=self._on_task_done,
        )
        with self._lock:
            self._actors[spec.actor_id] = executor
        executor.start()
        return executor

    def get_actor(self, actor_id: ActorID) -> Optional["ActorExecutor"]:
        with self._lock:
            return self._actors.get(actor_id)

    def remove_actor(self, actor_id: ActorID) -> None:
        with self._lock:
            self._actors.pop(actor_id, None)

    def shutdown(self) -> None:
        self.alive = False
        with self._lock:
            actors = list(self._actors.values())
        for actor in actors:
            actor.kill(reason="node shutdown")
        self._pool.shutdown(wait=False, cancel_futures=True)


class ActorExecutor:
    """Executes one actor's creation task and method calls.

    Mode selection (matches the reference's rules, _raylet.pyx:3769 +
    transport/concurrency_group_manager.h):
      * class has any `async def` method  → asyncio loop thread, up to
        max_concurrency concurrent coroutines;
      * max_concurrency > 1               → thread pool (threaded actor);
      * otherwise                         → single thread, strict submission
        order (sequential_actor_submit_queue.h semantics).
    """

    def __init__(self, node, creation_spec, grant, resolve_args, on_task_done):
        self.node = node
        self.creation_spec = creation_spec
        self.actor_id: ActorID = creation_spec.actor_id
        self.grant = grant
        self._resolve_args = resolve_args
        self._on_task_done = on_task_done
        self.instance: Any = None
        self.dead = False
        self.death_reason = ""
        self._inbox: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self._lock = threading.Lock()
        self._is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(
                creation_spec.func, predicate=inspect.isfunction
            )
        )
        self.max_concurrency = max(1, creation_spec.max_concurrency)
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._method_pool: Optional[ThreadPoolExecutor] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._main,
            name=f"actor-{self.actor_id.hex()[:8]}",
            daemon=True,
        )
        self._thread.start()

    def submit(self, spec: TaskSpec) -> None:
        with self._lock:
            dead = self.dead
            reason = self.death_reason
        if dead:
            # Fail fast — outside the lock: _on_task_done may re-enter submit()
            # on this same thread via the retry path.
            self._on_task_done(
                spec,
                self.node.node,
                {},
                TaskResult(exc=ActorDiedError(self.actor_id, reason or "actor died")),
            )
            return
        self._inbox.put(spec)

    def kill(self, reason: str = "ray_tpu_torch.kill") -> None:
        with self._lock:
            if self.dead:
                return
            self.dead = True
            self.death_reason = reason
        self._inbox.put(None)  # poison pill
        if self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(lambda: None)
            except RuntimeError:
                pass

    def pending_count(self) -> int:
        return self._inbox.qsize()

    # -- execution -----------------------------------------------------------

    def _set_context(self, spec: TaskSpec) -> None:
        from ray_tpu_torch.util import tracing

        CONTEXT.task_id = spec.task_id
        CONTEXT.job_id = spec.job_id
        CONTEXT.node_id = self.node.node.node_id
        CONTEXT.actor_id = self.actor_id
        CONTEXT.task_name = spec.name
        CONTEXT.resource_grant = self.grant
        CONTEXT.put_counter = 0
        tracing.activate_task(spec)

    def _main(self) -> None:
        # Run the creation task (constructor) first; its single return object
        # doubles as the readiness/error signal for the handle.
        self._set_context(self.creation_spec)
        try:
            args, kwargs = self._resolve_args(self.creation_spec)
            with _activate_runtime_env(self.creation_spec):
                result = _run_callable(
                    lambda *a, **k: self.creation_spec.func(*a, **k), args, kwargs
                )
            if result.exc is None:
                self.instance = result.value
                result = TaskResult(value=None)
        except BaseException as exc:  # noqa: BLE001
            result = TaskResult(exc=exc, traceback_str=traceback.format_exc())
        creation_failed = result.exc is not None
        self._on_task_done(self.creation_spec, self.node.node, {}, result)
        if creation_failed:
            with self._lock:
                self.dead = True
                self.death_reason = "actor constructor failed"
            self._drain_inbox()
            return

        if self._is_async:
            self._async_main()
        elif self.max_concurrency > 1:
            self._threaded_main()
        else:
            self._sync_main()
        self._drain_inbox()

    def _sync_main(self) -> None:
        while True:
            spec = self._inbox.get()
            if spec is None:
                return
            self._execute_method(spec)

    def _threaded_main(self) -> None:
        self._method_pool = ThreadPoolExecutor(max_workers=self.max_concurrency)
        while True:
            spec = self._inbox.get()
            if spec is None:
                self._method_pool.shutdown(wait=False, cancel_futures=True)
                return
            self._method_pool.submit(self._execute_method, spec)

    def _async_main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        sem = asyncio.Semaphore(self.max_concurrency)

        async def run_one(spec: TaskSpec):
            async with sem:
                self._set_context(spec)
                self._record_running(spec)
                try:
                    args, kwargs = self._resolve_args(spec)
                    method = getattr(self.instance, spec.method_name)
                    env = _activate_runtime_env(
                        spec, fallback=self.creation_spec.runtime_env
                    )
                    with env:
                        if inspect.isasyncgenfunction(method) and spec.streaming:
                            result = await _consume_async_stream(
                                spec, method(*args, **kwargs)
                            )
                        else:
                            if inspect.iscoroutinefunction(method):
                                value = await method(*args, **kwargs)
                            else:
                                value = method(*args, **kwargs)
                            result = _maybe_consume_stream(spec, TaskResult(value=value))
                except BaseException as exc:  # noqa: BLE001
                    result = TaskResult(exc=exc, traceback_str=traceback.format_exc())
                self._on_task_done(spec, self.node.node, {}, result)

        async def pump():
            while True:
                spec = await self._loop.run_in_executor(None, self._inbox.get)
                if spec is None:
                    # Let in-flight coroutines finish.
                    for _ in range(self.max_concurrency):
                        await sem.acquire()
                    return
                self._loop.create_task(run_one(spec))

        try:
            self._loop.run_until_complete(pump())
        finally:
            self._loop.close()
            self._loop = None

    def _record_running(self, spec: TaskSpec) -> None:
        from ray_tpu_torch._private.runtime import get_runtime

        try:
            get_runtime().task_events.record(
                spec.task_id, "RUNNING", node_id=self.node.node.node_id
            )
        except Exception:
            pass  # runtime tearing down

    def _execute_method(self, spec: TaskSpec) -> None:
        self._set_context(spec)
        self._record_running(spec)
        try:
            args, kwargs = self._resolve_args(spec)
            method = getattr(self.instance, spec.method_name)
            with _activate_runtime_env(
                spec, fallback=self.creation_spec.runtime_env
            ):
                result = _run_callable(method, args, kwargs)
                result = _maybe_consume_stream(
                    spec, result, should_abort=lambda: self.dead
                )
        except BaseException as exc:  # noqa: BLE001
            result = TaskResult(exc=exc, traceback_str=traceback.format_exc())
        with self._lock:
            dead, reason = self.dead, self.death_reason
        if dead:
            # The method outlived a kill (threads can't be preempted): its
            # result must surface as the actor's death, matching the
            # reference's force-killed-worker semantics.
            result = TaskResult(
                exc=ActorDiedError(self.actor_id, reason or "actor killed")
            )
        self._on_task_done(spec, self.node.node, {}, result)

    def _drain_inbox(self) -> None:
        with self._lock:
            reason = self.death_reason
        while True:
            try:
                spec = self._inbox.get_nowait()
            except queue.Empty:
                return
            if spec is None:
                continue
            self._on_task_done(
                spec,
                self.node.node,
                {},
                TaskResult(
                    exc=ActorDiedError(self.actor_id, reason or "actor died")
                ),
            )
