"""The runtime: task manager + ownership + dispatch wiring.

This is the re-design of the reference's CoreWorker (src/ray/core_worker/
core_worker.h:284 — Put :558, Get :665, Wait :704, SubmitTask :829, CreateActor
:850, SubmitActorTask :896) plus the owner-side TaskManager (task_manager.h:
retries) for a single-control-plane cluster. Every public API call lands
here. Workers are threads of this process (`isolation="thread"`) or OS
processes (`isolation="process"`, process_engine.py, watched by the memory
monitor); the object table stays in this process either way, with large
values in the native shared-memory store that worker processes map, and
spill files under memory pressure. A lost value (a missing spill file, shm
eviction) is rebuilt by re-executing its producing task (lineage). Node
daemons join over TCP (`serve_clients`, remote_node.py), each with its own
store whose values the head pulls through the object plane, and remote
drivers connect through the same listener. The control-plane tables persist
to `gcs_storage_path` (gcs_storage.py). With `include_dashboard`, the
dashboard (dashboard/head.py) serves this state over HTTP.

Key invariants preserved from the reference:
  * return ObjectIDs are computed at submission (ownership without coordination);
  * argument refs are counted per *submission attempt* and released per
    completion (UpdateSubmittedTaskReferences / UpdateFinishedTaskReferences);
  * user exceptions become error objects sealed into the task's returns and
    re-raised at `get` as an instance of the original exception type;
  * retries: system failures always consume a retry; user exceptions only with
    retry_exceptions (task_manager.h FailOrRetryPendingTask/RetryTaskIfPossible);
  * actor restarts honor max_restarts, queued calls honor max_task_retries
    (gcs_actor_manager.cc:1100 ReconstructActor).
"""

from __future__ import annotations

import os
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import cloudpickle

from ray_tpu_torch._private import engine as engine_mod
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.controller import (
    ActorRecord,
    ActorState,
    Controller,
    NodeState,
)
from ray_tpu_torch._private.engine import CONTEXT, ActorExecutor, NodeEngine, TaskResult
from ray_tpu_torch._private.fault_injection import maybe_fail
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    _Counter,
)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import InProcessStore
from ray_tpu_torch._private.refcount import ReferenceCounter
from ray_tpu_torch._private.scheduler import Scheduler
from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ObjectLostError,
    PoisonRequestError,
    TaskCancelledError,
    TaskError,
)

_RUNTIME: Optional["Runtime"] = None
_PUT_INDEX_OFFSET = 1 << 20  # puts live above return indices in the ObjectID space
_STREAM_INDEX_OFFSET = 1 << 19  # streaming-generator items live below puts
_STREAM_ERROR_INDEX = (1 << 19) - 1  # slot for pre-generator failures


class ErrorObject:
    """Marker stored as a task's result when it failed; `get` re-raises."""

    __slots__ = ("exc", "traceback_str")

    def __init__(self, exc: BaseException, traceback_str: str = ""):
        self.exc = exc
        self.traceback_str = traceback_str

    def raise_(self):
        exc = self.exc
        if isinstance(exc, TaskError):
            raise _as_instanceof_cause(exc)
        raise exc


def _as_instanceof_cause(err: TaskError) -> BaseException:
    """Build `TaskError(CauseType)` so `except CauseType` works at the call site
    (reference: RayTaskError.as_instanceof_cause, python/ray/exceptions.py)."""
    return err.as_instanceof_cause()


def _capture_trace() -> Optional[tuple]:
    from ray_tpu_torch.util import tracing

    return tracing.capture_context()


def _default_store_budget(config: Config) -> Optional[int]:
    """30% of system RAM capped at 200GB (reference: ray_constants.py:51-53)."""
    try:
        import os as _os

        total = _os.sysconf("SC_PAGE_SIZE") * _os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None
    return min(int(total * config.object_store_memory_fraction),
               config.object_store_memory_cap)


class _TaskRecord:
    __slots__ = (
        "spec",
        "request",
        "retries_left",
        "node_id",
        "dispatched",
        "finalized",
    )

    def __init__(self, spec: TaskSpec, request: dict[str, float]):
        self.spec = spec
        self.request = request
        self.retries_left = max(0, spec.max_retries) if spec.max_retries >= 0 else 1 << 30
        self.node_id: Optional[NodeID] = None
        self.dispatched = False
        self.finalized = False


class Runtime:
    def __init__(
        self,
        resources: Optional[dict[str, float]] = None,
        system_config: Optional[dict] = None,
        namespace: str = "default",
    ):
        global _RUNTIME
        self.config = Config().apply_overrides(system_config)
        if self.config.worker_device not in ("", "cpu"):
            raise ValueError(
                f"worker_device={self.config.worker_device!r}: '' (the driver's "
                "CUDA devices) or 'cpu' (none)")
        self.shutting_down = False
        self.namespace = namespace
        self.controller = Controller()
        # Control-plane persistence: KV + job counter must be restored BEFORE
        # this session mints its job id; actors/PGs are restored at the end
        # of init once the scheduler and head node exist.
        self._gcs_storage = None
        self._pending_snapshot = None
        if self.config.gcs_storage_path:
            from ray_tpu_torch._private.gcs_storage import GcsStorage

            self._gcs_storage = GcsStorage(self.config.gcs_storage_path)
            self._pending_snapshot = self._gcs_storage.load()
            if self._pending_snapshot:
                with self.controller._lock:
                    self.controller._kv.update(self._pending_snapshot.get("kv", {}))
                    self.controller._job_counter = max(
                        self.controller._job_counter,
                        self._pending_snapshot.get("job_counter", 0),
                    )
        budget = self.config.object_store_memory or _default_store_budget(self.config)
        # The native store raises here when its library cannot be built or
        # loaded: no runtime starts without the store it was asked for.
        self._native_store = None
        if self.config.native_store_enabled and self.config.native_store_threshold:
            from ray_tpu_torch._private.native_store import NativeStore

            self._native_store = NativeStore(
                f"/ray_tpu_torch_{os.getpid()}", capacity=budget or (1 << 30)
            )
        self._spill_storage = None
        if self.config.object_spilling_enabled:
            from ray_tpu_torch._private.external_storage import FileSystemStorage

            self._spill_storage = FileSystemStorage(
                self.config.object_spill_directory or None
            )
        self.store = InProcessStore(
            memory_budget=budget,
            native=self._native_store,
            native_threshold=self.config.native_store_threshold,
            spill_storage=self._spill_storage,
            serialize=self.config.serialize_objects,
        )
        # Multi-machine plane: registered node daemons + the head's half of
        # the object plane (created lazily when the first node joins).
        self._node_handles: dict[NodeID, Any] = {}
        self._object_server = None
        self._object_fetcher = None
        self._head_server = None
        self.store.set_remote_fetch(self._fetch_remote_object)
        # Deferred-deletion reaper (see _on_object_out_of_scope for why the
        # callback itself must never touch the store).
        self._reap_queue: deque = deque()
        self._reap_event = threading.Event()
        self._reaper_thread = threading.Thread(
            target=self._reaper_loop, name="object-reaper", daemon=True
        )
        self._reaper_thread.start()
        self.refcount = ReferenceCounter(
            on_object_out_of_scope=self._on_object_out_of_scope,
            on_lineage_released=self._release_lineage,
        )
        # Lineage table: producing spec kept while any output is referenced,
        # enabling re-execution of lost objects (reference: lineage pinning,
        # reference_count.h:75 + object_recovery_manager.h:42). The retained
        # spec's arg ObjectRefs transitively pin upstream lineage via ordinary
        # handle liveness.
        self._lineage: dict[TaskID, tuple[TaskSpec, dict]] = {}
        self._recovering: dict[TaskID, threading.Event] = {}
        self.store.set_pinned_check(self.refcount.pinned)
        self.job_id = JobID.from_int(self.controller.next_job_id())
        self.driver_task_id = TaskID.for_job(self.job_id)
        self._put_counter = _Counter()
        self._lock = threading.RLock()
        self.engines: dict[NodeID, NodeEngine] = {}
        self.actor_executors: dict[ActorID, ActorExecutor] = {}
        self._actor_buffers: dict[ActorID, list[TaskSpec]] = {}
        self._actor_chains: dict[ActorID, "deque[dict]"] = {}
        self._actor_specs: dict[ActorID, TaskSpec] = {}
        self._actor_grants: dict[ActorID, tuple[NodeID, dict[str, float]]] = {}
        self._task_records: dict[TaskID, _TaskRecord] = {}
        self._streams: dict[TaskID, Any] = {}
        # Per-node companion process engines (per-actor isolation overrides).
        self._companions: dict[NodeID, Any] = {}
        from ray_tpu_torch._private.task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer()
        # Cross-node worker log plane: engine and daemon pipe tails feed
        # this ring; sinks reprint on the driver and fan out to remote
        # clients (reference: log_monitor.py → pubsub → worker.py print_logs).
        from ray_tpu_torch._private.log_aggregation import (
            LogBuffer,
            print_batch_to_driver,
        )

        self.logs = LogBuffer()
        if self.config.log_to_driver:
            self.logs.add_sink(print_batch_to_driver)
        # User spans shipped home by workers (util/tracing.py traces()).
        self.user_spans: deque = deque(maxlen=10_000)
        from ray_tpu_torch._private.runtime_env import RuntimeEnvManager

        self.runtime_env_manager = RuntimeEnvManager()
        self._background = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="ray_tpu_torch-bg"
        )
        self.scheduler = Scheduler(
            self.controller, dispatch=self._dispatch, fail_task=self._fail_unscheduled
        )
        # Handles pinning detached actors' creation objects (their lifetime is
        # the cluster's, not any caller's).
        self._detached_creation_refs: list = []
        # Host-memory monitor: only process-backed workers are killable.
        self.memory_monitor = None
        if (
            self.config.memory_usage_threshold
            and self.config.isolation == "process"
        ):
            from ray_tpu_torch._private.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                self,
                threshold=self.config.memory_usage_threshold,
                period_s=self.config.memory_monitor_refresh_s,
                kill_cooldown_ticks=self.config.memory_monitor_kill_cooldown_ticks,
            )
            self.scheduler.dispatch_gate = (
                lambda: not self.memory_monitor.under_pressure
            )
        _RUNTIME = self
        if resources is not None:
            self.add_node(resources, is_head=True)
        # Standard per-subsystem gauge suite (stats/metric_defs.h analog):
        # refreshed in the background, rendered by prometheus_text().
        from ray_tpu_torch.util.runtime_metrics import RuntimeMetricsSampler

        self._metrics_sampler = RuntimeMetricsSampler(self)
        # Web dashboard (dashboard/head.py): read-only HTTP over the state
        # sources above (reference: dashboard/head.py module autoload).
        self.dashboard = None
        if self.config.include_dashboard:
            from ray_tpu_torch.dashboard import start_dashboard

            self.dashboard = start_dashboard(
                self,
                host=self.config.dashboard_host,
                port=self.config.dashboard_port,
            )
        if self._gcs_storage is not None:
            from ray_tpu_torch._private.gcs_storage import restore_snapshot

            if self._pending_snapshot:
                restore_snapshot(self, self._pending_snapshot)
                self._pending_snapshot = None
            self._persist_stop = threading.Event()
            self._persist_thread = threading.Thread(
                target=self._persist_loop, name="gcs-persist", daemon=True
            )
            self._persist_thread.start()

    def _persist_loop(self) -> None:
        """Debounced control-plane flush (the reference writes GCS tables to
        Redis asynchronously; a crash loses at most one interval)."""
        from ray_tpu_torch._private.gcs_storage import build_snapshot

        interval = max(0.5, self.config.health_check_period_s)
        while not self._persist_stop.wait(interval):
            try:
                self._gcs_storage.save(build_snapshot(self))
            except Exception:
                pass  # disk hiccup: retry next interval

    # ------------------------------------------------------------------ nodes

    def add_node(
        self,
        resources: dict[str, float],
        labels: Optional[dict] = None,
        is_head: bool = False,
    ) -> NodeID:
        node = NodeState(NodeID.from_random(), resources, labels)
        if self.config.isolation == "process":
            from ray_tpu_torch._private.process_engine import ProcessNodeEngine

            engine = ProcessNodeEngine(node, self, on_task_done=self._on_task_done)
        else:
            engine = NodeEngine(node, on_task_done=self._on_task_done)
        with self._lock:
            self.engines[node.node_id] = engine
        self.controller.register_node(node, is_head=is_head)
        self.controller.retry_pending_placement_groups()
        return node.node_id

    # --------------------------------------------------------- remote nodes

    def register_remote_node(self, handle, reg: dict) -> NodeID:
        """A node daemon registered over TCP: build its NodeState + engine
        (GcsNodeManager::HandleRegisterNode; the daemon is the raylet)."""
        from ray_tpu_torch._private.remote_node import RemoteNodeEngine

        self._ensure_object_plane()
        resources = {
            k: float(v) for k, v in (reg.get("resources") or {}).items() if v
        }
        node = NodeState(handle.node_id, resources, reg.get("labels"))
        engine = RemoteNodeEngine(node, self, handle)
        with self._lock:
            self.engines[node.node_id] = engine
            self._node_handles[node.node_id] = handle
        self.controller.register_node(node)
        self.controller.retry_pending_placement_groups()
        self.scheduler.notify()
        return handle.node_id

    def on_node_disconnected(self, node_id: NodeID) -> None:
        """Node daemon connection dropped: treat as node death — objects
        whose only copy lived there become lost (lineage recovery), actors
        restart elsewhere, dispatched tasks retry."""
        self.remove_node(node_id)

    def _ensure_object_plane(self) -> None:
        from ray_tpu_torch._private.object_plane import ObjectFetcher, ObjectServer

        if self._object_fetcher is not None:
            return
        head = self._head_server
        token = head.token if head else ""
        # Bind where the control plane binds: a loopback-only (or
        # auth-disabled, trusted-local) head must not silently widen its
        # exposure through the object plane.
        host = head.host if head else "127.0.0.1"
        self._object_fetcher = ObjectFetcher(token)
        try:
            self._object_server = ObjectServer(
                self._object_bytes_provider, token, host=host
            )
        except OSError:
            self._object_server = None

    def _object_bytes_provider(self, oid_bytes: bytes):
        """Serve this process's copy of an object to a pulling peer."""
        from ray_tpu_torch._private.object_plane import TAG_ENVELOPE, TAG_PICKLE

        oid = ObjectID(oid_bytes)
        ns = self._native_store
        if ns is not None:
            view = ns.get_raw(oid)
            if view is not None:
                # Serve straight from shm: the object server sendall()s the
                # live view and releases the pin afterwards — no heap copy,
                # memory bounded regardless of object size.
                return (TAG_ENVELOPE, view, lambda: ns.release(oid))
        data = self.store.get_serialized(oid)
        if data is not None:
            return (TAG_PICKLE, data)
        try:
            if self.store.contains(oid) and self.store.location_of(oid) is None:
                value = self.store.get(oid, timeout=0)
                return (TAG_PICKLE, cloudpickle.dumps(value, protocol=5))
        except Exception:
            return None
        return None

    def _fetch_remote_object(self, oid: ObjectID, node_id: NodeID):
        """Pull a remotely-located object's bytes from the holding node's
        object server and cache them locally (the head-side PullManager)."""
        from ray_tpu_torch._private import native_store as native_mod
        from ray_tpu_torch._private.object_plane import TAG_ENVELOPE

        # Try every known holder (producer first, then cached copies): a
        # dead producer doesn't lose the object while any node still holds
        # a pulled copy.
        candidates = [node_id] + [
            n for n in self.store.locations_of(oid) if n != node_id
        ]
        fetched = None
        last_exc: Exception | None = None
        for candidate in candidates:
            handle = self._node_handles.get(candidate)
            if handle is None or not handle.alive or not handle.object_addr:
                continue
            try:
                fetched = self._object_fetcher.fetch(
                    handle.object_addr, oid.binary()
                )
            except (ConnectionError, OSError) as exc:
                last_exc = exc
                continue
            if fetched is not None:
                break
        if fetched is None:
            raise ObjectLostError(
                oid,
                f"Object {oid} could not be pulled from any holder "
                f"{[str(c) for c in candidates]}"
                + (f" (last error: {last_exc})" if last_exc else ""),
            )
        tag, data = fetched
        if tag == TAG_ENVELOPE:
            ns = self._native_store
            if ns is not None:
                try:
                    ns.put_raw(oid, data)
                    self.store.adopt_fetched_native(oid)
                except Exception:
                    pass  # shm full: serve this read, stay remote-located
            return native_mod.decode_envelope(data)
        from ray_tpu_torch._private.wire import loads_value

        value = loads_value(data)
        self.store.adopt_fetched(oid, None, pickled=data)
        return value

    def _on_object_out_of_scope(self, oid: ObjectID) -> None:
        """Out-of-scope callback fires from ObjectRef.__del__, which the
        cyclic GC can run at ANY allocation — including on a thread that
        already holds the store lock. Touching the store here would deadlock
        (observed: GC inside _ensure_entry -> this callback -> store lock),
        so the actual deletion is deferred to the reaper thread."""
        self._reap_queue.append(oid)
        self._reap_event.set()

    def _reaper_loop(self) -> None:
        """Processes deferred object deletions: notifies the holding node
        daemon (if the bytes live remotely) and drops the local entry."""
        while True:
            self._reap_event.wait()
            if self.shutting_down:
                return
            self._reap_event.clear()
            while self._reap_queue:
                try:
                    oid = self._reap_queue.popleft()
                except IndexError:
                    break
                try:
                    location = self.store.location_of(oid)
                    if location is not None:
                        handle = self._node_handles.get(location)
                        if handle is not None and handle.alive:
                            try:
                                handle.conn.send(
                                    "delete_objects", {"oids": [oid.binary()]}
                                )
                            except Exception:
                                pass
                    self.store.delete([oid])
                except Exception:
                    pass  # a single bad entry must not stop the reaper

    def remove_node(self, node_id: NodeID) -> None:
        """Simulate node failure: actors die (and maybe restart elsewhere);
        dispatched tasks are treated as system failures (retry or lost)."""
        node = self.controller.remove_node(node_id)
        with self._lock:
            engine = self.engines.pop(node_id, None)
            companion = self._companions.pop(node_id, None)
            node_handle = self._node_handles.pop(node_id, None)
        if companion is not None:
            companion.shutdown()
        if node_handle is not None:
            # Objects whose only bytes lived on that node are lost — but
            # leave their entries sealed+located: the next read's fetch
            # raises ObjectLostError (dead node), which is what triggers
            # lineage recovery. Unsealing here would block readers forever.
            node_handle.alive = False
            # Cached copies on the dead node must stop being advertised.
            self.store.drop_node_locations(node_id)
        if engine is None:
            return
        # Collect this node's actors before shutdown kills them. Snapshot
        # under the lock: other threads add/remove executors under it, and
        # items() over a resizing dict raises (found by lint RTL201).
        with self._lock:
            doomed_actors = [
                (aid, ex) for aid, ex in self.actor_executors.items()
                if ex.node.node is node
            ]
        engine.shutdown()
        for actor_id, executor in doomed_actors:
            with self._lock:
                self.actor_executors.pop(actor_id, None)
                self._actor_grants.pop(actor_id, None)
            self._handle_actor_death(actor_id, "node died", allow_restart=True)
        # Fail or retry dispatched-but-unfinished normal tasks.
        with self._lock:
            records = [
                r
                for r in self._task_records.values()
                if r.node_id == node_id and r.dispatched and not r.finalized
                and r.spec.kind == TaskKind.NORMAL
            ]
        for record in records:
            self._system_failure(record, ObjectLostError(reason="node died"))
        self.scheduler.notify()

    # ------------------------------------------------------------------ utils

    def background(self, fn: Callable) -> None:
        if not self.shutting_down:
            self._background.submit(fn)

    def current_task_id(self) -> TaskID:
        return CONTEXT.task_id or self.driver_task_id

    def _new_task_id(self, actor_id: Optional[ActorID] = None) -> TaskID:
        if actor_id is not None:
            return TaskID.of(actor_id)
        return TaskID.of(ActorID.of(self.job_id))

    @staticmethod
    def _dep_ids(spec: TaskSpec) -> list[ObjectID]:
        deps = []
        for arg in spec.args:
            if isinstance(arg, ObjectRef):
                deps.append(arg.id)
        for arg in spec.kwargs.values():
            if isinstance(arg, ObjectRef):
                deps.append(arg.id)
        return deps

    # ------------------------------------------------------------------- put

    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed")
        oid = ObjectID.of(
            self.current_task_id(), _PUT_INDEX_OFFSET + self._put_counter.next()
        )
        self.refcount.add_owned_object(oid)
        ref = ObjectRef(oid)  # incref before seal so it can't be evicted
        self.store.seal(oid, value)
        return ref

    # ------------------------------------------------------------------- get

    def get(self, refs: list[ObjectRef], timeout: Optional[float]) -> list[Any]:
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        values = []
        for ref in refs:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - _time.monotonic())
            value = self.get_value(ref.id, remaining)
            if isinstance(value, ErrorObject):
                value.raise_()
            values.append(value)
        return values

    def get_value(self, oid: ObjectID, timeout: Optional[float]) -> Any:
        """store.get with lineage recovery: a LOST value (missing spill file,
        shm eviction) re-executes its producing task instead of raising
        (reference: ObjectRecoveryManager, object_recovery_manager.h:42).
        Explicitly freed objects (ObjectFreedError) are never recovered."""
        from ray_tpu_torch.exceptions import ObjectFreedError

        for _attempt in range(3):
            try:
                return self.store.get(oid, timeout)
            except ObjectFreedError:
                raise
            except ObjectLostError:
                if not self._try_recover(oid):
                    raise
        return self.store.get(oid, timeout)

    # ------------------------------------------------------------ recovery

    def _release_lineage(self, task_id: TaskID) -> None:
        with self._lock:
            self._lineage.pop(task_id, None)

    def _try_recover(self, oid: ObjectID) -> bool:
        """Re-execute the producing task of a lost object. Returns False if
        no lineage is retained (put objects, streaming items, actor tasks)."""
        task_id = oid.task_id
        with self._lock:
            entry = self._lineage.get(task_id)
        if entry is None:
            return False
        spec, request = entry
        with self._lock:
            event = self._recovering.get(task_id)
            leader = event is None
            if leader:
                event = threading.Event()
                self._recovering[task_id] = event
        if not leader:
            # Another thread is already reconstructing this task's outputs.
            event.wait(timeout=300)
            return True
        try:
            # Recursively ensure the args exist (their own recovery may
            # re-execute upstream producers). Probe availability WITHOUT
            # materializing values — dispatch-time arg resolution will do
            # the one real deserialization.
            for dep in self._dep_ids(spec):
                if self.store.is_available(dep):
                    continue
                if self.store.was_freed(dep):
                    return False  # explicitly freed: never resurrected
                if not self._try_recover(dep):
                    return False  # upstream unrecoverable
                ready, _ = self.store.wait([dep], 1, timeout=300)
                if not ready:
                    return False
            for ret in spec.return_ids:
                self.store.invalidate(ret)
            with self._lock:
                self._task_records[spec.task_id] = _TaskRecord(spec, request)
            from ray_tpu_torch.util import tracing as _tracing

            trace_ctx = spec.trace_ctx
            self.task_events.record(
                spec.task_id, "PENDING_ARGS_AVAIL", name=spec.name,
                kind="RECOVERY", job_id=spec.job_id,
                trace_id=(
                    trace_ctx[0] if trace_ctx
                    else _tracing.task_span_id(spec.task_id)
                ),
                parent_span_id=trace_ctx[1] if trace_ctx else None,
            )
            self._submit_when_ready(spec, request)
            return True
        finally:
            with self._lock:
                self._recovering.pop(task_id, None)
            event.set()

    # ------------------------------------------------------------------ wait

    def wait(
        self,
        refs: list[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
    ) -> tuple[list[ObjectRef], list[ObjectRef]]:
        by_id = {ref.id: ref for ref in refs}
        ready_ids, remaining_ids = self.store.wait(
            [r.id for r in refs], num_returns, timeout
        )
        return [by_id[i] for i in ready_ids], [by_id[i] for i in remaining_ids]

    # ---------------------------------------------------------- task submit

    def submit_task(
        self,
        func: Callable,
        args: tuple,
        kwargs: dict,
        *,
        name: str,
        num_returns: int,
        resources: dict[str, float],
        scheduling_strategy: Any,
        max_retries: int,
        retry_exceptions: Any,
        runtime_env: Optional[dict] = None,
        trace_ctx: Optional[tuple] = None,
    ) -> list[ObjectRef]:
        from ray_tpu_torch._private.runtime_env import validate_runtime_env

        runtime_env = validate_runtime_env(runtime_env)
        streaming = num_returns == "streaming"
        spec = TaskSpec(
            task_id=self._new_task_id(),
            job_id=self.job_id,
            name=name,
            kind=TaskKind.NORMAL,
            func=func,
            args=args,
            kwargs=dict(kwargs),
            num_returns=1 if streaming else num_returns,
            streaming=streaming,
            resources=resources,
            scheduling_strategy=scheduling_strategy,
            # Streaming tasks are not retried: items already consumed can't be
            # un-yielded (reference dedups by item index; out of scope here).
            max_retries=0 if streaming else max_retries,
            retry_exceptions=retry_exceptions,
            runtime_env=runtime_env,
            parent_task_id=self.current_task_id(),
            trace_ctx=trace_ctx or _capture_trace(),
        )
        spec.compute_return_ids()
        refs = []
        for oid in spec.return_ids:
            self.refcount.add_owned_object(oid, owner_task=spec.task_id)
            refs.append(ObjectRef(oid))
        with self._lock:
            self._task_records[spec.task_id] = _TaskRecord(spec, resources)
            if not streaming and spec.return_ids:
                # Streaming outputs can't be deterministically re-yielded, and
                # num_returns=0 tasks have nothing to recover (their lineage
                # release would also never fire — no tracked outputs).
                self._lineage[spec.task_id] = (spec, dict(resources))
        if streaming:
            gen = self._register_stream(spec, completion_ref=refs[0])
            self._submit_when_ready(spec, resources)
            return [gen]
        self._submit_when_ready(spec, resources)
        return refs

    # ------------------------------------------------------- streaming gens

    def _register_stream(self, spec: TaskSpec, completion_ref: ObjectRef):
        """Create the owner-side ObjectRefStream for a streaming task
        (reference: TaskManager ObjectRefStream, task_manager.h:100)."""
        from ray_tpu_torch._private.streaming import ObjectRefGenerator, ObjectRefStream

        stream = ObjectRefStream()
        with self._lock:
            self._streams[spec.task_id] = stream
        gen = ObjectRefGenerator(stream, spec.task_id)
        # The completion object's lifetime rides on the generator handle.
        gen._completion_ref = completion_ref
        return gen

    def report_stream_item(
        self,
        spec: TaskSpec,
        index: int,
        value: Any = None,
        error: Optional[BaseException] = None,
        traceback_str: str = "",
    ) -> None:
        """Seal one yielded item and hand its ref to the consumer (reference:
        CoreWorker::ReportGeneratorItemReturns, core_worker.h:770)."""
        with self._lock:
            stream = self._streams.get(spec.task_id)
        oid = ObjectID.of(spec.task_id, _STREAM_INDEX_OFFSET + index)
        self.refcount.add_owned_object(oid, owner_task=spec.task_id)
        ref = ObjectRef(oid)
        if error is not None:
            exc = error
            if not isinstance(
                exc,
                (
                    TaskError,
                    ActorDiedError,
                    ObjectLostError,
                    TaskCancelledError,
                    PoisonRequestError,
                ),
            ):
                exc = TaskError(exc, traceback_str, spec.name)
            self.store.seal(oid, ErrorObject(exc, traceback_str))
        else:
            self.store.seal(oid, value)
        if stream is not None:
            stream.offer(ref)

    def _finish_stream(self, spec: TaskSpec, result: TaskResult) -> None:
        with self._lock:
            stream = self._streams.pop(spec.task_id, None)
        if stream is None:
            return
        if result.exc is not None:
            # Failure before the generator produced (bad args, actor death):
            # surface it as the stream's last item so iteration raises.
            exc = result.exc
            if not isinstance(
                exc,
                (
                    TaskError,
                    ActorDiedError,
                    ObjectLostError,
                    TaskCancelledError,
                    PoisonRequestError,
                ),
            ):
                exc = TaskError(exc, result.traceback_str, spec.name)
            oid = ObjectID.of(spec.task_id, _STREAM_INDEX_OFFSET + _STREAM_ERROR_INDEX)
            self.refcount.add_owned_object(oid, owner_task=spec.task_id)
            ref = ObjectRef(oid)
            self.store.seal(oid, ErrorObject(exc, result.traceback_str))
            stream.offer(ref)
        total = result.value if isinstance(result.value, int) else 0
        stream.finish(total)

    def _record_pending(self, spec: TaskSpec, request: Optional[dict] = None) -> None:
        from ray_tpu_torch.util import tracing

        trace_ctx = spec.trace_ctx
        self.task_events.record(
            spec.task_id,
            "PENDING_ARGS_AVAIL",
            name=spec.name,
            kind=spec.kind.name,
            job_id=spec.job_id,
            actor_id=spec.actor_id,
            required_resources=request,
            trace_id=(
                trace_ctx[0] if trace_ctx
                else tracing.task_span_id(spec.task_id)
            ),
            parent_span_id=trace_ctx[1] if trace_ctx else None,
        )

    def _submit_when_ready(self, spec: TaskSpec, request: dict[str, float]) -> None:
        """Hold args alive for this attempt, then queue once deps are sealed
        (LocalDependencyResolver, transport/dependency_resolver.h)."""
        self._record_pending(spec, request)
        deps = self._dep_ids(spec)
        self.refcount.update_submitted_task_references(deps)
        if not deps:
            self.scheduler.submit(spec, request)
            return
        pending = {"n": len(deps)}
        lock = threading.Lock()

        def on_dep_ready():
            with lock:
                pending["n"] -= 1
                ready = pending["n"] == 0
            if ready:
                self.scheduler.submit(spec, request)

        for dep in deps:
            self.store.on_sealed(dep, on_dep_ready)

    # ---------------------------------------------------------------- actors

    def create_actor(
        self,
        cls: type,
        args: tuple,
        kwargs: dict,
        *,
        name: Optional[str],
        namespace: Optional[str],
        resources: dict[str, float],
        scheduling_strategy: Any,
        max_restarts: int,
        max_task_retries: int,
        max_concurrency: int,
        detached: bool,
        runtime_env: Optional[dict] = None,
        trace_ctx: Optional[tuple] = None,
        isolation: Optional[str] = None,
    ) -> tuple[ActorID, ObjectRef]:
        from ray_tpu_torch._private.runtime_env import validate_runtime_env

        runtime_env = validate_runtime_env(runtime_env)
        actor_id = ActorID.of(self.job_id)
        spec = TaskSpec(
            task_id=TaskID.of(actor_id),
            job_id=self.job_id,
            name=f"{cls.__name__}.__init__",
            kind=TaskKind.ACTOR_CREATION,
            func=cls,
            args=args,
            kwargs=dict(kwargs),
            num_returns=1,
            resources=resources,
            scheduling_strategy=scheduling_strategy,
            actor_id=actor_id,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            runtime_env=runtime_env,
            parent_task_id=self.current_task_id(),
            isolation=isolation,
            trace_ctx=trace_ctx or _capture_trace(),
        )
        spec.compute_return_ids()
        record = ActorRecord(
            actor_id=actor_id,
            name=name,
            namespace=namespace or self.namespace,
            max_restarts=max_restarts,
            detached=detached,
            class_name=cls.__name__,
        )
        self.controller.register_actor(record)
        self.refcount.add_owned_object(spec.return_ids[0], owner_task=spec.task_id)
        creation_ref = ObjectRef(spec.return_ids[0])
        with self._lock:
            if detached:
                # A detached actor's lifetime is the cluster's: pin its
                # creation object so dropping the user handle can't collect
                # it. Under the lock: _handle_actor_death prunes this list
                # under self._lock from other threads (found by lint
                # RTL201).
                self._detached_creation_refs.append(creation_ref)
            self._actor_specs[actor_id] = spec
            self._actor_buffers[actor_id] = []
            self._task_records[spec.task_id] = _TaskRecord(spec, resources)
        self._submit_when_ready(spec, resources)
        return actor_id, creation_ref

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: tuple,
        kwargs: dict,
        *,
        name: str,
        num_returns: int,
        trace_ctx: Optional[tuple] = None,
    ) -> list[ObjectRef]:
        maybe_fail("actor.submit", detail=name)
        record = self.controller.get_actor_record(actor_id)
        if record is None:
            raise ValueError(f"Unknown actor {actor_id}")
        creation = self._actor_specs.get(actor_id)
        streaming = num_returns == "streaming"
        spec = TaskSpec(
            task_id=TaskID.of(actor_id),
            job_id=self.job_id,
            name=name,
            kind=TaskKind.ACTOR_TASK,
            method_name=method_name,
            args=args,
            kwargs=dict(kwargs),
            num_returns=1 if streaming else num_returns,
            streaming=streaming,
            resources={},
            actor_id=actor_id,
            max_retries=0 if streaming else (creation.max_task_retries if creation else 0),
            retry_exceptions=False,
            parent_task_id=self.current_task_id(),
            trace_ctx=trace_ctx or _capture_trace(),
        )
        spec.compute_return_ids()
        refs = []
        for oid in spec.return_ids:
            self.refcount.add_owned_object(oid, owner_task=spec.task_id)
            refs.append(ObjectRef(oid))
        with self._lock:
            self._task_records[spec.task_id] = _TaskRecord(spec, {})
        if streaming:
            gen = self._register_stream(spec, completion_ref=refs[0])
            self._enqueue_actor_task_when_ready(spec)
            return [gen]
        self._enqueue_actor_task_when_ready(spec)
        return refs

    def _enqueue_actor_task_when_ready(self, spec: TaskSpec) -> None:
        """Ordered delivery: actor calls are handed to the executor in strict
        submission order, with the chain head blocking on its argument deps —
        the caller-side sequential submit queue
        (transport/sequential_actor_submit_queue.h)."""
        self._record_pending(spec)
        deps = self._dep_ids(spec)
        self.refcount.update_submitted_task_references(deps)
        entry = {"spec": spec, "ready": not deps}
        with self._lock:
            chain = self._actor_chains.setdefault(spec.actor_id, deque())
            chain.append(entry)
        if deps:
            pending = {"n": len(deps)}
            dep_lock = threading.Lock()

            def on_dep_ready():
                with dep_lock:
                    pending["n"] -= 1
                    ready = pending["n"] == 0
                if ready:
                    entry["ready"] = True
                    self._advance_actor_chain(spec.actor_id)

            for dep in deps:
                self.store.on_sealed(dep, on_dep_ready)
        self._advance_actor_chain(spec.actor_id)

    def _advance_actor_chain(self, actor_id: ActorID) -> None:
        while True:
            with self._lock:
                chain = self._actor_chains.get(actor_id)
                if not chain or not chain[0]["ready"]:
                    return
                entry = chain.popleft()
            self._deliver_actor_task(entry["spec"])

    def _deliver_actor_task(self, spec: TaskSpec) -> None:
        with self._lock:
            executor = self.actor_executors.get(spec.actor_id)
            if executor is None:
                buffer = self._actor_buffers.get(spec.actor_id)
                if buffer is not None:
                    buffer.append(spec)
                    return
        if executor is None:
            # Actor already dead and buffer gone.
            record = self.controller.get_actor_record(spec.actor_id)
            reason = (record.death_cause if record else None) or "actor died"
            self._finalize(spec, TaskResult(exc=ActorDiedError(spec.actor_id, reason)))
            return
        executor.submit(spec)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        with self._lock:
            executor = self.actor_executors.pop(actor_id, None)
            node_grant = self._actor_grants.pop(actor_id, None)
        if executor is not None:
            executor.kill(reason="ray_tpu_torch.kill")
            executor.node.remove_actor(actor_id)
            if node_grant is not None:
                node_id, grant = node_grant
                node = self.controller.nodes.get(node_id)
                if node is not None:
                    node.release(grant)
        else:
            # Still pending creation: cancel the creation task.
            spec = self._actor_specs.get(actor_id)
            if spec is not None:
                self.scheduler.cancel(spec.task_id)
                self._finalize(
                    spec, TaskResult(exc=ActorDiedError(actor_id, "killed before start"))
                )
        self._handle_actor_death(
            actor_id, "killed via ray_tpu_torch.kill", allow_restart=not no_restart
        )
        self.scheduler.notify()

    def on_actor_process_died(self, actor_id: ActorID, reason: str) -> None:
        """An actor's worker process died out from under us (crash, os._exit,
        OOM-kill). Release its slot and restart per max_restarts — the
        process-isolation analog of GcsActorManager::OnWorkerDead
        (gcs_actor_manager.cc:1036)."""
        with self._lock:
            executor = self.actor_executors.pop(actor_id, None)
            node_grant = self._actor_grants.pop(actor_id, None)
        if executor is not None:
            if hasattr(executor, "mark_dead"):
                executor.mark_dead(reason)
            executor.node.remove_actor(actor_id)
        if node_grant is not None:
            node_id, grant = node_grant
            node = self.controller.nodes.get(node_id)
            if node is not None:
                node.release(grant)
        self._handle_actor_death(actor_id, reason, allow_restart=True)
        self.scheduler.notify()

    def _handle_actor_death(
        self, actor_id: ActorID, reason: str, allow_restart: bool
    ) -> None:
        record = self.controller.get_actor_record(actor_id)
        if record is None or record.state == ActorState.DEAD:
            return
        can_restart = allow_restart and (
            record.max_restarts == -1 or record.num_restarts < record.max_restarts
        )
        if can_restart:
            record.num_restarts += 1
            record.state = ActorState.RESTARTING
            self._restart_actor(actor_id)
        else:
            self.controller.mark_actor_dead(actor_id, reason)
            with self._lock:
                buffered = self._actor_buffers.pop(actor_id, [])
                # Release the detached-lifetime pin, or cycling detached
                # actors (create/kill loops) leaks one creation spec each.
                creation = self._actor_specs.get(actor_id)
                if creation is not None and creation.return_ids:
                    rid = creation.return_ids[0]
                    self._detached_creation_refs = [
                        r for r in self._detached_creation_refs if r.id != rid
                    ]
            for spec in buffered:
                self._finalize(spec, TaskResult(exc=ActorDiedError(actor_id, reason)))

    def _restart_actor(self, actor_id: ActorID) -> None:
        """Re-run the creation task (GcsActorManager::ReconstructActor)."""
        with self._lock:
            creation = self._actor_specs.get(actor_id)
            if creation is None:
                return
            self._actor_buffers.setdefault(actor_id, [])
            # Fresh attempt of the same creation spec.
            self._task_records[creation.task_id] = _TaskRecord(
                creation, creation.resources
            )
        self._submit_when_ready(creation, creation.resources)

    # --------------------------------------------------------------- cancel

    def cancel(
        self, ref: ObjectRef, force: bool = False, recursive: bool = False
    ) -> bool:
        return self._cancel_task(ref.id.task_id, force=force, recursive=recursive)

    def _cancel_task(
        self,
        task_id,
        *,
        force: bool = False,
        recursive: bool = False,
        _seen: Optional[set] = None,
    ) -> bool:
        if _seen is None:
            _seen = set()
        if task_id in _seen:
            return False
        _seen.add(task_id)
        if recursive:
            # Cancel tasks submitted BY this task first (reference: ray.cancel
            # recursive=True cancels the whole descendant tree). Finished
            # children are no-ops below.
            with self._lock:
                children = [
                    tid
                    for tid, rec in self._task_records.items()
                    if rec.spec.parent_task_id == task_id and tid not in _seen
                ]
            for child in children:
                self._cancel_task(
                    child, force=force, recursive=True, _seen=_seen
                )
        if self.scheduler.cancel(task_id):
            with self._lock:
                record = self._task_records.get(task_id)
            if record is not None:
                self._finalize(record.spec, TaskResult(cancelled=True, exc=TaskCancelledError(task_id)))
            return True
        # Already running: a thread can't be preempted, but a RUNNING
        # streaming task stops at its next yield — the stream drivers check
        # the engine-level cancel registry between items (reference: the
        # running-generator cancel path; the stream then completes early and
        # its completion ref seals, releasing any router slots).
        with self._lock:
            record = self._task_records.get(task_id)
        if record is not None and record.spec.streaming:
            with self._lock:
                engines = list(self.engines.values()) + list(
                    self._companions.values()
                )
            from ray_tpu_torch._private import engine as _engine

            _engine.request_stream_cancel(task_id)  # in-process drivers
            for eng in engines:  # worker processes
                forward = getattr(eng, "request_stream_cancel", None)
                if forward is None:
                    continue
                try:
                    if forward(task_id):
                        break
                except Exception:
                    pass
            return True
        return False

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, spec: TaskSpec, node: NodeState, grant: dict[str, float]):
        self.task_events.record(spec.task_id, "RUNNING", node_id=node.node_id)
        with self._lock:
            engine = self.engines.get(node.node_id)
            record = self._task_records.get(spec.task_id)
            if record is not None:
                record.node_id = node.node_id
                record.dispatched = True
        if engine is None:  # node died between pick and dispatch
            node.release(grant)
            if record is not None:
                self._system_failure(record, ObjectLostError(reason="node died"))
            return
        if spec.kind == TaskKind.ACTOR_CREATION:
            if spec.isolation == "process" and isinstance(engine, NodeEngine):
                # Per-actor isolation override on a threaded node: host the
                # actor in this node's companion process engine instead.
                engine = self._process_companion(node)
            executor = engine.create_actor(spec, grant, self._resolve_args)
            actor_record = self.controller.get_actor_record(spec.actor_id)
            if actor_record is not None:
                actor_record.node_id = node.node_id
            with self._lock:
                self.actor_executors[spec.actor_id] = executor
                self._actor_grants[spec.actor_id] = (node.node_id, grant)
                buffered = self._actor_buffers.pop(spec.actor_id, [])
                self._actor_buffers[spec.actor_id] = []
            for queued in buffered:
                executor.submit(queued)
        else:
            engine.execute_task(spec, grant, self._resolve_args)

    def _process_companion(self, node: NodeState):
        """Lazily-created ProcessNodeEngine sharing a threaded node's
        NodeState, hosting actors that demanded isolation=\"process\"."""
        from ray_tpu_torch._private.process_engine import ProcessNodeEngine

        with self._lock:
            companion = self._companions.get(node.node_id)
            if companion is None:
                companion = ProcessNodeEngine(
                    node, self, on_task_done=self._on_task_done
                )
                self._companions[node.node_id] = companion
        return companion

    def _resolve_args(self, spec: TaskSpec) -> tuple[tuple, dict]:
        """Replace top-level ObjectRef args with their values (the dependency
        resolver guarantees they are sealed). A failed dependency re-raises its
        error so the dependent task fails with the same cause (error cascade)."""

        def resolve(value):
            if isinstance(value, ObjectRef):
                stored = self.get_value(value.id, timeout=30.0)
                if isinstance(stored, ErrorObject):
                    stored.raise_()
                return stored
            if self.config.inproc_copy_args:
                return cloudpickle.loads(cloudpickle.dumps(value))
            return value

        args = tuple(resolve(a) for a in spec.args)
        kwargs = {k: resolve(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    # ------------------------------------------------------------ completion

    def _on_task_done(
        self,
        spec: TaskSpec,
        node: NodeState,
        grant: dict[str, float],
        result: TaskResult,
    ) -> None:
        keep_grant = spec.kind == TaskKind.ACTOR_CREATION and result.exc is None
        if grant and not keep_grant:
            node.release(grant)
            if spec.kind == TaskKind.ACTOR_CREATION:
                with self._lock:
                    self._actor_grants.pop(spec.actor_id, None)
        self.refcount.update_finished_task_references(self._dep_ids(spec))

        if result.exc is not None and not result.cancelled:
            handled = self._maybe_retry(spec, result)
            if handled:
                self.scheduler.notify()
                return
        self._finalize(spec, result, already_decrefed=True)
        if spec.kind == TaskKind.ACTOR_CREATION:
            actor_record = self.controller.get_actor_record(spec.actor_id)
            if result.exc is None:
                if actor_record is not None:
                    actor_record.state = ActorState.ALIVE
            else:
                with self._lock:
                    executor = self.actor_executors.pop(spec.actor_id, None)
                if executor is not None:
                    # Tear the executor down fully — in process mode this
                    # kills the dedicated worker process, which would
                    # otherwise idle forever (one leaked OS process per
                    # failed constructor).
                    try:
                        executor.kill(reason="constructor failed")
                        executor.node.remove_actor(spec.actor_id)
                    except Exception:
                        pass
                self._handle_actor_death(
                    spec.actor_id,
                    f"constructor failed: {result.exc!r}",
                    allow_restart=False,
                )
        self.scheduler.notify()

    def _maybe_retry(self, spec: TaskSpec, result: TaskResult) -> bool:
        from ray_tpu_torch.exceptions import WorkerCrashedError

        system_failure = isinstance(
            result.exc, (ActorDiedError, ObjectLostError, WorkerCrashedError)
        )
        with self._lock:
            record = self._task_records.get(spec.task_id)
            if record is None:
                return False
            if record.retries_left <= 0:
                return False
            if spec.kind == TaskKind.ACTOR_TASK:
                actor_record = self.controller.get_actor_record(spec.actor_id)
                retriable = (
                    system_failure
                    and actor_record is not None
                    and actor_record.state
                    in (ActorState.RESTARTING, ActorState.ALIVE, ActorState.PENDING)
                )
                if not retriable:
                    return False
            elif not spec.should_retry(result.exc, system_failure):
                return False
            record.retries_left -= 1
        if spec.kind == TaskKind.ACTOR_TASK:
            self._enqueue_actor_task_when_ready(spec)
        else:
            self._submit_when_ready(spec, record.request)
        return True

    def _system_failure(self, record: _TaskRecord, exc: Exception) -> None:
        with self._lock:
            if record.finalized:
                return
            if record.retries_left > 0:
                record.retries_left -= 1
                retry = True
            else:
                retry = False
        if retry:
            self._submit_when_ready(record.spec, record.request)
        else:
            result = TaskResult(exc=exc)
            self._finalize(record.spec, result)

    def _fail_unscheduled(self, spec: TaskSpec, exc: BaseException) -> None:
        """Scheduler could not place the task (infeasible / bad PG)."""
        self.refcount.update_finished_task_references(self._dep_ids(spec))
        result = TaskResult(exc=exc)
        self._finalize(spec, result, already_decrefed=True)

    def _finalize(
        self, spec: TaskSpec, result: TaskResult, already_decrefed: bool = False
    ) -> None:
        with self._lock:
            record = self._task_records.get(spec.task_id)
            if record is not None:
                if record.finalized:
                    return
                record.finalized = True
                if spec.kind != TaskKind.ACTOR_CREATION:
                    self._task_records.pop(spec.task_id, None)
        if spec.streaming:
            # Drop any pending stream-cancel mark: in the driver process the
            # stream driver's own finally runs in the WORKER, so without
            # this the driver-side entry would linger until the cap ages it.
            from ray_tpu_torch._private.engine import _clear_stream_cancel

            _clear_stream_cancel(spec.task_id)
        if result.cancelled or result.exc is not None:
            exc = result.exc
            self.task_events.record(
                spec.task_id,
                "FAILED",
                error_type=type(exc).__name__ if exc is not None else "Cancelled",
                error_message=str(exc) if exc is not None else "",
            )
        else:
            self.task_events.record(spec.task_id, "FINISHED")
        try:
            if not already_decrefed:
                self.refcount.update_finished_task_references(self._dep_ids(spec))
            if result.cancelled:
                error = ErrorObject(
                    result.exc or TaskCancelledError(spec.task_id), result.traceback_str
                )
                for oid in spec.return_ids:
                    self.store.seal(oid, error)
                return
            if result.exc is not None:
                from ray_tpu_torch.exceptions import WorkerCrashedError

                exc = result.exc
                if not isinstance(
                    exc,
                    (
                        TaskError,
                        ActorDiedError,
                        ObjectLostError,
                        TaskCancelledError,
                        WorkerCrashedError,
                        PoisonRequestError,
                    ),
                ):
                    exc = TaskError(exc, result.traceback_str, spec.name)
                error = ErrorObject(exc, result.traceback_str)
                for oid in spec.return_ids:
                    self.store.seal(oid, error)
                return
            try:
                self._seal_returns(spec, result.value)
            except MemoryError as exc:
                # The value didn't fit in the store even after eviction; surface
                # the OOM to the caller instead of leaving returns unsealed forever
                # (the reference spills to disk here — spilling is a later milestone).
                error = ErrorObject(TaskError(exc, "", spec.name))
                for oid in spec.return_ids:
                    self.store.seal(oid, error)
        finally:
            # Every finalize path must release stream consumers, or a
            # generator killed/cancelled before producing hangs its reader
            # (kill/cancel/actor-death paths call _finalize directly).
            if spec.streaming:
                self._finish_stream(spec, result)

    def _seal_returns(self, spec: TaskSpec, value: Any) -> None:
        from ray_tpu_torch._private.engine import SEALED_EXTERNALLY

        if value is SEALED_EXTERNALLY:
            return  # the worker's bytes are already sealed (process_engine)
        n = spec.num_returns
        if n == 0:
            return
        if n == 1:
            self.store.seal(spec.return_ids[0], value)
            return
        if not isinstance(value, (tuple, list)) or len(value) != n:
            err = ErrorObject(
                TaskError(
                    ValueError(
                        f"Task {spec.name} declared num_returns={n} but returned "
                        f"{type(value).__name__}"
                    ),
                    "",
                    spec.name,
                )
            )
            for oid in spec.return_ids:
                self.store.seal(oid, err)
            return
        for oid, item in zip(spec.return_ids, value):
            self.store.seal(oid, item)

    def serve_clients(
        self, host: str = "127.0.0.1", port: int = 0, token: Optional[str] = None
    ) -> str:
        """Expose the control plane over TCP for node daemons and remote
        drivers (ray_tpu_torch.init(address=...)). Returns the bound address,
        which carries the auth token ("host:port?token=<hex>"). token=None
        generates one unless RAY_TPU_TORCH_CLIENT_TOKEN is set (the
        cross-machine deployment path: export the same value on every host);
        token="" disables auth."""
        from ray_tpu_torch._private.head_server import HeadServer

        if token is None:
            token = os.environ.get("RAY_TPU_TORCH_CLIENT_TOKEN") or None
        self._head_server = HeadServer(self, host, port, token=token)
        return self._head_server.address

    # ------------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        global _RUNTIME
        if self._metrics_sampler is not None:
            self._metrics_sampler.stop()
            self._metrics_sampler = None
        if self.dashboard is not None:
            self.dashboard.stop()
            self.dashboard = None
        if self._head_server is not None:
            try:
                self._head_server.stop()
            except Exception:
                pass
            self._head_server = None
        if self._gcs_storage is not None:
            from ray_tpu_torch._private.gcs_storage import build_snapshot

            # Stop + join the persist thread BEFORE the final save, so a
            # racing tick can't overwrite the good snapshot with one taken
            # mid-teardown (detached actors would read as DEAD and be lost).
            self._persist_stop.set()
            self._persist_thread.join(timeout=5.0)
            try:
                self._gcs_storage.save(build_snapshot(self))
            except Exception:
                pass
        self.shutting_down = True
        self._reap_event.set()  # release the reaper thread
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        self.scheduler.shutdown()
        with self._lock:
            engines = list(self.engines.values()) + list(self._companions.values())
            self.engines.clear()
            self._companions.clear()
            self._node_handles.clear()
        for engine in engines:
            engine.shutdown()
        if self._object_server is not None:
            try:
                self._object_server.stop()
            except Exception:
                pass
        if self._object_fetcher is not None:
            self._object_fetcher.close()
        self._background.shutdown(wait=False, cancel_futures=True)
        if self._native_store is not None:
            try:
                self._native_store.destroy()
            except Exception:
                pass
            self._native_store = None
        try:
            self.runtime_env_manager.cleanup()
        except Exception:
            pass
        if self._spill_storage is not None:
            try:
                self._spill_storage.destroy()
            except Exception:
                pass
        _RUNTIME = None


def get_runtime() -> Runtime:
    if _RUNTIME is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return _RUNTIME
