"""Process-isolated execution engine (driver side).

The analog of the reference's worker pool + direct task transport
(raylet/worker_pool.h:156 PopWorker/prestart, transport/direct_task_transport.h):
each logical node runs real OS worker processes (worker_main.py), one task at a
time per worker, one dedicated process per actor. Task specs, argument values
and results cross a real serialization boundary (wire.py); large values ride
the shared-memory native store instead of the socket.

Failure semantics this buys over the threaded engine:
  * a crashing worker (segfault, os._exit) kills only itself — the driver maps
    the EOF to WorkerCrashedError / ActorDiedError and retries per policy;
  * workers fate-share with the driver through the socket (EOF -> exit);
  * mutation aliasing is impossible: every value is serialized across;
  * a worker's CUDA context is its own: killing the process (an OOM kill
    by the memory monitor, a crash) gives its card memory back.

Selected with config flag `isolation="process"` (env RAY_TPU_TORCH_ISOLATION),
or per actor with `.options(isolation="process")`.

Three classes share the work, as in the reference: `WirePeer` serves the
runtime's API over one connection (a remote driver's `ClientHandle` is
one), `WorkerChannel` adds task dispatch and frame handling, and
`ProcessWorkerHandle` the local subprocess (remote_node.RemoteWorkerHandle
the daemon-hosted one).
"""

from __future__ import annotations

import itertools
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import cloudpickle

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.controller import NodeState
from ray_tpu_torch._private.engine import SEALED_EXTERNALLY, TaskResult
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    TaskError,
    WorkerCrashedError,
)


# The directory holding the ray_tpu_torch package.
_PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class WirePeer:
    """Shared driver-side state + RPC service for one wire connection.

    Serves the runtime's ownership-bearing API (put/get/wait/submit/actors/
    streams) to a connected peer — a local worker process
    (ProcessWorkerHandle), a worker hosted by a node daemon
    (remote_node.RemoteWorkerHandle) or a remote driver client
    (head_server.ClientHandle) — with per-peer borrow accounting released on
    disconnect: the reference's CoreWorkerService + GCS RPC handlers
    collapsed onto one framed socket."""

    def __init__(self, runtime):
        self.runtime = runtime
        self._lock = threading.Lock()
        # oid bytes -> borrow count held on behalf of this peer
        self.borrows: dict[bytes, int] = {}
        # task_id bytes -> driver-side ObjectRefGenerator (peer-submitted
        # streaming tasks pulled via next_stream_item)
        self.streams: dict[bytes, Any] = {}
        self.conn: wire.Connection  # set by subclass before use
        self.rpc_pool: ThreadPoolExecutor  # set by subclass before use

    # -- borrows -----------------------------------------------------------

    def preborrow(self, oid: ObjectID) -> bytes:
        """Take a driver-side reference on behalf of this worker (closes the
        reply/incref race of the borrower protocol)."""
        raw = oid.binary()
        with self._lock:
            self.borrows[raw] = self.borrows.get(raw, 0) + 1
        self.runtime.refcount.add_local_reference(oid)
        return raw

    def _drop_all_borrows(self) -> None:
        with self._lock:
            borrows, self.borrows = self.borrows, {}
        for raw, count in borrows.items():
            for _ in range(count):
                self.runtime.refcount.remove_local_reference(ObjectID(raw))

    def _handle_incref(self, body: dict) -> None:
        with self._lock:
            raw = body["oid"]
            self.borrows[raw] = self.borrows.get(raw, 0) + 1
        self.runtime.refcount.add_local_reference(ObjectID(body["oid"]))

    def _handle_decref(self, body: dict) -> None:
        raw = body["oid"]
        with self._lock:
            n = self.borrows.get(raw, 0)
            if n <= 1:
                self.borrows.pop(raw, None)
            else:
                self.borrows[raw] = n - 1
        if n >= 1:
            self.runtime.refcount.remove_local_reference(ObjectID(raw))

    def _handle_ref_deltas(self, body: dict) -> None:
        """Merged borrow deltas from a worker's batching window ("refs" frame):
        positive deltas are increfs, negative are decrefs — applied per oid
        so a worker's net position stays exact with far fewer frames."""
        for raw, delta in body.get("d", ()):
            if delta > 0:
                for _ in range(delta):
                    self._handle_incref({"oid": raw})
            else:
                for _ in range(-delta):
                    self._handle_decref({"oid": raw})

    # -- worker-initiated RPCs ---------------------------------------------

    def _handle_rpc(self, body: dict) -> None:
        msg_id = body["id"]
        try:
            result = self._dispatch_rpc(body["method"], body["payload"])
            reply = {"id": msg_id, "ok": True, "result": result}
        except BaseException as exc:  # noqa: BLE001 — ship errors to the worker
            # Exceptions are user data: pre-pickled so a class the worker
            # can't unpickle degrades to an RPC error there instead of
            # corrupting the frame envelope (the worker fate-shares on
            # envelope corruption).
            try:
                exc_bytes = cloudpickle.dumps(exc, protocol=5)
            except Exception:
                exc_bytes = cloudpickle.dumps(
                    RuntimeError(f"unserializable RPC error: {exc!r}"), protocol=5
                )
            reply = {"id": msg_id, "ok": False, "exc_pickled": exc_bytes}
        try:
            self.conn.send("rpc_reply", reply)
        except Exception as exc:
            # A reply over the frame limit says so (a value read with the
            # native store off); anything else could not be pickled.
            if not isinstance(exc, wire.FrameTooLargeError):
                exc = RuntimeError("unserializable RPC reply")
            try:
                self.conn.send(
                    "rpc_reply",
                    {
                        "id": msg_id,
                        "ok": False,
                        "exc": exc,
                    },
                )
            except Exception:
                pass  # worker is gone

    def _dispatch_rpc(self, method: str, payload: dict):
        runtime = self.runtime
        if method == "put":
            ref = runtime.put(payload["value"])
            return {"oid": self.preborrow(ref.id)}
        if method == "get_by_id":
            oid = ObjectID(payload["oid"])
            timeout = payload.get("timeout")
            if not payload.get("force_value"):
                # Wait for seal WITHOUT materializing: shm-resident objects
                # are read by the worker from the segment, so decoding a copy
                # here just to throw it away would waste the whole benefit.
                ready, _ = runtime.store.wait([oid], 1, timeout)
                if not ready:
                    from ray_tpu_torch.exceptions import GetTimeoutError

                    raise GetTimeoutError(
                        f"Get timed out after {timeout}s waiting for {oid}"
                    )
                if runtime.store.is_native(oid):
                    return {"in_native": True}
                # Forward the store's serialized bytes untouched (no driver-
                # side decode + re-encode); the worker deserializes and
                # raises ErrorObjects itself.
                data = runtime.store.get_serialized(oid)
                if data is not None:
                    return {"value_pickled": data}
            value = runtime.get_value(oid, timeout)
            from ray_tpu_torch._private.runtime import ErrorObject

            if isinstance(value, ErrorObject):
                value.raise_()
            # Pre-pickled: rpc_reply frames must stay envelope-safe (a raw
            # user value in the frame would make a worker-side unpickle
            # failure look like wire corruption).
            return {"value_pickled": cloudpickle.dumps(value, protocol=5)}
        if method == "wait_ids":
            oids = [ObjectID(raw) for raw in payload["oids"]]
            ready, remaining = runtime.store.wait(
                oids,
                payload.get("num_returns", len(oids)),
                payload.get("timeout"),
            )
            return {
                "ready": [o.binary() for o in ready],
                "remaining": [o.binary() for o in remaining],
            }
        if method == "submit_task":
            func = cloudpickle.loads(payload["func"])
            out = runtime.submit_task(
                func, payload["args"], payload["kwargs"], **payload["options"]
            )
            return self._reply_refs(out, payload["options"])
        if method == "create_actor":
            cls = cloudpickle.loads(payload["cls"])
            actor_id, ref = runtime.create_actor(
                cls, payload["args"], payload["kwargs"], **payload["options"]
            )
            return {
                "actor_id": actor_id.binary(),
                "creation_ref": self.preborrow(ref.id),
            }
        if method == "submit_actor_task":
            out = runtime.submit_actor_task(
                ActorID(payload["actor_id"]),
                payload["method_name"],
                payload["args"],
                payload["kwargs"],
                **payload["options"],
            )
            return self._reply_refs(out, payload["options"])
        if method == "next_stream_item":
            gen = self.streams.get(payload["task_id"])
            if gen is None:
                return {"done": True, "total": 0}
            from ray_tpu_torch._private.streaming import _SENTINEL

            ref = gen._stream.next()
            if ref is _SENTINEL:
                self.streams.pop(payload["task_id"], None)
                return {"done": True, "total": gen._stream._total}
            return {"done": False, "oid": self.preborrow(ref.id)}
        if method == "named_actor":
            actor_id = runtime.controller.get_named_actor(
                payload["name"], payload["namespace"]
            )
            return {"actor_id": actor_id.binary()} if actor_id else None
        if method == "actor_record":
            record = runtime.controller.get_actor_record(ActorID(payload["actor_id"]))
            if record is None:
                return None
            return {
                "class_name": record.class_name,
                "name": record.name,
                "namespace": record.namespace,
                "max_restarts": record.max_restarts,
            }
        if method == "kill_actor":
            runtime.kill_actor(
                ActorID(payload["actor_id"]), no_restart=payload["no_restart"]
            )
            return None
        if method == "cancel":
            ref = ObjectRef(ObjectID(payload["oid"]))
            return runtime.cancel(
                ref,
                force=payload.get("force", False),
                recursive=payload.get("recursive", False),
            )
        if method == "get_logs":
            return {
                "rows": runtime.logs.tail(
                    node_id=payload.get("node_id"),
                    wid=payload.get("wid"),
                    pid=payload.get("pid"),
                    after_seq=payload.get("after_seq"),
                    limit=payload.get("limit", 1000),
                )
            }
        if method == "kv":
            # The controller's KV for a worker or a remote driver: the job
            # table (job_submission.py) lives there (ROADMAP.md §D30).
            op = payload["op"]
            if op not in ("kv_get", "kv_put", "kv_del", "kv_keys"):
                raise ValueError(f"unknown KV op {op!r}")
            return getattr(runtime.controller, op)(*payload["args"])
        raise ValueError(f"unknown RPC method {method!r}")

    def _reply_refs(self, out: list, options: dict) -> dict:
        from ray_tpu_torch._private.streaming import ObjectRefGenerator

        if out and isinstance(out[0], ObjectRefGenerator):
            gen = out[0]
            tid = gen._task_id.binary()
            self.streams[tid] = gen
            return {
                "refs": [self.preborrow(gen._completion_ref.id)],
                "streaming": True,
                "task_id": tid,
            }
        return {"refs": [self.preborrow(ref.id) for ref in out]}


class WorkerChannel(WirePeer):
    """Protocol half of a worker handle: task dispatch + frame handling +
    in-flight bookkeeping, independent of WHERE the worker process runs.

    Subclasses provide the transport: ProcessWorkerHandle (local subprocess
    over a socketpair) and remote_node.RemoteWorkerHandle (a worker hosted
    by a node daemon, frames muxed over the node's TCP connection)."""

    def __init__(self, engine):
        super().__init__(engine.runtime)
        self.engine = engine
        self.rpc_pool = engine.rpc_pool
        self.actor_id: Optional[ActorID] = None
        self.expected_death = False
        # Set by the memory monitor before an OOM kill: the in-flight tasks
        # fail with OutOfMemoryError instead of a generic crash.
        self.death_note: Optional[str] = None
        self.last_pong = time.monotonic()
        # task_id bytes -> (spec, grant)
        self.in_flight: dict[bytes, tuple[TaskSpec, dict]] = {}
        # When the most recent task was dispatched here — the memory
        # monitor's retriable-FIFO policy kills the NEWEST victim first
        # (least progress lost).
        self.last_dispatch = 0.0

    # Transport hooks -------------------------------------------------------

    def describe(self) -> str:
        """Human-readable worker identity for error messages."""
        return "worker"

    def _ref_in_native(self, oid) -> bool:
        """Whether THIS worker can read the arg from the shm store it is
        attached to (the head's for local workers, its node's for remote
        ones)."""
        return False

    def kill_process(self) -> None:
        raise NotImplementedError

    def _post_disconnect(self) -> None:
        """Transport-specific cleanup after in-flight failure handling."""

    def _seal_native_return(self, spec: TaskSpec, body: dict) -> "TaskResult":
        """Adopt an in_native return (bytes already sealed into a store)."""
        raise NotImplementedError


_LOCAL_WID = itertools.count(1)


class ProcessWorkerHandle(WorkerChannel):
    """One worker process: socket, reader thread, in-flight tasks, borrows."""

    def __init__(self, engine: "ProcessNodeEngine"):
        super().__init__(engine)
        # Small stable worker id for the log plane (daemon workers get wids
        # from their node; pids are recorded separately).
        self.wid = next(_LOCAL_WID)
        parent_sock, child_sock = socket.socketpair()
        env = os.environ.copy()
        env["RAY_TPU_TORCH_WORKER_FD"] = str(child_sock.fileno())
        env["RAY_TPU_TORCH_IS_WORKER"] = "1"
        # The worker imports the package the driver imported, wherever the
        # driver was started from.
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
        )
        # A CUDA device admits contexts from many processes, so by default
        # a worker sees the driver's devices; worker_device="cpu" hides them
        # (ROADMAP.md §D22).
        if self.runtime.config.worker_device == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            pass_fds=[child_sock.fileno()],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        child_sock.close()
        # Worker output goes through the log plane, so driver output carries
        # (worker pid=...) prefixes and `Runtime.logs` holds the lines.
        from ray_tpu_torch._private.log_aggregation import PipeTailer

        self._tailers = [
            PipeTailer(pipe.fileno(), stream, self._emit_log)
            for stream, pipe in (("stdout", self.proc.stdout),
                                 ("stderr", self.proc.stderr))
        ]
        for tailer in self._tailers:
            tailer.start()
        self.conn = wire.Connection(parent_sock)
        native = self.runtime._native_store
        self.conn.send(
            "hello",
            {
                "store_name": native.name.decode() if native is not None else None,
                "native_threshold": self.runtime.config.native_store_threshold
                if native is not None
                else 0,
                "node_id": engine.node.node_id,
                "job_id": self.runtime.job_id.binary(),
                "driver_task_id": self.runtime.driver_task_id.binary(),
                "namespace": self.runtime.namespace,
                "sys_path": [p for p in sys.path if p],
            },
        )
        self._reader = threading.Thread(
            target=self._read_loop, name=f"pworker-{self.proc.pid}", daemon=True
        )
        self._reader.start()

    def _emit_log(self, stream: str, lines: list) -> None:
        try:
            self.runtime.logs.append(
                node_id=self.engine.node.node_id.hex(),
                hostname="local",
                wid=self.wid,
                pid=self.proc.pid,
                stream=stream,
                lines=lines,
            )
        except Exception:
            pass

    # -- sending tasks -----------------------------------------------------

    def _wire_body(self, spec: TaskSpec, grant: dict) -> dict:
        def wrap(value):
            if isinstance(value, ObjectRef):
                return wire.WireRef(value.id.binary(), self._ref_in_native(value.id))
            return value

        body = {
            "task_id": spec.task_id.binary(),
            "name": spec.name,
            "kind": spec.kind.value,
            "num_returns": spec.num_returns,
            "streaming": spec.streaming,
            "method_name": spec.method_name,
            "actor_id": spec.actor_id.binary() if spec.actor_id else None,
            "max_concurrency": spec.max_concurrency,
            "trace_ctx": spec.trace_ctx,
            "runtime_env": spec.runtime_env,
            "grant": dict(grant),
            # args/kwargs are user data: nested as a separately-pickled blob
            # so the frame envelope always decodes on the worker — a payload
            # the worker can't deserialize (e.g. a function pickled by
            # reference to a module only the driver can import) fails THIS
            # task inside the worker's try/except instead of looking like
            # protocol corruption and killing the process.
            "payload": cloudpickle.dumps(
                (
                    tuple(wrap(a) for a in spec.args),
                    {k: wrap(v) for k, v in spec.kwargs.items()},
                ),
                protocol=5,
            ),
        }
        if spec.kind in (TaskKind.NORMAL, TaskKind.ACTOR_CREATION):
            body["func"] = cloudpickle.dumps(spec.func, protocol=5)
        return body

    def send_task(self, kind: str, spec: TaskSpec, grant: dict) -> None:
        """Serialize and ship one task; serialization failures fail the task
        (unpicklable args must not crash the scheduler thread)."""
        try:
            body = self._wire_body(spec, grant)
        except Exception as exc:
            # The handle stays healthy on a serialization failure — return it
            # to the pool, else every unpicklable submission leaks a process.
            if self.actor_id is None and not self.expected_death:
                self.engine.checkin(self)
            self.runtime._on_task_done(
                spec,
                self.engine.node,
                grant,
                TaskResult(
                    exc=TaskError(exc, traceback.format_exc(), spec.name),
                    traceback_str=traceback.format_exc(),
                ),
            )
            return
        # Serialize before registering in-flight: a pickling failure is the
        # user's (unpicklable payload -> TaskError), a socket failure is the
        # system's (dead worker -> WorkerCrashedError, retryable).
        try:
            payload = wire.encode_frame(kind, body)
        except Exception as exc:
            if self.actor_id is None and not self.expected_death:
                self.engine.checkin(self)
            self.runtime._on_task_done(
                spec,
                self.engine.node,
                grant,
                TaskResult(exc=TaskError(exc, traceback.format_exc(), spec.name)),
            )
            return
        with self._lock:
            self.in_flight[spec.task_id.binary()] = (spec, grant)
            self.last_dispatch = time.monotonic()
        try:
            self.conn.send_bytes(payload)
        except Exception:
            # The reader's _on_disconnect may have raced us and already
            # failed this task — only complete it if we pop it ourselves.
            with self._lock:
                entry = self.in_flight.pop(spec.task_id.binary(), None)
            if entry is not None:
                self.runtime._on_task_done(
                    spec,
                    self.engine.node,
                    grant,
                    TaskResult(
                        exc=WorkerCrashedError(
                            f"{self.describe()} connection "
                            f"lost submitting {spec.name}"
                        )
                    ),
                )
            return
        if spec.streaming:
            # A cancel may have raced dispatch: runtime.cancel() marks the
            # driver registry and scans in_flight, but this task was not yet
            # registered. The mark is authoritative — forward it now so the
            # worker aborts the stream it is about to start.
            from ray_tpu_torch._private import engine as _engine

            if _engine._stream_cancel_requested(spec.task_id):
                try:
                    self.conn.send(
                        "cancel_stream", {"task_id": spec.task_id.binary()}
                    )
                except Exception:
                    pass

    # -- reader ------------------------------------------------------------

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except Exception:
                traceback.print_exc()
                msg = None
            if msg is not None and msg[0] == "__decode_error__":
                # Undecodable frame (e.g. an exception class whose unpickle
                # raises). We can't know which task it belonged to, so the
                # only hang-free option is to declare the worker dead: every
                # in-flight task fails below and retries run on a fresh one.
                print(
                    f"worker {self.proc.pid}: undecodable frame, declaring "
                    f"dead: {msg[1].get('error')}",
                    file=sys.stderr,
                )
                msg = None
            if msg is None:
                break
            try:
                self._handle_frame(*msg)
            except Exception:
                traceback.print_exc()
        self._on_disconnect()

    def _handle_frame(self, kind: str, body: dict) -> None:
        if kind == "done":
            for span in body.get("spans", ()):
                self.runtime.user_spans.append(span)
            self._handle_done(body)
        elif kind == "stream_item":
            with self._lock:
                entry = self.in_flight.get(body["task_id"])
            if entry is not None:
                spec = entry[0]
                self.runtime.report_stream_item(
                    spec,
                    body["index"],
                    value=body.get("value"),
                    error=body.get("error"),
                    traceback_str=body.get("tb", ""),
                )
        elif kind in ("rpc", "rpc_get"):
            self.rpc_pool.submit(self._handle_rpc, body)
        elif kind == "incref":
            self._handle_incref(body)
        elif kind == "decref":
            self._handle_decref(body)
        elif kind == "refs":
            self._handle_ref_deltas(body)
        elif kind == "prefetch":
            pass  # daemon-level pull hint: meaningless for a head-hosted worker
        elif kind == "pong":
            self.last_pong = time.monotonic()
        elif kind == "ready":
            pass

    @staticmethod
    def _decode_exc(body: dict, spec: TaskSpec):
        """Decode a pre-pickled worker exception; an exception class the
        driver can't unpickle degrades to a RuntimeError for this task
        instead of looking like wire corruption."""
        raw = body.get("exc_pickled")
        if raw is None:
            return body.get("exc")
        try:
            return cloudpickle.loads(raw)
        except Exception as exc:  # noqa: BLE001
            return RuntimeError(
                f"task {spec.name} failed with an exception the driver "
                f"could not deserialize ({exc!r}); worker traceback:\n"
                f"{body.get('tb', '')}"
            )

    def _handle_done(self, body: dict) -> None:
        with self._lock:
            entry = self.in_flight.pop(body["task_id"], None)
        if entry is None:
            return
        spec, grant = entry
        if body.get("cancelled"):
            from ray_tpu_torch.exceptions import TaskCancelledError

            result = TaskResult(
                exc=self._decode_exc(body, spec) or TaskCancelledError(spec.task_id),
                cancelled=True,
                traceback_str=body.get("tb", ""),
            )
        elif not body["ok"]:
            result = TaskResult(
                exc=self._decode_exc(body, spec), traceback_str=body.get("tb", "")
            )
        elif body.get("in_native"):
            result = self._seal_native_return(spec, body)
        elif "value_pickled" in body:
            # Worker pre-serialized the single return: seal the bytes as-is.
            nested = [ObjectRef(ObjectID(raw)) for raw in body.get("nested", ())]
            self.runtime.store.seal_pickled(
                spec.return_ids[0], body["value_pickled"], nested_refs=nested or None
            )
            result = TaskResult(value=SEALED_EXTERNALLY)
        else:
            result = TaskResult(value=body.get("value"))
        # Return the worker to the pool before completion bookkeeping so a
        # task dispatched from inside _on_task_done can reuse it immediately.
        if self.actor_id is None and not self.expected_death:
            self.engine.checkin(self)
        self.runtime._on_task_done(spec, self.engine.node, grant, result)

    # -- death -------------------------------------------------------------

    def _on_disconnect(self) -> None:
        expected = self.expected_death
        with self._lock:
            in_flight, self.in_flight = self.in_flight, {}
        self.engine.forget(self)
        if not expected:
            creation_inflight = any(
                spec.kind == TaskKind.ACTOR_CREATION for spec, _ in in_flight.values()
            )
            if self.actor_id is not None and not creation_inflight:
                # Actor process died out from under us: mark the actor
                # restarting/dead *before* failing calls so retries see the
                # right state (GcsActorManager::OnNodeDead ordering).
                self.runtime.on_actor_process_died(
                    self.actor_id, "actor process died"
                )
        for spec, grant in in_flight.values():
            if spec.kind in (TaskKind.ACTOR_CREATION, TaskKind.ACTOR_TASK):
                exc: Exception = ActorDiedError(
                    spec.actor_id,
                    self.death_note or self.death_reason_for(expected),
                )
            elif self.death_note:
                from ray_tpu_torch.exceptions import OutOfMemoryError

                exc = OutOfMemoryError(self.death_note)
            else:
                exc = WorkerCrashedError(
                    f"{self.describe()} died while running {spec.name}"
                )
            self.runtime._on_task_done(
                spec, self.engine.node, grant, TaskResult(exc=exc)
            )
        self._drop_all_borrows()
        self._post_disconnect()

    def _seal_native_return(self, spec: TaskSpec, body: dict) -> TaskResult:
        """Adopt a return the worker wrote and sealed into the shm store.
        Nested refs serialized into the shm bytes become borrows held by the
        sealed entry (same protocol as driver-side seal)."""
        nested = [ObjectRef(ObjectID(raw)) for raw in body.get("nested", ())]
        sealed = self.runtime.store.seal_native(
            spec.return_ids[0], body["in_native"], nested_refs=nested or None
        )
        if sealed:
            return TaskResult(value=SEALED_EXTERNALLY)
        # shm raced an eviction; extremely unlikely — treat as lost
        return TaskResult(exc=WorkerCrashedError("shm-resident return value lost"))

    def death_reason_for(self, expected: bool) -> str:
        return "actor killed" if expected else "actor process died"

    def describe(self) -> str:
        return f"worker process (pid {self.proc.pid})"

    def _ref_in_native(self, oid) -> bool:
        return self.runtime.store.is_native(oid)

    def _post_disconnect(self) -> None:
        try:
            self.proc.kill()
        except Exception:
            pass
        self.reap()

    def reap(self, timeout: float = 10.0) -> None:
        """Wait for the killed process to be gone, so its pid and what it
        held (a CUDA context, card memory) are released, and for its last
        output lines to reach the log plane, before the caller goes on."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return
        for tailer in self._tailers:
            tailer.join(timeout)
        self.engine.reaped(self)

    def kill_process(self) -> None:
        self.expected_death = True
        try:
            self.conn.send("kill", {})
        except Exception:
            pass
        try:
            self.proc.kill()
        except Exception:
            pass
        self.conn.close()


class ProcessActorExecutor:
    """Driver-side handle for an actor hosted in a dedicated worker process.

    Implements the same surface as engine.ActorExecutor (submit/kill/
    pending_count/node) so the Runtime treats both engines uniformly.
    """

    def __init__(self, engine: "ProcessNodeEngine", handle: ProcessWorkerHandle,
                 creation_spec: TaskSpec, grant: dict):
        self.node = engine
        self.handle = handle
        self.creation_spec = creation_spec
        self.actor_id = creation_spec.actor_id
        self.grant = grant
        self.dead = False
        self.death_reason = ""
        handle.actor_id = self.actor_id

    def start(self) -> None:
        self.handle.send_task("create_actor", self.creation_spec, self.grant)

    def submit(self, spec: TaskSpec) -> None:
        if self.dead:
            self.node.runtime._on_task_done(
                spec,
                self.node.node,
                {},
                TaskResult(
                    exc=ActorDiedError(
                        self.actor_id, self.death_reason or "actor died"
                    )
                ),
            )
            return
        self.node.runtime.task_events.record(
            spec.task_id, "RUNNING", node_id=self.node.node.node_id
        )
        self.handle.send_task("actor_call", spec, {})

    def mark_dead(self, reason: str) -> None:
        self.dead = True
        self.death_reason = reason

    def kill(self, reason: str = "ray_tpu_torch.kill") -> None:
        if self.dead:
            return
        self.mark_dead(reason)
        self.handle.kill_process()

    def pending_count(self) -> int:
        with self.handle._lock:
            return len(self.handle.in_flight)


class ProcessNodeEngine:
    """Process-backed node engine: pooled workers + per-actor processes."""

    def __init__(self, node: NodeState, runtime, on_task_done: Callable):
        self.node = node
        self.runtime = runtime
        self._on_task_done = on_task_done
        self.alive = True
        self._lock = threading.Lock()
        # (handle, idle_since) — LIFO so checkout reuses the warmest worker
        # and the reaper kills from the cold end.
        self._idle: list[tuple[ProcessWorkerHandle, float]] = []
        self._workers: set[ProcessWorkerHandle] = set()
        # Every handle whose process has not been reaped yet: a killed
        # worker leaves _workers at once, while its reader thread still
        # waits for the process to exit; shutdown() waits for it too.
        self._unreaped: set[ProcessWorkerHandle] = set()
        self._actors: dict[ActorID, ProcessActorExecutor] = {}
        self.rpc_pool = ThreadPoolExecutor(
            max_workers=256, thread_name_prefix=f"rpc-{node.node_id.hex()[:6]}"
        )
        idle_s = runtime.config.idle_worker_killing_time_s
        if idle_s and idle_s > 0:
            reaper = threading.Thread(
                target=self._reap_loop,
                args=(idle_s,),
                name=f"reaper-{node.node_id.hex()[:6]}",
                daemon=True,
            )
            reaper.start()
        period = runtime.config.health_check_period_s
        if period and period > 0:
            prober = threading.Thread(
                target=self._health_loop,
                args=(period, runtime.config.health_check_failure_threshold),
                name=f"health-{node.node_id.hex()[:6]}",
                daemon=True,
            )
            prober.start()

    # -- pool --------------------------------------------------------------

    def _checkout(self) -> ProcessWorkerHandle:
        with self._lock:
            if self._idle:
                return self._idle.pop()[0]
        handle = ProcessWorkerHandle(self)
        with self._lock:
            self._workers.add(handle)
            self._unreaped.add(handle)
        return handle

    def checkin(self, handle: ProcessWorkerHandle) -> None:
        with self._lock:
            if self.alive and handle in self._workers:
                self._idle.append((handle, time.monotonic()))

    def reaped(self, handle: ProcessWorkerHandle) -> None:
        with self._lock:
            self._unreaped.discard(handle)

    def forget(self, handle: ProcessWorkerHandle) -> None:
        with self._lock:
            self._workers.discard(handle)
            self._idle = [(h, t) for h, t in self._idle if h is not handle]

    def _health_loop(self, period: float, threshold: int) -> None:
        """Active liveness probing of every worker process: ping each period;
        a worker silent for period*threshold is hung (native-code livelock,
        deadlocked recv thread) and is killed so its tasks fail-and-retry
        through the normal crash path (gcs_health_check_manager.h:39)."""
        deadline = max(period * max(1, threshold), period + 1.0)
        while self.alive:
            time.sleep(period)
            with self._lock:
                workers = list(self._workers)
            now = time.monotonic()
            for handle in workers:
                if handle.expected_death:
                    continue
                # A worker mid-task can legitimately starve its recv thread
                # (long GIL-holding native work: cloudpickle of multi-GB
                # returns, non-releasing compiles), so a busy worker with a
                # live OS process gets a much longer staleness deadline —
                # hung-forever tasks are still eventually killed and retried,
                # but legitimate long GIL-bound work is not.
                with handle._lock:
                    busy = bool(handle.in_flight)
                worker_deadline = deadline
                if busy and handle.proc.poll() is None:
                    worker_deadline = deadline * 10
                if now - handle.last_pong > worker_deadline:
                    # Unexpected kill: EOF cleanup treats it as a crash.
                    try:
                        handle.proc.kill()
                    except Exception:
                        pass
                    continue
                try:
                    handle.conn.send("ping", {"id": int(now)})
                except Exception:
                    pass  # reader will observe the EOF

    def _reap_loop(self, idle_s: float) -> None:
        """Kill workers idle longer than idle_worker_killing_time_s
        (reference: worker_pool.cc idle worker killing)."""
        interval = min(10.0, max(1.0, idle_s / 4))
        while self.alive:
            time.sleep(interval)
            cutoff = time.monotonic() - idle_s
            with self._lock:
                expired = [h for h, t in self._idle if t <= cutoff]
                if expired:
                    gone = set(expired)
                    self._idle = [(h, t) for h, t in self._idle if h not in gone]
                    self._workers.difference_update(gone)
            for handle in expired:
                handle.kill_process()

    # -- NodeEngine interface ----------------------------------------------

    def execute_task(self, spec: TaskSpec, grant: dict, resolve_args) -> None:
        handle = self._checkout()
        handle.send_task("run_task", spec, grant)

    def create_actor(self, spec: TaskSpec, grant: dict, resolve_args):
        handle = ProcessWorkerHandle(self)
        with self._lock:
            self._workers.add(handle)
            self._unreaped.add(handle)
        executor = ProcessActorExecutor(self, handle, spec, grant)
        with self._lock:
            self._actors[spec.actor_id] = executor
        executor.start()
        return executor

    def get_actor(self, actor_id: ActorID):
        with self._lock:
            return self._actors.get(actor_id)

    def remove_actor(self, actor_id: ActorID) -> None:
        with self._lock:
            self._actors.pop(actor_id, None)

    def request_stream_cancel(self, task_id) -> bool:
        """Forward a running-stream cancel to the worker process hosting the
        task (its recv thread marks the in-worker cancel registry, so the
        generator loop aborts at its next yield even while the executor
        thread is busy driving it)."""
        tid = task_id.binary()
        with self._lock:
            workers = list(self._workers)
        for handle in workers:
            with handle._lock:
                hosted = tid in handle.in_flight
            if hosted:
                try:
                    handle.conn.send("cancel_stream", {"task_id": tid})
                except Exception:
                    pass  # dead worker: the crash path ends the stream anyway
                return True
        return False

    def shutdown(self) -> None:
        self.alive = False
        with self._lock:
            workers = list(self._unreaped)
            self._workers.clear()
            self._idle.clear()
            actors = list(self._actors.values())
            self._actors.clear()
        for actor in actors:
            actor.mark_dead("node shutdown")
        for handle in workers:
            handle.kill_process()
        for handle in workers:
            handle.reap()
        self.rpc_pool.shutdown(wait=False, cancel_futures=True)
