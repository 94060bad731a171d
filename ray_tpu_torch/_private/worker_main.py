"""Worker process entry point (process-isolation mode).

The analog of the reference's `python/ray/_private/workers/default_worker.py`
plus the worker half of CoreWorker: a standalone process that executes tasks
and hosts at most one actor, speaking the wire protocol (wire.py) to the
driver over an inherited socketpair fd.

Fate-sharing: the socket IS the lifeline. EOF in either direction means the
peer died; the worker exits immediately (reference: raylet socket
disconnect -> worker suicide, core_worker.cc OnRayletDisconnected) and the
driver fails the worker's in-flight tasks.

Inside tasks the full `ray_tpu_torch` public API works: a
`WorkerProxyRuntime` is installed as the process-global runtime, forwarding
put/get/wait/submit/actor calls to the owning driver as RPC frames (the
worker->owner leg of the reference's CoreWorkerService). Values in the
native shared-memory store are read from the segment, which the worker maps
at hello, and returns of at least the threshold are written into it;
everything else crosses the socket.

Start-up imports neither torch nor numpy: a task pays for torch when it uses
it, so a worker that runs plain Python starts in a fraction of a second.

Run as `python -m ray_tpu_torch._private.worker_main` with the socket's fd
in RAY_TPU_TORCH_WORKER_FD (process_engine does this, and so does a node
daemon, node_daemon.py, for the workers it hosts).
"""

from __future__ import annotations

import inspect
import os
import queue
import socket
import sys
import threading
import traceback
from typing import Any, Optional

import cloudpickle

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec

_SIZE_PROBE_LIMIT = 64  # list/tuple/dict items sampled when sizing values


def _approx_size(value: Any) -> int:
    """Cheap size probe deciding socket-vs-shm for return values (a dict
    counts as the dict alone, as in the reference)."""
    np = sys.modules.get("numpy")
    if np is not None and isinstance(value, np.ndarray):
        return value.nbytes
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, (list, tuple)) and value:
        sample = value[:_SIZE_PROBE_LIMIT]
        return len(value) * max(1, sum(_approx_size(v) for v in sample) // len(sample))
    return sys.getsizeof(value)


class _BorrowCounter:
    """Worker-local reference counts; edge transitions notify the owner.

    0->1 sends incref, 1->0 sends decref — so the driver tracks at most one
    borrow per (worker, object), released on worker death (the in-process
    analog of the reference's borrower protocol, reference_count.h:39).
    RPC replies that hand out refs arrive pre-borrowed by the driver to close
    the race between the reply and this worker's first incref.
    """

    def __init__(self, proxy: "WorkerProxyRuntime"):
        self._proxy = proxy
        self._lock = threading.Lock()
        self._counts: dict[ObjectID, int] = {}
        self._preborrowed: set[bytes] = set()

    def note_preborrowed(self, oid_bytes: bytes) -> None:
        with self._lock:
            self._preborrowed.add(oid_bytes)

    def add_local_reference(self, object_id: ObjectID) -> None:
        send = False
        with self._lock:
            n = self._counts.get(object_id, 0)
            self._counts[object_id] = n + 1
            if n == 0:
                if object_id.binary() in self._preborrowed:
                    self._preborrowed.discard(object_id.binary())
                else:
                    send = True
        if send:
            self._proxy.note_ref_delta(object_id.binary(), +1)

    def remove_local_reference(self, object_id: ObjectID) -> None:
        send = False
        with self._lock:
            n = self._counts.get(object_id, 0)
            if n <= 1:
                self._counts.pop(object_id, None)
                send = n == 1
            else:
                self._counts[object_id] = n - 1
        if send:
            self._proxy.note_ref_delta(object_id.binary(), -1)

    # The public-API surface ObjectRef construction may touch:
    def add_borrowed_reference(self, object_id: ObjectID) -> None:
        self.add_local_reference(object_id)


class _ProxyStoreShim:
    """Just enough of the store interface for ObjectRef.future()/__await__."""

    def __init__(self, proxy: "WorkerProxyRuntime"):
        self._proxy = proxy

    def on_sealed(self, object_id: ObjectID, callback) -> None:
        def waiter():
            try:
                self._proxy.rpc("wait_ids", {"oids": [object_id.binary()]})
            except Exception:
                pass
            callback()

        self._proxy.background(waiter)


class _ProxyControllerShim:
    def __init__(self, proxy: "WorkerProxyRuntime"):
        self._proxy = proxy

    def get_named_actor(self, name: str, namespace: str):
        info = self._proxy.rpc(
            "named_actor", {"name": name, "namespace": namespace}
        )
        return ActorID(info["actor_id"]) if info else None

    def get_actor_record(self, actor_id: ActorID):
        info = self._proxy.rpc("actor_record", {"actor_id": actor_id.binary()})
        if info is None:
            return None

        class _Rec:
            pass

        rec = _Rec()
        for k, v in info.items():
            setattr(rec, k, v)
        return rec

    # The head controller's KV, by RPC (the reference's proxy has none, so
    # its JobSupervisor fails in a worker process; ROADMAP.md §D30).
    def kv_get(self, key: bytes):
        return self._proxy.rpc("kv", {"op": "kv_get", "args": [key]})

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        return self._proxy.rpc("kv", {"op": "kv_put", "args": [key, value, overwrite]})

    def kv_del(self, key: bytes) -> bool:
        return self._proxy.rpc("kv", {"op": "kv_del", "args": [key]})

    def kv_keys(self, prefix: bytes = b"") -> list:
        return self._proxy.rpc("kv", {"op": "kv_keys", "args": [prefix]})


class _NoopTaskEvents:
    def record(self, *args, **kwargs) -> None:
        pass


def _trace_ctx():
    """The worker's ambient trace context, shipped with submissions so the
    head parents the new task correctly (tracing_helper's _inject)."""
    from ray_tpu_torch.util import tracing

    return tracing.capture_context()


class WorkerProxyRuntime:
    """Runtime facade inside a worker process: every ownership-bearing
    operation is an RPC to the driver (the owner); reads of shm-resident
    objects go through the shared native store."""

    def __init__(self, worker: "Worker"):
        self._worker = worker
        self.shutting_down = False
        self.refcount = _BorrowCounter(self)
        self.store = _ProxyStoreShim(self)
        self.controller = _ProxyControllerShim(self)
        self.task_events = _NoopTaskEvents()
        from ray_tpu_torch._private.runtime_env import RuntimeEnvManager

        self.runtime_env_manager = RuntimeEnvManager()
        self.namespace = worker.namespace
        self.job_id = worker.job_id
        from concurrent.futures import ThreadPoolExecutor

        self._bg = ThreadPoolExecutor(max_workers=4, thread_name_prefix="wproxy-bg")
        # Ref-count delta batching: borrow edge transitions accumulate here
        # and ship as ONE merged "refs" frame — flushed before every done/
        # stream frame (preserving the incref-before-done wire invariant,
        # wire.py:8) and every 200ms for idle holders. An incref/decref pair
        # inside one window nets to zero and sends nothing, which is the
        # common task-arg lifecycle (the reference batches the same traffic
        # in ReferenceCount flush timers).
        self._ref_lock = threading.Lock()
        self._ref_flush_lock = threading.Lock()
        self._ref_deltas: dict[bytes, int] = {}
        self._ref_flusher = threading.Thread(
            target=self._ref_flush_loop, name="ref-flusher", daemon=True
        )
        self._ref_flusher.start()

    def note_ref_delta(self, oid_bytes: bytes, delta: int) -> None:
        with self._ref_lock:
            n = self._ref_deltas.get(oid_bytes, 0) + delta
            if n:
                self._ref_deltas[oid_bytes] = n
            else:
                self._ref_deltas.pop(oid_bytes, None)

    def flush_ref_deltas(self) -> None:
        """Ship pending deltas NOW. The flush mutex spans drain+send so a
        concurrent periodic flush can never land its refs frame after a
        done frame whose sender observed an empty buffer."""
        with self._ref_flush_lock:
            with self._ref_lock:
                if not self._ref_deltas:
                    return
                deltas, self._ref_deltas = self._ref_deltas, {}
            self._send_quiet("refs", {"d": list(deltas.items())})

    def _ref_flush_loop(self) -> None:
        import time as _time

        while not self.shutting_down:
            _time.sleep(0.2)
            try:
                self.flush_ref_deltas()
            except Exception:
                pass

    # -- plumbing ----------------------------------------------------------

    def _send_quiet(self, kind: str, body: dict) -> None:
        try:
            self._worker.conn.send(kind, body)
        except Exception:
            pass  # driver gone; we exit when the recv loop sees EOF

    def rpc(self, method: str, payload: dict):
        return self._worker.rpc(method, payload)

    def background(self, fn) -> None:
        self._bg.submit(fn)

    def current_task_id(self) -> TaskID:
        from ray_tpu_torch._private.engine import CONTEXT

        return CONTEXT.task_id or self._worker.driver_task_id

    def _refs_from_reply(self, oid_bytes_list: list) -> list:
        from ray_tpu_torch._private.object_ref import ObjectRef

        refs = []
        for raw in oid_bytes_list:
            self.refcount.note_preborrowed(raw)
            refs.append(ObjectRef(ObjectID(raw)))
        return refs

    # -- core API ----------------------------------------------------------

    def put(self, value: Any):
        reply = self.rpc("put", {"value": value})
        return self._refs_from_reply([reply["oid"]])[0]

    def get(self, refs: list, timeout: Optional[float]) -> list[Any]:
        if len(refs) > 1:
            # Multi-ref get: hint the node daemon (fire-and-forget) so all
            # cross-node pulls start NOW and their location lookups coalesce
            # into one batched loc_sub frame; the serial reads below then hit
            # the local store. Head-hosted workers and the head's client
            # handles ignore the frame.
            self._send_quiet(
                "prefetch",
                {"oids": [r.id.binary() for r in refs], "timeout": timeout},
            )
        return [self._get_one(ref.id, timeout) for ref in refs]

    def _get_one(self, oid: ObjectID, timeout: Optional[float]) -> Any:
        native = self._worker.native
        if native is not None:
            found, value = native.get_object(oid)
            if found:
                return self._raise_if_error(value)
        # Without a local shm attach, ask the owner for the bytes outright.
        reply = self.rpc(
            "get_by_id",
            {"oid": oid.binary(), "timeout": timeout, "force_value": native is None},
        )
        if reply.get("in_native"):
            found, value = native.get_object(oid)
            if found:
                return self._raise_if_error(value)
            reply = self.rpc(
                "get_by_id", {"oid": oid.binary(), "timeout": timeout, "force_value": True}
            )
        if "envelope" in reply:
            # Raw store-envelope bytes served by the local node daemon (a
            # worker without a shm attach still reads node-local objects
            # without a head round trip).
            from ray_tpu_torch._private.native_store import decode_envelope

            value = decode_envelope(reply["envelope"])
        else:
            value = wire.loads_value(reply["value_pickled"])
        return self._raise_if_error(value)

    @staticmethod
    def _raise_if_error(value: Any) -> Any:
        """Task-failure ErrorObjects raise as the cause type no matter which
        path (shm fast path or owner RPC) delivered the bytes."""
        from ray_tpu_torch._private.runtime import ErrorObject

        if isinstance(value, ErrorObject):
            value.raise_()
        return value

    def wait(self, refs: list, num_returns: int, timeout: Optional[float]):
        by_id = {ref.id.binary(): ref for ref in refs}
        reply = self.rpc(
            "wait_ids",
            {
                "oids": [r.id.binary() for r in refs],
                "num_returns": num_returns,
                "timeout": timeout,
            },
        )
        ready = [by_id[raw] for raw in reply["ready"]]
        remaining = [by_id[raw] for raw in reply["remaining"]]
        return ready, remaining

    def submit_task(self, func, args, kwargs, **options):
        reply = self.rpc(
            "submit_task",
            {
                "func": cloudpickle.dumps(func, protocol=5),
                "args": args,
                "kwargs": kwargs,
                "options": {**options, "trace_ctx": _trace_ctx()},
                "parent_task_id": self.current_task_id().binary(),
            },
        )
        refs = self._refs_from_reply(reply["refs"])
        if reply.get("streaming"):
            return [self._remote_stream(reply, refs[0])]
        return refs

    def create_actor(self, cls, args, kwargs, **options):
        reply = self.rpc(
            "create_actor",
            {
                "cls": cloudpickle.dumps(cls, protocol=5),
                "args": args,
                "kwargs": kwargs,
                "options": {**options, "trace_ctx": _trace_ctx()},
            },
        )
        ref = self._refs_from_reply([reply["creation_ref"]])[0]
        return ActorID(reply["actor_id"]), ref

    def submit_actor_task(self, actor_id: ActorID, method_name, args, kwargs, **options):
        reply = self.rpc(
            "submit_actor_task",
            {
                "actor_id": actor_id.binary(),
                "method_name": method_name,
                "args": args,
                "kwargs": kwargs,
                "options": {**options, "trace_ctx": _trace_ctx()},
            },
        )
        refs = self._refs_from_reply(reply["refs"])
        if reply.get("streaming"):
            return [self._remote_stream(reply, refs[0])]
        return refs

    def _remote_stream(self, reply: dict, completion_ref):
        """Consume a streaming task's items from the driver on demand."""
        from ray_tpu_torch._private.streaming import ObjectRefGenerator, ObjectRefStream

        stream = ObjectRefStream()
        gen = ObjectRefGenerator(stream, TaskID(reply["task_id"]))
        gen._completion_ref = completion_ref

        def pump():
            index = 0
            while True:
                try:
                    item = self.rpc(
                        "next_stream_item",
                        {"task_id": reply["task_id"], "index": index},
                    )
                except Exception:
                    stream.finish(index)
                    return
                if item["done"]:
                    stream.finish(item["total"])
                    return
                refs = self._refs_from_reply([item["oid"]])
                stream.offer(refs[0])
                index += 1

        self.background(pump)
        return gen

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self.rpc("kill_actor", {"actor_id": actor_id.binary(), "no_restart": no_restart})

    def cancel(self, ref, force: bool = False, recursive: bool = False) -> bool:
        return self.rpc(
            "cancel",
            {"oid": ref.id.binary(), "force": force, "recursive": recursive},
        )

    def report_stream_item(
        self, spec: TaskSpec, index: int, value=None, error=None, traceback_str=""
    ) -> None:
        self.flush_ref_deltas()  # increfs must precede the item that hands out refs
        body = {"task_id": spec.task_id.binary(), "index": index, "tb": traceback_str}
        if error is not None:
            wire.send_with_fallback(
                self._worker.conn,
                "stream_item",
                {**body, "error": error},
                {**body, "error": RuntimeError(f"unserializable error: {error!r}")},
            )
        else:
            wire.send_with_fallback(
                self._worker.conn,
                "stream_item",
                {**body, "value": value},
                {**body, "error": RuntimeError(f"unserializable item: {value!r}")},
            )


class Worker:
    """The worker process: recv loop + task executor."""

    def __init__(self, conn: wire.Connection, hello: dict):
        self.conn = conn
        self.node_id = hello["node_id"]
        self.job_id = JobID(hello["job_id"])
        self.driver_task_id = TaskID(hello["driver_task_id"])
        self.namespace = hello.get("namespace", "default")
        for path in reversed(hello.get("sys_path", [])):
            if path and path not in sys.path:
                sys.path.insert(0, path)
        # The driver's shm segment; the driver built and opened it, so an
        # open that fails here is a fault to see, not to work around.
        self.native_threshold = hello.get("native_threshold", 0)
        self.native = None
        if hello.get("store_name"):
            from ray_tpu_torch._private.native_store import NativeStore

            self.native = NativeStore(hello["store_name"])
        self._rpc_counter = 0
        self._rpc_lock = threading.Lock()
        self._rpc_waiters: dict[int, tuple[threading.Event, dict]] = {}
        self._inbox: "queue.Queue[Optional[tuple[str, dict]]]" = queue.Queue()
        # Actor state (one actor per worker process, like the reference).
        self.actor_instance: Any = None
        self.actor_creation: Optional[dict] = None
        self._actor_pool = None
        self._actor_loop = None
        self.proxy = WorkerProxyRuntime(self)
        from ray_tpu_torch._private import runtime as runtime_mod

        runtime_mod._RUNTIME = self.proxy

    # -- RPC client --------------------------------------------------------

    def rpc(self, method: str, payload: dict):
        with self._rpc_lock:
            self._rpc_counter += 1
            msg_id = self._rpc_counter
            event = threading.Event()
            slot: dict = {}
            self._rpc_waiters[msg_id] = (event, slot)
        # get_by_id rides its own frame KIND: node daemons intercept it for
        # the local-store fast path by looking at the envelope alone — every
        # other rpc body (put values, task args) relays undecoded.
        frame_kind = "rpc_get" if method == "get_by_id" else "rpc"
        self.conn.send(
            frame_kind, {"id": msg_id, "method": method, "payload": payload}
        )
        event.wait()
        if slot.get("dead"):
            raise ConnectionError("driver connection lost")
        if slot["ok"]:
            return slot["result"]
        raw = slot.get("exc_pickled")
        if raw is not None:
            try:
                exc = cloudpickle.loads(raw)
            except Exception as decode_exc:  # noqa: BLE001
                exc = RuntimeError(
                    f"RPC {method} failed with an exception this worker "
                    f"could not deserialize ({decode_exc!r})"
                )
            raise exc
        raise slot["exc"]

    def _fail_all_rpcs(self) -> None:
        with self._rpc_lock:
            waiters = list(self._rpc_waiters.values())
            self._rpc_waiters.clear()
        for event, slot in waiters:
            slot["dead"] = True
            event.set()

    # -- main loop ---------------------------------------------------------

    def run(self) -> None:
        executor = threading.Thread(target=self._executor_main, daemon=True)
        executor.start()
        self.conn.send("ready", {"pid": os.getpid()})
        while True:
            try:
                msg = self.conn.recv()
            except Exception:
                msg = None  # undecodable frame: treat as a dead driver
            if msg is None:
                break  # driver died: fate-share
            kind, body = msg
            if kind == "__decode_error__":
                # Driver->worker frames are envelope-safe (task payloads and
                # rpc_reply values/exceptions ride as nested pre-pickled
                # bytes), so an undecodable envelope is real corruption:
                # fate-share so in-flight work fails fast and retries on a
                # fresh worker instead of hanging an rpc waiter forever.
                print(
                    f"worker: undecodable frame, exiting: {body.get('error')}",
                    file=sys.stderr,
                )
                break
            if kind == "rpc_reply":
                with self._rpc_lock:
                    waiter = self._rpc_waiters.pop(body["id"], None)
                if waiter is not None:
                    event, slot = waiter
                    slot.update(body)
                    event.set()
            elif kind == "ping":
                # Health probe: answered from the recv thread so a worker
                # whose executor is busy still pongs; only a truly wedged
                # process (GIL held by native code, deadlock) goes silent.
                try:
                    self.conn.send("pong", {"id": body.get("id")})
                except Exception:
                    break
            elif kind == "cancel_stream":
                # Handled on the recv thread: the executor thread is busy
                # driving the very generator being cancelled.
                from ray_tpu_torch._private.engine import request_stream_cancel

                request_stream_cancel(TaskID(body["task_id"]))
            elif kind == "kill":
                break
            else:
                self._inbox.put((kind, body))
        self._fail_all_rpcs()
        os._exit(0)

    # -- execution ---------------------------------------------------------

    def _executor_main(self) -> None:
        while True:
            item = self._inbox.get()
            if item is None:
                return
            kind, body = item
            if kind == "run_task":
                self._run_normal(body)
            elif kind == "create_actor":
                self._create_actor(body)
            elif kind == "actor_call":
                self._dispatch_actor_call(body)

    def _build_spec(self, body: dict) -> TaskSpec:
        return TaskSpec(
            task_id=TaskID(body["task_id"]),
            job_id=self.job_id,
            name=body["name"],
            kind=TaskKind(body["kind"]),
            method_name=body.get("method_name"),
            num_returns=body.get("num_returns", 1),
            streaming=body.get("streaming", False),
            actor_id=ActorID(body["actor_id"]) if body.get("actor_id") else None,
            max_concurrency=body.get("max_concurrency", 1),
            runtime_env=body.get("runtime_env"),
            trace_ctx=tuple(body["trace_ctx"]) if body.get("trace_ctx") else None,
        )

    def _set_context(self, body: dict, spec: TaskSpec) -> None:
        from ray_tpu_torch._private.engine import CONTEXT
        from ray_tpu_torch.util import tracing

        CONTEXT.task_id = spec.task_id
        CONTEXT.job_id = self.job_id
        CONTEXT.node_id = self.node_id
        CONTEXT.actor_id = spec.actor_id
        CONTEXT.task_name = spec.name
        CONTEXT.resource_grant = body.get("grant", {})
        CONTEXT.put_counter = 0
        tracing.activate_task(spec)

    def _resolve(self, body: dict) -> tuple[tuple, dict]:
        def materialize(value):
            if isinstance(value, wire.WireRef):
                return self.proxy._get_one(ObjectID(value.oid_bytes), timeout=None)
            return value

        # User args ride as a nested pre-pickled blob (see _wire_body): an
        # undeserializable payload raises HERE, inside the per-task
        # try/except, and fails only this task.
        raw_args, raw_kwargs = wire.loads_value(body["payload"])
        args = tuple(materialize(a) for a in raw_args)
        kwargs = {k: materialize(v) for k, v in raw_kwargs.items()}
        return args, kwargs

    def _send_done(self, spec: TaskSpec, result) -> None:
        from ray_tpu_torch.util import tracing

        # Flush buffered ref deltas FIRST: the owner releases this task's
        # arg borrows when the done frame lands, so any incref this task
        # accumulated must be on the wire ahead of it (wire.py:8).
        self.proxy.flush_ref_deltas()
        body = {
            "task_id": spec.task_id.binary(),
            "cancelled": result.cancelled,
            "tb": result.traceback_str,
        }
        # User spans opened inside this task ride home with its result so
        # head-side traces() sees a complete tree (tracing_helper exports
        # via the driver; here the done frame is the export channel). Only
        # THIS task's spans leave the buffer: with max_concurrency > 1 a
        # concurrent task's spans must wait for their own done frame.
        spans = tracing._buffer.drain(owner=spec.task_id.binary())
        if spans:
            body["spans"] = [s.to_dict() for s in spans]
        if result.exc is not None:
            # Exceptions are user data: ship pre-pickled so a class the
            # driver can't unpickle degrades to a task error there instead
            # of corrupting the frame envelope (driver kills the worker on
            # envelope corruption).
            try:
                exc_bytes = cloudpickle.dumps(result.exc, protocol=5)
            except Exception:
                exc_bytes = cloudpickle.dumps(
                    RuntimeError(f"unserializable exception: {result.exc!r}"),
                    protocol=5,
                )
            self.proxy._send_quiet(
                "done", {**body, "ok": False, "exc_pickled": exc_bytes}
            )
            return
        value = result.value
        # Large single returns go through shm: the driver seals the existing
        # allocation instead of copying bytes over the socket. ObjectRefs
        # serialized into the shm bytes are reported so the driver can pin
        # them as borrows of the sealed entry (the nested-ref protocol).
        if (
            self.native is not None
            and self.native_threshold
            and not spec.streaming
            and spec.num_returns == 1
            and _approx_size(value) >= self.native_threshold
        ):
            try:
                from ray_tpu_torch._private.object_ref import capture_serialized_refs

                nested: list = []
                with capture_serialized_refs(nested):
                    size = self.native.put_object(spec.return_ids[0], value)
                self.conn.send(
                    "done",
                    {
                        **body,
                        "ok": True,
                        "in_native": size,
                        "nested": [r.id.binary() for r in nested],
                    },
                )
                return
            except Exception:
                pass  # shm full or unpicklable: fall through to socket bytes
        # Single returns ship pre-serialized so the driver can seal the bytes
        # directly (its store holds values serialized anyway) — one pickle
        # pass end-to-end instead of pickle/unpickle/pickle.
        if not spec.streaming and spec.num_returns == 1:
            try:
                from ray_tpu_torch._private.object_ref import capture_serialized_refs

                nested = []
                with capture_serialized_refs(nested):
                    data = cloudpickle.dumps(value, protocol=5)
                self.conn.send(
                    "done",
                    {
                        **body,
                        "ok": True,
                        "value_pickled": data,
                        "nested": [r.id.binary() for r in nested],
                    },
                )
            except wire.FrameTooLargeError as exc:
                self.proxy._send_quiet("done", {**body, "ok": False, "exc": exc})
            except Exception:
                self.proxy._send_quiet(
                    "done",
                    {
                        **body,
                        "ok": False,
                        "exc": RuntimeError(
                            f"unserializable return value from {spec.name}"
                        ),
                    },
                )
            return
        wire.send_with_fallback(
            self.conn,
            "done",
            {**body, "ok": True, "value": value},
            {
                **body,
                "ok": False,
                "exc": RuntimeError(
                    f"unserializable return value from {spec.name}"
                ),
            },
        )

    def _run_normal(self, body: dict) -> None:
        from ray_tpu_torch._private.engine import (
            _activate_runtime_env,
            _maybe_consume_stream,
            _run_callable,
        )

        spec = self._build_spec(body)
        spec.compute_return_ids()
        self._set_context(body, spec)
        try:
            func = cloudpickle.loads(body["func"])
            spec.func = func
            args, kwargs = self._resolve(body)
            env_cm = _activate_runtime_env(spec)
        except BaseException as exc:  # noqa: BLE001 — bad args/env
            from ray_tpu_torch._private.engine import TaskResult

            self._send_done(
                spec, TaskResult(exc=exc, traceback_str=traceback.format_exc())
            )
            return
        with env_cm:
            result = _run_callable(func, args, kwargs)
            result = _maybe_consume_stream(spec, result)
        self._send_done(spec, result)

    # -- actor -------------------------------------------------------------

    def _create_actor(self, body: dict) -> None:
        from ray_tpu_torch._private.engine import (
            TaskResult,
            _activate_runtime_env,
            _run_callable,
        )

        spec = self._build_spec(body)
        spec.compute_return_ids()
        self._set_context(body, spec)
        self.actor_creation = body
        try:
            cls = cloudpickle.loads(body["func"])
            args, kwargs = self._resolve(body)
            with _activate_runtime_env(spec):
                result = _run_callable(lambda *a, **k: cls(*a, **k), args, kwargs)
            if result.exc is None:
                self.actor_instance = result.value
                result = TaskResult(value=None)
        except BaseException as exc:  # noqa: BLE001
            result = TaskResult(exc=exc, traceback_str=traceback.format_exc())
        if result.exc is None:
            self._setup_actor_concurrency(cls, body.get("max_concurrency", 1))
        self._send_done(spec, result)

    def _setup_actor_concurrency(self, cls: type, max_concurrency: int) -> None:
        is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(cls, predicate=inspect.isfunction)
        )
        if is_async:
            import asyncio

            self._actor_sem = asyncio.Semaphore(max(1, max_concurrency))
            self._actor_loop = asyncio.new_event_loop()
            thread = threading.Thread(
                target=self._actor_loop.run_forever, daemon=True
            )
            thread.start()
        elif max_concurrency > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._actor_pool = ThreadPoolExecutor(max_workers=max_concurrency)

    def _dispatch_actor_call(self, body: dict) -> None:
        if self._actor_loop is not None:
            import asyncio

            asyncio.run_coroutine_threadsafe(
                self._run_actor_call_async(body), self._actor_loop
            )
        elif self._actor_pool is not None:
            self._actor_pool.submit(self._run_actor_call, body)
        else:
            self._run_actor_call(body)

    def _run_actor_call(self, body: dict) -> None:
        from ray_tpu_torch._private.engine import (
            TaskResult,
            _activate_runtime_env,
            _maybe_consume_stream,
            _run_callable,
        )

        spec = self._build_spec(body)
        spec.compute_return_ids()
        self._set_context(body, spec)
        try:
            args, kwargs = self._resolve(body)
            method = getattr(self.actor_instance, spec.method_name)
            fallback_env = (
                self.actor_creation.get("runtime_env") if self.actor_creation else None
            )
            with _activate_runtime_env(spec, fallback=fallback_env):
                result = _run_callable(method, args, kwargs)
                result = _maybe_consume_stream(spec, result)
        except BaseException as exc:  # noqa: BLE001
            result = TaskResult(exc=exc, traceback_str=traceback.format_exc())
        self._send_done(spec, result)

    async def _run_actor_call_async(self, body: dict) -> None:
        async with self._actor_sem:
            await self._run_actor_call_async_inner(body)

    async def _run_actor_call_async_inner(self, body: dict) -> None:
        from ray_tpu_torch._private.engine import (
            TaskResult,
            _activate_runtime_env,
            _consume_async_stream,
            _maybe_consume_stream,
            _run_callable,
        )

        spec = self._build_spec(body)
        spec.compute_return_ids()
        self._set_context(body, spec)
        try:
            args, kwargs = self._resolve(body)
            method = getattr(self.actor_instance, spec.method_name)
            fallback_env = (
                self.actor_creation.get("runtime_env") if self.actor_creation else None
            )
            env = _activate_runtime_env(spec, fallback=fallback_env)
            with env:
                if inspect.isasyncgenfunction(method) and spec.streaming:
                    result = await _consume_async_stream(spec, method(*args, **kwargs))
                elif inspect.iscoroutinefunction(method):
                    value = await method(*args, **kwargs)
                    result = _maybe_consume_stream(spec, TaskResult(value=value))
                else:
                    result = _run_callable(method, args, kwargs)
                    result = _maybe_consume_stream(spec, result)
        except BaseException as exc:  # noqa: BLE001
            result = TaskResult(exc=exc, traceback_str=traceback.format_exc())
        self._send_done(spec, result)


def main() -> None:
    fd = int(os.environ["RAY_TPU_TORCH_WORKER_FD"])
    sock = socket.socket(fileno=fd)
    conn = wire.Connection(sock)
    msg = conn.recv()
    if msg is None or msg[0] != "hello":
        os._exit(1)
    worker = Worker(conn, msg[1])
    worker.run()


if __name__ == "__main__":
    main()
