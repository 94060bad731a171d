"""Head-side half of the multi-machine cluster: remote worker nodes (the
port's copy of ray_tpu/_private/remote_node.py).

A node daemon (node_daemon.py — the raylet analog, raylet/main.cc) connects
to the head's TCP server with preamble role 'N' and registers its resources.
The head builds a NodeHandle (this file) around the connection, a NodeState
for the scheduler, and a RemoteNodeEngine implementing the same NodeEngine
interface the in-process/process engines implement — so scheduling, actors,
retries, lineage recovery and placement groups work on remote nodes with no
changes above this layer.

Frame protocol over the node connection (all cloudpickle frames, wire.py):
  head -> daemon:
    node_welcome {...}            first frame: node id, job, worker_device
    spawn_worker {wid}            create a pooled/dedicated worker process
    tw {wid, p: frame_bytes}      deliver a pre-framed message to worker wid
    kill_worker {wid}             kill a worker process
    delete_objects {oids}         drop objects from the node's local store
    loc_pub {results}             batched object locations (answers loc_sub)
    shutdown {}                   the head is going: the daemon exits
    ping {id}
  daemon -> head:
    register_node {...}           first frame (handled by accept_node)
    loc_sub {reqs}                batched location subscriptions
    object_cached {oid}           the node now holds a pulled copy
    wf {wid, k, raw|b}            frame from worker wid (raw = body bytes
                                  forwarded undecoded; the head is the single
                                  decoder — b only for daemon-inspected RPCs)
    wl {wid, pid, stream, lines}  worker stdout/stderr line batch
    worker_exit {wid}             a worker process died
    pong {id}

The reference also carries a daemon-level `rpc` / `rpc_reply` pair
(`locate_object`), which nothing in either package sends since the batched
location channel replaced it; the port leaves it out.

Object bytes never ride this connection: each node (and the head) runs an
object server (object_plane.py); the owner's location table directs pulls
(reference: ownership_based_object_directory.h + pull_manager.h).
"""

from __future__ import annotations

import sys
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import cloudpickle

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.controller import NodeState
from ray_tpu_torch._private.engine import TaskResult
from ray_tpu_torch._private.ids import ActorID, NodeID, ObjectID
from ray_tpu_torch._private.process_engine import (
    ProcessActorExecutor,
    ProcessWorkerHandle,
    WorkerChannel,
)
from ray_tpu_torch._private.task_spec import TaskSpec


class _MuxConn:
    """Connection shim for one remote worker: frames are wrapped with the
    worker id and ride the node daemon's TCP connection."""

    def __init__(self, node_handle: "NodeHandle", wid: int):
        self._node = node_handle
        self._wid = wid

    def send(self, kind: str, body: dict) -> None:
        self.send_bytes(wire.encode_frame(kind, body))

    def send_bytes(self, payload: bytes) -> None:
        self._node.conn.send("tw", {"wid": self._wid, "p": payload})

    def close(self) -> None:
        pass  # the node connection outlives individual workers


class RemoteWorkerHandle(ProcessWorkerHandle):
    """A worker process hosted by a node daemon on a (possibly) remote
    machine. Shares the full task/frame protocol with ProcessWorkerHandle;
    only the transport and the return-sealing policy differ: returns sealed
    into the node's local store are recorded as LOCATIONS here, not bytes."""

    def __init__(self, engine: "RemoteNodeEngine", wid: int):
        WorkerChannel.__init__(self, engine)  # deliberately skip the
        # subprocess-spawning ProcessWorkerHandle.__init__: no local process
        self.wid = wid
        self.conn = _MuxConn(engine.handle, wid)

    def describe(self) -> str:
        return f"remote worker {self.wid} on node {self.engine.node.node_id}"

    def _ref_in_native(self, oid) -> bool:
        # True iff the arg's bytes are in THIS worker's node-local store.
        return (
            self.runtime.store.location_of(oid) == self.engine.node.node_id
        )

    def _seal_native_return(self, spec: TaskSpec, body: dict) -> TaskResult:
        from ray_tpu_torch._private.engine import SEALED_EXTERNALLY
        from ray_tpu_torch._private.object_ref import ObjectRef

        nested = [ObjectRef(ObjectID(raw)) for raw in body.get("nested", ())]
        self.runtime.store.seal_remote(
            spec.return_ids[0],
            self.engine.node.node_id,
            body["in_native"],
            nested_refs=nested or None,
        )
        return TaskResult(value=SEALED_EXTERNALLY)

    def _post_disconnect(self) -> None:
        pass  # the daemon reaps the OS process

    def kill_process(self) -> None:
        self.expected_death = True
        try:
            self.engine.handle.conn.send("kill_worker", {"wid": self.wid})
        except Exception:
            pass


class NodeHandle:
    """Owns the TCP connection to one registered node daemon."""

    def __init__(self, runtime, conn: wire.Connection, reg: dict):
        self.runtime = runtime
        self.conn = conn
        self.reg = reg
        self.node_id = NodeID.from_random()
        self.hostname = reg.get("hostname", "?")
        self.object_addr = tuple(reg["object_addr"]) if reg.get("object_addr") else None
        self.alive = True
        self._lock = threading.Lock()
        self._workers: dict[int, RemoteWorkerHandle] = {}
        self._wid_counter = 0
        import time as _time

        self.last_pong = _time.monotonic()
        self.engine: Optional["RemoteNodeEngine"] = None
        # Per-kind counts of frames received from this daemon: the scale
        # tests assert control-plane traffic budgets against these, and the
        # dashboard surfaces them per node.
        self.frame_counts: dict[str, int] = {}
        # Batched location publication (head half of the daemon's loc_sub
        # channel): seal callbacks queue oids here and one flusher drains
        # them as a single loc_pub frame per wakeup.
        self._pub_lock = threading.Lock()
        self._pub_cond = threading.Condition(self._pub_lock)
        self._pub_outbox: list = []
        # Live subscriptions (one seal callback per oid per handle) and the
        # deadlines at which unanswered ones publish an explicit miss.
        self._subbed: set = set()
        self._sub_deadlines: dict = {}
        self._pub_thread = threading.Thread(
            target=self._flush_loc_pubs,
            name=f"locpub-{self.hostname}",
            daemon=True,
        )
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"node-{self.hostname}",
            daemon=True,
        )

    def start(self) -> None:
        self._reader.start()
        self._pub_thread.start()

    def next_wid(self) -> int:
        with self._lock:
            self._wid_counter += 1
            return self._wid_counter

    def register_worker(self, handle: RemoteWorkerHandle) -> None:
        with self._lock:
            self._workers[handle.wid] = handle

    def forget_worker(self, wid: int) -> None:
        with self._lock:
            self._workers.pop(wid, None)

    # -- reader -------------------------------------------------------------

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except Exception:
                traceback.print_exc()
                msg = None
            if msg is None:
                break
            kind, body = msg
            self.frame_counts[kind] = self.frame_counts.get(kind, 0) + 1
            try:
                self._handle_frame(kind, body)
            except Exception:
                traceback.print_exc()
        self._on_disconnect()

    def _handle_frame(self, kind: str, body: dict) -> None:
        if kind == "wf":
            with self._lock:
                handle = self._workers.get(body["wid"])
            if handle is None:
                return
            if "raw" in body:
                # Decode-free relay: the daemon forwarded the worker's
                # pickled body untouched; this is the single decode.
                try:
                    body = {
                        "wid": body["wid"],
                        "k": body["k"],
                        "b": cloudpickle.loads(body["raw"]),
                    }
                except Exception as exc:  # noqa: BLE001
                    body = {
                        "wid": body["wid"],
                        "k": "__decode_error__",
                        "b": {"error": repr(exc)},
                    }
            if body["k"] == "__decode_error__":
                # The daemon couldn't unpickle this worker's frame (e.g. a
                # return value referencing a module the node cannot import).
                # Same hang-free policy as the local path: declare the
                # worker dead so in-flight work fails fast and retries.
                print(
                    f"node {self.hostname}: undecodable frame from worker "
                    f"{body['wid']}, declaring dead: {body['b'].get('error')}",
                    file=sys.stderr,
                )
                try:
                    self.conn.send("kill_worker", {"wid": body["wid"]})
                except Exception:
                    pass
                with self._lock:
                    self._workers.pop(body["wid"], None)
                handle._on_disconnect()
                return
            handle._handle_frame(body["k"], body["b"])
        elif kind == "object_cached":
            # This node finished pulling an object into its local store:
            # record the copy so later pullers spread across holders.
            self.runtime.store.add_location(
                ObjectID(body["oid"]), self.node_id
            )
        elif kind == "wl":
            # Worker log lines tailed by the daemon (log_aggregation.py).
            self.runtime.logs.append(
                node_id=self.node_id.hex(),
                hostname=self.hostname,
                wid=body["wid"],
                pid=body.get("pid", 0),
                stream=body["stream"],
                lines=body["lines"],
            )
        elif kind == "worker_exit":
            with self._lock:
                handle = self._workers.pop(body["wid"], None)
            if handle is not None:
                handle._on_disconnect()
        elif kind == "loc_sub":
            self._handle_loc_sub(body)
        elif kind == "pong":
            import time

            self.last_pong = time.monotonic()

    def _loc_payload(self, oid: ObjectID):
        """Location answer for a SEALED object: the object servers holding
        its bytes. Cached copies are listed in random order AHEAD of the
        producer so a 1-to-N broadcast fans out across nodes that already
        pulled instead of serializing on the producer (push_manager.h's
        chunked-broadcast scaling, collapsed onto the pull protocol).
        Returns None when the object has no pullable location."""
        import random as _random

        runtime = self.runtime
        locations = runtime.store.locations_of(oid)
        primary = runtime.store.location_of(oid)
        addrs = []
        cached = []
        for node_id in locations:
            if node_id == self.node_id:
                continue  # don't point a node at itself
            peer = runtime._node_handles.get(node_id)
            if peer is not None and peer.alive and peer.object_addr:
                entry = list(peer.object_addr)
                if node_id == primary:
                    addrs.append(entry)
                else:
                    cached.append(entry)
        _random.shuffle(cached)
        addrs = cached + addrs
        if primary is None and runtime._object_server is not None:
            addrs.append(list(runtime._object_server.address))
        if not addrs:
            return None
        return {"addrs": addrs, "addr": addrs[0]}

    def _handle_loc_sub(self, body: dict) -> None:
        """Batched location subscription: answer sealed oids in one loc_pub
        now; unsealed ones get a seal callback that queues the publication —
        no blocked head thread per pending object (the pubsub long-poll
        batching analog, reference pubsub/README.md). A request's timeout is
        honored head-side: the flusher publishes {missing} at the deadline
        so a timed get falls back at ~timeout, not at the daemon's padded
        wait ceiling."""
        import time as _time

        store = self.runtime.store
        ready: list = []
        for req in body.get("reqs", ()):
            if isinstance(req, (list, tuple)):
                oid_bytes, timeout = req[0], req[1] if len(req) > 1 else None
            else:
                oid_bytes, timeout = req, None
            oid = ObjectID(oid_bytes)
            if store.contains(oid):
                ready.append((oid_bytes, self._loc_payload(oid) or {"missing": True}))
                continue
            with self._pub_lock:
                already = oid_bytes in self._subbed
                if not already:
                    self._subbed.add(oid_bytes)
                if timeout is not None:
                    deadline = _time.monotonic() + timeout
                    prev = self._sub_deadlines.get(oid_bytes)
                    if prev is None or deadline < prev:
                        self._sub_deadlines[oid_bytes] = deadline
                        self._pub_cond.notify()
            if not already:
                # One live callback per oid per handle: a retried get must
                # not stack another closure on the store entry.
                store.on_sealed(oid, self._make_seal_pub(oid_bytes, oid))
        if ready:
            self._queue_pubs(ready)

    def _make_seal_pub(self, oid_bytes: bytes, oid: ObjectID):
        # Weakref: a never-sealing object's callback must not pin this
        # handle (conn, worker map, outboxes) after the node goes away.
        import weakref

        handle_ref = weakref.ref(self)

        def _on_seal() -> None:
            handle = handle_ref()
            if handle is None or not handle.alive:
                return
            with handle._pub_lock:
                was_live = oid_bytes in handle._subbed
                handle._subbed.discard(oid_bytes)
                handle._sub_deadlines.pop(oid_bytes, None)
            if not was_live:
                return  # expired (miss already published) or superseded
            payload = (
                handle._loc_payload(oid)
                if handle.runtime.store.contains(oid)
                else None
            )
            handle._queue_pubs([(oid_bytes, payload or {"missing": True})])

        return _on_seal

    def _queue_pubs(self, results: list) -> None:
        with self._pub_lock:
            self._pub_outbox.extend(results)
            self._pub_cond.notify()

    def _flush_loc_pubs(self) -> None:
        import time as _time

        while True:
            with self._pub_lock:
                while not self._pub_outbox and self.alive:
                    wait_t = None
                    if self._sub_deadlines:
                        wait_t = max(
                            0.0,
                            min(self._sub_deadlines.values()) - _time.monotonic(),
                        )
                        if wait_t == 0.0:
                            break  # a deadline already passed: sweep now
                    self._pub_cond.wait(timeout=wait_t)
                if not self.alive:
                    return
                now = _time.monotonic()
                expired = [
                    oid for oid, dl in self._sub_deadlines.items() if dl <= now
                ]
                for oid in expired:
                    del self._sub_deadlines[oid]
                    self._subbed.discard(oid)
                results, self._pub_outbox = self._pub_outbox, []
            # Timed-out subscriptions publish an explicit miss so the
            # daemon's waiter falls back promptly (the seal callback, if the
            # object appears later, re-checks _subbed and goes quiet).
            store = self.runtime.store
            for oid in expired:
                obj = ObjectID(oid)
                results.append(
                    (oid, self._loc_payload(obj) or {"missing": True})
                    if store.contains(obj)
                    else (oid, {"missing": True})
                )
            if not results:
                continue
            try:
                self.conn.send("loc_pub", {"results": results})
            except Exception:
                return  # connection gone: reader thread owns the teardown

    # -- death --------------------------------------------------------------

    def _on_disconnect(self) -> None:
        if not self.alive:
            return
        self.alive = False
        with self._pub_lock:
            self._pub_cond.notify_all()  # release the loc_pub flusher
        try:
            self.conn.close()
        except Exception:
            pass
        self.runtime.on_node_disconnected(self.node_id)

    def close(self) -> None:
        self.alive = False
        with self._pub_lock:
            self._pub_cond.notify_all()
        try:
            self.conn.send("shutdown", {})
        except Exception:
            pass
        try:
            self.conn.close()
        except Exception:
            pass


class RemoteNodeEngine:
    """NodeEngine interface over a node daemon: pooled remote workers +
    per-actor dedicated remote workers (mirrors ProcessNodeEngine)."""

    def __init__(self, node: NodeState, runtime, handle: NodeHandle):
        self.node = node
        self.runtime = runtime
        self.handle = handle
        handle.engine = self
        self.alive = True
        self._lock = threading.Lock()
        self._idle: list[RemoteWorkerHandle] = []
        self._workers: set[RemoteWorkerHandle] = set()
        self._actors: dict[ActorID, ProcessActorExecutor] = {}
        self.rpc_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix=f"rnode-{handle.hostname[:8]}"
        )

    # -- pool ---------------------------------------------------------------

    def _checkout(self) -> RemoteWorkerHandle:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        wid = self.handle.next_wid()
        worker = RemoteWorkerHandle(self, wid)
        self.handle.register_worker(worker)
        with self._lock:
            self._workers.add(worker)
        self.handle.conn.send("spawn_worker", {"wid": wid})
        return worker

    def checkin(self, handle: RemoteWorkerHandle) -> None:
        with self._lock:
            if self.alive and handle in self._workers:
                self._idle.append(handle)

    def forget(self, handle: RemoteWorkerHandle) -> None:
        with self._lock:
            self._workers.discard(handle)
            self._idle = [h for h in self._idle if h is not handle]
        self.handle.forget_worker(handle.wid)

    # -- NodeEngine interface ----------------------------------------------

    def execute_task(self, spec: TaskSpec, grant: dict, resolve_args) -> None:
        handle = self._checkout()
        handle.send_task("run_task", spec, grant)

    def create_actor(self, spec: TaskSpec, grant: dict, resolve_args):
        wid = self.handle.next_wid()
        worker = RemoteWorkerHandle(self, wid)
        self.handle.register_worker(worker)
        with self._lock:
            self._workers.add(worker)
        self.handle.conn.send("spawn_worker", {"wid": wid})
        executor = ProcessActorExecutor(self, worker, spec, grant)
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
        """Relay a running-stream cancel to the daemon-hosted worker running
        the task (frame muxed decode-free through the node connection; the
        worker recv thread marks its in-process cancel registry)."""
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
                    pass
                return True
        return False

    def shutdown(self) -> None:
        self.alive = False
        with self._lock:
            workers = list(self._workers)
            self._workers.clear()
            self._idle.clear()
            actors = list(self._actors.values())
            self._actors.clear()
        for actor in actors:
            actor.mark_dead("node removed")
        # Fail every in-flight task on this node's workers (the daemon is
        # gone or being told to go; nothing will come back).
        for worker in workers:
            worker.expected_death = True
            worker._on_disconnect()
        self.handle.close()
        self.rpc_pool.shutdown(wait=False, cancel_futures=True)


def accept_node(runtime, conn: wire.Connection) -> None:
    """Server-side node registration: read register_node, wire up the engine,
    reply node_welcome (the GcsNodeManager::HandleRegisterNode analog)."""
    msg = conn.recv()
    if msg is None or msg[0] != "register_node":
        conn.close()
        return
    reg = msg[1]
    handle = NodeHandle(runtime, conn, reg)
    cfg = runtime.config
    # Welcome FIRST, register second: the moment the node is schedulable a
    # concurrent dispatch may send spawn_worker on this connection, and the
    # daemon requires node_welcome to be the first frame it reads.
    conn.send(
        "node_welcome",
        {
            "node_id": handle.node_id,
            "job_id": runtime.job_id.binary(),
            "driver_task_id": runtime.driver_task_id.binary(),
            "namespace": runtime.namespace,
            "native_threshold": cfg.native_store_threshold,
            # CUDA devices of the node's workers (ROADMAP.md §D22): ""
            # inherits the daemon's, "cpu" hides them.
            "worker_device": cfg.worker_device,
            "health_check_period_s": cfg.health_check_period_s,
            "health_check_failure_threshold": cfg.health_check_failure_threshold,
            # The driver's import roots: functions cloudpickled by REFERENCE
            # (importable module on the driver) must resolve on remote
            # workers too. Nonexistent paths on the node's machine are
            # harmless — Python skips them (services.py propagates the
            # driver environment to raylets the same way).
            "sys_path": [p for p in sys.path if p],
        },
    )
    runtime.register_remote_node(handle, reg)
    handle.start()
