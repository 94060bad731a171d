"""Client-mode runtime: a remote driver over TCP.

`ray_tpu_torch.init(address="host:port")` connects to a HeadServer
(head_server.py) and installs a proxy runtime speaking the wire protocol —
the full public API works against the remote control plane. Reuses the
worker-side proxy (worker_main.WorkerProxyRuntime): a client is just a peer
that never executes tasks.

When the head is on the SAME machine (proven by reading the head's pinned
random probe object out of the shm segment), the client attaches the head's
shared-memory store and reads large objects zero-copy instead of over the
socket. Connections authenticate with a shared-secret token carried in the
address ("host:port?token=<hex>") or RAY_TPU_TORCH_CLIENT_TOKEN;
RAY_TPU_TORCH_CLIENT_SHM_ATTACH=0 turns the shm attach off.
"""

from __future__ import annotations

import hashlib
import os
import socket
import sys
import threading
from typing import Optional

import cloudpickle

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.ids import JobID, TaskID


class ClientCore:
    """Worker-duck-typed connection core for WorkerProxyRuntime: conn + rpc
    + identity, without the task-execution half."""

    def __init__(self, address: str, timeout: float = 30.0):
        # Address may carry credentials: "host:port?token=<hex>"; a bare
        # address falls back to RAY_TPU_TORCH_CLIENT_TOKEN.
        address, _, query = address.partition("?")
        token = ""
        if query.startswith("token="):
            token = query[len("token="):]
        token = token or os.environ.get("RAY_TPU_TORCH_CLIENT_TOKEN", "")
        host, _, port = address.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        from ray_tpu_torch._private.head_server import send_preamble

        send_preamble(sock, token)  # pre-framing auth, sent unconditionally
        self.conn = wire.Connection(sock)
        msg = self.conn.recv()
        if msg is None or msg[0] != "hello":
            raise ConnectionError(
                f"bad handshake from {address} (wrong or missing auth token?)"
            )
        hello = msg[1]
        self.job_id = JobID(hello["job_id"])
        self.driver_task_id = TaskID(hello["driver_task_id"])
        self.namespace = hello.get("namespace", "default")
        self.native = self._try_attach_store(hello)
        self._rpc_counter = 0
        self._rpc_lock = threading.Lock()
        self._rpc_waiters: dict[int, tuple[threading.Event, dict]] = {}
        self.closed = False
        # Whether head-pushed worker log batches are reprinted locally (the
        # log_to_driver analog for remote drivers).
        self.print_pushed_logs = True
        self._reader = threading.Thread(
            target=self._read_loop, name="client-reader", daemon=True
        )
        self._reader.start()

    def _try_attach_store(self, hello: dict):
        """Zero-copy shm attach, gated on PROOF of same-machine: the segment
        must exist locally AND the head's pinned random probe object must
        read back with a matching digest (hostname equality false-positives
        in containers sharing a hostname)."""
        if not hello.get("store_name"):
            return None
        if os.environ.get("RAY_TPU_TORCH_CLIENT_SHM_ATTACH", "1") == "0":
            return None
        probe_oid = hello.get("store_probe_oid")
        probe_sha = hello.get("store_probe_sha")
        if not probe_oid or not probe_sha:
            return None
        if not os.path.exists("/dev/shm" + hello["store_name"]):
            return None  # not on the head's machine: values ride the socket
        # The segment is here: its library must load (no silent fallback to
        # the socket when it cannot be built).
        from ray_tpu_torch._private.native_store import NativeStore

        try:
            store = NativeStore(hello["store_name"])
        except RuntimeError as exc:
            if "tps_open" not in str(exc):
                raise
            return None  # the segment went away between the check and the open
        try:
            view = store.get_raw(probe_oid)
            if view is None:
                store.close()
                return None
            digest = hashlib.sha256(bytes(view)).digest()
            del view
            store.release(probe_oid)
            if digest != probe_sha:
                store.close()
                return None
            return store
        except Exception:
            store.close()
            return None

    def rpc(self, method: str, payload: dict):
        with self._rpc_lock:
            if self.closed:
                raise ConnectionError("client connection closed")
            self._rpc_counter += 1
            msg_id = self._rpc_counter
            event = threading.Event()
            slot: dict = {}
            self._rpc_waiters[msg_id] = (event, slot)
        self.conn.send("rpc", {"id": msg_id, "method": method, "payload": payload})
        event.wait()
        if slot.get("dead"):
            raise ConnectionError("head connection lost")
        if slot["ok"]:
            return slot["result"]
        # The head ships errors pre-pickled (process_engine.WirePeer); the
        # reference's client reads only "exc" and raises KeyError instead
        # (ROADMAP.md §D28).
        raw = slot.get("exc_pickled")
        if raw is not None:
            try:
                exc = cloudpickle.loads(raw)
            except Exception as decode_exc:  # noqa: BLE001
                exc = RuntimeError(
                    f"RPC {method} failed with an exception this client "
                    f"could not deserialize ({decode_exc!r})"
                )
            raise exc
        raise slot["exc"]

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except Exception:
                msg = None
            if msg is None:
                break
            kind, body = msg
            if kind == "__decode_error__":
                # rpc_reply frames carry user values this client may not be
                # able to unpickle; we can't know which waiter the frame
                # belonged to, so the only hang-free option is declaring the
                # connection dead: every waiter fails with ConnectionError.
                print(
                    f"client: undecodable frame, closing: {body.get('error')}",
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
                try:
                    self.conn.send("pong", {"id": body.get("id")})
                except Exception:
                    break
            elif kind == "log":
                # Worker log batch pushed by the head: reprint with the
                # (pid, node) prefix, the worker.py print_logs analog.
                if self.print_pushed_logs:
                    try:
                        from ray_tpu_torch._private.log_aggregation import (
                            print_batch_to_driver,
                        )

                        print_batch_to_driver(body)
                    except Exception:
                        pass
        self._fail_all()

    def _fail_all(self) -> None:
        with self._rpc_lock:
            self.closed = True
            waiters = list(self._rpc_waiters.values())
            self._rpc_waiters.clear()
        for event, slot in waiters:
            slot["dead"] = True
            event.set()

    def close(self) -> None:
        # Same lock _fail_all publishes under: an RPC thread checking
        # `closed` must never see the flag flip between its check and its
        # waiter registration (found by lint RTL201).
        with self._rpc_lock:
            self.closed = True
        self.conn.close()


def connect(address: str, namespace: Optional[str] = None, timeout: float = 30.0):
    """Build the client proxy runtime (returned AND installed by api.init)."""
    from ray_tpu_torch._private.worker_main import WorkerProxyRuntime

    core = ClientCore(address, timeout)
    if namespace and namespace != "default":
        core.namespace = namespace  # client-chosen namespace for named actors
    proxy = WorkerProxyRuntime(core)
    proxy._client_core = core

    def shutdown():
        from ray_tpu_torch._private import runtime as runtime_mod

        proxy.shutting_down = True
        core.close()
        if runtime_mod._RUNTIME is proxy:
            runtime_mod._RUNTIME = None

    proxy.shutdown = shutdown
    return proxy
