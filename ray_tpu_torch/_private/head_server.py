"""TCP control-plane server: remote drivers speak the wire protocol.

The ray-client analog (reference: python/ray/util/client/ — a gRPC proxy
letting a remote interactive driver use a cluster via `ray://host:port`).
Here the head runtime listens on TCP and serves the SAME framed-RPC surface
workers use (process_engine.WirePeer), so a client process gets the full API
(put/get/wait/remote/actors/streaming) with per-client borrow accounting
that is dropped when the connection closes.

Start server-side:  runtime.serve_clients(host, port)  or
                    ray_tpu_torch.init(num_cpus=..., client_server_port=...)
Connect client-side: ray_tpu_torch.init(address="host:port?token=...")
Node daemons join through the same listener (role byte 'N', remote_node.py).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import socket
import sys
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.process_engine import WirePeer

# Auth preamble: every peer's first bytes are MAGIC + u8 token length +
# token + u8 role — checked BEFORE any frame is unpickled, so an
# unauthenticated peer never reaches cloudpickle.loads (the wire protocol is
# arbitrary code execution by design; the token is the trust boundary). The
# preamble is unconditional (length 0 when the peer has no token) so an
# auth-disabled server and a token-bearing client never misparse each
# other's streams. Roles: C = remote driver, N = node daemon joining the
# cluster, O = object-plane fetch connection.
PREAMBLE_MAGIC = b"RTP1"
HANDSHAKE_TIMEOUT_S = 10.0


def send_preamble(sock: socket.socket, token: str, role: bytes = b"C") -> None:
    raw = token.encode()
    if len(raw) > 255:
        raise ValueError("auth token longer than 255 bytes")
    sock.sendall(PREAMBLE_MAGIC + bytes([len(raw)]) + raw + role)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    got = b""
    while len(got) < n:
        chunk = sock.recv(n - len(got))
        if not chunk:
            raise ConnectionError("eof during auth preamble")
        got += chunk
    return got


class ClientHandle(WirePeer):
    """One connected remote driver."""

    def __init__(self, server: "HeadServer", conn: wire.Connection):
        super().__init__(server.runtime)
        self.server = server
        self.conn = conn
        self.rpc_pool = server.rpc_pool
        runtime = server.runtime
        # Each client acts as a driver task of the head's job: its submitted
        # tasks parent under a fresh driver task id.
        self.driver_task_id = TaskID.for_job(runtime.job_id)
        # Log pushes ride a bounded queue + dedicated sender thread: a
        # stalled client (full TCP buffer) drops its own log batches instead
        # of blocking the appending thread (which for remote-node logs is
        # that node's frame-reader — a stall there would freeze task results
        # from the whole node).
        import queue as _queue

        self._log_q: "_queue.Queue" = _queue.Queue(maxsize=256)
        self._log_sender = threading.Thread(
            target=self._send_logs_loop, name="client-logpush", daemon=True
        )
        native = runtime._native_store
        conn.send(
            "hello",
            {
                "job_id": runtime.job_id.binary(),
                "driver_task_id": self.driver_task_id.binary(),
                "namespace": runtime.namespace,
                "hostname": socket.gethostname(),
                "store_name": native.name.decode() if native is not None else None,
                # Same-machine proof for shm attach: the client must read
                # this pinned probe object out of the segment and match the
                # digest — hostname equality alone false-positives in
                # containers sharing a hostname.
                "store_probe_oid": server.store_probe_oid,
                "store_probe_sha": server.store_probe_sha,
            },
        )
        self._reader = threading.Thread(
            target=self._read_loop, name="client-conn", daemon=True
        )

    def start(self) -> None:
        """Begin serving; called AFTER the server registered this handle so
        an instantly-dying connection's forget() can actually remove it."""
        self._reader.start()
        self._log_sender.start()

    def push_log(self, batch: dict) -> None:
        try:
            self._log_q.put_nowait(batch)
        except Exception:
            pass  # queue full: drop the batch for this viewer

    def _send_logs_loop(self) -> None:
        while True:
            batch = self._log_q.get()
            if batch is None:
                return
            try:
                self.conn.send("log", batch)
            except Exception:
                return  # reader thread owns disconnect handling

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
            if kind == "__decode_error__":
                # Client 'rpc' frames embed user values (put payloads) the
                # head may not be able to unpickle; no way to know which
                # call it was, so drop the client — it sees ConnectionError
                # and its waiters fail instead of hanging.
                print(
                    f"head: undecodable client frame, dropping client: "
                    f"{body.get('error')}",
                    file=sys.stderr,
                )
                break
            try:
                if kind == "rpc":
                    self.rpc_pool.submit(self._handle_rpc, body)
                elif kind == "incref":
                    self._handle_incref(body)
                elif kind == "decref":
                    self._handle_decref(body)
                elif kind == "refs":
                    self._handle_ref_deltas(body)
                elif kind == "ping":
                    self.conn.send("pong", {"id": body.get("id")})
            except Exception:
                traceback.print_exc()
        self._drop_all_borrows()
        self.server.forget(self)
        try:
            self._log_q.put_nowait(None)  # release the log sender thread
        except Exception:
            pass
        self.conn.close()


class HeadServer:
    def __init__(
        self,
        runtime,
        host: str = "127.0.0.1",
        port: int = 0,
        token: Optional[str] = None,
    ):
        self.runtime = runtime
        # token=None -> generate; token="" -> auth disabled (trusted network,
        # explicit opt-out only).
        self.token = secrets.token_hex(16) if token is None else token
        self.rpc_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="head-rpc"
        )
        self.store_probe_oid: Optional[bytes] = None
        self.store_probe_sha: Optional[bytes] = None
        native = runtime._native_store
        if native is not None:
            try:
                probe = os.urandom(64)
                self.store_probe_oid = os.urandom(28)
                native.put_raw(self.store_probe_oid, probe)
                native.pin(self.store_probe_oid)
                self.store_probe_sha = hashlib.sha256(probe).digest()
            except Exception:
                self.store_probe_oid = self.store_probe_sha = None
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        self._clients: set[ClientHandle] = set()
        self._lock = threading.Lock()
        self._running = True
        # Fan worker log batches out to every connected remote driver (the
        # head's own driver printing is a separate sink on the same buffer).
        runtime.logs.add_sink(self._fanout_logs)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="head-accept", daemon=True
        )
        self._accept_thread.start()

    def _fanout_logs(self, batch: dict) -> None:
        with self._lock:
            clients = list(self._clients)
        for handle in clients:
            handle.push_log(batch)

    @property
    def address(self) -> str:
        """Connect string for clients; carries the auth token so the address
        alone is sufficient (and secret) credentials."""
        if self.token:
            return f"{self.host}:{self.port}?token={self.token}"
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Handshake off-thread: a slow/hostile peer must not block accepts.
            threading.Thread(
                target=self._handshake, args=(sock,), daemon=True
            ).start()

    def _handshake(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(HANDSHAKE_TIMEOUT_S)
            magic = _recv_exact(sock, len(PREAMBLE_MAGIC))
            if magic != PREAMBLE_MAGIC:
                raise ConnectionError("bad preamble magic")
            (token_len,) = _recv_exact(sock, 1)
            got = _recv_exact(sock, token_len) if token_len else b""
            if self.token and not hmac.compare_digest(got, self.token.encode()):
                raise ConnectionError("bad token")
            role = _recv_exact(sock, 1)
            sock.settimeout(None)
        except Exception:
            sock.close()
            return
        if role == b"N":
            # A worker node joining the cluster: hand the authenticated
            # socket to the remote-node layer (the raylet-registration
            # analog); its first frame is register_node.
            try:
                from ray_tpu_torch._private.remote_node import accept_node

                accept_node(self.runtime, wire.Connection(sock))
            except Exception:
                traceback.print_exc()
                sock.close()
            return
        try:
            handle = ClientHandle(self, wire.Connection(sock))
        except Exception:
            traceback.print_exc()
            sock.close()
            return
        # Register BEFORE serving: the reader's disconnect path calls
        # forget(), which must find the handle in the set.
        with self._lock:
            self._clients.add(handle)
        handle.start()

    def forget(self, handle: ClientHandle) -> None:
        with self._lock:
            self._clients.discard(handle)

    def stop(self) -> None:
        self._running = False
        try:
            self.runtime.logs.remove_sink(self._fanout_logs)
        except Exception:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            clients = list(self._clients)
            self._clients.clear()
        for handle in clients:
            handle.conn.close()
        self.rpc_pool.shutdown(wait=False, cancel_futures=True)
