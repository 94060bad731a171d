"""Worker-node daemon: joins a head over TCP and hosts local workers (the
port's copy of ray_tpu/_private/node_daemon.py).

The raylet analog (reference: raylet/main.cc + services.py:1353 `ray start`
plumbing): one daemon per machine. It owns

  * a node-local shared-memory store its workers attach zero-copy,
  * an object server exposing those bytes to peers (object_plane.py),
  * the worker processes (worker_main.py over inherited socketpairs),

and muxes worker frames over one authenticated TCP connection to the head
(remote_node.py documents the frame protocol). All ownership/scheduling
state stays on the head; the daemon is deliberately dumb — spawn, route,
serve bytes, report deaths.

The daemon intercepts exactly one worker RPC: `get_by_id`. Reads hit the
node-local store first (zero-copy); misses trigger an owner-directed
location lookup on the head and a direct pull from the holding node's
object server, after which the bytes are cached in the local store so every
other worker on this node reads them zero-copy (reference: PullManager
request dedup, object_manager/pull_manager.h).

Start:  python -m ray_tpu_torch._private.node_daemon --address='head:port?token=...'
            [--num-cpus N] [--num-gpus N] [--object-store-memory BYTES]
Stops when the head connection drops (fate-sharing, both directions),
unless it rejoins a restarted head within its reconnect window.

Where the port differs from the reference's daemon:

* The node's store is required (ROADMAP.md §D25, §D27): a library that
  cannot be built or loaded, or an explicit --object-store-memory larger
  than /dev/shm's free bytes, stops the daemon before it joins; the
  reference's daemon then runs without a store and without an object
  server.
* Its workers' CUDA devices follow the head's `worker_device` (§D22): ""
  inherits the daemon's, "cpu" hides them; `GPU` is advertised only as
  --num-gpus says. There is no --num-tpus.
* Workers it kills (a lost head, shutdown) are waited for, so what they
  held (a CUDA context, card memory) is released before the daemon
  rejoins a head or exits.
* Its connection to the head has no read timeout once it is welcomed: the
  reference's keeps the dial's 30 s, so a head that sends nothing for
  30 s reads as lost (§D29).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import cloudpickle

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.log_aggregation import PipeTailer
from ray_tpu_torch._private.object_plane import (
    TAG_ENVELOPE,
    TAG_PICKLE,
    ObjectFetcher,
    ObjectServer,
)

# Seconds to dial the head and be welcomed.
CONNECT_TIMEOUT_S = 30.0

# The directory holding the ray_tpu_torch package.
_PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class DaemonWorker:
    """One local worker process: spawn, forward frames, report death."""

    def __init__(self, daemon: "NodeDaemon", wid: int):
        self.daemon = daemon
        self.wid = wid
        self.alive = True
        parent_sock, child_sock = socket.socketpair()
        env = os.environ.copy()
        env["RAY_TPU_TORCH_WORKER_FD"] = str(child_sock.fileno())
        env["RAY_TPU_TORCH_IS_WORKER"] = "1"
        # The worker imports the package this daemon imported.
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
        )
        if daemon.welcome.get("worker_device") == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            pass_fds=[child_sock.fileno()],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        child_sock.close()
        # Tail the worker's stdout/stderr and ship line batches to the head
        # ("wl" frames): the reference's log_monitor → pubsub → driver path
        # (python/ray/_private/log_monitor.py:102) collapsed onto the
        # existing node connection.
        self._tailers = [
            PipeTailer(pipe.fileno(), stream, self._emit_log)
            for stream, pipe in (("stdout", self.proc.stdout),
                                 ("stderr", self.proc.stderr))
        ]
        for tailer in self._tailers:
            tailer.start()
        self.conn = wire.Connection(parent_sock)
        self.conn.send(
            "hello",
            {
                "store_name": daemon.store.name.decode(),
                "node_id": daemon.welcome["node_id"],
                "job_id": daemon.welcome["job_id"],
                "driver_task_id": daemon.welcome["driver_task_id"],
                "namespace": daemon.welcome.get("namespace", "default"),
                "native_threshold": daemon.welcome.get("native_threshold", 0),
                # Daemon's own path + the driver's import roots forwarded in
                # node_welcome (functions pickled by reference must resolve
                # on this machine's workers too).
                "sys_path": list(
                    dict.fromkeys(
                        [p for p in sys.path if p]
                        + list(daemon.welcome.get("sys_path", ()))
                    )
                ),
            },
        )
        self._reader = threading.Thread(
            target=self._read_loop, name=f"dworker-{wid}", daemon=True
        )
        self._reader.start()

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self.conn.recv_raw()
            except Exception:
                traceback.print_exc()
                msg = None
            if msg is None:
                break
            kind, body_bytes = msg
            try:
                if kind == "rpc_get":
                    # The ONE frame the daemon inspects: get_by_id takes the
                    # local-store fast path + cross-node pull (off-thread so
                    # a blocking wait-for-seal doesn't wedge forwarding). A
                    # body that fails to decode forwards as a decode error —
                    # the head kills the worker rather than letting its
                    # blocking rpc() hang.
                    try:
                        body = cloudpickle.loads(body_bytes)
                    except Exception as exc:  # noqa: BLE001
                        self.daemon.to_head(
                            "wf",
                            {
                                "wid": self.wid,
                                "k": "__decode_error__",
                                "b": {"error": repr(exc)},
                            },
                        )
                        continue
                    self.daemon.rpc_pool.submit(
                        self.daemon.serve_get, self, body
                    )
                elif kind == "prefetch":
                    # Fire-and-forget multi-object pull hint (worker is about
                    # to get() these refs): start the pulls now so their
                    # location lookups coalesce into one loc_sub frame and
                    # the serial per-ref reads hit the local store.
                    try:
                        body = cloudpickle.loads(body_bytes)
                    except Exception:
                        continue
                    self.daemon.prefetch(body.get("oids", ()), body.get("timeout"))
                elif kind == "pong":
                    pass  # local liveness only; EOF is the real signal
                else:
                    # Decode-free relay for EVERYTHING else (including rpc
                    # put/submit bodies and __decode_error__ reports): the
                    # head is the single decoder of worker frame bodies
                    # (wire.py module docstring).
                    self.daemon.to_head(
                        "wf",
                        {"wid": self.wid, "k": kind, "raw": body_bytes},
                    )
            except Exception:
                traceback.print_exc()
        self.alive = False
        try:
            self.proc.kill()
        except Exception:
            pass
        self.daemon.on_worker_exit(self)

    def _emit_log(self, stream: str, lines: list) -> None:
        try:
            self.daemon.to_head(
                "wl",
                {
                    "wid": self.wid,
                    "pid": self.proc.pid,
                    "stream": stream,
                    "lines": lines,
                },
            )
        except Exception:
            pass  # head gone: fate-sharing will tear us down shortly

    def send_frame_bytes(self, payload: bytes) -> None:
        self.conn.send_bytes(payload)

    def reply(self, msg_id: int, *, ok: bool, result=None, exc=None) -> None:
        body = {"id": msg_id, "ok": ok}
        if ok:
            body["result"] = result
        else:
            body["exc"] = exc
        try:
            self.conn.send("rpc_reply", body)
        except Exception:
            pass

    def kill(self) -> None:
        self.alive = False
        try:
            self.conn.send("kill", {})
        except Exception:
            pass
        try:
            self.proc.kill()
        except Exception:
            pass
        self.conn.close()

    def reap(self, timeout: float = 10.0) -> None:
        """Wait for the killed process to be gone, so its CUDA context and
        card memory are released, and for its last output lines."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return
        for tailer in self._tailers:
            tailer.join(timeout)


class NodeDaemon:
    def __init__(
        self,
        address: str,
        resources: Optional[dict] = None,
        labels: Optional[dict] = None,
        object_store_memory: Optional[int] = None,
        reconnect_window_s: Optional[float] = None,
    ):
        address, _, query = address.partition("?")
        token = ""
        if query.startswith("token="):
            token = query[len("token=") :]
        token = token or os.environ.get("RAY_TPU_TORCH_CLIENT_TOKEN", "")
        self.token = token
        host, _, port = address.rpartition(":")
        self.head_host = host or "127.0.0.1"
        self.head_port = int(port)
        # Head-crash tolerance (the raylet's gcs_rpc_server_reconnect_timeout
        # analog, reference gcs_redis_failure_detector.h): an UNEXPECTED
        # connection loss triggers reconnect-with-backoff for this window
        # before the daemon gives up and fate-shares. An explicit head
        # "shutdown" frame still kills the daemon immediately.
        if reconnect_window_s is None:
            reconnect_window_s = float(
                os.environ.get("RAY_TPU_TORCH_RECONNECT_WINDOW_S", "30")
            )
        self.reconnect_window_s = reconnect_window_s

        # Node-local store (workers attach it; peers pull via the object
        # server). Sized like the head's default budget unless given. No
        # fallback: a store that cannot be built, or an explicit size
        # /dev/shm cannot hold, stops the daemon here (§D25, §D27).
        self.store = self._open_store(object_store_memory)
        # Bind the interface this node is reachable at from the cluster
        # (loopback for a localhost cluster — don't expose object bytes
        # wider than the control plane's reach).
        self.object_server = ObjectServer(
            self._serve_bytes, token, host=self._advertise_host()
        )
        self.fetcher = ObjectFetcher(token)
        self.rpc_pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="daemon-rpc"
        )
        # Prefetch waiters BLOCK (waiting on loc_pub) — they get their own
        # pool so a large multi-ref get can never occupy every rpc_pool
        # thread and starve serve_get's local-store fast path for other
        # workers on this node.
        self.pull_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="daemon-pull"
        )

        if resources is None:
            resources = {}
        resources.setdefault("CPU", float(os.cpu_count() or 1))
        self._resources = resources
        self._labels = labels or {}
        try:
            self._connect()
        except BaseException:
            # No head to join: leave no segment or listener behind.
            self.object_server.stop()
            self.store.destroy()
            raise

        self._lock = threading.Lock()
        self.workers: dict[int, DaemonWorker] = {}
        # In-flight cross-node pulls deduped per oid (PullManager semantics).
        self._pulls: dict[bytes, threading.Event] = {}
        self._closed = False
        # Batched location subscription (the reference pubsub's per-subscriber
        # long-poll batching, pubsub/README.md, collapsed onto the persistent
        # node connection): concurrent misses queue into one outbox the
        # flusher drains as a single `loc_sub` frame, and the head pushes
        # `loc_pub` batches back — in-flight head RPCs stay O(1) per daemon
        # no matter how many objects are being pulled.
        self._loc_lock = threading.Lock()
        self._loc_cond = threading.Condition(self._loc_lock)
        self._loc_waiters: dict[bytes, list] = {}
        self._loc_outbox: list = []
        self._loc_flusher = threading.Thread(
            target=self._flush_loc_subs, name="loc-flusher", daemon=True
        )
        self._loc_flusher.start()

    def _connect(self) -> None:
        """Dial the head, register, and adopt its welcome. Used at startup
        AND on reconnect after a head crash (the restarted head assigns a
        fresh node_id; the daemon keeps its store/object server/process)."""
        sock = socket.create_connection(
            (self.head_host, self.head_port), CONNECT_TIMEOUT_S
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        from ray_tpu_torch._private.head_server import send_preamble

        send_preamble(sock, self.token, role=b"N")
        conn = wire.Connection(sock)
        conn.send(
            "register_node",
            {
                "resources": dict(self._resources),
                "labels": dict(self._labels),
                "hostname": socket.gethostname(),
                "pid": os.getpid(),
                "object_addr": [self._advertise_host(), self.object_server.port],
                "store_name": self.store.name.decode(),
            },
        )
        msg = conn.recv()
        if msg is None or msg[0] != "node_welcome":
            conn.close()
            raise ConnectionError("head rejected node registration")
        # The timeout bounds the dial and the welcome only: a head may send
        # nothing for minutes while this node's workers run, and a recv
        # that timed out would read as a lost head (the reference keeps
        # it, and re-registers an idle node every 30 s, ROADMAP.md §D29).
        sock.settimeout(None)
        self.conn = conn
        self.welcome = msg[1]
        self.node_id = self.welcome["node_id"]
        # Adopt the driver's import roots: the daemon decodes every worker
        # frame before muxing it to the head, so values pickled by reference
        # to driver-side modules must resolve HERE too (nonexistent paths on
        # this machine are skipped by the import system).
        for path in self.welcome.get("sys_path", ()):
            if path not in sys.path:
                sys.path.append(path)

    def _open_store(self, object_store_memory: Optional[int]):
        from ray_tpu_torch._private.native_store import (
            NativeStore,
            NativeStoreFullError,
            shm_free_bytes,
        )

        free = shm_free_bytes()
        if object_store_memory and free is not None and object_store_memory > free:
            # Every store of the machine draws on the same /dev/shm: a
            # request it cannot hold now is refused rather than capped, so
            # the node never advertises bytes it does not have.
            raise NativeStoreFullError(
                f"--object-store-memory {object_store_memory} bytes: /dev/shm "
                f"has {free} bytes free (ROADMAP.md §D27)"
            )
        return NativeStore(
            f"/ray_tpu_torch_node_{os.getpid()}",
            capacity=object_store_memory or self._default_budget(),
        )

    @staticmethod
    def _default_budget() -> int:
        # Same sizing rule as the head (30% of RAM, 200 GB cap —
        # _private/ray_constants.py:51-53 in the reference).
        try:
            pages = os.sysconf("SC_PHYS_PAGES")
            page = os.sysconf("SC_PAGE_SIZE")
            return min(int(pages * page * 0.3), 200 * 1024**3)
        except (ValueError, OSError):
            return 1 << 30

    def _advertise_host(self) -> str:
        """The address peers reach this node's object server at: the local
        interface used to reach the head (works on localhost and real LANs)."""
        try:
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            probe.connect((self.head_host, 1))
            addr = probe.getsockname()[0]
            probe.close()
            return addr
        except OSError:
            return "127.0.0.1"

    # -- object plane -------------------------------------------------------

    def _serve_bytes(self, oid_bytes: bytes):
        """Zero-copy provider: the object server streams the live shm view
        and releases the pin after the last byte."""
        view = self.store.get_raw(oid_bytes)
        if view is None:
            return None
        return (TAG_ENVELOPE, view, lambda: self.store.release(oid_bytes))

    def serve_get(self, worker: DaemonWorker, body: dict) -> None:
        """Intercepted get_by_id from a local worker."""
        payload = body["payload"]
        oid = payload["oid"]
        msg_id = body["id"]
        # A worker that couldn't attach the shm store (or that missed a
        # local read after an eviction race) asks for the value itself:
        # never answer {in_native}. Objects already sealed locally are served
        # as raw envelope bytes (worker decodes them — no daemon-side
        # unpickle, no double network hop through the head); everything else
        # forwards to the head so the bytes ride the control plane.
        if payload.get("force_value"):
            try:
                if self.store.contains(oid):
                    view = self.store.get_raw(oid)
                    if view is not None:
                        try:
                            data = bytes(view)  # frame-embedded: must copy
                        finally:
                            del view
                            self.store.release(oid)
                        worker.reply(
                            msg_id, ok=True, result={"envelope": data}
                        )
                        return
            except Exception:
                traceback.print_exc()
            self.to_head("wf", {"wid": worker.wid, "k": "rpc", "b": body})
            return
        try:
            if self.store.contains(oid):
                worker.reply(msg_id, ok=True, result={"in_native": True})
                return
            if self._pull_into_store(oid, payload.get("timeout")):
                worker.reply(msg_id, ok=True, result={"in_native": True})
                return
        except Exception:
            traceback.print_exc()
        # Fallback: forward the original RPC to the head (value rides the
        # control connection — correct for small/local-only values).
        self.to_head("wf", {"wid": worker.wid, "k": "rpc", "b": body})

    def prefetch(self, oids, timeout) -> None:
        """Kick off pulls for every oid not already local (deduped against
        in-flight pulls). ALL location subscriptions are registered under one
        outbox lock before the flusher can wake, so a 200-object prefetch
        costs ONE loc_sub frame; the fetches then run concurrently and the
        prefetching worker's subsequent reads are local-store hits."""
        work: list[bytes] = []
        with self._lock:
            if self._closed:
                return
            for oid in dict.fromkeys(oids):
                try:
                    if self.store.contains(oid) or oid in self._pulls:
                        continue
                except Exception:
                    continue
                self._pulls[oid] = threading.Event()
                work.append(oid)
        if not work:
            return
        waiters: dict[bytes, tuple] = {}
        with self._loc_lock:
            if self._closed:
                with self._lock:
                    for oid in work:
                        self._pulls.pop(oid, None)
                return
            for oid in work:
                event = threading.Event()
                slot: dict = {}
                self._loc_waiters.setdefault(oid, []).append((event, slot))
                self._loc_outbox.append((oid, timeout))
                waiters[oid] = (event, slot)
            self._loc_cond.notify()
        wait_s = 300.0 if timeout is None else timeout + 30.0

        def finish(oid: bytes) -> None:
            event, slot = waiters[oid]
            try:
                replied = event.wait(timeout=wait_s)
                self._locate_unregister(oid, event)
                if replied and slot and not slot.get("dead"):
                    self._fetch_from(oid, slot)
            except Exception:
                pass
            finally:
                with self._lock:
                    done_event = self._pulls.pop(oid, None)
                if done_event is not None:
                    done_event.set()

        for oid in work:
            self.pull_pool.submit(finish, oid)

    def _pull_into_store(self, oid: bytes, timeout) -> bool:
        """Locate via the head, pull from a holding node's object server
        (streaming straight into a created shm allocation — pull memory is
        bounded by the socket buffer, not the object), seal, and advertise
        the cached copy so later pullers spread across holders instead of
        hammering the producer (the reference PushManager's broadcast
        scaling). Returns False when no peer holds bytes (head-local small
        values fall back to the control-plane path)."""
        with self._lock:
            event = self._pulls.get(oid)
            leader = event is None
            if leader:
                event = self._pulls[oid] = threading.Event()
        if not leader:
            event.wait(timeout=300)
            return self.store.contains(oid)
        try:
            # Bound the reply wait by the caller's get-timeout (+margin for
            # the lookup itself) so a long user timeout doesn't look like a
            # dead head and a short one isn't held 300s.
            reply = self._locate(
                oid,
                timeout,
                wait_s=300.0 if timeout is None else timeout + 30.0,
            )
            return self._fetch_from(oid, reply)
        except Exception:
            return False
        finally:
            with self._lock:
                self._pulls.pop(oid, None)
            event.set()

    def _fetch_from(self, oid: bytes, reply: dict) -> bool:
        """Fetch `oid` from the holders named in a location reply, trying
        each in order; seal into the local store and advertise the cached
        copy on success."""
        addrs = reply.get("addrs") or (
            [reply["addr"]] if reply.get("addr") else []
        )
        for addr in addrs:
            created = False

            def create(size: int):
                nonlocal created
                view = self.store.create_raw(oid, size)
                created = view is not None
                return view

            try:
                fetched = self.fetcher.fetch_into(
                    (addr[0], addr[1]), oid, create
                )
            except (ConnectionError, OSError):
                if created:
                    self.store.abort_create(oid)
                continue  # holder gone/stale: try the next one
            if fetched is None:
                if created:
                    self.store.abort_create(oid)
                continue  # evicted there: try the next holder
            tag, data = fetched
            if data is None:
                self.store.seal_raw(oid)  # streamed into shm
            else:
                if tag == TAG_PICKLE:
                    from ray_tpu_torch._private.native_store import (
                        envelope_from_pickle,
                    )

                    data = envelope_from_pickle(data)
                self.store.put_raw(oid, data)
                if not self.store.contains(oid):
                    # put_raw's idempotent-reseal rc can mask a stale
                    # kCreated slot: never report success (or advertise
                    # a copy) unless the object is actually readable.
                    return False
            try:
                self.to_head("object_cached", {"oid": oid})
            except Exception:
                pass
            return True
        return False

    # -- batched location lookups ------------------------------------------

    def _locate(self, oid: bytes, timeout, wait_s: float) -> dict:
        """Owner-directed location lookup via the batched subscription
        channel: register a waiter, queue the request for the flusher, block
        until the head publishes this oid (or `wait_s` passes). Concurrent
        lookups ride ONE loc_sub frame and ONE loc_pub reply regardless of
        how many objects are in flight."""
        event = threading.Event()
        slot: dict = {}
        with self._loc_lock:
            if self._closed:
                raise ConnectionError("head connection lost")
            self._loc_waiters.setdefault(oid, []).append((event, slot))
            self._loc_outbox.append((oid, timeout))
            self._loc_cond.notify()
        replied = event.wait(timeout=wait_s)
        self._locate_unregister(oid, event)
        if slot.get("dead"):
            raise ConnectionError("head connection lost")
        if not replied or not slot:
            return {"missing": True}
        return slot

    def _locate_unregister(self, oid: bytes, event: threading.Event) -> None:
        with self._loc_lock:
            waiters = self._loc_waiters.get(oid)
            if waiters:
                kept = [w for w in waiters if w[0] is not event]
                if kept:
                    self._loc_waiters[oid] = kept
                else:
                    del self._loc_waiters[oid]

    def _flush_loc_subs(self) -> None:
        while True:
            with self._loc_lock:
                while not self._loc_outbox and not self._closed:
                    self._loc_cond.wait()
                if self._closed:
                    return
                reqs, self._loc_outbox = self._loc_outbox, []
            try:
                self.to_head("loc_sub", {"reqs": reqs})
            except Exception:
                # Head connection gone: fail THIS batch's waiters now — a
                # lookup registered after the reconnect sweep would
                # otherwise block its full wait ceiling on a frame that
                # never left. The thread itself keeps serving (it must
                # survive a reconnect).
                for oid, _timeout in reqs:
                    with self._loc_lock:
                        waiters = self._loc_waiters.pop(oid, ())
                    for event, slot in waiters:
                        slot["dead"] = True
                        event.set()
                continue

    def _handle_loc_pub(self, body: dict) -> None:
        for oid, payload in body.get("results", ()):
            with self._loc_lock:
                waiters = self._loc_waiters.pop(oid, ())
            for event, slot in waiters:
                slot.update(payload)
                event.set()

    def to_head(self, kind: str, body: dict) -> None:
        self.conn.send(kind, body)

    # -- worker lifecycle ---------------------------------------------------

    def on_worker_exit(self, worker: DaemonWorker) -> None:
        with self._lock:
            existing = self.workers.get(worker.wid)
            if existing is worker:
                del self.workers[worker.wid]
            else:
                return
        try:
            self.to_head("worker_exit", {"wid": worker.wid})
        except Exception:
            pass

    # -- main loop ----------------------------------------------------------

    def run_forever(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except Exception:
                traceback.print_exc()
                msg = None
            if msg is None or msg[0] == "__decode_error__":
                # Head died, kicked us, or the stream corrupted. A fresh
                # connection resets the stream either way: try to rejoin
                # within the reconnect window (head restart tolerance);
                # past it, fate-share.
                if msg is not None:
                    print(
                        f"daemon: undecodable head frame: "
                        f"{msg[1].get('error')}",
                        file=sys.stderr,
                    )
                if self._try_reconnect():
                    continue
                break
            kind, body = msg
            try:
                self._handle_frame(kind, body)
            except Exception:
                traceback.print_exc()
        self.shutdown()

    def _try_reconnect(self) -> bool:
        """Rejoin a (re)started head after an unexpected connection loss.

        The old head owned every in-flight task and object reference, so
        local workers are killed (their results are undeliverable) and all
        pending location waiters fail fast; the store and object server
        survive, and the restarted head re-registers this machine as a fresh
        node (reference: raylet re-registration after GCS restart,
        gcs_redis_failure_detector.h)."""
        import time as _time

        # ray-tpu: lint-ignore[RTL201] advisory fast-path read of an
        # atomic bool; shutdown-vs-reconnect is settled by the locked
        # state swaps below, a stale read here only wastes one attempt
        if self.reconnect_window_s <= 0 or self._closed:
            return False
        with self._lock:
            workers = list(self.workers.values())
            self.workers.clear()
        for worker in workers:
            worker.kill()
        for worker in workers:
            worker.reap()
        with self._loc_lock:
            loc_waiters = [
                w for ws in self._loc_waiters.values() for w in ws
            ]
            self._loc_waiters.clear()
            self._loc_outbox.clear()
        for event, slot in loc_waiters:
            slot["dead"] = True
            event.set()
        deadline = _time.monotonic() + self.reconnect_window_s
        delay = 0.5
        print(
            f"daemon: head connection lost; retrying for "
            f"{self.reconnect_window_s:.0f}s",
            flush=True,
        )
        while _time.monotonic() < deadline:
            old = self.conn
            try:
                self._connect()
                try:
                    old.close()
                except Exception:
                    pass
                print(
                    f"daemon: rejoined head as node {self.node_id}",
                    flush=True,
                )
                return True
            except Exception:
                pass
            _time.sleep(min(delay, max(0.1, deadline - _time.monotonic())))
            delay = min(delay * 2, 5.0)
        return False

    def _handle_frame(self, kind: str, body: dict) -> None:
        if kind == "tw":
            with self._lock:
                worker = self.workers.get(body["wid"])
            if worker is not None:
                worker.send_frame_bytes(body["p"])
        elif kind == "spawn_worker":
            worker = DaemonWorker(self, body["wid"])
            with self._lock:
                self.workers[body["wid"]] = worker
        elif kind == "kill_worker":
            with self._lock:
                worker = self.workers.pop(body["wid"], None)
            if worker is not None:
                worker.kill()
        elif kind == "delete_objects":
            for oid in body["oids"]:
                try:
                    self.store.delete(oid)
                except Exception:
                    pass
        elif kind == "loc_pub":
            self._handle_loc_pub(body)
        elif kind == "ping":
            try:
                self.to_head("pong", {"id": body.get("id")})
            except Exception:
                pass
        elif kind == "shutdown":
            raise SystemExit(0)

    def shutdown(self) -> None:
        # Fail every pending location lookup so pulls blocked behind them
        # (and their deduped followers) unblock immediately instead of
        # eating the full 300s timeout; _closed makes late registrants fail
        # fast. Lives here (not in run_forever) so the head-sent "shutdown"
        # SystemExit path runs it too.
        with self._lock:
            self._closed = True
            workers = list(self.workers.values())
            self.workers.clear()
        with self._loc_lock:
            # Re-publish the flag under the loc lock too: the flusher
            # thread reads _closed while holding only _loc_lock, so this
            # is the barrier that makes the wake-up check reliable
            # (found by lint RTL201).
            self._closed = True
            loc_waiters = [
                w for waiters in self._loc_waiters.values() for w in waiters
            ]
            self._loc_waiters.clear()
            self._loc_outbox.clear()
            self._loc_cond.notify_all()  # release the flusher thread
        for event, slot in loc_waiters:
            slot["dead"] = True
            event.set()
        for worker in workers:
            worker.kill()
        for worker in workers:
            worker.reap()
        self.rpc_pool.shutdown(wait=False)
        self.pull_pool.shutdown(wait=False)
        self.object_server.stop()
        self.fetcher.close()
        try:
            self.store.destroy()
        except Exception:
            pass


def main(argv: Optional[list] = None) -> None:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="Join a ray_tpu_torch cluster as a worker node"
    )
    parser.add_argument(
        "--address",
        required=True,
        help="head connect string, host:port?token=... (printed by the head)",
    )
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument(
        "--num-gpus", type=float, default=None,
        help="GPU resource to advertise (none unless given)",
    )
    parser.add_argument(
        "--resources", default=None, help='extra resources as JSON, e.g. \'{"mem": 4}\''
    )
    parser.add_argument("--labels", default=None, help="node labels as JSON")
    parser.add_argument("--object-store-memory", type=int, default=None)
    parser.add_argument(
        "--reconnect-window",
        type=float,
        default=None,
        help="seconds to retry joining a restarted head after an unexpected "
        "connection loss (0 disables; default 30 or "
        "$RAY_TPU_TORCH_RECONNECT_WINDOW_S)",
    )
    args = parser.parse_args(argv)

    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = args.num_cpus
    if args.num_gpus:
        resources["GPU"] = args.num_gpus
    labels = json.loads(args.labels) if args.labels else {}

    daemon = NodeDaemon(
        args.address,
        resources=resources,
        labels=labels,
        object_store_memory=args.object_store_memory,
        reconnect_window_s=args.reconnect_window,
    )
    # SIGTERM (an autoscaler's provider terminating the node) shuts down as
    # a lost head does: the workers killed and reaped, so their CUDA contexts
    # are gone, and the segment removed. The reference's daemon dies at once
    # there, leaving its segment behind (ROADMAP.md §D32).
    import signal

    def on_sigterm(*_):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)  # one shutdown
        if not daemon._closed:  # else a shutdown (the head's) is running
            sys.exit(0)

    signal.signal(signal.SIGTERM, on_sigterm)
    print(
        f"node daemon up: node_id={daemon.node_id} pid={os.getpid()} "
        f"store={daemon.store.name.decode()} capacity={daemon.store.capacity()}",
        flush=True,
    )
    try:
        daemon.run_forever()
    except SystemExit:
        daemon.shutdown()


if __name__ == "__main__":
    main()
