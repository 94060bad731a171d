"""Cross-node object transfer: one object server per host process.

The pull half of the reference's inter-node object plane
(object_manager/object_manager.h: chunked push/pull over gRPC, directed by
the ownership-based object directory). Here the owner (head) records each
sealed object's location; readers pull the bytes directly from the holding
node's object server over a raw TCP protocol — no pickle anywhere on this
path, so an unauthenticated peer can never reach a deserializer.

Request:  preamble (head_server.send_preamble, role 'O'), then per fetch:
          u32 oid_len + oid bytes
Reply:    u8 status (0=ok, 1=missing) + u8 format_tag + u64 size + raw bytes
          format tags: N = native-store envelope (put_raw-able verbatim),
                       P = plain cloudpickle bytes

Memory is bounded on BOTH ends regardless of object size (the reference's
chunked ObjectManager push/pull, object_manager.h): the server sendall()s
straight from the holder's shm view (no heap copy — the provider hands back
the live view plus a release callback), and the fetcher recv_into()s
envelope payloads directly into a create_raw'd shm allocation sealed after
the last byte. Only the small control-plane-pickled values (tag P) buffer
on the heap.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Optional

TAG_ENVELOPE = ord("N")
TAG_PICKLE = ord("P")

# Per-syscall serve timeout: generous for slow-but-progressing readers
# (applies to each send/recv, not the whole transfer).
SERVE_IO_TIMEOUT_S = 60.0

_U32 = struct.Struct("<I")
_HDR = struct.Struct("<BBQ")  # status, tag, size

# provider(oid_bytes) -> (tag, buffer[, release_callback]) or None; the
# server calls release_callback (when present) after the bytes are sent,
# letting providers serve live shm views without copying them first.
Provider = Callable[[bytes], Optional[tuple]]


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    got = bytearray()
    while len(got) < n:
        try:
            chunk = sock.recv(min(1 << 20, n - len(got)))
        except OSError:
            return None
        if not chunk:
            return None
        got += chunk
    return bytes(got)


class ObjectServer:
    """Serves this process's object bytes to authenticated peers."""

    def __init__(
        self,
        provider: Provider,
        token: str,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self._provider = provider
        self._token = token
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="objsrv-accept", daemon=True
        )
        self._accept_thread.start()

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_conn, args=(sock,), daemon=True
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        from ray_tpu_torch._private import head_server as hs

        try:
            sock.settimeout(hs.HANDSHAKE_TIMEOUT_S)
            magic = _recv_exact(sock, len(hs.PREAMBLE_MAGIC))
            if magic != hs.PREAMBLE_MAGIC:
                raise ConnectionError("bad magic")
            lead = _recv_exact(sock, 1)
            if lead is None:
                raise ConnectionError("eof")
            token = _recv_exact(sock, lead[0]) if lead[0] else b""
            if self._token:
                import hmac

                if token is None or not hmac.compare_digest(
                    token, self._token.encode()
                ):
                    raise ConnectionError("bad token")
            if _recv_exact(sock, 1) != b"O":  # preamble role byte
                raise ConnectionError("bad role")
            # Bounded per-syscall stall: a hung reader must not hold a shm
            # pin (zero-copy serves keep the object pinned until sent) or a
            # server thread forever. Idle cached fetcher connections time
            # out too — the fetcher transparently reconnects.
            sock.settimeout(SERVE_IO_TIMEOUT_S)
            while True:
                raw = _recv_exact(sock, _U32.size)
                if raw is None:
                    return
                (oid_len,) = _U32.unpack(raw)
                if oid_len > 64:
                    return  # protocol violation
                oid = _recv_exact(sock, oid_len)
                if oid is None:
                    return
                found = self._provider(oid)
                if found is None:
                    sock.sendall(_HDR.pack(1, 0, 0))
                    continue
                tag, buf = found[0], found[1]
                release = found[2] if len(found) > 2 else None
                try:
                    view = memoryview(buf)
                    sock.sendall(_HDR.pack(0, tag, view.nbytes))
                    sock.sendall(view)  # kernel-chunked straight from shm
                    del view
                finally:
                    if release is not None:
                        try:
                            release()
                        except Exception:
                            pass
        except Exception:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._running = False
        try:
            self._listener.close()
        except OSError:
            pass


class ObjectFetcher:
    """Pull client with one cached connection per peer address."""

    def __init__(self, token: str, timeout: float = 30.0):
        self._token = token
        self._timeout = timeout
        self._conns: dict[tuple[str, int], socket.socket] = {}
        self._lock = threading.Lock()

    def _connect(self, addr: tuple[str, int]) -> socket.socket:
        from ray_tpu_torch._private.head_server import send_preamble

        sock = socket.create_connection(addr, self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_preamble(sock, self._token, role=b"O")
        return sock

    def fetch(self, addr: tuple[str, int], oid_bytes: bytes):
        """Returns (tag, bytes) or None when the peer doesn't hold the
        object. Raises ConnectionError when the peer is unreachable."""
        return self.fetch_into(addr, oid_bytes, None)

    def fetch_into(
        self,
        addr: tuple[str, int],
        oid_bytes: bytes,
        create: Optional[Callable[[int], Optional[memoryview]]],
    ):
        """Like fetch, but envelope payloads (tag N) stream via recv_into
        straight into the writable view `create(size)` returns — typically a
        create_raw'd shm allocation — so pull memory stays bounded by the
        socket buffer, not the object. Returns (tag, bytes_or_None):
        bytes is None exactly when the payload landed in the view (the
        caller seals it). create returning None falls back to heap
        buffering."""
        addr = (addr[0], int(addr[1]))
        with self._lock:
            sock = self._conns.pop(addr, None)
        for fresh in (False, True):
            if sock is None:
                sock = self._connect(addr)
                fresh = True
            used_view = False
            try:
                sock.sendall(_U32.pack(len(oid_bytes)) + oid_bytes)
                hdr = _recv_exact(sock, _HDR.size)
                if hdr is None:
                    raise ConnectionError("peer closed mid-fetch")
                status, tag, size = _HDR.unpack(hdr)
                if status != 0:
                    self._cache_conn(addr, sock)
                    return None
                view = None
                if create is not None and tag == TAG_ENVELOPE:
                    try:
                        view = create(size)
                    except Exception:
                        view = None  # e.g. store full: buffer on the heap
                if view is not None:
                    used_view = True
                    if not self._recv_into(sock, view, size):
                        raise ConnectionError("peer closed mid-payload")
                    self._cache_conn(addr, sock)
                    return tag, None
                data = _recv_exact(sock, size)
                if data is None:
                    raise ConnectionError("peer closed mid-payload")
                self._cache_conn(addr, sock)
                return tag, data
            except (OSError, ConnectionError):
                try:
                    sock.close()
                except OSError:
                    pass
                sock = None
                # Once create() handed out a view the allocation may be
                # partially written: NEVER retry internally (a second
                # create() on the same id would fail and silently divert to
                # a no-op heap put). The caller aborts the allocation and
                # decides whether to retry.
                if fresh or used_view:
                    raise
                # stale cached connection: retry once with a fresh one
        raise ConnectionError(f"unreachable object server {addr}")

    @staticmethod
    def _recv_into(sock: socket.socket, view: memoryview, size: int) -> bool:
        got = 0
        while got < size:
            try:
                n = sock.recv_into(view[got:], min(1 << 20, size - got))
            except OSError:
                return False
            if n == 0:
                return False
            got += n
        return True

    def _cache_conn(self, addr: tuple[str, int], sock: socket.socket) -> None:
        # One cached connection per peer: the loser of a concurrent fetch
        # closes its socket instead of leaking the fd.
        with self._lock:
            kept = self._conns.setdefault(addr, sock)
        if kept is not sock:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            conns, self._conns = dict(self._conns), {}
        for sock in conns.values():
            try:
                sock.close()
            except OSError:
                pass
