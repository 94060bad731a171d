"""Wire protocol for the driver <-> worker-process boundary.

The L0 protocol layer of this framework (reference: src/ray/protobuf/ +
gRPC in src/ray/rpc/). The reference speaks protobuf over gRPC between
daemons; here the boundary is driver <-> node-local worker processes over an
inherited unix socketpair, so the protocol is length-prefixed cloudpickle
frames — same framing both directions, full duplex, strictly ordered per
socket (ordering is load-bearing: incref frames must land before the task's
"done", and stream items before the stream's completion).

Frame = [u32 little-endian length][u8 kind_len][kind utf-8][pickled body].

The kind rides OUTSIDE the pickle so intermediaries can route frames
without deserializing them: a node daemon muxing worker frames to the head
peeks the kind (`recv_raw`) and forwards the body bytes verbatim, so the
body is pickled once (worker) and unpickled once (head).

Values of at least `native_store_threshold` returned by a task, and
arguments passed by reference to such values, cross through the native
shared-memory store (native_store.py); everything else crosses as frame
bytes, so a frame's u32 length caps such a value at 4 GiB
(`FrameTooLargeError`).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Any, Optional

import cloudpickle

_LEN = struct.Struct("<I")
_KLEN = struct.Struct("<B")
# The largest frame payload a u32 length can carry.
MAX_FRAME_BYTES = (1 << 32) - 1


class FrameTooLargeError(ValueError):
    """A value too large for one frame. Values of 4 GiB and more cross
    between processes only through the native shared-memory store."""


def encode_frame(kind: str, body: dict) -> bytes:
    """Serialize one frame payload (kind + pickled body)."""
    return encode_frame_from_bytes(
        kind, cloudpickle.dumps(body, protocol=5)
    )


def encode_frame_from_bytes(kind: str, body_bytes: bytes) -> bytes:
    kind_b = kind.encode("utf-8")
    if len(kind_b) > 255:
        raise ValueError(f"frame kind too long: {kind!r}")
    size = 1 + len(kind_b) + len(body_bytes)
    if size > MAX_FRAME_BYTES:
        raise FrameTooLargeError(
            f"a {kind!r} frame of {size} bytes exceeds the wire's "
            f"{MAX_FRAME_BYTES}-byte frame: values this large cross between "
            "processes only through the native shared-memory store, which is "
            "off (native_store_enabled=False) or was not used for this value: "
            "it carries task returns of at least native_store_threshold bytes "
            "and ObjectRef arguments (ray_tpu_torch.put), not values passed "
            "inline (ROADMAP.md §B10)"
        )
    return _KLEN.pack(len(kind_b)) + kind_b + body_bytes


# Driver -> worker kinds: hello, run_task, create_actor, actor_call, kill,
#                         rpc_reply
# Worker -> driver kinds: ready, done, stream_item, rpc, rpc_get, prefetch,
#                         incref, decref, refs


class CUDAUnavailableError(RuntimeError):
    """A pickled CUDA tensor reached a process that sees no CUDA device."""


def loads_value(data: bytes, buffers=None) -> Any:
    """Unpickle a value that crossed the boundary (with the out-of-band
    `buffers` of a store envelope, when given). Torch pickles a CUDA tensor
    through host bytes tagged with its device index and rebuilds it there; a
    process whose CUDA devices are hidden cannot, and says so."""
    try:
        return cloudpickle.loads(data, buffers=buffers)
    except RuntimeError as exc:
        if "deserialize object on a CUDA device" not in str(exc):
            raise
        raise CUDAUnavailableError(
            f"a CUDA tensor reached process {os.getpid()}, which sees no CUDA "
            f"device (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}): tensors cross between "
            "processes as torch pickles them and land on the device index they "
            "left. Move them to the host first, or run the workers with "
            "worker_device='' to inherit the driver's CUDA devices"
        ) from exc


class Connection:
    """One framed, thread-safe duplex connection over a stream socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()

    def send(self, kind: str, body: dict) -> None:
        self.send_bytes(encode_frame(kind, body))

    def send_bytes(self, payload: bytes) -> None:
        """Ship an already-serialized frame payload (encode_frame output);
        lets callers distinguish serialization errors from socket errors."""
        with self._send_lock:
            self._sock.sendall(_LEN.pack(len(payload)))
            self._sock.sendall(payload)

    def recv(self) -> Optional[tuple[str, dict]]:
        """Blocking read of one frame; None on clean EOF/reset.

        A frame that reads fully but fails to unpickle comes back as a
        ``("__decode_error__", {"error": ...})`` tuple: the stream framing is
        intact (the bad payload was consumed), so the caller decides whether
        to skip the frame or declare the peer dead — user data never rides
        raw in frames (func/args/values are nested pre-pickled bytes), so a
        decode error here means genuine protocol corruption."""
        frame = self._recv_frame()
        if frame is None:
            return None
        kind, body = frame
        if body is None:
            return ("__decode_error__", {"error": "malformed frame envelope"})
        try:
            return kind, cloudpickle.loads(body)
        except Exception as exc:  # noqa: BLE001 — undecodable payload
            return ("__decode_error__", {"error": repr(exc), "kind": kind})

    def recv_raw(self) -> Optional[tuple[str, bytes]]:
        """Blocking read of one frame WITHOUT deserializing the body:
        (kind, body_bytes), or None on EOF. Relays (a node daemon muxing its
        workers' frames to the head) route on the kind and forward the bytes
        untouched."""
        frame = self._recv_frame()
        if frame is None:
            return None
        kind, body = frame
        if body is None:
            # Unparseable envelope: an unloadable body, so recv() on the
            # far side of a relay reports it as a decode error too.
            return ("__decode_error__", cloudpickle.dumps({
                "error": "malformed frame envelope"
            }))
        return kind, bytes(body)

    def _recv_frame(self) -> Optional[tuple[str, Optional[memoryview]]]:
        """(kind, view of the body) of one frame; body None for a malformed
        envelope; None on EOF."""
        header = self._recv_exact(_LEN.size)
        if header is None:
            return None
        (length,) = _LEN.unpack(header)
        payload = self._recv_exact(length)
        if payload is None:
            return None
        try:
            (klen,) = _KLEN.unpack_from(payload, 0)
            kind = bytes(payload[1:1 + klen]).decode("utf-8")
        except Exception:
            return ("__decode_error__", None)
        return kind, memoryview(payload)[1 + klen:]

    def _recv_exact(self, n: int) -> Optional[bytearray]:
        """Exactly n bytes, read into one buffer of that size (a frame may
        be hundreds of MB: growing a bytes object chunk by chunk would copy
        it once per chunk); None on EOF."""
        buf = bytearray(n)
        view = memoryview(buf)
        have = 0
        while have < n:
            try:
                got = self._sock.recv_into(view[have:], n - have)
            except OSError:
                return None
            if not got:
                return None
            have += got
        return buf

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class WireRef:
    """Placeholder for a resolved top-level ObjectRef argument.

    The driver's dependency resolver guarantees the object is sealed before
    dispatch; the worker materializes it either from the shared shm store
    (in_native) or via a get_by_id RPC to the owner.
    """

    __slots__ = ("oid_bytes", "in_native")

    def __init__(self, oid_bytes: bytes, in_native: bool):
        self.oid_bytes = oid_bytes
        self.in_native = in_native


def send_with_fallback(
    conn: Connection, kind: str, body: dict, fallback: dict
) -> None:
    """Send a frame whose body may fail to pickle (user values/exceptions);
    degrade to the picklable `fallback` body, and swallow socket errors —
    a dead peer is detected by the reader, not the writer."""
    try:
        conn.send(kind, body)
    except Exception:
        try:
            conn.send(kind, fallback)
        except Exception:
            pass
