"""ctypes binding to the port's native shared-memory object store
(csrc/store.cc), the counterpart of ray_tpu/_private/native_store.py.

The plasma-client equivalent: every process of the node maps the runtime's
shm segment by name and reads sealed objects without copying them through a
socket. Serialization is pickle protocol 5 with out-of-band buffers: the
pickle stream and every buffer land in one shm allocation.

Layout of one stored object (the reference's, byte for byte):
    [u64 pickle_len][u64 n_buffers][n × u64 buffer_len]
    [pickle bytes][pad to 64][buf 0][pad to 64][buf 1]...

Where the port differs from the reference's binding:

* The library builds with g++ from ``csrc/store.cc`` into ``_build/``
  beside this file (git-ignored) at first use, named after a hash of the
  source and flags. ``RAY_TPU_TORCH_STORE_LIB`` loads another build (the
  sanitizer lanes, ``build("asan")`` / ``build("tsan")``). A build or load
  that fails raises `NativeStoreBuildError` with the compiler's message;
  the reference warns and runs without a store.
* Torch tensors pickle out of band: torch pickles a tensor's bytes into
  the stream, so the store's own pickler (`_StorePickler`, this module
  only) hands each tensor's bytes to the buffer callback, with dtype, shape
  and strides in the stream. A CUDA tensor is copied device to host once,
  straight into its shm allocation.
* Reads (ROADMAP.md §D24): numpy arrays come back as read-only views of the
  segment (the reference's are writable, so one reader's write changed
  what every other reader got); a CPU tensor comes back as one private
  copy out of the segment, since torch has no read-only tensor; a CUDA
  tensor is rebuilt on the device index it left with one host-to-device
  copy, and a process that sees no card raises
  `wire.CUDAUnavailableError`.
* The segment's capacity is capped at /dev/shm's free bytes when it is
  created (§D25): the segment is sized by a sparse ftruncate, and a write
  past the tmpfs's limit would kill the writer with SIGBUS.

Nothing here builds or loads anything at import: worker processes import
this module at start-up, and start-up imports neither torch nor numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import pickle
import struct
import subprocess
import sys
import threading
import warnings
import weakref
from pathlib import Path
from typing import Any, Optional

import cloudpickle

_ALIGN = 64
SOURCE = Path(__file__).resolve().parent / "csrc" / "store.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")
# The sanitizer lanes (the reference's src/Makefile asan / tsan targets):
# extra flags, and the runtime to LD_PRELOAD into the process that loads them.
LANES = {
    "": (),
    "asan": ("-g", "-fsanitize=address,undefined", "-fno-omit-frame-pointer"),
    "tsan": ("-g", "-fsanitize=thread", "-fno-omit-frame-pointer"),
}
SANITIZER_RUNTIMES = {"asan": "libasan.so", "tsan": "libtsan.so"}
LIB_ENV = "RAY_TPU_TORCH_STORE_LIB"
# The open-addressing index's slots when tps_open is given 0, and each
# slot's bytes (csrc/store.cc `Slot`): the table sits in the segment too.
_DEFAULT_SLOTS = 1 << 16
_SLOT_BYTES = 72

_lib = None
_lib_lock = threading.Lock()


class NativeStoreBuildError(RuntimeError):
    """The store's library could not be built or loaded."""


class NativeStoreFullError(MemoryError):
    pass


def library_path(lane: str = "") -> Path:
    """Where `build(lane)` puts its library: ``_build/`` inside this
    package, named after a hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS + LANES[lane]).encode())
    stem = f"libstore_{lane}" if lane else "libstore"
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(lane: str = "") -> Path:
    """Compile csrc/store.cc with g++ (``$CXX`` if set) unless a current
    build exists; returns the library's path. Concurrent builds each
    write a temporary and rename it into place. Raises
    NativeStoreBuildError with the compiler's output on failure."""
    target = library_path(lane)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, *LANES[lane],
           "-o", str(tmp), str(SOURCE), "-lpthread", "-lrt"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeStoreBuildError(
            f"building the native store failed: {' '.join(cmd)}: {exc!r}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeStoreBuildError(
            f"building the native store failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _declare(lib) -> None:
    P, U64, CP, I = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int
    signatures = {
        "tps_open": ([CP, U64, U64], P),
        "tps_create": ([P, CP, U64, ctypes.POINTER(P)], I),
        "tps_seal": ([P, CP], I),
        "tps_put": ([P, CP, P, U64], I),
        "tps_get": ([P, CP, ctypes.POINTER(P), ctypes.POINTER(U64)], I),
        "tps_release": ([P, CP], I),
        "tps_contains": ([P, CP], I),
        "tps_delete": ([P, CP], I),
        "tps_used": ([P], U64),
        "tps_capacity": ([P], U64),
        "tps_num_objects": ([P], U64),
        "tps_close": ([P], None),
        "tps_debug_lock": ([P], I),
        "tps_poisoned": ([P], I),
        "tps_destroy": ([CP], I),
        "tps_put_gather": ([P, CP, ctypes.POINTER(P), ctypes.POINTER(U64),
                            ctypes.POINTER(U64), ctypes.c_int32, U64,
                            ctypes.c_int32], I),
    }
    for name, (args, ret) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ret


def load_library():
    """The loaded store library: ``$RAY_TPU_TORCH_STORE_LIB`` if set, else
    this package's build, compiled first if needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path = os.environ.get(LIB_ENV) or str(build())
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise NativeStoreBuildError(
                    f"loading the native store {path} failed: {exc}") from exc
            _declare(lib)
            _lib = lib
        return _lib


# Copy parallelism for large puts: the GIL is released inside the C call and
# the copy stripes across threads (one memcpy stream leaves host memory
# bandwidth on the table).
_COPY_THREADS = max(2, min(8, (os.cpu_count() or 1)))


def _buffer_address(view: memoryview) -> int:
    """Zero-copy raw pointer of any contiguous buffer (readonly included)."""
    import numpy as np

    return np.frombuffer(view, dtype=np.uint8).ctypes.data


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def shm_free_bytes() -> Optional[int]:
    """Bytes free on /dev/shm (None where there is none)."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


# ------------------------------------------------------------ torch tensors


def _dense_strides(shape, stride) -> bool:
    """Whether a tensor of these strides can be rebuilt with them: no two
    elements share memory (a stride-0 or overlapping view cannot be written
    back element by element)."""
    need = 1
    for st, size in sorted((st, size) for size, st in zip(shape, stride) if size != 1):
        if st < need:
            return False
        need = st * size
    return True


def _reduce_tensor(t, device_pieces: dict):
    """Reduce a strided CPU or CUDA tensor to its bytes, out of band, and
    what rebuilds it: dtype, shape and strides (kept when no elements
    overlap; the rebuilt tensor has a storage of its own, so a view's
    storage offset is not carried). A CUDA tensor's bytes stay on the card
    here: its placeholder buffer is mapped to the tensor in
    `device_pieces`, and put_object copies it into shm."""
    import torch

    if (t.layout != torch.strided or t.is_quantized
            or t.device.type not in ("cpu", "cuda")
            or (t.requires_grad and not t.is_leaf)):
        return NotImplemented  # torch's own pickling
    data = t.detach().resolve_conj().resolve_neg()
    shape = tuple(data.shape)
    stride = tuple(data.stride()) if _dense_strides(shape, data.stride()) else None
    raw = data.contiguous().reshape(-1).view(torch.uint8)
    device = str(data.device) if data.device.type == "cuda" else "cpu"
    if device == "cpu":
        buf = pickle.PickleBuffer(raw.numpy())
    else:
        buf = pickle.PickleBuffer(bytearray(0))
        device_pieces[id(buf)] = raw
    meta = (str(data.dtype).replace("torch.", ""), shape, stride, device,
            t.requires_grad, isinstance(t, torch.nn.Parameter))
    return _rebuild_tensor, (buf, *meta)


def _rebuild_tensor(buf, dtype: str, shape, stride, device: str,
                    requires_grad: bool, is_param: bool):
    """A tensor of its own from bytes in the segment: one copy out of it,
    host to host or host to device."""
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        from ray_tpu_torch._private.wire import CUDAUnavailableError

        raise CUDAUnavailableError(
            f"a {device} tensor read from the native store reached process "
            f"{os.getpid()}, which sees no CUDA device (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}): a tensor is rebuilt on "
            "the device index it left. Move it to the host first, or run the "
            "workers with worker_device='' to inherit the driver's CUDA devices")
    dtype = getattr(torch, dtype)
    if stride is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    else:
        out = torch.empty_strided(shape, stride, dtype=dtype, device=device)
    if out.numel():
        with warnings.catch_warnings():
            # The segment's bytes are read-only; this wrapper only reads them.
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(buf, dtype=torch.uint8)
        if out.is_contiguous():
            out.view(-1).view(torch.uint8).copy_(src)
        else:
            out.copy_(src.view(dtype).view(shape))
    if is_param:
        return torch.nn.Parameter(out, requires_grad=requires_grad)
    return out.requires_grad_(requires_grad)


class _StorePickler(cloudpickle.CloudPickler):
    """cloudpickle with torch tensors reduced out of band (this module's
    pickler only: a tensor pickled anywhere else pickles as torch says)."""

    def __init__(self, file, buffer_callback):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self.device_pieces: dict = {}

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) in (torch.Tensor, torch.nn.Parameter):
            return _reduce_tensor(obj, self.device_pieces)
        return super().reducer_override(obj)


def dumps_out_of_band(value: Any) -> tuple[bytes, list, dict]:
    """(pickle stream, out-of-band PickleBuffers, {id(buffer): CUDA bytes})."""
    buffers: list = []
    f = io.BytesIO()
    pickler = _StorePickler(f, buffers.append)
    pickler.dump(value)
    return f.getvalue(), buffers, pickler.device_pieces


def envelope_from_pickle(pickled: bytes) -> bytes:
    """Wrap plain cloudpickle bytes in the envelope format (zero out-of-band
    buffers) so they can be put_raw() into a store and get_object()ed back."""
    header = struct.pack("<QQ", len(pickled), 0)
    total = _pad(len(header)) + _pad(len(pickled))
    out = bytearray(total)
    out[: len(header)] = header
    pos = _pad(len(header))
    out[pos : pos + len(pickled)] = pickled
    return bytes(out)


def decode_envelope(view) -> Any:
    """Deserialize a payload in the store's envelope format. Buffers are
    handed over read-only: numpy arrays are read-only views of them, and
    tensors copy out of them (§D24)."""
    view = memoryview(view).cast("B").toreadonly()
    pickle_len, n_bufs = struct.unpack_from("<QQ", view, 0)
    buf_lens = struct.unpack_from(f"<{n_bufs}Q", view, 16)
    pos = _pad(16 + 8 * n_bufs)
    pickled = view[pos : pos + pickle_len]
    pos += _pad(pickle_len)
    bufs = []
    for blen in buf_lens:
        bufs.append(view[pos : pos + blen])
        pos += _pad(blen)
    from ray_tpu_torch._private.wire import loads_value

    return loads_value(pickled, buffers=bufs)


class NativeStore:
    """One mapped shm segment; open the same name from any process on the
    node. `capacity` applies when this call creates the segment, capped at
    /dev/shm's free bytes less the index (§D25); `requested_capacity` keeps
    what was asked."""

    def __init__(self, name: str, capacity: int = 1 << 30, slots: int = 0):
        lib = load_library()
        self._lib = lib
        self.name = name.encode() if isinstance(name, str) else name
        self.requested_capacity = capacity
        free = shm_free_bytes()
        if free is not None and not os.path.exists("/dev/shm" + self.name.decode()):
            index = (slots or _DEFAULT_SLOTS) * _SLOT_BYTES + (1 << 20)
            if free - index < _ALIGN * 2:
                raise NativeStoreFullError(
                    f"/dev/shm has {free} bytes free: too few for a native store "
                    f"segment ({index} bytes of index alone)")
            capacity = min(capacity, free - index)
        self._handle = lib.tps_open(self.name, capacity, slots)
        if not self._handle:
            raise RuntimeError(f"tps_open({name!r}) failed")

    # -- raw bytes API ----------------------------------------------------

    @staticmethod
    def _key(object_id: Any) -> bytes:
        raw = object_id.binary() if hasattr(object_id, "binary") else bytes(object_id)
        return raw.ljust(32, b"\0")[:32]

    @staticmethod
    def _check_put(rc: int, what: str) -> None:
        if rc in (-2, -3):
            raise NativeStoreFullError(f"native store full ({what})")
        if rc in (-4, -5):
            # Poisoned segment / old payload awaiting deferred delete: the
            # caller stores the value elsewhere (MemoryError is the signal).
            raise NativeStoreFullError(f"native store unavailable ({what})")

    def put_raw(self, object_id, data: bytes) -> None:
        rc = self._lib.tps_put(self._handle, self._key(object_id), data, len(data))
        self._check_put(rc, f"putting {object_id}")
        if rc not in (0, -1):  # -1 = already present (idempotent reseal)
            raise RuntimeError(f"tps_put failed rc={rc}")

    def create_raw(self, object_id, size: int) -> Optional[memoryview]:
        """Two-phase put, phase 1 (plasma Create): allocate `size` bytes in
        shm and return a WRITABLE view of them, invisible to readers until
        seal_raw. None when the id already holds a live object."""
        ptr = ctypes.c_void_p()
        rc = self._lib.tps_create(
            self._handle, self._key(object_id), size, ctypes.byref(ptr)
        )
        if rc == -1:
            return None
        self._check_put(rc, f"creating {object_id}")
        if rc != 0:
            raise RuntimeError(f"tps_create failed rc={rc}")
        array_t = (ctypes.c_uint8 * size).from_address(ptr.value)
        return memoryview(array_t).cast("B")

    def seal_raw(self, object_id) -> None:
        """Two-phase put, phase 2 (plasma Seal): publish a create_raw'd
        object to readers."""
        rc = self._lib.tps_seal(self._handle, self._key(object_id))
        if rc != 0:
            raise RuntimeError(f"tps_seal failed rc={rc}")

    def abort_create(self, object_id) -> None:
        """Drop a created-but-unsealed allocation."""
        self._lib.tps_delete(self._handle, self._key(object_id))

    def get_raw(self, object_id, track: bool = False) -> Optional[memoryview]:
        """Zero-copy view of the sealed payload (pins the object). With
        track=True the pin is released automatically once every view derived
        from the returned memoryview has been garbage collected."""
        ptr = ctypes.c_void_p()
        size = ctypes.c_uint64()
        key = self._key(object_id)
        rc = self._lib.tps_get(self._handle, key, ctypes.byref(ptr), ctypes.byref(size))
        if rc != 0:
            return None
        array_t = (ctypes.c_uint8 * size.value).from_address(ptr.value)
        if track:
            weakref.finalize(array_t, self._release_and_reap, key)
        # ctypes arrays expose format '<B'; cast to plain 'B' so slicing and
        # buffer-assignment work and pickle accepts the views.
        return memoryview(array_t).cast("B")

    def _release_and_reap(self, key: bytes) -> None:
        # The deferred-delete decision lives in the shared slot: tps_release
        # from ANY process reclaims the object on the last unpin.
        if self._handle:
            self._lib.tps_release(self._handle, key)

    def pin(self, object_id) -> bool:
        """Hold a refcount on a sealed object without materializing a view
        (the owner-side pin preventing LRU eviction of live objects)."""
        ptr = ctypes.c_void_p()
        size = ctypes.c_uint64()
        return self._lib.tps_get(
            self._handle, self._key(object_id), ctypes.byref(ptr), ctypes.byref(size)
        ) == 0

    def unpin_and_delete(self, object_id) -> None:
        """Owner-side delete: drop the owner pin; if readers (in any process)
        still hold views, the shared delete_pending bit defers the delete to
        the last release."""
        key = self._key(object_id)
        self._lib.tps_release(self._handle, key)
        self._lib.tps_delete(self._handle, key)

    def release(self, object_id) -> None:
        self._lib.tps_release(self._handle, self._key(object_id))

    def contains(self, object_id) -> bool:
        return bool(self._lib.tps_contains(self._handle, self._key(object_id)))

    def delete(self, object_id) -> bool:
        return self._lib.tps_delete(self._handle, self._key(object_id)) == 0

    # -- object API (pickle5 out-of-band) ---------------------------------

    def put_object(self, object_id, value: Any) -> int:
        """Serialize with out-of-band buffers into one shm allocation.
        Returns the stored size in bytes. Host buffers go in ONE
        tps_put_gather call (copied with the GIL released, striped across
        threads); a value holding CUDA tensors is created, filled (each
        tensor copied device to host straight into its place) and sealed."""
        pickled, buffers, device_pieces = dumps_out_of_band(value)
        pieces: list = [None, memoryview(pickled)]
        for b in buffers:
            if id(b) in device_pieces:
                pieces.append(device_pieces[id(b)])
                continue
            raw = memoryview(b.raw()).cast("B")
            # Non-contiguous buffers can't be gathered as one pointer+length.
            pieces.append(raw if raw.contiguous else memoryview(bytes(raw)))
        lens = [p.nbytes for p in pieces[2:]]
        pieces[0] = memoryview(
            struct.pack(f"<QQ{len(lens)}Q", len(pickled), len(lens), *lens))
        offsets, pos = [], 0
        for piece in pieces:
            offsets.append(pos)
            pos += _pad(piece.nbytes)
        if device_pieces:
            self._put_filled(object_id, pieces, offsets, pos)
            return pos
        n = len(pieces)
        rc = self._lib.tps_put_gather(
            self._handle, self._key(object_id),
            (ctypes.c_void_p * n)(*[_buffer_address(p) for p in pieces]),
            (ctypes.c_uint64 * n)(*[p.nbytes for p in pieces]),
            (ctypes.c_uint64 * n)(*offsets), n, pos, _COPY_THREADS,
        )
        if rc == -1:  # already stored (task retry reseal) — idempotent
            return pos
        self._check_put(rc, f"{pos} bytes")
        if rc != 0:
            raise RuntimeError(f"tps_put_gather failed rc={rc}")
        return pos

    def _put_filled(self, object_id, pieces: list, offsets: list, total: int) -> None:
        import torch

        view = self.create_raw(object_id, total)
        if view is None:
            return  # already stored
        try:
            base = _buffer_address(view)
            for piece, off in zip(pieces, offsets):
                if isinstance(piece, torch.Tensor):
                    if piece.numel():
                        dst = torch.frombuffer(view[off:off + piece.nbytes],
                                               dtype=torch.uint8)
                        dst.copy_(piece)  # device to host, into the segment
                elif piece.nbytes:
                    ctypes.memmove(base + off, _buffer_address(piece), piece.nbytes)
        except BaseException:
            del view
            self.abort_create(object_id)
            raise
        del view
        self.seal_raw(object_id)

    def get_object(self, object_id, track: bool = True) -> tuple:
        """Returns (found, value). Numpy arrays in `value` are read-only
        views of the segment and keep the object pinned until they are
        collected (track=True) or until an explicit `release`
        (track=False); tensors are copies of their own."""
        view = self.get_raw(object_id, track=track)
        if view is None:
            return False, None
        return True, decode_envelope(view)

    # -- stats / lifecycle -------------------------------------------------

    def used_bytes(self) -> int:
        return int(self._lib.tps_used(self._handle))

    def capacity(self) -> int:
        return int(self._lib.tps_capacity(self._handle))

    def num_objects(self) -> int:
        return int(self._lib.tps_num_objects(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.tps_close(self._handle)
            self._handle = None

    def destroy(self) -> None:
        """Unlink the segment (runtime shutdown). Deliberately does NOT
        munmap: zero-copy arrays handed to the user may outlive the runtime,
        and the kernel reclaims the memory once the last mapping drops at
        process exit. Unlinking removes the name, so the next runtime starts
        fresh."""
        self._lib.tps_destroy(self.name)
