"""The port's native shared-memory store (ray_tpu_torch/_private/csrc/store.cc
through native_store.py).

Every case of tests/test_native_store.py on the port's binding and its own
build of the store: lifecycle, pinning, eviction, cross-process reads and
deletes, EOWNERDEAD repair, the kill -9 rebuild and both sanitizer lanes.
Then what the port adds: the same seeded operations on the port's and the
reference's bindings agree step by step; a segment written by either
library reads with the other; torch tensors cross out of band and come back
as copies of their own (ROADMAP.md §D24); numpy arrays come back as
read-only views; a capacity above /dev/shm's free bytes is capped (§D25);
a failed build raises. The reference binding is imported inside the cases
that use it, so the `cuda` case runs on the card's machine, which has no
JAX: `python -m pytest --noconftest -q tests/test_torch_native_store.py -k card`.
"""

import gc
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import native_store
from ray_tpu_torch._private.native_store import NativeStore, NativeStoreFullError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def store():
    name = f"/tpt_test_{os.getpid()}"
    s = NativeStore(name, capacity=8 << 20)
    yield s
    s.destroy()


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


# ------------------------------------------------ tests/test_native_store.py


def test_put_get_roundtrip(store):
    data = b"x" * 10_000
    store.put_raw(b"id-1", data)
    view = store.get_raw(b"id-1")
    assert bytes(view) == data
    store.release(b"id-1")


def test_object_pickle5_zero_copy(store):
    arr = np.arange(50_000, dtype=np.float64)
    store.put_object(b"obj", {"a": arr, "b": "meta"})
    found, out = store.get_object(b"obj")
    assert found and out["b"] == "meta"
    np.testing.assert_array_equal(out["a"], arr)
    assert not out["a"].flags["OWNDATA"]  # view onto shm


def test_contains_delete_pin(store):
    store.put_raw(b"k", b"payload")
    assert store.contains(b"k")
    assert store.pin(b"k")
    assert not store.delete(b"k")  # pinned -> deferred via shared slot bit
    # The deferred delete completes on the LAST release, whichever process
    # performs it (delete_pending lives in the shared segment).
    store.release(b"k")
    assert not store.contains(b"k")


def test_lru_eviction_under_pressure(store):
    # 8MB capacity; write 20 x 1MB unpinned objects -> early ones evicted.
    for i in range(20):
        store.put_object(f"e{i}".encode(), np.ones(1 << 17, dtype=np.float64))
    assert store.num_objects() < 20
    assert store.contains(b"e19")  # most recent survives
    assert not store.contains(b"e0")


def test_pinned_objects_never_evicted(store):
    store.put_object(b"pinned", np.ones(1 << 17, dtype=np.float64))
    assert store.pin(b"pinned")
    for i in range(20):
        store.put_object(f"f{i}".encode(), np.ones(1 << 17, dtype=np.float64))
    assert store.contains(b"pinned")


def test_store_full_when_all_pinned(store):
    store.put_object(b"big", np.ones(7 << 17, dtype=np.float64))  # ~7MB
    store.pin(b"big")
    with pytest.raises(NativeStoreFullError):
        store.put_object(b"big2", np.ones(7 << 17, dtype=np.float64))


def test_deferred_delete_until_views_die(store):
    arr = np.arange(10_000, dtype=np.float32)
    store.put_object(b"d", arr)
    found, out = store.get_object(b"d")  # tracked view pins it
    store.unpin_and_delete(b"d")
    # Reader view still alive -> payload still readable.
    np.testing.assert_array_equal(out, arr)
    del out, found
    gc.collect()
    assert not store.contains(b"d")


def test_cross_process_read(store):
    """A second process maps the same segment by name and reads the object
    (the property the reference gets from plasma's unix-socket clients).
    A fresh interpreter, not a fork: the test process has threads."""
    arr = np.arange(1000, dtype=np.int64)
    store.put_object(b"xproc", arr)
    code = f"""
import numpy as np
from ray_tpu_torch._private.native_store import NativeStore
s = NativeStore({store.name.decode()!r}, capacity=1)  # opens existing; capacity ignored
found, value = s.get_object(b"xproc")
print(found, int(np.asarray(value).sum()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, env=_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", str(int(arr.sum()))]


def test_runtime_integration_large_objects():
    import ray_tpu_torch

    rt = ray_tpu_torch.init(
        num_cpus=2, num_gpus=0, _system_config={"native_store_threshold": 64 * 1024}
    )
    try:
        assert rt._native_store is not None  # no silent fallback

        @ray_tpu_torch.remote
        def produce():
            return np.arange(500_000, dtype=np.float32)

        arr = ray_tpu_torch.get(produce.remote())
        assert not arr.flags["OWNDATA"]
        assert rt._native_store.num_objects() >= 1
        small = ray_tpu_torch.get(ray_tpu_torch.put(123))  # small stays in python
        assert small == 123
    finally:
        ray_tpu_torch.shutdown()


def test_cross_process_deferred_delete(store, tmp_path):
    """A reader pin held in ANOTHER process defers the owner's delete; that
    process's release completes it (shared delete_pending bit)."""
    store.put_raw(b"xp", b"payload")
    marker = tmp_path / "pinned"
    code = f"""
import time
from ray_tpu_torch._private.native_store import NativeStore
s = NativeStore({store.name.decode()!r})
assert s.pin(b"xp")
open({str(marker)!r}, "w").write("1")
time.sleep(1.0)
s.release(b"xp")   # last release -> deferred delete completes
"""
    proc = subprocess.Popen([sys.executable, "-c", code], env=_env())
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not marker.exists():
        time.sleep(0.05)
    assert marker.exists(), "child never pinned"
    store.delete(b"xp")  # pinned remotely -> deferred
    assert proc.wait(timeout=30) == 0
    assert not store.contains(b"xp")


def test_eownerdead_repair_keeps_store_usable(store):
    """A process dying WHILE HOLDING the store mutex must not wedge or
    corrupt the segment: the next locker repairs and continues."""
    store.put_raw(b"before", b"data-before")
    code = f"""
import os
from ray_tpu_torch._private.native_store import NativeStore
s = NativeStore({store.name.decode()!r})
s._lib.tps_debug_lock(s._handle)
os._exit(1)   # die holding the robust mutex
"""
    subprocess.run([sys.executable, "-c", code], timeout=60, env=_env())
    # Next operation takes EOWNERDEAD, repairs, proceeds.
    store.put_raw(b"after", b"data-after")
    assert store.contains(b"before")
    assert store.contains(b"after")
    view = store.get_raw(b"after", track=False)
    assert bytes(view) == b"data-after"
    store.release(b"after")
    assert store._lib.tps_poisoned(store._handle) == 0


def test_create_seal_streaming_put(store):
    """Two-phase put (plasma Create/Seal): write into the returned view
    incrementally, invisible to readers until sealed."""
    payload = bytes(range(256)) * 64
    view = store.create_raw(b"stream-oid", len(payload))
    assert view is not None
    assert not store.contains(b"stream-oid")  # kCreated: invisible
    half = len(payload) // 2
    view[:half] = payload[:half]
    view[half:] = payload[half:]
    del view
    store.seal_raw(b"stream-oid")
    assert store.contains(b"stream-oid")
    got = store.get_raw(b"stream-oid")
    assert bytes(got) == payload
    del got
    store.release(b"stream-oid")
    # create on a live object -> None (idempotent reseal signal)
    assert store.create_raw(b"stream-oid", 10) is None


def test_abort_create_reclaims(store):
    view = store.create_raw(b"aborted-oid", 4096)
    assert view is not None
    del view
    store.abort_create(b"aborted-oid")
    assert not store.contains(b"aborted-oid")
    # the id is reusable after an abort
    view = store.create_raw(b"aborted-oid", 16)
    assert view is not None
    view[:16] = b"x" * 16
    del view
    store.seal_raw(b"aborted-oid")
    assert store.contains(b"aborted-oid")


_CHAOS_WRITER_SRC = r"""
import sys
import numpy as np

from ray_tpu_torch._private.native_store import NativeStore

name, seed, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
rng = np.random.default_rng(seed)
s = NativeStore(name, capacity=1)
i = 0
out = open(out_path, "w", buffering=1)
while True:
    key = f"chaos-{seed}-{i % 40}".encode()
    size = int(rng.integers(1 << 10, 1 << 16))
    payload = np.full(size, seed % 251, dtype=np.uint8)
    try:
        s.put_object(key, payload)
    except Exception:
        pass  # store full under churn: fine
    found, value = s.get_object(key)
    if found:
        arr = np.asarray(value)
        if arr.size and int(arr[0]) != seed % 251:
            out.write(f"corrupt {int(arr[0])}\n")
            sys.exit(2)
        del value, arr
    if i % 7 == 0:
        try:
            s.delete(key)
        except Exception:
            pass
    i += 1
    if i % 50 == 0:
        out.write(f"alive {i}\n")
"""


def test_kill9_under_load_rebuild(store, tmp_path):
    """Plasma's colocated-store crash tests, ported: fresh-interpreter
    writers hammer the segment; one is SIGKILLed mid-operation (possibly
    holding the shared robust mutex) three times over. EOWNERDEAD repair
    must rebuild the arena and the survivors (and a fresh client) must keep
    working without corruption."""
    import signal

    def spawn(seed):
        out = tmp_path / f"w{seed}.log"
        proc = subprocess.Popen(
            [sys.executable, "-c", _CHAOS_WRITER_SRC, store.name.decode(), str(seed),
             str(out)],
            stdout=subprocess.DEVNULL,
            stderr=open(tmp_path / f"w{seed}.err", "w"),
            env=_env(),
        )
        return proc, out

    writers = [spawn(seed) for seed in range(3)]
    kills = 0

    def _alive_text(entry):
        _, out = entry
        return out.read_text() if out.exists() else ""

    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not all(
            "alive" in _alive_text(w) for w in writers
        ):
            time.sleep(0.5)
        assert all("alive" in _alive_text(w) for w in writers), "writers never warmed up"
        while kills < 3:
            victim, _ = writers[kills % 3]
            if victim.poll() is None:
                os.kill(victim.pid, signal.SIGKILL)
                victim.wait(timeout=10)
            kills += 1
            writers[(kills - 1) % 3] = spawn(10 + kills)
            time.sleep(1.0)
        # Survivors make NEW progress after the last kill, zero corruption.
        marks = [len(_alive_text(w)) for w in writers]
        deadline = time.monotonic() + 60
        progressed = 0
        while time.monotonic() < deadline and not progressed:
            time.sleep(1.0)
            progressed = sum(
                1 for w, mark in zip(writers, marks)
                if w[0].poll() is None and len(_alive_text(w)) > mark
            )
        for _, out in writers:
            text = out.read_text() if out.exists() else ""
            assert "corrupt" not in text, text[-200:]
        assert progressed, "no surviving writer reported progress"
        # The segment is not poisoned: a fresh round-trip still works.
        probe = np.arange(4096, dtype=np.int32)
        store.put_object(b"post-chaos", probe)
        found, value = store.get_object(b"post-chaos")
        assert found and int(np.asarray(value).sum()) == int(probe.sum())
        del value
    finally:
        for proc, _ in writers:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.mark.parametrize("lane", ["asan", "tsan"])
def test_sanitizer_lane_smoke(lane, tmp_path):
    """The sanitizer builds of the port's store.cc (native_store.build(lane),
    the reference's src/Makefile asan / tsan targets) load and survive a
    concurrent put/get/delete exercise with the sanitizer runtime
    interposed. The whole file runs under a lane with
    RAY_TPU_TORCH_STORE_LIB and LD_PRELOAD (README)."""
    lib = native_store.build(lane)
    assert lib.parent == native_store.BUILD_DIR
    runtime_lib = subprocess.run(
        ["g++", f"-print-file-name={native_store.SANITIZER_RUNTIMES[lane]}"],
        capture_output=True,
        text=True,
    ).stdout.strip()
    assert "/" in runtime_lib, f"{native_store.SANITIZER_RUNTIMES[lane]} not installed"

    script = r"""
import os, threading
import numpy as np
from ray_tpu_torch._private import native_store

store = native_store.NativeStore(f"/tpt_san_smoke_{os.getpid()}", capacity=64 << 20)
errors = []

def worker(seed):
    try:
        rng = np.random.default_rng(seed)
        for i in range(40):
            oid = bytes([seed]) * 28
            data = rng.integers(0, 255, size=4096, dtype=np.uint8).tobytes()
            store.put_raw(oid, native_store.envelope_from_pickle(data))
            view = store.get_raw(oid)
            if view is not None:
                store.release(oid)
            store.delete(oid)
    except Exception as e:  # noqa: BLE001
        errors.append(e)

threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
for t in threads: t.start()
for t in threads: t.join()
store.destroy()
assert not errors, errors
assert native_store.load_library()._name == os.environ["RAY_TPU_TORCH_STORE_LIB"]
print("SAN_SMOKE_OK")
"""
    env = dict(
        _env(),
        RAY_TPU_TORCH_STORE_LIB=str(lib),
        LD_PRELOAD=runtime_lib,
        ASAN_OPTIONS="detect_leaks=0",
        TSAN_OPTIONS="report_bugs=1 exitcode=66",
    )
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True,
        text=True,
        timeout=180,
        env=env,
        cwd=str(tmp_path),
    )
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-800:]
    assert "SAN_SMOKE_OK" in proc.stdout


# ------------------------------------------------------- what the port adds


def _reference_store(name: str, capacity: int):
    from ray_tpu._private import native_store as ref

    if not ref.native_store_available():
        pytest.fail("the reference's store library did not build (make -C src)")
    return ref.NativeStore(name, capacity=capacity)


def test_op_sequence_matches_the_reference():
    """The same seeded put / get / pin / release / delete / over-capacity
    put sequence on both bindings, each on its own segment of the same
    capacity: the same outcome for every step, and the same contains,
    num_objects and used_bytes after it."""
    capacity = 4 << 20
    port = NativeStore(f"/tpt_parity_port_{os.getpid()}", capacity=capacity)
    ref = _reference_store(f"/tpt_parity_ref_{os.getpid()}", capacity)
    rng = np.random.RandomState(0)
    keys = [f"k{i}".encode() for i in range(24)]
    held = {id(port): [], id(ref): []}  # keys each binding holds a pin on
    try:
        for step in range(400):
            op = rng.choice(["put", "put", "get", "pin", "release", "delete", "huge"])
            key = keys[rng.randint(len(keys))]
            n = int(rng.randint(1 << 10, 1 << 19))
            pick = rng.randint(1 << 30)
            outcome = []
            for s in (port, ref):
                pins = held[id(s)]
                try:
                    if op == "put":
                        s.put_object(key, np.full(n // 8, step, dtype=np.float64))
                        outcome.append("ok")
                    elif op == "huge":
                        s.put_object(key, np.zeros(capacity // 4, dtype=np.float64))
                        outcome.append("ok")
                    elif op == "get":
                        view = s.get_raw(key)
                        outcome.append(None if view is None else bytes(view[:64]))
                        if view is not None:
                            pins.append(key)
                        del view
                    elif op == "pin":
                        outcome.append(s.pin(key))
                        if outcome[-1]:
                            pins.append(key)
                    elif op == "release":
                        if pins:
                            s.release(pins.pop(pick % len(pins)))
                        outcome.append(len(pins))
                    else:
                        outcome.append(s.delete(key))
                except MemoryError:  # both bindings' NativeStoreFullError
                    outcome.append("full")
            assert outcome[0] == outcome[1], (step, op, outcome)
            for k in keys:
                assert port.contains(k) == ref.contains(k), (step, op, k)
            assert port.num_objects() == ref.num_objects(), (step, op)
            assert port.used_bytes() == ref.used_bytes(), (step, op)
        assert port.capacity() == ref.capacity()
        assert held[id(port)] == held[id(ref)]
    finally:
        port.destroy()
        ref.destroy()


def test_segment_layout_reads_both_ways():
    """A segment written by the port's library is read by the reference's
    binding, and the reverse: one format, byte for byte."""
    value = {"a": np.arange(100_000, dtype=np.float32), "b": b"bytes" * 100, "c": [1, "x"]}
    for writer_cls, reader_cls in (("port", "ref"), ("ref", "port")):
        name = f"/tpt_layout_{writer_cls}_{os.getpid()}"
        make = {"port": lambda n: NativeStore(n, capacity=8 << 20),
                "ref": lambda n: _reference_store(n, 8 << 20)}
        writer = make[writer_cls](name)
        try:
            writer.put_object(b"layout", value)
            writer.put_raw(b"raw", b"raw bytes")
            reader = make[reader_cls](name)  # opens the existing segment
            found, got = reader.get_object(b"layout")
            assert found
            np.testing.assert_array_equal(got["a"], value["a"])
            assert got["b"] == value["b"] and got["c"] == value["c"]
            assert bytes(reader.get_raw(b"raw", track=False)) == b"raw bytes"
            assert reader.num_objects() == writer.num_objects() == 2
            assert reader.used_bytes() == writer.used_bytes()
        finally:
            writer.destroy()


_TENSORS = {
    "f32": lambda: torch.randn(64, 33, generator=torch.Generator().manual_seed(0)),
    "bf16": lambda: torch.randn(17, 8, generator=torch.Generator().manual_seed(1)).bfloat16(),
    "f16": lambda: torch.randn(40, generator=torch.Generator().manual_seed(2)).half(),
    "int64": lambda: torch.arange(-50, 50, dtype=torch.int64),
    "bool": lambda: torch.arange(30) % 3 == 0,
    "non_contiguous": lambda: torch.randn(8, 6, generator=torch.Generator().manual_seed(3)).t(),
    "strided": lambda: torch.randn(8, 12, generator=torch.Generator().manual_seed(4))[:, ::3],
    "offset": lambda: torch.randn(100, generator=torch.Generator().manual_seed(5))[37:61],
    "0d": lambda: torch.tensor(2.5),
    "empty": lambda: torch.empty(0, 7),
}


@pytest.mark.parametrize("kind", sorted(_TENSORS))
def test_tensor_round_trip(store, kind):
    """Each tensor comes back equal, with its dtype, shape and strides (an
    offset view comes back with a storage of its own), as a copy: writing
    to what a read returned changes neither the stored value nor the next
    read (§D24)."""
    t = _TENSORS[kind]()
    store.put_object(b"t", {"t": t, "tag": kind})
    found, out = store.get_object(b"t")
    got = out["t"]
    assert found and out["tag"] == kind and type(got) is torch.Tensor
    assert got.dtype == t.dtype and got.shape == t.shape and got.stride() == t.stride()
    assert torch.equal(got, t)
    if kind == "offset":
        assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
    if got.numel():
        got.logical_not_() if got.dtype == torch.bool else got.add_(1)
        _, again = store.get_object(b"t")
        assert torch.equal(again["t"], t)
        assert not torch.equal(got, t)


def test_tensor_crosses_out_of_band(store):
    """A 1 MiB tensor's bytes leave the pickle stream (under 4 KiB) as an
    out-of-band buffer, as a numpy array's do; torch alone pickles them in
    band."""
    import io
    import pickle

    import cloudpickle

    t = torch.arange(1 << 18, dtype=torch.float32)  # 1 MiB
    stream, buffers, device = native_store.dumps_out_of_band(t)
    assert len(buffers) >= 1 and len(stream) < 4096 and not device
    assert sum(memoryview(b.raw()).nbytes for b in buffers) == t.numel() * 4
    plain: list = []
    f = io.BytesIO()
    cloudpickle.CloudPickler(f, protocol=5, buffer_callback=plain.append).dump(t)
    assert not plain and len(f.getvalue()) > t.numel() * 4  # torch's own: in band
    store.put_object(b"oob", t)
    assert store.used_bytes() < t.numel() * 4 + 8192
    assert torch.equal(store.get_object(b"oob")[1], t)
    assert pickle.loads(pickle.dumps(t)).equal(t)  # other picklers unchanged


def test_parameter_and_requires_grad_round_trip(store):
    p = torch.nn.Parameter(torch.randn(4, 3))
    leaf = torch.ones(5, requires_grad=True)
    store.put_object(b"p", (p, leaf))
    got_p, got_leaf = store.get_object(b"p")[1]
    assert isinstance(got_p, torch.nn.Parameter) and got_p.requires_grad
    assert got_leaf.requires_grad and got_leaf.is_leaf
    assert torch.equal(got_p.detach(), p.detach())


def test_numpy_reads_are_read_only_views(store):
    """Numpy arrays stay zero-copy views of the segment, read-only: a
    reader's write cannot change what other readers get (§D24)."""
    store.put_object(b"np", np.arange(1000, dtype=np.int32))
    found, arr = store.get_object(b"np")
    assert found and not arr.flags["OWNDATA"] and not arr.flags["WRITEABLE"]
    with pytest.raises(ValueError):
        arr[0] = 7


def test_capacity_is_capped_at_dev_shm_free_bytes():
    """A segment asked for more than /dev/shm holds is created at what it
    holds (less the index), not sparsely past it, where the first write
    beyond the tmpfs's limit would be a SIGBUS (§D25)."""
    free = native_store.shm_free_bytes()
    assert free is not None
    s = NativeStore(f"/tpt_cap_{os.getpid()}", capacity=4 * free)
    try:
        assert s.requested_capacity == 4 * free
        assert s.capacity() <= free
        assert s.capacity() >= free // 2  # capped, not refused
        s.put_object(b"after-cap", np.arange(1024))
        assert s.contains(b"after-cap")
    finally:
        s.destroy()


def test_library_builds_inside_the_package(monkeypatch, tmp_path):
    """The store's library comes from this package's csrc/store.cc into its
    git-ignored _build/, never from the reference's src/build/; a build that
    fails raises with the compiler's message."""
    lib = native_store.load_library()
    pkg = os.path.join(REPO, "ray_tpu_torch")
    if not os.environ.get(native_store.LIB_ENV):
        assert os.path.commonpath([lib._name, pkg]) == pkg
    assert native_store.SOURCE == native_store.BUILD_DIR.parent / "csrc" / "store.cc"
    bad = tmp_path / "store.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_store, "SOURCE", bad)
    monkeypatch.setattr(native_store, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(native_store.NativeStoreBuildError, match="exit"):
        native_store.build()


def test_init_raises_when_the_store_cannot_build(monkeypatch, tmp_path):
    """No fallback hides the store: with native_store_enabled, init() raises
    the build's error instead of running without shared memory."""
    import ray_tpu_torch

    bad = tmp_path / "store.cc"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(native_store, "_lib", None)
    monkeypatch.setattr(native_store, "SOURCE", bad)
    monkeypatch.setattr(native_store, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.delenv(native_store.LIB_ENV, raising=False)
    with pytest.raises(native_store.NativeStoreBuildError, match="building the native store"):
        ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    assert not ray_tpu_torch.is_initialized()
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0,
                            _system_config={"native_store_enabled": False})
    try:
        assert rt._native_store is None
    finally:
        ray_tpu_torch.shutdown()


def test_cuda_tensor_read_without_a_card_fails_clearly():
    """A CUDA tensor's bytes are rebuilt on the device index they left; a
    process that sees no card raises CUDAUnavailableError (as frames do,
    §D22) instead of handing back a host tensor."""
    from ray_tpu_torch._private.wire import CUDAUnavailableError

    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    with pytest.raises(CUDAUnavailableError, match="worker_device"):
        native_store._rebuild_tensor(memoryview(bytes(8)), "float32", (2,), (1,),
                                     "cuda:0", False, False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device-to-host copy into shm runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensor_round_trip_on_the_card(store, cuda):
    """A CUDA tensor goes device to host once into its shm allocation and
    comes back on the device index it left, bit for bit, bf16 and f32."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    value = {"f32": torch.randn(1024, 257, device=cuda, generator=gen),
             "bf16": torch.randn(300, 64, device=cuda, generator=gen).bfloat16(),
             "t": torch.randn(64, 32, device=cuda, generator=gen).t()}
    store.put_object(b"cuda", value)
    found, got = store.get_object(b"cuda")
    assert found
    for k, v in value.items():
        assert got[k].device == v.device and got[k].stride() == v.stride()
        assert torch.equal(got[k], v), k
