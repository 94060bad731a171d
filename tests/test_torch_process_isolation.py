"""The port's process-isolated workers (`isolation="process"`).

Every case of tests/test_process_isolation.py, on ray_tpu_torch: crashing
workers don't kill the driver, fate-sharing, retries on worker death and
serialization across the boundary. Then what the port adds or changes: an
8 MB array crosses through the native store, a value too large for a frame
is refused naming ROADMAP.md §B10, and under a lowered frame limit a value
crosses with the store on and fails with it off; a worker's CUDA devices
(`worker_device`, §D22); the port's own environment variables; a worker
imports no JAX, no `ray_tpu` and, until a task needs it, no torch; a CUDA
tensor that reaches a worker which sees no card fails with a clear error;
the per-actor override on a threaded runtime; shutdown reaps every worker,
a killed one still exiting included;
and a GPT served from a process actor is token-identical to `ray_tpu.llm`.

One process runtime serves the module, so few workers are spawned; the
cases that need a runtime of their own run it in a child interpreter.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import wire
from ray_tpu_torch._private.config import Config
from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60.0  # every get/wait in this file has its own timeout


@pytest.fixture(scope="module")
def proc_runtime():
    runtime = ray_tpu_torch.init(
        num_cpus=8, num_gpus=0, _system_config={"isolation": "process"}
    )
    yield runtime
    ray_tpu_torch.shutdown()


def _pid_alive(pid: int) -> bool:
    """True while the process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def _run_child(code: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
        text=True, timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


# ------------------------------------------- tests/test_process_isolation.py


def test_task_runs_in_separate_process(proc_runtime):
    @ray_tpu_torch.remote
    def worker_pid():
        return os.getpid()

    pid = ray_tpu_torch.get(worker_pid.remote(), timeout=T)
    assert pid != os.getpid()


def test_actor_crash_does_not_kill_driver(proc_runtime):
    @ray_tpu_torch.remote
    class Bomb:
        def boom(self):
            os._exit(1)

        def ping(self):
            return "pong"

    bomb = Bomb.remote()
    assert ray_tpu_torch.get(bomb.ping.remote(), timeout=T) == "pong"
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(bomb.boom.remote(), timeout=T)

    @ray_tpu_torch.remote
    def alive():
        return 1

    assert ray_tpu_torch.get(alive.remote(), timeout=T) == 1


def test_task_crash_is_retried_then_surfaces(proc_runtime, tmp_path):
    marker = tmp_path / "attempt"

    @ray_tpu_torch.remote(max_retries=2)
    def crash_once(path):
        if not os.path.exists(path):
            open(path, "w").write("x")
            os._exit(1)
        return "recovered"

    assert ray_tpu_torch.get(crash_once.remote(str(marker)), timeout=T) == "recovered"

    @ray_tpu_torch.remote(max_retries=1)
    def always_crashes():
        os._exit(1)

    with pytest.raises(WorkerCrashedError):
        ray_tpu_torch.get(always_crashes.remote(), timeout=T)


def test_actor_restart_resets_state(proc_runtime):
    @ray_tpu_torch.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

        def die(self):
            os._exit(1)

    ph = Phoenix.remote()
    assert ray_tpu_torch.get(ph.bump.remote(), timeout=T) == 1
    assert ray_tpu_torch.get(ph.bump.remote(), timeout=T) == 2
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(ph.die.remote(), timeout=T)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            assert ray_tpu_torch.get(ph.bump.remote(), timeout=T) == 1  # fresh
            break
        except ActorDiedError:
            time.sleep(0.1)
    else:
        pytest.fail("actor never restarted")


def test_mutation_cannot_cross_the_boundary(proc_runtime):
    ref = ray_tpu_torch.put({"xs": [1, 2, 3]})

    @ray_tpu_torch.remote
    def mutate(d):
        d["xs"].append(99)
        return len(d["xs"])

    assert ray_tpu_torch.get(mutate.remote(ref), timeout=T) == 4
    assert ray_tpu_torch.get(ref, timeout=T) == {"xs": [1, 2, 3]}
    local = ray_tpu_torch.get(ref, timeout=T)
    local["xs"].clear()
    assert ray_tpu_torch.get(ref, timeout=T) == {"xs": [1, 2, 3]}


def test_nested_submission_from_worker(proc_runtime):
    @ray_tpu_torch.remote
    def inner(x):
        return x * 2

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x), timeout=60) + 1

    assert ray_tpu_torch.get(outer.remote(10), timeout=T) == 21


def test_worker_put_get_and_wait(proc_runtime):
    @ray_tpu_torch.remote
    def round_trip():
        ref = ray_tpu_torch.put(np.arange(10))
        ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=5)
        assert ready
        return int(ray_tpu_torch.get(ref, timeout=60).sum())

    assert ray_tpu_torch.get(round_trip.remote(), timeout=T) == 45


def test_streaming_generator_across_process(proc_runtime):
    @ray_tpu_torch.remote
    def gen(n):
        for i in range(n):
            yield i * i

    items = [
        ray_tpu_torch.get(r, timeout=T)
        for r in gen.options(num_returns="streaming").remote(5)
    ]
    assert items == [0, 1, 4, 9, 16]


def test_large_object_crosses_the_socket(proc_runtime):
    """An 8 MB array crosses both ways intact. It is over the native
    store's threshold, so it goes through shared memory, as the reference
    sends its ~4 MB one; the flag that turns the store on is accepted (the
    socket path is held by the cases with the store off below)."""

    @ray_tpu_torch.remote
    def produce():
        return np.arange(1_000_000, dtype=np.float64)  # 8 MB

    @ray_tpu_torch.remote
    def consume(arr):
        return float(arr.sum()), arr.dtype.str, arr.shape

    ref = produce.remote()
    want = float(np.arange(1_000_000, dtype=np.float64).sum())
    assert ray_tpu_torch.get(consume.remote(ref), timeout=T) == (want, "<f8", (1_000_000,))
    np.testing.assert_array_equal(
        ray_tpu_torch.get(ref, timeout=T), np.arange(1_000_000, dtype=np.float64))
    assert proc_runtime.store.is_native(ref.id)
    assert Config().apply_overrides({"native_store_enabled": True}).native_store_enabled


def test_named_actor_lookup_from_task(proc_runtime):
    @ray_tpu_torch.remote
    class Registry:
        def who(self):
            return "registry"

    Registry.options(name="proc_registry").remote()

    @ray_tpu_torch.remote
    def lookup():
        handle = ray_tpu_torch.get_actor("proc_registry")
        return ray_tpu_torch.get(handle.who.remote(), timeout=60)

    assert ray_tpu_torch.get(lookup.remote(), timeout=T) == "registry"


def test_async_actor_in_process(proc_runtime):
    @ray_tpu_torch.remote
    class AsyncWorker:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.01)
            return x + 1

    actor = AsyncWorker.remote()
    assert ray_tpu_torch.get([actor.work.remote(i) for i in range(4)], timeout=T) == [
        1, 2, 3, 4]


def test_threaded_actor_concurrency(proc_runtime):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Threaded:
        def ready(self):
            return True

        def slow(self):
            time.sleep(0.3)
            return 1

    actor = Threaded.remote()
    ray_tpu_torch.get(actor.ready.remote(), timeout=T)  # process spawned
    start = time.monotonic()
    ray_tpu_torch.get([actor.slow.remote() for _ in range(4)], timeout=T)
    assert time.monotonic() - start < 1.0  # 4 x 0.3s sequential would be 1.2s


def test_exceptions_carry_cause_type(proc_runtime):
    @ray_tpu_torch.remote
    def raises():
        raise ValueError("bad value")

    with pytest.raises(ValueError, match="bad value"):
        ray_tpu_torch.get(raises.remote(), timeout=T)


def test_unpicklable_argument_fails_cleanly(proc_runtime):
    import threading

    @ray_tpu_torch.remote
    def takes(x):
        return x

    with pytest.raises(Exception):
        ray_tpu_torch.get(takes.remote(threading.Lock()), timeout=T)

    # The scheduler survives the serialization failure.
    assert ray_tpu_torch.get(takes.remote(5), timeout=T) == 5


# ------------------------------------------------------- what the port adds


def test_value_over_a_frame_is_refused_naming_b10(proc_runtime, monkeypatch):
    """A frame's length is a u32: a value of 4 GiB or more cannot cross
    without the native store. Faked without allocating it: a body that
    claims 4 GiB, and an argument over a lowered limit, which fails its task
    (the user's error, not a crash) and leaves the worker pool healthy."""

    class Huge:
        def __len__(self):
            return 1 << 32

    with pytest.raises(wire.FrameTooLargeError, match="§B10"):
        wire.encode_frame_from_bytes("done", Huge())
    assert issubclass(wire.FrameTooLargeError, ValueError)

    @ray_tpu_torch.remote(max_retries=0)
    def size(x):
        return len(x)

    monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 1 << 20)
    with pytest.raises(wire.FrameTooLargeError, match="native shared-memory store"):
        ray_tpu_torch.get(size.remote(b"x" * (2 << 20)), timeout=T)
    monkeypatch.undo()
    assert ray_tpu_torch.get(size.remote(b"x" * (2 << 20)), timeout=T) == 2 << 20


def test_large_return_is_sealed_native_and_read_by_another_worker(proc_runtime):
    """A worker's return of at least the threshold (a 2 MB tensor) is
    written into shm and adopted by the driver as is (`is_native`), and an
    actor in another process reads it from the segment: its own copy, equal
    to the producer's (§D24)."""
    import torch

    @ray_tpu_torch.remote
    def produce():
        return os.getpid(), torch.arange(1 << 19, dtype=torch.float32)

    @ray_tpu_torch.remote
    def tensor():
        return torch.arange(1 << 19, dtype=torch.float32)

    @ray_tpu_torch.remote
    class Reader:
        def read(self, t):
            t.add_(1)  # a private copy: the stored value stays as it was
            return os.getpid(), float(t.sum()), t.dtype

    ref = tensor.remote()
    got = ray_tpu_torch.get(ref, timeout=T)
    assert proc_runtime.store.is_native(ref.id)
    assert torch.equal(got, torch.arange(1 << 19, dtype=torch.float32))
    producer_pid = ray_tpu_torch.get(produce.remote(), timeout=T)[0]
    reader = Reader.remote()
    pid, total, dtype = ray_tpu_torch.get(reader.read.remote(ref), timeout=T)
    ray_tpu_torch.kill(reader)
    assert pid not in (os.getpid(), producer_pid)
    n = 1 << 19
    assert (total, dtype) == (float(n * (n - 1) // 2 + n), torch.float32)
    assert torch.equal(ray_tpu_torch.get(ref, timeout=T),
                       torch.arange(1 << 19, dtype=torch.float32))


def test_driver_put_reaches_the_worker_through_shm(proc_runtime):
    """A driver put of at least the threshold lands in shm, and the worker
    maps it: its argument is a read-only view of the segment, not an array
    of its own unpickled from a frame."""

    @ray_tpu_torch.remote
    def inspect_arg(arr):
        return (float(arr.sum()), bool(arr.flags["OWNDATA"]),
                bool(arr.flags["WRITEABLE"]))

    arr = np.arange(1 << 18, dtype=np.float64)  # 2 MB
    ref = ray_tpu_torch.put(arr)
    assert proc_runtime.store.is_native(ref.id)
    assert ray_tpu_torch.get(inspect_arg.remote(ref), timeout=T) == (
        float(arr.sum()), False, False)
    # Below the threshold a put stays in the driver's table and crosses by
    # the socket, as a writable array of the worker's own.
    small = ray_tpu_torch.put(np.arange(16, dtype=np.float64))
    assert not proc_runtime.store.is_native(small.id)
    total, _, writeable = ray_tpu_torch.get(inspect_arg.remote(small), timeout=T)
    assert (total, writeable) == (120.0, True)


def test_value_over_a_lowered_frame_crosses_only_with_the_store(proc_runtime, monkeypatch):
    """Under the lowered frame limit of the case above, a 2 MB ObjectRef
    argument crosses with the native store on (the worker reads it from the
    segment), and with the store off fails with FrameTooLargeError (its
    bytes would have to ride one frame)."""

    @ray_tpu_torch.remote(max_retries=0)
    def size(x):
        return x.nbytes

    monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 1 << 20)
    ref = ray_tpu_torch.put(np.ones(2 << 20, dtype=np.uint8))
    assert ray_tpu_torch.get(size.remote(ref), timeout=T) == 2 << 20
    monkeypatch.undo()
    out = _run_child("""
        import numpy as np
        import ray_tpu_torch
        from ray_tpu_torch._private import wire
        wire.MAX_FRAME_BYTES = 1 << 20
        rt = ray_tpu_torch.init(num_cpus=2, num_gpus=0, _system_config={
            "isolation": "process", "native_store_enabled": False})
        assert rt._native_store is None

        @ray_tpu_torch.remote(max_retries=0)
        def size(x):
            return x.nbytes

        ref = ray_tpu_torch.put(np.ones(2 << 20, dtype=np.uint8))
        try:
            print("crossed", ray_tpu_torch.get(size.remote(ref), timeout=60))
        except wire.FrameTooLargeError as exc:
            print("FrameTooLargeError", "native_store_enabled=False" in str(exc))
        print("small", ray_tpu_torch.get(size.remote(ray_tpu_torch.put(np.ones(8))),
                                         timeout=60))
        ray_tpu_torch.shutdown()
    """)
    assert out.split() == ["FrameTooLargeError", "True", "small", "64"], out


def test_a_large_frame_crosses_whole():
    """A frame of tens of MB arrives whole and in order behind a small one,
    read into one buffer whatever sizes the socket hands out (the GPT-2
    125M parameters a DAG step returns are one ~500 MB frame)."""
    import socket
    import threading

    a, b = socket.socketpair()
    send, recv = wire.Connection(a), wire.Connection(b)
    big = np.random.RandomState(0).bytes(48 << 20)
    sender = threading.Thread(target=lambda: (send.send("small", {"n": 1}),
                                              send.send("done", {"value_pickled": big})))
    sender.start()
    assert recv.recv() == ("small", {"n": 1})
    kind, body = recv.recv()
    sender.join(timeout=T)
    assert not sender.is_alive()
    assert kind == "done" and body["value_pickled"] == big
    send.close()
    assert recv.recv() is None
    recv.close()


def test_worker_output_reaches_the_log_plane(proc_runtime, capsys):
    """A worker's stdout lines land in Runtime.logs with its pid, and
    log_to_driver (on by default) reprints them on the driver with a
    `(worker pid=...)` prefix."""

    @ray_tpu_torch.remote
    def speak():
        print("hello from a worker process", flush=True)
        return os.getpid()

    pid = ray_tpu_torch.get(speak.remote(), timeout=T)

    def rows():
        return [r for r in proc_runtime.logs.tail(pid=pid)
                if r["line"] == "hello from a worker process"]

    deadline = time.monotonic() + 10
    while not rows() and time.monotonic() < deadline:
        time.sleep(0.05)
    (row,) = rows()
    assert row["stream"] == "stdout" and row["pid"] == pid
    assert f"pid={pid}" in capsys.readouterr().out


def test_worker_devices_follow_worker_device(proc_runtime, monkeypatch):
    """§D22: worker_device="" (the default) leaves a worker the driver's
    CUDA devices; "cpu" hides them with CUDA_VISIBLE_DEVICES="". Read from
    os.environ inside a fresh actor process of each setting."""

    @ray_tpu_torch.remote
    class Env:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert Config().worker_device == ""
    want = os.environ.get("CUDA_VISIBLE_DEVICES")
    inherit = Env.remote()
    assert ray_tpu_torch.get(inherit.visible.remote(), timeout=T) == want
    monkeypatch.setattr(proc_runtime.config, "worker_device", "cpu")
    hidden = Env.remote()
    assert ray_tpu_torch.get(hidden.visible.remote(), timeout=T) == ""
    for actor in (inherit, hidden):
        ray_tpu_torch.kill(actor)
    with pytest.raises(ValueError, match="worker_device"):
        ray_tpu_torch._private.runtime.Runtime(
            system_config={"worker_device": "cuda:1"})


def test_environment_variables_are_the_ports(proc_runtime, monkeypatch):
    """The worker's fd and is-worker flag and the isolation override use
    RAY_TPU_TORCH_* names, so a reference worker and a port worker in one
    test process never read each other's variables."""

    @ray_tpu_torch.remote
    def names():
        return {k: os.environ.get(k) for k in (
            "RAY_TPU_TORCH_IS_WORKER", "RAY_TPU_TORCH_WORKER_FD",
            "RAY_TPU_IS_WORKER", "RAY_TPU_WORKER_FD")}

    got = ray_tpu_torch.get(names.remote(), timeout=T)
    assert got["RAY_TPU_TORCH_IS_WORKER"] == "1"
    assert got["RAY_TPU_TORCH_WORKER_FD"].isdigit()
    assert got["RAY_TPU_IS_WORKER"] is None and got["RAY_TPU_WORKER_FD"] is None
    monkeypatch.setenv("RAY_TPU_ISOLATION", "process")
    assert Config().isolation == "thread"
    monkeypatch.setenv("RAY_TPU_TORCH_ISOLATION", "process")
    assert Config().isolation == "process"


def test_worker_imports_no_jax_no_reference_and_no_torch_at_start(proc_runtime):
    """A fresh worker has imported neither JAX nor the reference package,
    and not torch either: a task pays for torch only when it uses it."""

    @ray_tpu_torch.remote
    class Probe:
        def __init__(self):
            self.at_start = sorted(sys.modules)

        def modules(self):
            import torch  # noqa: F401 — the task's own import

            return self.at_start, sorted(sys.modules)

    probe = Probe.remote()
    at_start, later = ray_tpu_torch.get(probe.modules.remote(), timeout=T)
    ray_tpu_torch.kill(probe)

    def of(mods, root):
        return [m for m in mods if m == root or m.startswith(root + ".")]

    for root in ("jax", "jaxlib", "flax", "ray_tpu"):
        assert of(at_start, root) == [] and of(later, root) == [], root
    assert of(at_start, "torch") == [] and "torch" in later
    assert "ray_tpu_torch._private.runtime" in at_start


def test_cuda_tensor_reaching_a_worker_without_cuda_fails_clearly(proc_runtime):
    """A CUDA tensor crosses as torch pickles it: host bytes tagged with the
    device index they left, rebuilt there. A worker that sees no card (here,
    none at all; on a machine with one, worker_device="cpu") cannot, and the
    task fails with CUDAUnavailableError naming the worker's devices. The
    pickle is made on the CPU by tagging a host tensor's storage cuda:0."""
    import cloudpickle
    import torch
    from torch import serialization

    def tag(storage):
        return "cuda:0"

    serialization.register_package(0, tag, lambda obj, location: None)
    try:
        data = cloudpickle.dumps(torch.arange(4.0))
    finally:
        serialization._package_registry[:] = [
            e for e in serialization._package_registry if e[1] is not tag]

    class CudaTensorPickle:
        def __reduce__(self):
            return cloudpickle.loads, (data,)

    @ray_tpu_torch.remote(max_retries=0)
    def touch(t):
        return t

    with pytest.raises(wire.CUDAUnavailableError, match="CUDA_VISIBLE_DEVICES"):
        ray_tpu_torch.get(touch.remote(CudaTensorPickle()), timeout=T)
    with pytest.raises(wire.CUDAUnavailableError, match="worker_device"):
        wire.loads_value(cloudpickle.dumps(CudaTensorPickle()))


def test_per_actor_override_on_a_threaded_runtime():
    """isolation="process" on one actor of a thread runtime runs it in a
    companion process engine: another pid, a crash that kills only it and
    a restart in a fresh process; shutdown reaps the companion's worker."""
    out = _run_child("""
        import os, sys
        import ray_tpu_torch as rt
        from ray_tpu_torch.exceptions import ActorDiedError

        rt.init(num_cpus=2, num_gpus=0)

        @rt.remote(max_restarts=1)
        class A:
            def pid(self):
                return os.getpid()

            def die(self):
                os._exit(1)

        @rt.remote
        def task_pid():
            return os.getpid()

        a = A.options(isolation="process").remote()
        first = rt.get(a.pid.remote(), timeout=60)
        assert first != os.getpid(), first
        assert rt.get(task_pid.remote(), timeout=60) == os.getpid()
        try:
            rt.get(a.die.remote(), timeout=60)
            raise SystemExit("die returned")
        except ActorDiedError:
            pass
        import time
        deadline = time.monotonic() + 30
        while True:
            try:
                second = rt.get(a.pid.remote(), timeout=60)
                break
            except ActorDiedError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert second not in (first, os.getpid()), second
        rt.shutdown()
        print(first, second)
    """)
    first, second = map(int, out.split())
    assert not _pid_alive(first) and not _pid_alive(second)


def test_shutdown_leaves_no_worker_alive():
    """After shutdown() no worker process of the runtime exists: pooled task
    workers, actor processes and a worker that hung are all killed and
    reaped before shutdown returns."""
    out = _run_child("""
        import os
        import ray_tpu_torch as rt

        rt.init(num_cpus=4, num_gpus=0, _system_config={"isolation": "process"})

        @rt.remote
        def pid():
            return os.getpid()

        @rt.remote
        def hang():
            import time
            time.sleep(600)

        @rt.remote
        class A:
            def pid(self):
                return os.getpid()

        pids = set(rt.get([pid.remote() for _ in range(3)], timeout=60))
        actors = [A.remote() for _ in range(2)]
        pids |= set(rt.get([a.pid.remote() for a in actors], timeout=60))
        hung = hang.remote()
        import time
        time.sleep(0.5)
        runtime = rt._private.runtime.get_runtime()
        for engine in runtime.engines.values():
            pids |= {h.proc.pid for h in engine._workers}
        rt.shutdown()
        print(" ".join(map(str, sorted(pids))))
    """)
    pids = [int(p) for p in out.split()]
    assert len(pids) >= 4
    assert [p for p in pids if _pid_alive(p)] == []


def test_shutdown_waits_for_a_killed_actor_still_being_reaped():
    """An actor killed just before shutdown() leaves the engine's pool at
    once, while its reader thread still waits for the process to exit;
    shutdown() waits for that process as well, so none of the runtime's
    processes is still exiting when it returns. The reader's reap is held
    back here to make that window certain."""
    out = _run_child("""
        import os, threading, time
        import ray_tpu_torch as rt
        from ray_tpu_torch._private import process_engine

        reap = process_engine.ProcessWorkerHandle.reap

        def late_reap(self, timeout=10.0):
            if threading.current_thread().name.startswith("pworker-"):
                time.sleep(2.0)
            return reap(self, timeout)

        process_engine.ProcessWorkerHandle.reap = late_reap
        rt.init(num_cpus=2, num_gpus=0, _system_config={"isolation": "process"})

        @rt.remote
        class A:
            def pid(self):
                return os.getpid()

        a = A.remote()
        pid = rt.get(a.pid.remote(), timeout=60)
        engines = list(rt._private.runtime.get_runtime().engines.values())
        (handle,) = [h for e in engines for h in e._workers if h.proc.pid == pid]
        rt.kill(a)
        deadline = time.monotonic() + 30
        while any(handle in e._workers for e in engines):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        rt.shutdown()
        print(pid, handle.proc.returncode)
    """)
    pid, returncode = out.split()
    assert returncode != "None", "shutdown() returned before the process was reaped"
    assert not _pid_alive(int(pid))


def test_gpt_in_a_process_actor_matches_the_reference(proc_runtime):
    """A 2-layer GPT served from a process actor on device="cpu", its
    weights the reference's carried across (models.params_from_flax): greedy
    tokens identical to ray_tpu.llm's for the same prompts. The state dict
    crosses the socket as the actor's argument, the tokens come back."""
    import jax
    import jax.numpy as jnp
    import torch
    from flax.linen import meta

    from ray_tpu.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.llm import LLMEngine as JaxLLMEngine
    from ray_tpu.models.gpt import GPT as JaxGPT
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from ray_tpu_torch.models import GPTConfig, params_from_flax

    tiny = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
    jax_cfg = JaxGPTConfig(**tiny, dtype=jnp.float32, attention_impl="reference")
    port_cfg = GPTConfig(**tiny, dtype=torch.float32, attention_impl="reference")
    ecfg = dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8)
    params = JaxGPT(jax_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    rng = np.random.RandomState(9)
    prompts = [list(map(int, rng.randint(0, 128, size=n))) for n in (7, 19, 30)]
    want = JaxLLMEngine(jax_cfg, JaxEngineConfig(**ecfg), params=tree).generate(
        prompts, max_new_tokens=5)

    @ray_tpu_torch.remote
    class Server:
        def __init__(self, cfg, ecfg, state):
            import torch

            from ray_tpu_torch.llm import EngineConfig, LLMServer

            torch.set_num_threads(1)
            self.server = LLMServer(cfg, EngineConfig(**ecfg), params=state,
                                    device="cpu", warmup=False)

        def generate(self, prompt, n):
            return os.getpid(), self.server.generate(prompt, max_new_tokens=n)["token_ids"]

        def close(self):
            self.server.shutdown()

    server = Server.remote(port_cfg, ecfg, params_from_flax(tree))
    try:
        got = [ray_tpu_torch.get(server.generate.remote(p, 5), timeout=120)
               for p in prompts]
        ray_tpu_torch.get(server.close.remote(), timeout=T)
    finally:
        ray_tpu_torch.kill(server)
    assert all(pid != os.getpid() for pid, _ in got)
    assert [toks for _, toks in got] == want
