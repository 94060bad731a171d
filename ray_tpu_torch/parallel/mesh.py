"""The serving engine's tensor-parallel group (the counterpart of the
reference's ``tensor_parallel_mesh``, ``ray_tpu/parallel/mesh.py:107``).

One process per device. Rank 0 is the caller's own process (the engine's:
it keeps the scheduler, the allocator and the host buffers); ranks
1..tp-1 are processes started here, each a fresh interpreter running
``python -m ray_tpu_torch.llm.tp_worker`` on ``cuda:<base + r>``, or on
the CPU. Never a fork: the parent may hold CUDA, and the starting thread
may be a Serve actor's. Nor multiprocessing's ``spawn``, which re-imports
the caller's ``__main__`` in the child (a script without a main guard
would start its own engine there). The group is ``torch.distributed``'s NCCL backend on the card
and gloo on the CPU, built directly over a ``TCPStore`` on
``tcp://127.0.0.1:<free port>`` rather than through
``init_process_group``: a process may hold several groups at once (two
engines, or a test's tp=1 and tp=2 engines side by side).

Rank 0 talks to each worker over a pipe: a fixed-size int header per step
program (which program, which runner, its shapes) and control messages
(build or drop a runner, report launch counts and memory, stop), pickled
with the standard pickler (multiprocessing's would pass tensors as shared
memory handles, which a process it did not start cannot open).
The program's inputs then go out as ONE broadcast from rank 0's device.
Workers wait on the pipe between steps, never inside a collective, so an
idle engine holds no collective open against the group's timeout.

A dead rank raises ``TensorParallelError`` within ``TP_TIMEOUT_S``, and
within a few milliseconds of its exit: every dispatch first checks that
each worker process is alive, and on the CPU a collective that fails
(gloo reports a closed peer at once) or outlasts the timeout raises. On
the card NCCL's ``wait()`` orders the stream, not the host, so a
collective waiting on a dead rank would only show as rank 0's next copy
to the host blocking for good; rank 0 therefore never waits on its device
directly while a group is up, but through `TensorParallelGroup.fence`,
which polls the device's progress against the workers' liveness and the
timeout, and on either failure aborts the NCCL communicator (which ends
the waiting kernels) before it raises. Rank 0's NCCL watchdog is built
without its error handling (``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``): it
would tear down the engine's whole process on a timeout, where the fence
raises instead. The group is then broken for good: every later call
raises the same error at once.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import weakref
from multiprocessing.connection import Connection
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Bound on one collective (and on a worker's answer to a control message).
TP_TIMEOUT_S = 60.0
# How often the fence looks at the device and the workers.
FENCE_POLL_S = 5e-5
# Bound on a worker's start: spawn, `import torch`, joining the group.
START_TIMEOUT_S = 300.0
HEADER_INTS = 8

# Header words: [program, runner slot, dims...]. 0 stops, -1 announces a
# pickled control message.
STOP = 0
CONTROL = -1


class TensorParallelError(RuntimeError):
    """A rank of a tensor-parallel group died, or a collective failed or
    outlasted the group's timeout. The group cannot be used any more."""

    def __init__(self, message: str, rank: Optional[int] = None):
        super().__init__(message)
        self.rank = rank

    def __reduce__(self):
        return (type(self), (self.args[0], self.rank))


def check_tp_devices(tensor_parallel_size: int, visible: int, platform: str) -> None:
    """The reference's fail-fast check: more ranks than visible devices is
    a configuration error, raised before anything is spawned."""
    if tensor_parallel_size > visible:
        raise ValueError(
            f"tensor_parallel_size {tensor_parallel_size} exceeds the "
            f"{visible} device(s) the backend exposes ({platform}); shrink "
            "tensor_parallel_size or run on a larger slice (CPU: one "
            "process per rank, at most one per core)"
        )


def _visible(device: torch.device) -> tuple:
    """(devices a group on `device` may use, platform name). On the card
    the devices from `device`'s index up; on the CPU one rank per core."""
    if device.type == "cuda":
        base = device.index or 0
        return torch.cuda.device_count() - base, "cuda"
    return os.cpu_count() or 1, "cpu"


def _rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank r's device: `cuda:<base + r>` on the card, the CPU otherwise."""
    if device.type == "cuda":
        return torch.device("cuda", (device.index or 0) + rank)
    return torch.device("cpu")


def _make_backend(store, rank: int, size: int, device: torch.device):
    from torch import distributed as dist

    timeout = datetime.timedelta(seconds=TP_TIMEOUT_S)
    prefixed = dist.PrefixStore("tp", store)
    if device.type != "cuda":
        return dist.ProcessGroupGloo(prefixed, rank, size, timeout)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    if rank > 0:
        return dist.ProcessGroupNCCL(prefixed, rank, size, opts)
    # Rank 0 is the engine's process: its watchdog only logs (module doc).
    key = "TORCH_NCCL_ASYNC_ERROR_HANDLING"
    saved = os.environ.get(key)
    os.environ[key] = "0"
    try:
        return dist.ProcessGroupNCCL(prefixed, rank, size, opts)
    finally:
        if saved is None:
            del os.environ[key]
        else:
            os.environ[key] = saved


class RankGroup:
    """One rank's handle on the group: the collectives the step programs
    call. Counts the collectives it issues by kind (`counts`)."""

    def __init__(self, backend, rank: int, size: int, device):
        self.backend = backend
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.counts: Dict[str, int] = {"all_reduce": 0, "broadcast": 0, "gather": 0}
        self.broken: Optional[TensorParallelError] = None

    def _wait(self, work, what: str) -> None:
        try:
            work.wait()
        except Exception as exc:  # gloo: closed peer or timeout
            self._break(f"{what} failed on rank {self.rank}: {exc}")

    def _break(self, message: str, rank: Optional[int] = None):
        if self.broken is None:
            self.broken = TensorParallelError(message, rank)
            self._abort()
        raise self.broken

    def _abort(self) -> None:
        """On the card, abort NCCL's communicator: kernels still waiting on
        a peer end, and this rank's stream can drain. (gloo's collectives
        have returned or raised already.)"""
        if self.device.type != "cuda" or self.backend is None:
            return
        abort = getattr(self.backend, "abort", None) or self.backend.shutdown
        try:
            abort()
        except Exception:
            pass  # torn down already
        self.backend = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place (t must be contiguous)."""
        self.counts["all_reduce"] += 1
        self._wait(self.backend.allreduce([t]), "all_reduce")
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` into every rank's `t`, in place."""
        self.counts["broadcast"] += 1
        self._wait(self.backend.broadcast(t, 0), "broadcast")
        return t

    def gather(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's `t` (same shape and dtype) to rank 0, in rank order;
        None on the other ranks."""
        from torch import distributed as dist

        self.counts["gather"] += 1
        opts = dist.GatherOptions()
        opts.rootRank = 0
        outs = [torch.empty_like(t) for _ in range(self.size)] if self.rank == 0 else None
        self._wait(self.backend.gather([outs] if outs else [], [t], opts), "gather")
        return outs

    def shutdown(self) -> None:
        """Release the backend (its connections; NCCL's communicator)."""
        _shutdown(self.backend)
        self.backend = None


def _shutdown(backend) -> None:
    if backend is not None:
        try:
            backend.shutdown()
        except Exception:
            pass  # already torn down with a dead peer


class _Workers:
    """Rank 0's side of the spawned ranks: processes, pipes, rank 0's
    backend. Kept apart from TensorParallelGroup (and never pointing back
    at it) so its finalizer can stop them without holding the group
    alive."""

    def __init__(self):
        self.procs: List = []
        self.conns: List = []
        self.backend = None
        self.store = None
        self.closed = False

    def close(self, timeout_s: float = 10.0) -> None:
        if self.closed:
            return
        self.closed = True
        stop = np.zeros(HEADER_INTS, np.int64).tobytes()
        for conn in self.conns:
            try:
                conn.send_bytes(stop)
            except (OSError, ValueError):
                pass  # that rank is gone already
        deadline = time.monotonic() + timeout_s
        for proc in self.procs:
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5.0)
        for conn in self.conns:
            conn.close()
        _shutdown(self.backend)
        self.backend = self.store = None


class TensorParallelGroup(RankGroup):
    """Rank 0's handle: the collectives, plus the spawned ranks. Runners
    register with `add_runner` (each rank then holds that runner's shard)
    and send each step program with `dispatch`. `close()` stops the ranks
    and frees their devices; a group dropped without it is closed by its
    finalizer (also at interpreter exit)."""

    def __init__(self, workers: _Workers, backend, size: int, device):
        super().__init__(backend, 0, size, device)
        workers.backend = backend  # shut down with the workers
        self._workers = workers
        self.lock = threading.RLock()
        self._next_slot = 0
        self._finalizer = weakref.finalize(self, workers.close)

    @property
    def processes(self) -> list:
        """The workers' ``subprocess.Popen`` handles, rank 1 first."""
        return list(self._workers.procs)

    def check_alive(self) -> None:
        """Raise TensorParallelError if the group is broken or a worker
        process has exited."""
        if self.broken is not None:
            raise self.broken
        if self._workers.closed:
            self._break("tensor-parallel group is closed")
        for rank, proc in enumerate(self._workers.procs, start=1):
            if proc.poll() is not None:
                self._exited(rank, proc)

    def _abort(self) -> None:
        super()._abort()
        if self.backend is None:
            self._workers.backend = None  # nothing left to shut down

    def _wait(self, work, what: str) -> None:
        try:
            work.wait()
        except Exception as exc:  # gloo: closed peer or timeout
            # A peer that closed its end has died: name it if it has.
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                self.check_alive()
                time.sleep(0.01)
            self._break(f"{what} failed on rank 0: {exc}")

    def fence(self, event=None) -> None:
        """Wait on the host until rank 0's stream has run all it was given
        so far (or up to `event`): the one way rank 0 waits on its device
        while the group is up. Raises TensorParallelError when a worker
        exits or TP_TIMEOUT_S passes first, the communicator aborted (module
        doc). Nothing to wait for on the CPU, where each collective has
        returned or raised already."""
        if self.device.type != "cuda":
            return
        if event is None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not event.query():
            self.check_alive()
            if time.monotonic() > deadline:
                self._break(
                    f"rank 0's device work did not finish within {TP_TIMEOUT_S}s "
                    "(a collective waiting on a rank that never joined it)"
                )
            time.sleep(FENCE_POLL_S)

    def _exited(self, rank: int, proc) -> None:
        self._break(
            f"tensor-parallel rank {rank} (pid {proc.pid}) exited with code "
            f"{proc.returncode}", rank,
        )

    def dispatch(self, program: int, slot: int, dims: Sequence[int] = ()) -> None:
        """Send one step program's header to every worker (after the
        caller finished everything on the host that can raise)."""
        self.check_alive()
        header = np.zeros(HEADER_INTS, np.int64)
        header[0], header[1] = program, slot
        header[2 : 2 + len(dims)] = dims
        raw = header.tobytes()
        for rank, conn in enumerate(self._workers.conns, start=1):
            try:
                conn.send_bytes(raw)
            except (OSError, ValueError) as exc:
                self._break(f"tensor-parallel rank {rank} unreachable: {exc}", rank)

    def request(self, messages) -> list:
        """Send a control message to every worker and return their answers
        in rank order. `messages` is one message for all, or a callable
        rank -> message. A worker that raised answers with its exception,
        which is raised here."""
        with self.lock:
            self.dispatch(CONTROL, 0)
            for rank, conn in enumerate(self._workers.conns, start=1):
                msg = messages(rank) if callable(messages) else messages
                try:
                    conn.send_bytes(pickle.dumps(msg))
                except (OSError, ValueError) as exc:
                    self._break(f"tensor-parallel rank {rank} unreachable: {exc}", rank)
            answers = []
            for rank, (conn, proc) in enumerate(
                zip(self._workers.conns, self._workers.procs), start=1
            ):
                answers.append(self._answer(rank, conn, proc))
        for ans in answers:
            if isinstance(ans, BaseException):
                raise ans
        return answers

    def _answer(self, rank: int, conn, proc):
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not conn.poll(0.05):
            if proc.poll() is not None:
                self._exited(rank, proc)
            if time.monotonic() > deadline:
                self._break(
                    f"tensor-parallel rank {rank} did not answer within "
                    f"{TP_TIMEOUT_S}s", rank,
                )
        try:
            return pickle.loads(conn.recv_bytes())
        except (EOFError, OSError) as exc:
            self._break(f"tensor-parallel rank {rank} unreachable: {exc}", rank)

    def add_runner(self, spec_for_rank) -> int:
        """Build a runner on every worker; `spec_for_rank(rank)` gives rank
        r's spec (configs, its weight shard or None, seed). Returns the
        slot the runner's programs name in their headers."""
        with self.lock:
            slot = self._next_slot
            self._next_slot += 1
            self.request(lambda r: ("add_runner", slot, spec_for_rank(r)))
        return slot

    def drop_runner(self, slot: int) -> None:
        if self.broken is None and not self._workers.closed:
            self.request(("drop_runner", slot))

    def report(self) -> List[dict]:
        """Each worker's launch counts, allocated device bytes and pid."""
        return self.request(("report",))

    def reset_counters(self) -> None:
        self.request(("reset_counters",))

    def fail(self, message: str) -> None:
        """Break the group for good (the ranks may no longer meet in the
        same collective) and stop its workers."""
        if self.broken is None:
            self.broken = TensorParallelError(message)
            self._abort()
        self.close()

    def close(self) -> None:
        """Stop every worker (they free their devices as they exit) and
        release rank 0's backend. Idempotent."""
        self._finalizer()

    @property
    def closed(self) -> bool:
        return self._workers.closed


def tensor_parallel_group(tensor_parallel_size: int, device) -> TensorParallelGroup:
    """Spawn ranks 1..tp-1 and join them with the caller as rank 0.

    Raises ValueError (the reference's wording) before spawning anything
    when fewer devices are visible than `tensor_parallel_size` asks for.
    On the card the kernels are built here first, so the workers only load
    the built libraries (no two processes compile into one build dir)."""
    device = torch.device(device)
    if tensor_parallel_size < 2:
        raise ValueError("a tensor-parallel group needs tensor_parallel_size >= 2")
    visible, platform = _visible(device)
    check_tp_devices(tensor_parallel_size, visible, platform)
    if device.type == "cuda":
        from ray_tpu_torch.ops import _kernels

        _kernels.build(("paged_attention", "flash_fwd"))
    from torch import distributed as dist

    workers = _Workers()
    try:
        workers.store = dist.TCPStore(
            "127.0.0.1", 0, tensor_parallel_size, True,
            timeout=datetime.timedelta(seconds=START_TIMEOUT_S),
            wait_for_workers=False,
        )
        env = dict(os.environ)
        # The workers import the package this process imported.
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
        )
        for rank in range(1, tensor_parallel_size):
            parent, child = socket.socketpair()
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.llm.tp_worker",
                 str(rank), str(tensor_parallel_size), str(workers.store.port),
                 str(_rank_device(device, rank)), str(child.fileno())],
                pass_fds=[child.fileno()], env=env,
            )
            child.close()
            workers.procs.append(proc)
            workers.conns.append(Connection(parent.detach()))
        # Every rank has started and reached the store before rank 0 joins
        # (a rank that died on the way raises here, not in a hung join).
        deadline = time.monotonic() + START_TIMEOUT_S
        for rank, (conn, proc) in enumerate(zip(workers.conns, workers.procs), start=1):
            while not conn.poll(0.05):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise TensorParallelError(
                        f"tensor-parallel rank {rank} did not start "
                        f"(exit code {proc.returncode})", rank,
                    )
            conn.recv_bytes()  # hello
        backend = _make_backend(workers.store, 0, tensor_parallel_size, device)
        group = TensorParallelGroup(workers, backend, tensor_parallel_size, device)
        # One collective joins everyone (NCCL builds its communicator here).
        group.all_reduce(torch.zeros(1, device=device))
        group.counts["all_reduce"] = 0
        for rank, (conn, proc) in enumerate(zip(workers.conns, workers.procs), start=1):
            group._answer(rank, conn, proc)  # ("ready", pid)
        return group
    except BaseException:
        workers.close(timeout_s=2.0)
        raise
