"""The port's control-plane scale envelope: O(#nodes) traffic, batched
lookups, 1M queue.

Every case of tests/test_control_plane_scale.py, on ray_tpu_torch (its
1M-queue case keeps the reference's `slow` mark). The structural
properties it asserts, with explicit budgets, as the reference does:
  1. Per-node control traffic is CONSTANT (health probes), independent of how
     many tasks/objects the cluster is processing — asserted by registering
     100 protocol-faithful fake node daemons and counting every frame each
     one receives while the head runs a task storm.
  2. Object-location lookups ride a batched subscription channel (`loc_sub` /
     `loc_pub` frames on the node connection), so a worker getting N remote
     refs costs O(1) location frames, not N synchronous head RPCs — asserted
     against NodeHandle.frame_counts on a real daemon.
  3. A single head survives 1,000,000 QUEUED tasks (the reference's
     many_pending_tasks benchmark) with the queue parked per shape-class in
     O(#shapes) probe cost, the head still responsive mid-pile.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import wire
from ray_tpu_torch._private.head_server import send_preamble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait_for(predicate, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {msg}")


class FakeNodeDaemon:
    """Protocol-faithful node daemon stub: registers over TCP (role 'N'),
    answers health pings, and COUNTS every frame the head sends it. No
    workers, no store — pure control-plane endpoint, light enough to run
    100 per host (the reference's fake_multi_node strategy)."""

    def __init__(self, address: str, index: int):
        host_port, _, query = address.partition("?")
        token = query[len("token="):] if query.startswith("token=") else ""
        host, _, port = host_port.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)), 30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_preamble(sock, token, role=b"N")
        self.conn = wire.Connection(sock)
        self.frame_counts: dict[str, int] = {}
        self.registered = threading.Event()
        self.conn.send(
            "register_node",
            {
                "resources": {"CPU": 0.001, f"fake{index}": 1.0},
                "labels": {"fake": "1"},
                "hostname": f"fake-{index}",
                "pid": 0,
                "object_addr": None,
                "store_name": None,
            },
        )
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except Exception:
                return
            if msg is None:
                return
            kind, body = msg
            self.frame_counts[kind] = self.frame_counts.get(kind, 0) + 1
            if kind == "node_welcome":
                self.registered.set()
            elif kind == "ping":
                try:
                    self.conn.send("pong", {"id": body.get("id")})
                except Exception:
                    return

    def close(self) -> None:
        self.conn.close()


def test_hundred_nodes_constant_per_node_traffic():
    """100 registered nodes: per-node control traffic is health probes only —
    a task/object storm on the head adds ZERO frames to idle nodes."""
    runtime = ray_tpu_torch.init(
        num_cpus=4,
        num_gpus=0,
        _system_config={"health_check_period_s": 0.5},
    )
    fakes: list[FakeNodeDaemon] = []
    try:
        address = runtime.serve_clients(port=0)
        for i in range(100):
            fakes.append(FakeNodeDaemon(address, i))
        for fake in fakes:
            assert fake.registered.wait(timeout=60.0), "registration timed out"
        _wait_for(
            lambda: len(runtime.controller.alive_nodes()) == 101,
            msg="100 fake nodes alive",
        )

        # Task + object storm on the head while the fleet sits registered.
        @ray_tpu_torch.remote(num_cpus=1)
        def work(x):
            return x * 2

        t0 = time.monotonic()
        results = ray_tpu_torch.get([work.remote(i) for i in range(200)])
        storm_s = time.monotonic() - t0
        assert results == [i * 2 for i in range(200)]

        time.sleep(1.5)  # a few more health periods
        elapsed = time.monotonic() - t0 + 5.0  # registration headroom
        max_pings = int(elapsed / 0.5) + 10
        for fake in fakes:
            counts = dict(fake.frame_counts)
            welcome = counts.pop("node_welcome", 0)
            pings = counts.pop("ping", 0)
            assert welcome == 1
            # Health traffic is bounded by the probe period — and NOTHING
            # else reaches an idle node: no per-task, per-object, or
            # per-client frames leak across the fleet.
            assert pings <= max_pings, f"ping flood: {pings} > {max_pings}"
            assert counts == {}, f"unexpected per-node traffic: {counts}"
        # The head stayed responsive with 100 nodes attached.
        assert storm_s < 30.0, f"200-task storm took {storm_s:.1f}s"
        # Scheduler state scales by node count, not traffic: alive_nodes is
        # consulted per pick; a 200-task storm at 101 nodes finishing in
        # seconds demonstrates per-pick cost stayed tractable.
    finally:
        for fake in fakes:
            fake.close()
        ray_tpu_torch.shutdown()


@pytest.fixture
def one_daemon_cluster():
    """Head + one REAL node daemon subprocess (the batched-lookup target)."""
    runtime = ray_tpu_torch.init(
        num_cpus=2, num_gpus=0,
        _system_config={"isolation": "process", "worker_device": "cpu"},
    )
    address = runtime.serve_clients(port=0)
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.node_daemon",
            "--address",
            address,
            "--num-cpus",
            "4",
            "--resources",
            '{"remote_node": 1}',
            "--object-store-memory",
            str(256 << 20),
        ],
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p)),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        _wait_for(
            lambda: len(runtime.controller.alive_nodes()) == 2,
            msg="daemon to register",
        )
        yield runtime, proc
    finally:
        # shutdown() tells the daemon to go; it removes its store.
        ray_tpu_torch.shutdown()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
            try:  # a SIGKILLed daemon leaves its pid-named segment
                os.remove(f"/dev/shm/ray_tpu_torch_node_{proc.pid}")
            except FileNotFoundError:
                pass


def test_location_lookups_batch_o_one_not_o_objects(one_daemon_cluster):
    """A remote worker getting 120 head-resident objects costs O(1) loc_sub
    frames (batched subscription + prefetch), not 120 per-object head RPCs —
    the pubsub/README.md per-subscriber batching property, asserted as a
    hard frame budget."""
    runtime, proc = one_daemon_cluster
    refs = [ray_tpu_torch.put(("payload", i, b"x" * 256)) for i in range(120)]

    # Pass refs as a single list ARG value so the worker gets them itself
    # (top-level args would be resolved driver-side before dispatch).
    @ray_tpu_torch.remote(resources={"remote_node": 0.1})
    def consume_refs(ref_list):
        return sum(v[1] for v in ray_tpu_torch.get(ref_list))

    total = ray_tpu_torch.get(consume_refs.remote(refs))
    assert total == sum(range(120))

    (handle,) = runtime._node_handles.values()
    loc_subs = handle.frame_counts.get("loc_sub", 0)
    loc_rpcs = handle.frame_counts.get("rpc", 0)
    assert loc_subs >= 1, "batched location channel unused"
    # Budget: the 120-ref get must coalesce — a handful of frames for the
    # prefetch wave plus stragglers, nowhere near one per object.
    assert loc_subs <= 10, f"location lookups not batched: {loc_subs} frames"
    assert loc_rpcs <= 2, f"per-object locate RPCs leaked: {loc_rpcs}"


def test_ref_traffic_batches_per_connection(one_daemon_cluster):
    """Borrow-edge traffic from a worker ships as merged `refs` delta frames
    (flushed pre-done), not one incref + one decref frame per object."""
    runtime, proc = one_daemon_cluster
    refs = [ray_tpu_torch.put(i) for i in range(60)]

    @ray_tpu_torch.remote(resources={"remote_node": 0.1})
    def touch(ref_list):
        values = ray_tpu_torch.get(ref_list)  # 60 borrows appear and drop here
        return sum(values)

    assert ray_tpu_torch.get(touch.remote(refs)) == sum(range(60))
    (handle,) = runtime._node_handles.values()
    # All worker frames ride the mux ("wf"); the daemon connection itself
    # must carry no per-object incref/decref frames.
    assert handle.frame_counts.get("incref", 0) == 0
    assert handle.frame_counts.get("decref", 0) == 0


@pytest.mark.slow
def test_million_queued_tasks_single_node():
    """1,000,000 queued tasks on one node (reference many_pending_tasks
    envelope): submission completes, the queue parks in O(#shapes), and the
    head stays responsive while the pile waits."""
    runtime = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    # In-process (local isolation) task: the closure shares this Event, so
    # the finally block can release the holder — a plain sleep would pin a
    # non-daemon executor thread and stall interpreter exit for its full
    # duration (threads cannot be killed; the reference's equivalent lever
    # is killing the worker process).
    release = threading.Event()
    try:
        @ray_tpu_torch.remote(num_cpus=1)
        def hold():
            # Holds the node's only CPU for the duration of the test.
            release.wait(600)

        @ray_tpu_torch.remote(num_cpus=1)
        def queued():
            return 1

        hold.remote()
        time.sleep(0.5)

        N = 1_000_000
        t0 = time.monotonic()
        refs = [queued.remote() for _ in range(N)]
        submit_s = time.monotonic() - t0
        rate = N / submit_s
        sched = runtime.scheduler

        def parked_count() -> int:
            with sched._cond:
                return (
                    sum(len(dq) for dq in sched._blocked.values())
                    + len(sched._queue)
                    + len(sched._in_pass)
                )

        # Queue must be fully parked under one shape-class: probe cost per
        # scheduler pass is O(#shapes), not O(1M).
        _wait_for(lambda: parked_count() >= N, timeout=180.0, msg="1M parked")
        with sched._cond:
            n_shapes = len(sched._blocked)
        assert n_shapes <= 4, (
            "1M same-shape tasks must park under a handful of shape classes"
        )
        # Head responsiveness mid-pile: a zero-CPU task schedules and runs
        # around the parked million.
        @ray_tpu_torch.remote(num_cpus=0)
        def probe():
            return "alive"

        t1 = time.monotonic()
        assert ray_tpu_torch.get(probe.remote(), timeout=30) == "alive"
        probe_s = time.monotonic() - t1
        assert probe_s < 10.0, f"head unresponsive under 1M queue: {probe_s:.1f}s"
        print(
            f"submitted {N} tasks in {submit_s:.1f}s ({rate:.0f}/s), "
            f"probe latency {probe_s * 1000:.0f}ms"
        )
        assert rate > 2000, f"submission rate collapsed: {rate:.0f}/s"
    finally:
        release.set()
        ray_tpu_torch.shutdown()


def test_timed_get_of_unsealed_object_falls_back_promptly(one_daemon_cluster):
    """A worker's timed get of a not-yet-sealed object must honor ~timeout:
    the head publishes an explicit loc_pub miss at the request's deadline
    instead of letting the daemon burn its padded wait ceiling."""
    runtime, proc = one_daemon_cluster

    @ray_tpu_torch.remote(num_cpus=2)  # head has 2 CPUs: never schedules alongside
    def never_finishes():
        time.sleep(120)

    slow_ref = never_finishes.remote()

    @ray_tpu_torch.remote(resources={"remote_node": 0.1})
    def timed_get(ref_list):
        from ray_tpu_torch.exceptions import GetTimeoutError

        t0 = time.monotonic()
        try:
            ray_tpu_torch.get(ref_list, timeout=2)
            return ("no-timeout", time.monotonic() - t0)
        except GetTimeoutError:
            return ("timeout", time.monotonic() - t0)

    kind, elapsed = ray_tpu_torch.get(timed_get.remote([slow_ref]), timeout=60)
    assert kind == "timeout"
    assert elapsed < 15.0, (
        f"timed get took {elapsed:.1f}s — head-side miss publication "
        "at the deadline is not working"
    )
    ray_tpu_torch.cancel(slow_ref)
