"""The port's memory monitor and OOM worker-killing policy (every case of
tests/test_memory_monitor.py on ray_tpu_torch; reference:
common/memory_monitor.h:52, raylet/worker_killing_policy_retriable_fifo.h).

The memory fraction is injected so tests control "pressure" without
exhausting the host: an over-subscribing workload must get its workers
killed and retried (or fail with OutOfMemoryError once retries run out)
instead of the host's OOM killer taking the runtime down. One runtime serves
the module; each case installs its own fraction and waits for its own work.
"""

from __future__ import annotations

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import OutOfMemoryError


@pytest.fixture(scope="module")
def runtime():
    rt = ray_tpu_torch.init(
        num_cpus=4,
        num_gpus=0,
        _system_config={
            "isolation": "process",
            "memory_monitor_refresh_s": 0.1,
            "memory_usage_threshold": 0.95,
        },
    )
    yield rt
    ray_tpu_torch.shutdown()


class _FakeMemory:
    def __init__(self, fraction=0.5):
        self.fraction = fraction

    def __call__(self):
        return self.fraction


@pytest.fixture
def fake(runtime):
    fraction = _FakeMemory()
    runtime.memory_monitor._memory_fraction = fraction
    yield fraction
    fraction.fraction = 0.5


def test_oom_kill_fails_task_with_oom_error(runtime, fake):
    kills = runtime.memory_monitor.kills

    @ray_tpu_torch.remote(max_retries=0)
    def hog():
        time.sleep(60)

    ref = hog.remote()
    # Let the task dispatch, then simulate sustained pressure.
    time.sleep(1.0)
    fake.fraction = 0.99
    with pytest.raises(OutOfMemoryError, match="memory monitor"):
        ray_tpu_torch.get(ref, timeout=30)
    assert runtime.memory_monitor.kills >= kills + 1


def test_oom_killed_task_retries_after_pressure_clears(runtime, fake):
    kills = runtime.memory_monitor.kills

    @ray_tpu_torch.remote(max_retries=3)
    def work():
        return "done"

    @ray_tpu_torch.remote(max_retries=3)
    def slow():
        time.sleep(5)
        return "slow-done"

    ref = slow.remote()
    time.sleep(0.8)  # in flight
    fake.fraction = 0.99  # kill it (retriable)
    time.sleep(0.5)
    assert runtime.memory_monitor.kills >= kills + 1
    fake.fraction = 0.5  # pressure clears; retry proceeds

    # New work dispatches after the gate re-opens, and the killed task's
    # retry completes.
    assert ray_tpu_torch.get(work.remote(), timeout=30) == "done"
    assert ray_tpu_torch.get(ref, timeout=30) == "slow-done"


def test_dispatch_backpressure_under_pressure(runtime, fake):
    fake.fraction = 0.99
    time.sleep(0.4)  # monitor notices pressure

    @ray_tpu_torch.remote
    def f():
        return 1

    ref = f.remote()
    # Under pressure nothing dispatches...
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=1.0)
    assert not ready
    # ...until it clears.
    fake.fraction = 0.5
    assert ray_tpu_torch.get(ref, timeout=30) == 1


def test_policy_prefers_retriable_newest(runtime, fake):
    """The retriable-FIFO ordering: a non-retriable worker survives while a
    retriable one exists."""

    @ray_tpu_torch.remote(max_retries=0)
    def precious():
        time.sleep(6)
        return "precious-done"

    @ray_tpu_torch.remote(max_retries=5)
    def retriable():
        time.sleep(6)
        return "retriable-done"

    p_ref = precious.remote()
    r_ref = retriable.remote()
    time.sleep(1.2)  # both in flight
    fake.fraction = 0.99
    time.sleep(0.4)  # one kill tick
    fake.fraction = 0.5
    # The retriable task was sacrificed (and will retry); the non-retriable
    # one survives to completion.
    assert ray_tpu_torch.get(p_ref, timeout=30) == "precious-done"
    assert ray_tpu_torch.get(r_ref, timeout=60) == "retriable-done"
