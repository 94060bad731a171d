"""The port's in-process runtime against the reference's.

Each test runs one small program twice, once on `ray_tpu` and once on
`ray_tpu_torch`, each package through its own public API, and compares the
results (exact: both sides compute the same Python values). The features
the port refuses are checked to raise, naming where they would come from.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
import ray_tpu.util as jax_util
import ray_tpu_torch.util as torch_util

PACKAGES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


@pytest.fixture
def both():
    """Both runtimes up at once (4 CPUs each), each shut down after."""
    for rt in PACKAGES.values():
        rt.init(num_cpus=4, num_gpus=0)
    yield PACKAGES
    for rt in PACKAGES.values():
        rt.shutdown()


def _run(both, program):
    got = {name: program(rt) for name, rt in both.items()}
    assert got["ray_tpu_torch"] == got["ray_tpu"], got
    return got["ray_tpu_torch"]


def test_tasks_and_chained_refs(both):
    def program(rt):
        @rt.remote
        def square(x):
            return x * x

        @rt.remote
        def total(*xs):
            return sum(xs)

        refs = [square.remote(i) for i in range(6)]
        return rt.get(refs), rt.get(total.remote(*refs))

    assert _run(both, program) == ([0, 1, 4, 9, 16, 25], 55)


def test_put_get_wait(both):
    def program(rt):
        arr = np.arange(12.0).reshape(3, 4)
        ref = rt.put({"a": arr, "b": [1, 2]})
        value = rt.get(ref)

        @rt.remote
        def col_sums(d):
            return d["a"].sum(0).tolist()

        ready, rest = rt.wait([col_sums.remote(ref), rt.put(7)], num_returns=2,
                              timeout=30)
        return value["a"].tolist(), value["b"], sorted(
            map(str, rt.get(ready))), len(rest)

    _run(both, program)


def test_actor_call_sequence_named_get_actor_and_kill(both):
    def program(rt):
        @rt.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def add(self, k):
                self.n += k
                return self.n

        c = Counter.options(name="counter").remote(10)
        seq = rt.get([c.add.remote(i) for i in range(5)])
        again = rt.get(rt.get_actor("counter").add.remote(100))
        rt.kill(c)
        try:
            rt.get(c.add.remote(1), timeout=30)
            died = None
        except Exception as exc:  # ActorDiedError, each package its own
            died = type(exc).__name__
        try:
            rt.get_actor("counter")
            lookup = "found"
        except ValueError:
            lookup = "gone"
        return seq, again, died, lookup

    assert _run(both, program) == (
        [10, 11, 13, 16, 20], 120, "ActorDiedError", "gone"
    )


def test_task_error_reraises_as_cause_type(both):
    def program(rt):
        @rt.remote(max_retries=0)
        def fail():
            raise KeyError("missing")

        try:
            rt.get(fail.remote())
        except KeyError as exc:
            return "KeyError", "missing" in str(exc)

    assert _run(both, program) == ("KeyError", True)


def test_placement_groups(both):
    def program(rt):
        util = torch_util if rt is ray_tpu_torch else jax_util
        pg = util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
        assert pg.ready(timeout=30)
        strategy = util.PlacementGroupSchedulingStrategy

        @rt.remote(num_cpus=1)
        def where(i):
            return i * 2

        refs = [
            where.options(
                scheduling_strategy=strategy(
                    placement_group=pg, placement_group_bundle_index=i
                )
            ).remote(i)
            for i in range(2)
        ]
        out = rt.get(refs)
        nodes = len(set(pg.bundle_node_ids().values()))
        util.remove_placement_group(pg)
        return out, nodes, rt.available_resources()["CPU"]

    assert _run(both, program) == ([0, 2], 1, 4.0)


def test_refused_features_name_their_slice():
    """What the port does not construct is refused, never run reduced:
    worker prestart. The dashboard is ported: include_dashboard=True is
    accepted and serves on the port given (0: a free one). GCS persistence
    and remote drivers are ported: a gcs_storage_path is accepted (and
    written at shutdown),
    and init(address=...) connects, failing as a connection does when no
    head listens there. Worker processes, the memory monitor, the native
    store and spilling are ported: an actor asking for isolation="process"
    on this thread runtime runs in a process of its own, a
    memory_usage_threshold is accepted, and so are both store flags (on by
    default) with their threshold and directory."""
    import os
    import socket
    import tempfile

    for config, match in (
        ({"prestart_workers": False}, "prestart"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            ray_tpu_torch.init(num_cpus=1, _system_config=config)
        assert not ray_tpu_torch.is_initialized()
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "include_dashboard": True, "dashboard_port": 0})
    try:
        assert rt.dashboard is not None and rt.dashboard.port != 0
    finally:
        ray_tpu_torch.shutdown()
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "gcs.snap")
        rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0,
                                _system_config={"gcs_storage_path": snap})
        try:
            assert rt.config.gcs_storage_path == snap
            assert rt.config.head_restart_grace_s == 60.0
        finally:
            ray_tpu_torch.shutdown()
        assert os.path.exists(snap)
    free = socket.socket()
    free.bind(("127.0.0.1", 0))
    port = free.getsockname()[1]
    free.close()  # nothing listens on it now
    with pytest.raises(ConnectionError):
        ray_tpu_torch.init(address=f"127.0.0.1:{port}")
    assert not ray_tpu_torch.is_initialized()
    for config in ({}, {"native_store_enabled": True, "object_spilling_enabled": True,
                        "native_store_threshold": 1 << 20, "object_spill_directory": ""},
                   {"native_store_enabled": False, "object_spilling_enabled": False}):
        rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config=config)
        try:
            on = config.get("native_store_enabled", True)
            assert (rt._native_store is not None) == on
            assert (rt._spill_storage is not None) == on
        finally:
            ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, num_gpus=0,
                       _system_config={"memory_usage_threshold": 0.9})
    try:
        @ray_tpu_torch.remote
        class A:
            def pid(self):
                return os.getpid()

        a = A.options(isolation="process").remote()
        assert ray_tpu_torch.get(a.pid.remote(), timeout=60) != os.getpid()
    finally:
        ray_tpu_torch.shutdown()


def test_import_and_init_create_no_cuda_context():
    """`import ray_tpu_torch` and a CPU-only runtime's init/shutdown leave
    CUDA uninitialised (init counts devices without a context)."""
    import os
    import subprocess
    import sys

    code = (
        "import torch, ray_tpu_torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "ray_tpu_torch.init(num_cpus=1)\n"
        "ray_tpu_torch.shutdown()\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_node_daemon_refuses_to_run_without_its_store(tmp_path):
    """No hidden fallback in the daemon (ROADMAP.md §D27): a node daemon
    whose store library cannot be loaded exits non-zero before it joins,
    naming the failure, as init() does (§D25); the reference's daemon
    quietly runs without a store and then without an object server
    (ray_tpu/_private/node_daemon.py:246-265)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runtime = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        address = runtime.serve_clients(port=0)
        env = dict(os.environ, RAY_TPU_TORCH_STORE_LIB=str(tmp_path / "missing.so"),
                   PYTHONPATH=os.pathsep.join(
                       p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
             "--address", address, "--num-cpus", "1"],
            env=env, capture_output=True, text=True, timeout=60)
        out = proc.stdout + proc.stderr
        assert proc.returncode != 0, out
        assert "loading the native store" in out and "missing.so" in out
        assert "node daemon up" not in out
        assert len(runtime.controller.alive_nodes()) == 1  # never joined
    finally:
        ray_tpu_torch.shutdown()
