"""The port's control-plane persistence (GCS fault tolerance) and worker
health probing.

Every case of tests/test_gcs_persistence.py, on ray_tpu_torch: the KV and
the job counter survive a restart, a detached actor and a placement group
come back from the snapshot, the snapshot's write is atomic and a corrupt
one loads as nothing, and a hung worker process is killed by the health
probe. Then one parity case: after the same calls (a KV entry, a job, a
placement group, a named detached actor) both packages' `build_snapshot`
hold equal tables, compared field by field.
"""

from __future__ import annotations

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.gcs_storage import GcsStorage, build_snapshot


def test_kv_and_job_counter_survive_restart(tmp_path):
    path = str(tmp_path / "gcs.snap")
    runtime = ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                                 _system_config={"gcs_storage_path": path})
    runtime.controller.kv_put(b"cluster_config", b"v1")
    first_job = runtime.job_id.to_int()
    ray_tpu_torch.shutdown()

    runtime2 = ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                                  _system_config={"gcs_storage_path": path})
    assert runtime2.controller.kv_get(b"cluster_config") == b"v1"
    assert runtime2.job_id.to_int() > first_job  # counter monotonic
    ray_tpu_torch.shutdown()


def test_detached_actor_recreated_after_restart(tmp_path):
    path = str(tmp_path / "gcs.snap")
    ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                       _system_config={"gcs_storage_path": path})

    @ray_tpu_torch.remote
    class Registry:
        def __init__(self, tag):
            self.tag = tag

        def get_tag(self):
            return self.tag

    Registry.options(name="persistent_reg", lifetime="detached").remote("alpha")
    handle = ray_tpu_torch.get_actor("persistent_reg")
    assert ray_tpu_torch.get(handle.get_tag.remote()) == "alpha"
    ray_tpu_torch.shutdown()

    ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                       _system_config={"gcs_storage_path": path})
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            handle = ray_tpu_torch.get_actor("persistent_reg")
            assert ray_tpu_torch.get(handle.get_tag.remote()) == "alpha"
            break
        except Exception:
            time.sleep(0.1)
    else:
        pytest.fail("detached actor was not recreated from the snapshot")
    ray_tpu_torch.shutdown()


def test_placement_group_restored_with_same_id(tmp_path):
    path = str(tmp_path / "gcs.snap")
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       _system_config={"gcs_storage_path": path})
    from ray_tpu_torch.util.placement_group import placement_group

    pg = placement_group([{"CPU": 1}], strategy="PACK", name="durable_pg")
    assert pg.ready(timeout=5)
    pg_id = pg.id
    ray_tpu_torch.shutdown()

    runtime2 = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                                  _system_config={"gcs_storage_path": path})
    record = runtime2.controller.get_placement_group(pg_id)
    assert record is not None
    assert record.state.value == "CREATED"
    assert record.name == "durable_pg"
    ray_tpu_torch.shutdown()


def test_snapshot_roundtrip_is_atomic(tmp_path):
    path = str(tmp_path / "gcs.snap")
    storage = GcsStorage(path)
    storage.save({"version": 1, "kv": {b"k": b"v"}})
    assert storage.load()["kv"] == {b"k": b"v"}
    # Corrupt file: load degrades to None instead of crashing the session.
    with open(path, "wb") as f:
        f.write(b"garbage")
    assert storage.load() is None


def test_hung_worker_is_killed_by_health_probe():
    ray_tpu_torch.init(
        num_cpus=4,
        num_gpus=0,
        _system_config={
            "isolation": "process",
            "health_check_period_s": 0.2,
            "health_check_failure_threshold": 2,
        },
    )

    @ray_tpu_torch.remote(max_retries=0)
    def wedge():
        # Simulate a hung worker: mute every outgoing frame (pongs included)
        # while staying connected. A plain sleep would still pong — the recv
        # thread answers probes independently of the executor.
        import ray_tpu_torch._private.runtime as rmod

        worker = rmod._RUNTIME._worker
        worker.conn.send_bytes = lambda payload: None
        time.sleep(60)

    from ray_tpu_torch.exceptions import WorkerCrashedError

    try:
        with pytest.raises(WorkerCrashedError):
            ray_tpu_torch.get(wedge.remote(), timeout=30)
    finally:
        ray_tpu_torch.shutdown()


def _same_calls(pkg, path):
    """KV entry, a job, a placement group and a named detached actor through
    `pkg`'s public API; returns the snapshot build_snapshot takes of it."""
    import importlib

    placement_group = importlib.import_module(
        f"{pkg.__name__}.util.placement_group").placement_group
    gcs = importlib.import_module(f"{pkg.__name__}._private.gcs_storage")
    kwargs = {"num_gpus": 0} if pkg is ray_tpu_torch else {"num_tpus": 0}
    runtime = pkg.init(num_cpus=2, _system_config={"gcs_storage_path": path},
                       **kwargs)
    try:
        runtime.controller.kv_put(b"model", b"gpt2-125m")
        runtime.controller.next_job_id()
        pg = placement_group([{"CPU": 1}], strategy="PACK", name="pg_parity")
        assert pg.ready(timeout=10)

        @pkg.remote
        class Holder:
            def __init__(self, seed):
                self.seed = seed

            def seed_of(self):
                return self.seed

        h = Holder.options(name="holder", lifetime="detached",
                           max_restarts=2).remote(7)
        assert pkg.get(h.seed_of.remote(), timeout=30) == 7
        return gcs.build_snapshot(runtime)
    finally:
        pkg.shutdown()


def _same_calls_in_fresh_process(name: str, path: str) -> dict:
    """`_same_calls` on package `name` in a new interpreter: a test process
    may hold threads of an earlier test's runtime (a Serve router, say)
    that would add a detached actor of their own to the snapshot."""
    import base64
    import os
    import pickle
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import base64, importlib, pickle, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_gcs_persistence as t; "
            "snap = t._same_calls(importlib.import_module(sys.argv[2]), sys.argv[3]); "
            "print('RESULT ' + base64.b64encode(pickle.dumps(snap)).decode())")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(here), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code, here, name, path],
                          capture_output=True, text=True, timeout=240, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-2000:] + proc.stderr[-4000:]
    return pickle.loads(base64.b64decode(lines[-1][len("RESULT "):]))


def test_snapshot_tables_match_the_reference(tmp_path):
    """Both packages' build_snapshot after the same calls, each in a fresh
    process: the same KV, job counter, placement group (bundles, strategy,
    name) and detached actor (name, namespace, restarts, class, and its
    creation spec's name, kind, resources and arguments), field by field."""
    import cloudpickle

    ours = _same_calls_in_fresh_process("ray_tpu_torch", str(tmp_path / "port.snap"))
    ref = _same_calls_in_fresh_process("ray_tpu", str(tmp_path / "ref.snap"))
    assert sorted(ours) == sorted(ref) == sorted(
        ["version", "kv", "job_counter", "placement_groups", "detached_actors"])
    assert ours["version"] == ref["version"] == 1
    assert ours["kv"] == ref["kv"] == {b"model": b"gpt2-125m"}
    assert ours["job_counter"] == ref["job_counter"] == 2
    for key in ("bundles", "strategy", "name"):
        assert [p[key] for p in ours["placement_groups"]] == \
            [p[key] for p in ref["placement_groups"]]
    assert [p["name"] for p in ours["placement_groups"]] == ["pg_parity"]
    assert len(ours["detached_actors"]) == len(ref["detached_actors"]) == 1
    (a,), (b,) = ours["detached_actors"], ref["detached_actors"]
    for key in ("name", "namespace", "max_restarts", "class_name"):
        assert a[key] == b[key], key
    assert (a["name"], a["max_restarts"], a["class_name"]) == ("holder", 2, "Holder")
    spec_a, spec_b = cloudpickle.loads(a["spec"]), cloudpickle.loads(b["spec"])
    assert spec_a.name == spec_b.name
    assert spec_a.kind.value == spec_b.kind.value
    assert spec_a.args == spec_b.args == (7,)
    assert {k: v for k, v in spec_a.resources.items()} == \
        {k: v for k, v in spec_b.resources.items()}
