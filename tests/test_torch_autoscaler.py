"""The port's autoscaler (ray_tpu_torch.autoscaler) against the reference.

The counterparts of tests/test_autoscaler.py's 15 cases on ray_tpu_torch,
with the GPU in the place of the TPU (the port has no TPU resource and its
node daemon no `--num-tpus`; node types keep the reference's `TPU` key
where only the demand scheduler reads them). Then: the demand scheduler
returns the reference's answer on seeded node types, demands and bundles;
the daemon-backed providers pass `CPU` and `GPU` by `--num-cpus` and
`--num-gpus`, and a `GPU` so passed makes the same node as one given in
`--resources`; and a provisioned GPU node runs a `num_gpus` task.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (
    FakeNodeProvider,
    Monitor,
    ResourceDemandScheduler,
    StandardAutoscaler,
)
from ray_tpu_torch.cluster_utils import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    yield c
    c.shutdown()


CONFIG = {
    "max_workers": 10,
    "upscaling_speed": 2.0,
    "idle_timeout_s": 0.5,
    "available_node_types": {
        "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 4},
        "gpu-host": {"resources": {"CPU": 8, "GPU": 4}, "min_workers": 0, "max_workers": 4},
        "tpu-v5e-16": {
            "resources": {"CPU": 8, "TPU": 4},
            "min_workers": 0,
            "max_workers": 2,
            "hosts_per_slice": 4,
        },
    },
}


# -- demand scheduler unit tests -----------------------------------------


def test_demand_scheduler_basic():
    sched = ResourceDemandScheduler(CONFIG["available_node_types"])
    out = sched.get_nodes_to_launch(
        node_avail=[{"CPU": 1}],
        demands=[{"CPU": 4}, {"CPU": 4}, {"GPU": 4}],
        bundle_sets=[],
        current_counts={},
    )
    # Two CPU demands fit one new cpu-worker (4 CPU each → 2 nodes);
    # GPU demand needs a gpu-host.
    assert out.get("cpu-worker") == 2
    assert out.get("gpu-host") == 1


def test_demand_scheduler_respects_max_workers():
    sched = ResourceDemandScheduler(
        {"w": {"resources": {"CPU": 1}, "max_workers": 2}}
    )
    out = sched.get_nodes_to_launch(
        node_avail=[],
        demands=[{"CPU": 1}] * 5,
        bundle_sets=[],
        current_counts={"w": 1},
    )
    assert out == {"w": 1}  # 1 live + 1 launch = cap 2


def test_demand_scheduler_absorbs_into_existing():
    sched = ResourceDemandScheduler(CONFIG["available_node_types"])
    out = sched.get_nodes_to_launch(
        node_avail=[{"CPU": 8}],
        demands=[{"CPU": 2}, {"CPU": 2}],
        bundle_sets=[],
        current_counts={},
    )
    assert out == {}


def test_demand_scheduler_gang_bundles():
    sched = ResourceDemandScheduler(CONFIG["available_node_types"])
    # A 4-host slice PG: 4 bundles of 4 TPU each; nothing live can host.
    out = sched.get_nodes_to_launch(
        node_avail=[],
        demands=[],
        bundle_sets=[("STRICT_SPREAD", [{"TPU": 4}] * 4)],
        current_counts={},
    )
    # Served by tpu hosts (single or slice type depending on packing order) —
    # total new TPU capacity must cover all 4 bundles.
    total_tpu_capacity = 0
    for t, c in out.items():
        cfg = CONFIG["available_node_types"][t]
        total_tpu_capacity += (
            cfg["resources"].get("TPU", 0) * cfg.get("hosts_per_slice", 1) * c
        )
    assert total_tpu_capacity >= 16


# -- end-to-end with the fake provider -----------------------------------


def test_autoscaler_scales_up_for_infeasible_task(cluster):
    monitor = Monitor(cluster.runtime, CONFIG, update_interval_s=0.2).start()
    try:

        @ray_tpu_torch.remote(num_gpus=4)
        def on_gpu():
            return "ran-on-gpu"

        # Infeasible now (head has no GPU); the monitor provisions a gpu node.
        ref = on_gpu.remote()
        assert ray_tpu_torch.get(ref, timeout=30.0) == "ran-on-gpu"
        # The task can run the instant add_node registers the new node —
        # microseconds BEFORE the autoscaler thread reaches its
        # num_launches increment a few statements later. Poll briefly.
        deadline = time.time() + 5
        while time.time() < deadline and monitor.autoscaler.num_launches < 1:
            time.sleep(0.01)
        assert monitor.autoscaler.num_launches >= 1
    finally:
        monitor.stop()


def test_autoscaler_min_workers_and_idle_termination(cluster):
    config = {
        "max_workers": 5,
        "idle_timeout_s": 0.3,
        "available_node_types": {
            "cpu-worker": {
                "resources": {"CPU": 4},
                "min_workers": 2,
                "max_workers": 4,
            },
        },
    }
    monitor = Monitor(cluster.runtime, config, update_interval_s=0.1).start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            if len(monitor.provider.non_terminated_nodes()) >= 2:
                break
            time.sleep(0.05)
        assert len(monitor.provider.non_terminated_nodes()) >= 2

        # Scale-down never dips below min_workers even when all idle.
        time.sleep(1.0)
        monitor.update_now()
        assert len(monitor.provider.non_terminated_nodes()) == 2
    finally:
        monitor.stop()


def test_autoscaler_terminates_idle_above_min(cluster):
    config = {
        "max_workers": 5,
        "idle_timeout_s": 0.2,
        "available_node_types": {
            "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 4},
        },
    }
    provider = FakeNodeProvider(cluster.runtime)
    monitor = Monitor(cluster.runtime, config, provider=provider)
    provider.create_node("cpu-worker", config["available_node_types"]["cpu-worker"], 2)
    assert len(provider.non_terminated_nodes()) == 2
    monitor.update_now()  # records first-seen
    time.sleep(0.4)
    monitor.update_now()
    assert len(provider.non_terminated_nodes()) == 0
    assert monitor.autoscaler.num_terminations == 2


def test_autoscaler_slice_gang_launch(cluster):
    """A pending slice placement group provisions all hosts of the slice."""
    config = {
        "max_workers": 10,
        "idle_timeout_s": 60.0,
        "available_node_types": {
            "tpu-v5e-16": {
                "resources": {"CPU": 8, "TPU": 4},
                "min_workers": 0,
                "max_workers": 2,
                "hosts_per_slice": 4,
            },
        },
    }
    monitor = Monitor(cluster.runtime, config, update_interval_s=0.2).start()
    try:
        from ray_tpu_torch.util import placement_group

        pg = placement_group([{"TPU": 4}] * 4, strategy="STRICT_SPREAD")
        assert pg.ready(timeout=30.0), "slice PG never became ready"
        # All 4 hosts of one slice were launched. (ready() fires from inside
        # the last add_node, a beat before the provider records it — poll.)
        deadline = time.time() + 5
        while time.time() < deadline:
            if len(monitor.provider.non_terminated_nodes()) == 4:
                break
            time.sleep(0.05)
        assert len(monitor.provider.non_terminated_nodes()) == 4
        slice_ids = {
            monitor.provider.node_tags(n).get("tpu-slice-id")
            for n in monitor.provider.non_terminated_nodes()
        }
        assert len(slice_ids) == 1 and None not in slice_ids
    finally:
        monitor.stop()


def test_autoscaler_respects_global_max_workers(cluster):
    config = {
        "max_workers": 2,
        "idle_timeout_s": 60.0,
        "available_node_types": {
            "cpu-worker": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 10},
        },
    }
    monitor = Monitor(cluster.runtime, config, update_interval_s=0.1).start()
    try:

        @ray_tpu_torch.remote(num_cpus=2)
        def chew(i):
            time.sleep(0.5)
            return i

        refs = [chew.remote(i) for i in range(12)]
        out = ray_tpu_torch.get(refs, timeout=60.0)
        assert sorted(out) == list(range(12))
        # Global cap held the worker count at 2.
        assert len(monitor.provider.non_terminated_nodes()) <= 2
    finally:
        monitor.stop()


def test_strict_spread_needs_distinct_hosts():
    """Regression: a STRICT_SPREAD gang that numerically fits on fewer nodes
    must still launch enough distinct hosts (strategy-blind packing
    deadlocked the PG forever)."""
    sched = ResourceDemandScheduler(
        {"w": {"resources": {"CPU": 4}, "max_workers": 10}}
    )
    # 3 one-CPU bundles "fit" on the 2 live nodes numerically, but strict
    # spread needs 3 distinct hosts -> one launch.
    out = sched.get_nodes_to_launch(
        node_avail=[{"CPU": 2}, {"CPU": 4}],
        demands=[],
        bundle_sets=[("STRICT_SPREAD", [{"CPU": 1}] * 3)],
        current_counts={},
    )
    assert out == {"w": 1}


def test_strict_spread_pg_scales_up_end_to_end(cluster):
    config = {
        "max_workers": 6,
        "idle_timeout_s": 60.0,
        "available_node_types": {
            "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 6},
        },
    }
    monitor = Monitor(cluster.runtime, config, update_interval_s=0.2).start()
    try:
        from ray_tpu_torch.util import placement_group

        pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
        assert pg.ready(timeout=30.0)
    finally:
        monitor.stop()


def test_monitor_stop_restores_fail_fast(cluster):
    config = {
        "max_workers": 2,
        "available_node_types": {
            "cpu-worker": {"resources": {"CPU": 2}, "max_workers": 2},
        },
    }
    monitor = Monitor(cluster.runtime, config, update_interval_s=0.2).start()
    monitor.stop()
    # Listener removed: infeasible demand fails fast again instead of
    # queueing for an autoscaler that no longer exists.
    @ray_tpu_torch.remote(num_gpus=8)
    def impossible():
        return 1

    with pytest.raises(Exception):
        ray_tpu_torch.get(impossible.remote(), timeout=10.0)


def test_subprocess_provider_closes_the_loop():
    """The full provision loop with REAL daemons (VERDICT missing #3):
    demand beyond the head's capacity -> autoscaler launches a node-daemon
    subprocess via the provider -> it joins over TCP (`ray-tpu-torch start`
    path) -> the stranded tasks schedule there -> idle timeout terminates
    the daemon again."""
    import time

    from ray_tpu_torch.autoscaler import Monitor, SubprocessNodeProvider

    runtime = ray_tpu_torch.init(
        num_cpus=1, num_gpus=0,
        _system_config={"isolation": "process", "worker_device": "cpu"},
    )
    runtime.serve_clients(port=0)
    config = {
        "max_workers": 2,
        "idle_timeout_s": 3.0,
        "available_node_types": {
            "cpu-worker": {
                "resources": {"CPU": 4, "provisioned": 1},
                "min_workers": 0,
                "max_workers": 2,
            }
        },
    }
    provider = SubprocessNodeProvider(runtime)
    monitor = Monitor(
        runtime, config, provider=provider, update_interval_s=0.5
    ).start()
    try:
        @ray_tpu_torch.remote(num_cpus=2)
        def heavy(i):
            return i * 7

        # Needs 2 CPUs: impossible on the 1-CPU head -> demand -> provision.
        refs = [heavy.remote(i) for i in range(3)]
        results = ray_tpu_torch.get(refs, timeout=120)
        assert results == [0, 7, 14]
        assert provider.non_terminated_nodes(), "provider launched nothing"
        # Tasks really ran on the provisioned daemon.
        assert ray_tpu_torch.get(
            heavy.options(resources={"provisioned": 0.1}).remote(5)
        ) == 35
        # Idle: the daemon is terminated again.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and provider.non_terminated_nodes():
            time.sleep(0.5)
        assert not provider.non_terminated_nodes(), "idle daemon not reaped"
    finally:
        monitor.stop()
        ray_tpu_torch.shutdown()


def test_ssh_provider_command_shape():
    """SSHNodeProvider builds correct remote bootstrap commands (no sshd in
    the test image: command construction + pool accounting only)."""
    from ray_tpu_torch.autoscaler.node_provider import SSHNodeProvider

    class _Recorder(SSHNodeProvider):
        def __init__(self):
            super().__init__(runtime=None, provider_config={
                "worker_ips": ["10.0.0.5"],
                "ssh_user": "tpu",
                "ssh_key": "/keys/k.pem",
                "address": "head:1234?token=abc",
            })
            self.commands = []

        def _launch(self, address, resources, labels, type_config):
            # capture what the real _launch would exec
            base = self._ssh_base(self._free_ips[0])
            self.commands.append((base, address, resources, labels))
            with self._lock:
                ip = self._free_ips.pop(0)
            return {"ip": ip, "remote_pid": "4242"}

    provider = _Recorder()
    created = provider.create_node(
        "gpu-host", {"resources": {"CPU": 8, "GPU": 4}}, 1
    )
    assert len(created) == 1
    base, address, resources, labels = provider.commands[0]
    assert base[:1] == ["ssh"] and base[-1] == "tpu@10.0.0.5"
    assert "-i" in base and "/keys/k.pem" in base
    assert address == "head:1234?token=abc"
    assert resources == {"CPU": 8, "GPU": 4}
    assert any(k == "autoscaler-provider-id" for k in labels)
    assert not provider._free_ips  # leased
    provider.terminate_node(created[0])


def test_ssh_provider_join_deadline_reclaims_ip():
    """A launched daemon that never connects is reaped after the join
    deadline: remote pid killed, IP returned to the pool, autoscaler event
    recorded. A node that DID join is exempt from the deadline."""
    from ray_tpu_torch.autoscaler.node_provider import PROVIDER_LABEL, SSHNodeProvider

    class _Node:
        def __init__(self, labels):
            self.labels = labels
            self.node_id = "nid"

    class _Controller:
        nodes = {}

    class _FakeRuntime:
        controller = _Controller()

    kills = []

    class _NoSSH(SSHNodeProvider):
        def __init__(self):
            super().__init__(
                runtime=_FakeRuntime(),
                provider_config={
                    "worker_ips": ["10.0.0.9", "10.0.0.10"],
                    "address": "head:1",
                    "join_deadline_s": 0.2,
                },
            )

        def _launch(self, address, resources, labels, type_config):
            with self._lock:
                ip = self._free_ips.pop(0)
            return {"ip": ip, "remote_pid": "777", "labels": labels}

        def _remote_kill(self, info):
            kills.append(info["remote_pid"])

    provider = _NoSSH()
    created = provider.create_node("host", {"resources": {"CPU": 1}}, 2)
    assert sorted(provider.non_terminated_nodes()) == sorted(created)

    # First node "joins" (its provider label appears on a runtime node).
    joined_pid = created[0]
    _Controller.nodes = {"n1": _Node({PROVIDER_LABEL: joined_pid})}

    time.sleep(0.3)
    alive = provider.non_terminated_nodes()
    assert alive == [joined_pid], alive  # unjoined one reaped
    assert kills == ["777"]
    with provider._lock:
        assert len(provider._free_ips) == 1  # reclaimed
    assert provider.events and "never joined" in provider.events[-1]["message"]

    # The joined node stays exempt on later polls.
    time.sleep(0.1)
    assert provider.non_terminated_nodes() == [joined_pid]


# -------------------------------------------------- held against the reference


def _seeded_case(rng):
    """Node types, live nodes' availability, demands, bundle sets and live
    counts, drawn from one seeded generator."""
    keys = ("CPU", "GPU", "TPU", "mem")
    types = {}
    for i in range(rng.randint(1, 4)):
        res = {k: float(rng.choice([1, 2, 4, 8])) for k in keys if rng.rand() < 0.6}
        res = res or {"CPU": 4.0}
        cfg = {"resources": res, "max_workers": int(rng.randint(1, 5))}
        if rng.rand() < 0.3:
            cfg["hosts_per_slice"] = int(rng.randint(2, 5))
        types[f"t{i}"] = cfg

    def ask():
        return {k: float(rng.choice([0.5, 1, 2, 4])) for k in keys if rng.rand() < 0.4}

    avail = [ask() for _ in range(rng.randint(0, 4))]
    demands = [ask() for _ in range(rng.randint(0, 8))]
    strategies = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")
    bundles = [(strategies[rng.randint(4)], [ask() or {"CPU": 1.0}
                                             for _ in range(rng.randint(1, 5))])
               for _ in range(rng.randint(0, 3))]
    counts = {t: int(rng.randint(0, 3)) for t in types if rng.rand() < 0.5}
    return types, avail, demands, bundles, counts


@pytest.mark.parametrize("seed", range(4))
def test_demand_scheduler_matches_the_reference(seed):
    from ray_tpu.autoscaler import ResourceDemandScheduler as JaxScheduler

    rng = np.random.RandomState(seed)
    launched = 0
    for _ in range(150):
        types, avail, demands, bundles, counts = _seeded_case(rng)
        want = JaxScheduler(types).get_nodes_to_launch(avail, demands, bundles, counts)
        got = ResourceDemandScheduler(types).get_nodes_to_launch(
            avail, demands, bundles, counts)
        assert got == want, (types, avail, demands, bundles, counts)
        launched += sum(got.values())
    assert launched > 0  # the cases exercise launches, not only absorption


def test_slice_tags_and_labels_keep_the_reference_names(cluster):
    """A multi-host node type's hosts carry the reference's tag and label
    names, so both packages take the same cluster config."""
    from ray_tpu.autoscaler import node_provider as jax_np
    from ray_tpu_torch.autoscaler import node_provider as port_np

    for name in ("TAG_NODE_TYPE", "TAG_SLICE_ID", "TAG_SLICE_HOST", "PROVIDER_LABEL"):
        assert getattr(port_np, name) == getattr(jax_np, name)
    provider = FakeNodeProvider(cluster.runtime)
    created = provider.create_node("g", {"resources": {"CPU": 1}, "hosts_per_slice": 2}, 1)
    labels = [cluster.runtime.controller.nodes[provider.runtime_node_id(p)].labels
              for p in created]
    assert sorted(lab["tpu-host"] for lab in labels) == ["0", "1"]
    assert len({lab["tpu-slice"] for lab in labels}) == 1
    assert {provider.node_tags(p)["tpu-slice-id"] for p in created} == {labels[0]["tpu-slice"]}


@pytest.mark.parametrize("resources, want", [
    ({"CPU": 4, "GPU": 1}, ["--num-cpus", "4.0", "--num-gpus", "1.0"]),
    ({"CPU": 2, "GPU": 0.5, "nodeX": 1},
     ["--num-cpus", "2.0", "--num-gpus", "0.5", "--resources", '{"nodeX": 1}']),
    ({"mem": 3}, ["--resources", '{"mem": 3}']),
])
def test_daemon_argv_passes_cpu_and_gpu_by_flag(resources, want):
    from ray_tpu_torch.autoscaler.node_provider import daemon_argv

    argv = daemon_argv("h:1?token=t", resources, {"k": "v"}, {"object_store_memory": 1 << 26})
    assert argv == ["--address", "h:1?token=t", *want, "--labels", '{"k": "v"}',
                    "--object-store-memory", str(1 << 26)]
    assert "--num-tpus" not in daemon_argv("h:1", {"TPU": 4}, {}, {})


def _daemon_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def test_gpu_by_num_gpus_makes_the_same_node_as_gpu_in_resources():
    """One daemon given `{"GPU": 1}` in `--resources`, one launched by the
    subprocess provider for a `{"CPU": 2, "GPU": 1}` node type (so by
    `--num-gpus`): the head registers the same resources for both, and a
    num_gpus task runs on the provider's node."""
    from ray_tpu_torch.autoscaler import SubprocessNodeProvider
    from ray_tpu_torch.autoscaler.node_provider import PROVIDER_LABEL

    runtime = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "isolation": "process", "worker_device": "cpu"})
    address = runtime.serve_clients(port=0)
    by_json = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.node_daemon", "--address", address,
         "--num-cpus", "2", "--resources", json.dumps({"GPU": 1}),
         "--object-store-memory", str(64 << 20)],
        env=_daemon_env(), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    provider = SubprocessNodeProvider(runtime)
    try:
        [pid] = provider.create_node("gpu", {"resources": {"CPU": 2, "GPU": 1},
                                             "object_store_memory": 64 << 20}, 1)
        deadline = time.monotonic() + 60
        while len(runtime.controller.alive_nodes()) < 3:
            assert time.monotonic() < deadline, "daemons did not join"
            time.sleep(0.05)
        nodes = [n for n in runtime.controller.alive_nodes()
                 if n.node_id != runtime.controller.head_node_id]
        provided = next(n for n in nodes if n.labels.get(PROVIDER_LABEL) == pid)
        other = next(n for n in nodes if n is not provided)
        assert provided.total == other.total == {"CPU": 2.0, "GPU": 1.0}

        @ray_tpu_torch.remote(num_gpus=0.5)
        def where():
            return os.getppid()

        ppids = set(ray_tpu_torch.get([where.remote() for _ in range(4)], timeout=120))
        assert ppids <= {by_json.pid, provider._nodes[pid]["proc"].pid}
    finally:
        provider.terminate_node(pid)
        ray_tpu_torch.shutdown()
        by_json.wait(timeout=30)


def test_gpu_actor_scales_a_daemon_up_and_down():
    """The cluster phase's loop on the CPU: an actor asking for half a GPU
    is infeasible on the GPU-less head, so the monitor launches one daemon
    of the `{"CPU": 4, "GPU": 1}` type and the actor comes up under it.
    Killed, the actor leaves the node idle, and the provider terminates the
    daemon (SIGTERM), which reaps its workers and removes its segment
    (ROADMAP.md §D32); the state API lists the node DEAD."""
    from ray_tpu_torch.autoscaler import SubprocessNodeProvider
    from ray_tpu_torch.util.state import list_nodes

    runtime = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "isolation": "process", "worker_device": "cpu"})
    runtime.serve_clients(port=0)
    config = {"max_workers": 1, "idle_timeout_s": 1.0, "available_node_types": {
        "gpu": {"resources": {"CPU": 4, "GPU": 1}, "object_store_memory": 64 << 20,
                "min_workers": 0, "max_workers": 1}}}
    provider = SubprocessNodeProvider(runtime)
    monitor = Monitor(runtime, config, provider=provider, update_interval_s=0.2).start()
    try:
        @ray_tpu_torch.remote
        class Where:
            def pids(self):
                return os.getpid(), os.getppid()

        actor = Where.options(num_gpus=0.5).remote()
        worker, parent = ray_tpu_torch.get(actor.pids.remote(), timeout=120)
        [pid] = provider.non_terminated_nodes()
        daemon = provider._nodes[pid]["proc"]
        assert parent == daemon.pid and monitor.autoscaler.num_launches == 1
        node = provider.runtime_node_id(pid)
        ray_tpu_torch.kill(actor)
        deadline = time.monotonic() + 60
        while provider.non_terminated_nodes():
            assert time.monotonic() < deadline, "the idle daemon was not terminated"
            time.sleep(0.1)
        assert daemon.wait(timeout=30) == 0  # shut down, not killed
        assert not os.path.exists(f"/dev/shm/ray_tpu_torch_node_{daemon.pid}")
        with pytest.raises(ProcessLookupError):
            os.kill(worker, 0)
        rows = {r["node_id"]: r["state"] for r in list_nodes()}
        assert rows[node.hex()] == "DEAD"
        # Counted once terminate_node returns, after the daemon's exit.
        while monitor.autoscaler.num_terminations != 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        monitor.stop()
        ray_tpu_torch.shutdown()
