"""NodeProvider — the cloud-side plugin surface of the autoscaler.

Reference: autoscaler/node_provider.py (NodeProvider ABC) and the test-keystone
FakeMultiNodeProvider (autoscaler/_private/fake_multi_node/node_provider.py:237)
which simulates the whole loop in-process. Here the fake provider adds/removes
logical nodes on the running in-process cluster, which is exactly how the
reference's fake provider makes autoscaler + failure paths testable without
cloud hardware (SURVEY.md §4).

A node type may declare `hosts_per_slice > 1`; creating one "node" of that
type launches the whole group's hosts atomically, tagged and labelled with
the reference's names (`tpu-slice-id`, `tpu-slice`, `tpu-host`) so that both
packages take the same cluster config (ROADMAP.md §D, kept for parity).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Minimal provider contract (create/terminate/list + tags)."""

    def __init__(self, provider_config: Optional[dict] = None):
        self.provider_config = provider_config or {}

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def create_node(self, node_type: str, type_config: dict, count: int = 1) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError


TAG_NODE_TYPE = "ray-node-type"
TAG_SLICE_ID = "tpu-slice-id"
TAG_SLICE_HOST = "tpu-slice-host"


class FakeNodeProvider(NodeProvider):
    """Backs provider calls with logical nodes on the in-process runtime."""

    def __init__(self, runtime, provider_config: Optional[dict] = None):
        super().__init__(provider_config)
        self.runtime = runtime
        self._lock = threading.Lock()
        self._nodes: dict[str, dict] = {}  # provider id -> {node_id, tags}

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def runtime_node_id(self, provider_id: str):
        with self._lock:
            return self._nodes[provider_id]["node_id"]

    def create_node(self, node_type: str, type_config: dict, count: int = 1) -> List[str]:
        created = []
        resources = dict(type_config.get("resources", {}))
        labels = dict(type_config.get("labels", {}))
        hosts = int(type_config.get("hosts_per_slice", 1))
        for _ in range(count):
            slice_id = uuid.uuid4().hex[:8] if hosts > 1 else None
            for host in range(hosts):
                tags = {TAG_NODE_TYPE: node_type}
                node_labels = dict(labels)
                if slice_id:
                    tags[TAG_SLICE_ID] = slice_id
                    tags[TAG_SLICE_HOST] = str(host)
                    node_labels["tpu-slice"] = slice_id
                    node_labels["tpu-host"] = str(host)
                node_id = self.runtime.add_node(resources, node_labels)
                pid = f"fake-{uuid.uuid4().hex[:12]}"
                with self._lock:
                    self._nodes[pid] = {"node_id": node_id, "tags": tags}
                created.append(pid)
        return created

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_id, None)
        if info is not None:
            self.runtime.remove_node(info["node_id"])


PROVIDER_LABEL = "autoscaler-provider-id"


def daemon_argv(address: str, resources: dict, labels: dict,
                type_config: dict) -> list:
    """The node daemon's arguments for a node type's resources: `CPU` and
    `GPU` by `--num-cpus` and `--num-gpus` (the flags the daemon documents;
    it has no `--num-tpus`), the rest as `--resources` JSON, and the type's
    `object_store_memory` when it names one."""
    import json

    rest = dict(resources)
    argv = ["--address", address]
    for key, flag in (("CPU", "--num-cpus"), ("GPU", "--num-gpus")):
        if key in rest:
            argv += [flag, repr(float(rest.pop(key)))]
    if rest:
        argv += ["--resources", json.dumps(rest)]
    argv += ["--labels", json.dumps(labels)]
    if type_config.get("object_store_memory"):
        argv += ["--object-store-memory", str(int(type_config["object_store_memory"]))]
    return argv


class _DaemonBackedProvider(NodeProvider):
    """Shared half of the providers whose "nodes" are REAL node daemons
    that self-register with the head over TCP (`ray-tpu-torch start
    --address`, i.e. `python -m ray_tpu_torch._private.node_daemon`).

    The provider tags each launch with a unique label; the runtime NodeID
    mapping (needed by the autoscaler's idle-termination and pending-join
    accounting) is resolved by scanning the controller's node labels."""

    def __init__(self, runtime, provider_config: Optional[dict] = None):
        super().__init__(provider_config)
        self.runtime = runtime
        self._lock = threading.Lock()
        self._nodes: dict[str, dict] = {}  # pid -> {tags, ...}
        # Provider-level event log (join-deadline reaps, launch failures) —
        # surfaced to tests and operators; bounded.
        self.events: list = []

    def _emit_event(self, message: str) -> None:
        import logging
        import time as _time

        self.events.append({"time": _time.time(), "message": message})
        del self.events[:-100]
        logging.getLogger("ray_tpu_torch.autoscaler").warning(message)

    def _head_address(self) -> str:
        addr = self.provider_config.get("address")
        if addr:
            return addr
        head = getattr(self.runtime, "_head_server", None)
        if head is None:
            raise RuntimeError(
                "provider needs the head's TCP address: call "
                "runtime.serve_clients() first or set provider_config['address']"
            )
        return head.address

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            dead = [
                (pid, info)
                for pid, info in self._nodes.items()
                if self._is_dead(info)
            ]
            for pid, _ in dead:
                self._nodes.pop(pid, None)
            alive = list(self._nodes)
        for pid, info in dead:  # outside the lock: may ssh / re-lock
            self._on_dead(pid, info)
        return alive

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def runtime_node_id(self, provider_id: str):
        for node in self.runtime.controller.nodes.values():
            if node.labels.get(PROVIDER_LABEL) == provider_id:
                return node.node_id
        return None

    def create_node(self, node_type: str, type_config: dict, count: int = 1) -> List[str]:
        created: List[str] = []
        address = self._head_address()
        resources = dict(type_config.get("resources", {}))
        labels = dict(type_config.get("labels", {}))
        hosts = int(type_config.get("hosts_per_slice", 1))
        for _ in range(count):
            slice_id = uuid.uuid4().hex[:8] if hosts > 1 else None
            for host in range(hosts):
                pid = f"{self.KIND}-{uuid.uuid4().hex[:12]}"
                tags = {TAG_NODE_TYPE: node_type}
                node_labels = dict(labels)
                node_labels[PROVIDER_LABEL] = pid
                if slice_id:
                    tags[TAG_SLICE_ID] = slice_id
                    tags[TAG_SLICE_HOST] = str(host)
                    node_labels["tpu-slice"] = slice_id
                    node_labels["tpu-host"] = str(host)
                info = self._launch(address, resources, node_labels, type_config)
                info["tags"] = tags
                info["pid"] = pid
                import time as _time

                info["launched_at"] = _time.monotonic()
                with self._lock:
                    self._nodes[pid] = info
                created.append(pid)
        return created

    # subclass surface -----------------------------------------------------

    KIND = "daemon"

    def _launch(self, address: str, resources: dict, labels: dict,
                type_config: dict) -> dict:
        raise NotImplementedError

    def _is_dead(self, info: dict) -> bool:
        raise NotImplementedError

    def _on_dead(self, pid: str, info: dict) -> None:
        """Cleanup after a node judged dead was dropped (called unlocked)."""


class SubprocessNodeProvider(_DaemonBackedProvider):
    """Provisions "hosts" as local node-daemon subprocesses — the
    integration-testable stand-in for a cloud API (the reference's
    fake_multi_node provider pattern, node_provider.py:237, except these
    are REAL daemons over real TCP: the full demand → provision →
    `ray-tpu-torch start` → join → schedule loop runs end to end)."""

    KIND = "subproc"

    def _launch(self, address: str, resources: dict, labels: dict,
                type_config: dict) -> dict:
        import subprocess
        import sys

        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node_daemon"]
            + daemon_argv(address, resources, labels, type_config),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
        )
        return {"proc": proc}

    def _is_dead(self, info: dict) -> bool:
        return info["proc"].poll() is not None

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_id, None)
        if info is None:
            return
        proc = info["proc"]
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except Exception:
                proc.kill()


class SSHNodeProvider(_DaemonBackedProvider):
    """Provisions daemons on a static host pool over SSH — the on-prem /
    reserved-TPU-pod shape (reference: the cluster-YAML `provider` +
    `ray start` bootstrap in autoscaler/_private/command_runner.py).

    provider_config:
      worker_ips: ["10.0.0.2", ...]   hosts available for provisioning
      ssh_user:   "ubuntu"            (optional)
      ssh_key:    "~/.ssh/key.pem"    (optional)
      python:     "python3"           remote interpreter (optional)

    Each create_node leases the next free IP and starts the daemon there;
    terminate kills it remotely and returns the IP to the pool."""

    KIND = "ssh"

    def __init__(self, runtime, provider_config: Optional[dict] = None):
        super().__init__(runtime, provider_config)
        self._free_ips: list = list(self.provider_config.get("worker_ips", []))

    def _ssh_base(self, ip: str) -> list:
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes"]
        key = self.provider_config.get("ssh_key")
        if key:
            cmd += ["-i", key]
        user = self.provider_config.get("ssh_user")
        cmd.append(f"{user}@{ip}" if user else ip)
        return cmd

    def _launch(self, address: str, resources: dict, labels: dict,
                type_config: dict) -> dict:
        import shlex
        import subprocess

        with self._lock:
            if not self._free_ips:
                raise RuntimeError("SSH provider host pool exhausted")
            ip = self._free_ips.pop(0)
        python = self.provider_config.get("python", "python3")
        argv = daemon_argv(address, resources, labels, type_config)
        remote = (
            f"nohup {python} -m ray_tpu_torch._private.node_daemon "
            + " ".join(shlex.quote(a) for a in argv)
            + " >/tmp/ray-tpu-torch-daemon.log 2>&1 & echo $!"
        )
        out = subprocess.run(
            self._ssh_base(ip) + [remote],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return {"ip": ip, "remote_pid": out.stdout.strip()}

    JOIN_DEADLINE_S = 120.0

    def _is_dead(self, info: dict) -> bool:
        # Once joined, liveness is authoritative from the runtime (the
        # daemon fate-shares with its TCP connection); avoid an ssh per
        # poll. Before the first join, enforce a deadline: a daemon that
        # never connects (bad python path, firewall) must not leak its IP
        # from the pool forever while the autoscaler counts a phantom
        # pending node. Called with self._lock held — no locking here.
        if info.get("joined"):
            return False
        if self.runtime_node_id(info["pid"]) is not None:
            info["joined"] = True
            return False
        import time as _time

        deadline = float(
            self.provider_config.get("join_deadline_s", self.JOIN_DEADLINE_S)
        )
        return _time.monotonic() - info["launched_at"] > deadline

    def _on_dead(self, pid: str, info: dict) -> None:
        """A launch that never joined: kill the remote pid, reclaim the IP,
        record an autoscaler event."""
        self._remote_kill(info)
        with self._lock:
            self._free_ips.append(info["ip"])
        self._emit_event(
            f"ssh node {pid} on {info['ip']} never joined within its "
            f"deadline; killed remote pid {info['remote_pid']} and "
            f"reclaimed the IP"
        )

    def _remote_kill(self, info: dict) -> None:
        import subprocess

        try:
            subprocess.run(
                self._ssh_base(info["ip"])
                + [f"kill {info['remote_pid']} 2>/dev/null || true"],
                capture_output=True, timeout=60,
            )
        except Exception:
            # Best-effort: the daemon fate-shares with its head connection,
            # so an unreachable host's daemon dies when the head drops it.
            pass

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._nodes.pop(node_id, None)
        if info is None:
            return
        try:
            self._remote_kill(info)
        finally:
            with self._lock:
                self._free_ips.append(info["ip"])
