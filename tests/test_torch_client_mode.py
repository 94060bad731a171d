"""The port's remote-driver client mode over the TCP control plane
(reference: python/ray/util/client/ — the `ray://` proxy for remote
interactive drivers). The client process holds no runtime: every API call
rides the wire protocol to the head.

Every case of tests/test_client_mode.py, on ray_tpu_torch; then what the
port adds: an RPC error reaches the client as its own exception (the
reference's client raises KeyError, ROADMAP.md §D28), a client process
imports neither jax nor ray_tpu, `init(address=...)` refuses the
arguments that only start a local runtime, and a worker's output lines
reach the remote driver.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


@pytest.fixture
def head():
    runtime = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    address = runtime.serve_clients(port=0)
    yield runtime, address
    ray_tpu_torch.shutdown()


CLIENT_SCRIPT = textwrap.dedent(
    """
    import sys
    import ray_tpu_torch

    ray_tpu_torch.init(address=sys.argv[1])

    @ray_tpu_torch.remote
    def square(x):
        return x * x

    assert ray_tpu_torch.get(square.remote(7)) == 49

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

    c = Counter.remote()
    assert ray_tpu_torch.get([c.add.remote(1), c.add.remote(2)]) == [1, 3]

    ref = ray_tpu_torch.put({"weights": [1.0, 2.0]})
    assert ray_tpu_torch.get(ref)["weights"] == [1.0, 2.0]

    ready, pending = ray_tpu_torch.wait([square.remote(3)], num_returns=1, timeout=10)
    assert len(ready) == 1 and not pending

    # streaming across the TCP boundary
    @ray_tpu_torch.remote
    def gen(n):
        for i in range(n):
            yield i * 10

    items = [ray_tpu_torch.get(r)
             for r in gen.options(num_returns="streaming").remote(3)]
    assert items == [0, 10, 20]

    # named actor registered by the head-side driver
    h = ray_tpu_torch.get_actor("head_registry")
    assert ray_tpu_torch.get(h.whoami.remote()) == "head"

    # an RPC that fails on the head raises its own error here
    from ray_tpu_torch.exceptions import GetTimeoutError

    @ray_tpu_torch.remote
    def slow():
        import time
        time.sleep(30)

    try:
        ray_tpu_torch.get(slow.remote(), timeout=0.2)
        raise AssertionError("no timeout")
    except GetTimeoutError:
        pass

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "ray_tpu"))
    assert not leaked, leaked
    ray_tpu_torch.shutdown()
    print("CLIENT_OK")
    """
)


def test_remote_driver_full_api(head):
    runtime, address = head

    @ray_tpu_torch.remote
    class Registry:
        def whoami(self):
            return "head"

    Registry.options(name="head_registry").remote()

    proc = subprocess.run(
        [sys.executable, "-c", CLIENT_SCRIPT, address],
        capture_output=True,
        text=True,
        timeout=120,
        env=_env(),
    )
    assert proc.returncode == 0, proc.stderr
    assert "CLIENT_OK" in proc.stdout


def test_wrong_token_refused(head, monkeypatch):
    """The head must refuse an unauthenticated peer before unpickling
    anything it sends (the wire protocol is code execution by design)."""
    from ray_tpu_torch._private import head_server
    from ray_tpu_torch._private.client import ClientCore

    monkeypatch.setattr(head_server, "HANDSHAKE_TIMEOUT_S", 1.0)
    runtime, address = head
    host_port = address.partition("?")[0]
    assert "?token=" in address  # credentials ride in the address
    with pytest.raises(ConnectionError):
        ClientCore(host_port + "?token=" + "0" * 32, timeout=10.0)
    # missing token entirely is also refused (server times the peer out)
    monkeypatch.delenv("RAY_TPU_TORCH_CLIENT_TOKEN", raising=False)
    with pytest.raises(ConnectionError):
        ClientCore(host_port, timeout=10.0)


def test_client_disconnect_releases_borrows(head):
    runtime, address = head
    script = textwrap.dedent(
        """
        import sys
        import ray_tpu_torch

        ray_tpu_torch.init(address=sys.argv[1])
        ref = ray_tpu_torch.put(list(range(1000)))
        print(ref.hex(), flush=True)
        import os
        os._exit(0)  # die without shutdown: head must drop our borrows
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script, address],
        capture_output=True,
        text=True,
        timeout=60,
        env=_env(),
    )
    assert proc.returncode == 0, proc.stderr
    oid_hex = proc.stdout.strip().splitlines()[-1]
    from ray_tpu_torch._private.ids import ObjectID

    oid = ObjectID.from_hex(oid_hex)
    import time

    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        local, submitted = runtime.refcount.counts(oid)
        if local == 0 and submitted == 0:
            break
        time.sleep(0.1)
    assert runtime.refcount.counts(oid) == (0, 0)


def test_address_refuses_local_only_arguments():
    """init(address=...) connects to an existing head: the arguments that
    only start a local runtime are refused, as in the reference."""
    for kwargs in ({"num_cpus": 1}, {"num_gpus": 1}, {"resources": {"x": 1}},
                   {"client_server_port": 0}, {"_system_config": {}}):
        with pytest.raises(ValueError, match="only apply when starting a local"):
            ray_tpu_torch.init(address="127.0.0.1:1", **kwargs)
        assert not ray_tpu_torch.is_initialized()


LOG_CLIENT = textwrap.dedent(
    """
    import os, sys, threading
    import ray_tpu_torch
    from ray_tpu_torch._private import log_aggregation

    marker = f"client log marker {os.getpid()}"
    pushed = threading.Event()
    seen = {}
    reprint = log_aggregation.print_batch_to_driver

    def watch(batch, file=None):
        reprint(batch, file)
        if marker in batch["lines"]:
            seen.update(batch)
            pushed.set()

    log_aggregation.print_batch_to_driver = watch
    ray_tpu_torch.init(address=sys.argv[1])

    @ray_tpu_torch.remote
    def shout(text):
        print(text, flush=True)
        return os.getpid()

    pid = ray_tpu_torch.get(shout.remote(marker), timeout=60)
    assert pushed.wait(30), "the worker's line never reached this driver"
    assert seen["pid"] == pid and seen["stream"] == "stdout", seen
    ray_tpu_torch.shutdown()
    print("LOG_OK", pid)
    """
)


def test_worker_lines_reach_the_remote_driver():
    """The head fans every worker log batch out to its connected remote
    drivers (head_server.py's log push), which reprint it behind the
    `(worker pid=..., node=...)` prefix."""
    runtime = ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                                 _system_config={"isolation": "process"})
    try:
        address = runtime.serve_clients(port=0)
        proc = subprocess.run([sys.executable, "-c", LOG_CLIENT, address],
                              capture_output=True, text=True, timeout=120, env=_env())
        assert proc.returncode == 0, proc.stderr
        pid = int(proc.stdout.strip().splitlines()[-1].split()[1])
        assert f"(worker pid={pid}, node=local)" in proc.stdout
    finally:
        ray_tpu_torch.shutdown()
