"""The port's multi-machine cluster: a head + node daemons as separate OS
processes.

Every case of tests/test_multinode.py but the two that form JAX meshes
across daemons (ROADMAP.md §B7), on ray_tpu_torch: each "node" is a real
`python -m ray_tpu_torch._private.node_daemon` process joining the head
over TCP, with its own shared-memory store, worker processes and object
server; localhost stands in for the network. The head runs
`worker_device="cpu"`, which the daemons pass on to their workers. Then
what the port adds: a 2-layer GPT served by an actor on a daemon,
token-identical to `ray_tpu.llm`'s engine on the same weights; a seeded
numpy array and a CPU tensor pulled across daemons and to the head, bit for
bit; a daemon asked for more store than /dev/shm holds stops before it
joins (ROADMAP.md §D27; a daemon that cannot build its store is
tests/test_torch_runtime.py's); and no worker under a daemon imports jax
or ray_tpu.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 120.0  # every get in this file has its own timeout


def _wait_for(predicate, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {msg}")


def _daemon_cmd(address: str, tag: str, *extra: str) -> list:
    return [sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
            "--address", address, "--num-cpus", "4",
            "--resources", '{"%s": 1}' % tag,
            "--object-store-memory", str(256 << 20), *extra]


def _daemon_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


@pytest.fixture
def cluster():
    """Head (2 CPUs) + two node daemons (4 CPUs each, tagged nodeA/nodeB)."""
    runtime = ray_tpu_torch.init(
        num_cpus=2, num_gpus=0,
        _system_config={"isolation": "process", "worker_device": "cpu"},
    )
    address = runtime.serve_clients(port=0)
    daemons = []
    for tag in ("nodeA", "nodeB"):
        proc = subprocess.Popen(
            _daemon_cmd(address, tag), env=_daemon_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        )
        daemons.append(proc)
    try:
        _wait_for(
            lambda: len(runtime.controller.alive_nodes()) == 3,
            msg="2 daemons to register",
        )
        yield runtime, daemons
    finally:
        # shutdown() tells the live daemons to go; they remove their stores.
        ray_tpu_torch.shutdown()
        for proc in daemons:
            _reap_daemon(proc)


def _reap_daemon(proc) -> None:
    """Wait for a daemon to exit (kill it after 30 s). A SIGKILLed daemon
    cannot remove its shm segment, which is named by its pid: remove it."""
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
    if proc.returncode == -9:
        try:
            os.remove(f"/dev/shm/ray_tpu_torch_node_{proc.pid}")
        except FileNotFoundError:
            pass


def test_tasks_run_on_remote_nodes(cluster):
    runtime, daemons = cluster

    @ray_tpu_torch.remote
    def whoami():
        return os.getpid(), os.getppid()

    a = ray_tpu_torch.get(whoami.options(resources={"nodeA": 0.1}).remote(), timeout=T)
    b = ray_tpu_torch.get(whoami.options(resources={"nodeB": 0.1}).remote(), timeout=T)
    daemon_pids = {p.pid for p in daemons}
    # Each task ran in a worker forked by the matching daemon, not the head.
    assert a[1] in daemon_pids and b[1] in daemon_pids
    assert a[1] != b[1]
    assert a[0] != os.getpid() and b[0] != os.getpid()


def test_cross_node_object_transfer(cluster):
    runtime, daemons = cluster

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    def produce():
        # Large enough to land in nodeA's local shm store (not the socket).
        return np.arange(1_000_000, dtype=np.float32)

    @ray_tpu_torch.remote(resources={"nodeB": 0.1})
    def consume(arr):
        return float(arr.sum())

    ref = produce.remote()
    # (a) another node pulls the bytes through the object plane
    assert ray_tpu_torch.get(consume.remote(ref), timeout=T) == float(
        np.arange(1_000_000, dtype=np.float32).sum()
    )
    # (b) the driver pulls them too
    arr = ray_tpu_torch.get(ref, timeout=T)
    assert arr.shape == (1_000_000,) and arr[-1] == 999_999.0


def test_small_values_roundtrip(cluster):
    runtime, daemons = cluster

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    def small():
        return {"answer": 42}

    assert ray_tpu_torch.get(small.remote(), timeout=T) == {"answer": 42}


def test_remote_actor(cluster):
    runtime, daemons = cluster

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0
            self.pid = os.getpid()

        def add(self, k):
            self.n += k
            return self.n

        def where(self):
            return self.pid, os.getppid()

    c = Counter.options(resources={"nodeB": 0.1}).remote()
    assert ray_tpu_torch.get(
        [c.add.remote(1), c.add.remote(2), c.add.remote(3)], timeout=T
    ) == [1, 3, 6]
    pid, ppid = ray_tpu_torch.get(c.where.remote(), timeout=T)
    assert ppid in {p.pid for p in daemons}


def test_object_passed_from_head_to_remote_worker(cluster):
    runtime, daemons = cluster
    big = ray_tpu_torch.put(np.ones(500_000, dtype=np.float64))

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    def total(arr):
        return float(arr.sum())

    assert ray_tpu_torch.get(total.remote(big), timeout=T) == 500_000.0


def _node_id_with_resource(runtime, name: str):
    for node in runtime.controller.alive_nodes():
        if name in node.total:
            return node.node_id
    raise AssertionError(f"no node with resource {name}")


def test_node_death_object_recovery(cluster):
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    runtime, daemons = cluster
    node_a = _node_id_with_resource(runtime, "nodeA")

    @ray_tpu_torch.remote(max_retries=2)
    def produce():
        return np.full(300_000, 7.0)

    # Soft affinity: first attempt lands on nodeA; the recovery re-execution
    # falls back to any surviving node once nodeA is gone.
    ref = produce.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=node_a.hex(), soft=True
        )
    ).remote()
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
    assert ready  # sealed on nodeA; bytes NOT pulled to the head yet
    assert runtime.store.location_of(ref.id) == node_a
    daemons[0].kill()
    _wait_for(
        lambda: len(runtime.controller.alive_nodes()) == 2,
        msg="node death detected",
    )
    # The only copy died with the node: this get must re-execute the
    # producer from lineage on a surviving node.
    arr = ray_tpu_torch.get(ref, timeout=T)
    assert float(arr[0]) == 7.0 and arr.shape == (300_000,)


def test_actor_restart_after_node_death(cluster):
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    runtime, daemons = cluster
    node_a = _node_id_with_resource(runtime, "nodeA")

    @ray_tpu_torch.remote(max_restarts=1, max_task_retries=1)
    class Svc:
        def where(self):
            return os.getppid()

    s = Svc.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=node_a.hex(), soft=True
        )
    ).remote()
    first = ray_tpu_torch.get(s.where.remote(), timeout=T)
    assert first == daemons[0].pid
    daemons[0].kill()
    _wait_for(
        lambda: len(runtime.controller.alive_nodes()) == 2,
        msg="node death detected",
    )
    # max_restarts=1: the actor comes back on a surviving node.
    second = ray_tpu_torch.get(s.where.remote(), timeout=T)
    assert second != first


def test_streaming_pull_large_object(cluster):
    """A multi-MB object crosses nodes through the streaming path: the
    producer's shm view is sent without a heap copy and the puller recv()s
    straight into a created shm allocation (bounded memory on both ends)."""
    runtime, daemons = cluster

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    def produce():
        return np.arange(8 << 20, dtype=np.uint8)  # 8 MB, well over threshold

    @ray_tpu_torch.remote(resources={"nodeB": 0.1})
    def check(arr):
        return int(arr[0]), int(arr[123456]), int(arr[-1]), arr.nbytes

    ref = produce.remote()
    first, mid, last, nbytes = ray_tpu_torch.get(check.remote(ref), timeout=T)
    expect = np.arange(8 << 20, dtype=np.uint8)
    assert (first, mid, last) == (int(expect[0]), int(expect[123456]), int(expect[-1]))
    assert nbytes == 8 << 20


def test_cached_copy_survives_producer_death(cluster):
    """After nodeB pulls an object produced on nodeA, the head learns of the
    cached copy (object_cached); killing nodeA must NOT force lineage
    re-execution — the driver's get is served from nodeB's cache."""
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    runtime, daemons = cluster
    node_a = _node_id_with_resource(runtime, "nodeA")

    @ray_tpu_torch.remote(max_retries=2)
    def produce():
        return np.full(2 << 20, 3, dtype=np.uint8)  # 2 MB

    @ray_tpu_torch.remote(resources={"nodeB": 0.1})
    def reader(arr):
        return int(arr[0])

    ref = produce.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=node_a.hex(), soft=True
        )
    ).remote()
    assert ray_tpu_torch.get(reader.remote(ref), timeout=T) == 3  # nodeB holds a copy
    node_b = _node_id_with_resource(runtime, "nodeB")
    _wait_for(
        lambda: node_b in runtime.store.locations_of(ref.id),
        msg="cached location recorded on the head",
    )
    daemons[0].kill()
    _wait_for(
        lambda: len(runtime.controller.alive_nodes()) == 2,
        msg="node death detected",
    )
    arr = ray_tpu_torch.get(ref, timeout=T)  # served from nodeB's cached copy
    assert int(arr[0]) == 3 and arr.nbytes == 2 << 20


def test_chaos_daemon_kills_during_task_storm(cluster):
    """200 retriable tasks flood both daemons while one is SIGKILLed
    mid-storm. Everything must still complete correctly — dispatched tasks
    retry, node-resident results recover via lineage, and the cluster ends
    consistent."""
    import threading as _threading

    runtime, daemons = cluster

    @ray_tpu_torch.remote(max_retries=5)
    def work(i):
        time.sleep(0.01)
        return i * 3

    refs = [work.remote(i) for i in range(200)]

    def _chaos():
        time.sleep(0.5)
        daemons[0].kill()

    killer = _threading.Thread(target=_chaos, daemon=True)
    killer.start()
    results = ray_tpu_torch.get(refs, timeout=180)
    assert results == [i * 3 for i in range(200)]
    _wait_for(
        lambda: len(runtime.controller.alive_nodes()) == 2,
        msg="node death detected",
    )
    # The cluster still works after the chaos.
    assert ray_tpu_torch.get(work.remote(1000), timeout=T) == 3000


# -- what the port adds ------------------------------------------------------


def test_seeded_values_cross_daemons_bit_for_bit(cluster):
    """A seeded numpy array and a CPU tensor, each over the store's
    threshold, produced on nodeA: nodeB's worker pulls them through the
    object plane into its store, and the head pulls them after; every copy
    equal bit for bit to the same values made here (tolerance: none)."""
    import torch

    runtime, daemons = cluster

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    def make(kind):
        import numpy
        import torch

        arr = numpy.random.RandomState(23).standard_normal(400_000).astype("float32")
        return arr if kind == "numpy" else torch.from_numpy(arr.copy()).double()

    @ray_tpu_torch.remote(resources={"nodeB": 0.1})
    def echo_bytes(value):
        import os

        raw = value.numpy().tobytes() if hasattr(value, "numpy") else value.tobytes()
        return os.getppid(), raw

    want = np.random.RandomState(23).standard_normal(400_000).astype(np.float32)
    want_t = torch.from_numpy(want.copy()).double()
    for kind, expect in (("numpy", want.tobytes()), ("torch", want_t.numpy().tobytes())):
        ref = make.remote(kind)
        ppid, raw = ray_tpu_torch.get(echo_bytes.remote(ref), timeout=T)
        assert ppid == daemons[1].pid
        assert raw == expect
        here = ray_tpu_torch.get(ref, timeout=T)
        if kind == "numpy":
            assert isinstance(here, np.ndarray) and here.tobytes() == expect
        else:
            assert isinstance(here, torch.Tensor) and here.dtype == torch.float64
            assert here.numpy().tobytes() == expect


def test_tiny_gpt_on_a_daemon_matches_the_reference(cluster):
    """A 2-layer GPT of width 64 served by an actor on nodeA, on
    device="cpu", its weights the reference's carried across
    (models.params_from_flax): greedy tokens identical to ray_tpu.llm's for
    the same prompts (tolerance: none)."""
    import jax
    import jax.numpy as jnp
    import torch
    from flax.linen import meta

    from ray_tpu.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.llm import LLMEngine as JaxLLMEngine
    from ray_tpu.models.gpt import GPT as JaxGPT
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from ray_tpu_torch.models import GPTConfig, params_from_flax

    runtime, daemons = cluster
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

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    class Server:
        def __init__(self, cfg, ecfg, state):
            import torch

            from ray_tpu_torch.llm import EngineConfig, LLMServer

            torch.set_num_threads(1)
            self.server = LLMServer(cfg, EngineConfig(**ecfg), params=state,
                                    device="cpu", warmup=False)

        def generate(self, prompt, n):
            return os.getppid(), self.server.generate(prompt, max_new_tokens=n)["token_ids"]

    server = Server.remote(port_cfg, ecfg, params_from_flax(tree))
    got = [ray_tpu_torch.get(server.generate.remote(p, 5), timeout=T) for p in prompts]
    assert {ppid for ppid, _ in got} == {daemons[0].pid}
    assert [toks for _, toks in got] == want


def test_daemon_workers_import_no_jax_or_ray_tpu(cluster):
    """A task under a port daemon runs in a process that has neither jax nor
    anything of ray_tpu in sys.modules."""
    runtime, daemons = cluster

    @ray_tpu_torch.remote(resources={"nodeB": 0.1})
    def leaked():
        import sys

        return os.getppid(), sorted(
            m for m in sys.modules
            if m in ("jax", "jaxlib", "flax", "ray_tpu")
            or m.startswith(("jax.", "jaxlib.", "flax.", "ray_tpu."))
        )

    ppid, names = ray_tpu_torch.get(leaked.remote(), timeout=T)
    assert ppid == daemons[1].pid
    assert names == []


def _daemon_refused(env: dict, *extra: str) -> str:
    """Start a daemon against a head that never hears from it; returns its
    output after it exits non-zero."""
    runtime = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        address = runtime.serve_clients(port=0)
        proc = subprocess.run(_daemon_cmd(address, "doomed", *extra), env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode != 0, proc.stdout + proc.stderr
        assert len(runtime.controller.alive_nodes()) == 1  # never joined
        return proc.stdout + proc.stderr
    finally:
        ray_tpu_torch.shutdown()


def test_daemon_refuses_more_store_than_dev_shm_holds():
    """§D27: every store of the machine draws on the same /dev/shm, so an
    explicit --object-store-memory past its free bytes stops the daemon
    before it joins, naming both figures, instead of capping it (§D25)."""
    from ray_tpu_torch._private.native_store import shm_free_bytes

    free = shm_free_bytes()
    assert free is not None
    ask = 4 * free
    # The last --object-store-memory on the line wins (argparse).
    out = _daemon_refused(_daemon_env(), "--object-store-memory", str(ask))
    assert f"--object-store-memory {ask} bytes" in out and "free" in out


def test_idle_daemon_keeps_its_connection(monkeypatch):
    """§D29: the dial's timeout bounds the dial and the welcome only. A
    head that sends nothing for several times that timeout (its node's
    workers busy, or none) keeps the same node: the daemon neither reads
    the silence as a lost head nor re-registers. The reference's daemon
    keeps the timeout on the socket and, with no reconnect window, shuts
    down here. The daemon runs in this process, its dial timeout cut."""
    import threading

    from ray_tpu_torch._private import node_daemon

    monkeypatch.setattr(node_daemon, "CONNECT_TIMEOUT_S", 0.5)
    runtime = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "isolation": "process", "worker_device": "cpu"})
    daemon = None
    try:
        address = runtime.serve_clients(port=0)
        daemon = node_daemon.NodeDaemon(address, resources={"CPU": 1, "idle": 1},
                                        object_store_memory=64 << 20,
                                        reconnect_window_s=0)

        def serve():
            try:
                daemon.run_forever()
            except SystemExit:
                daemon.shutdown()

        thread = threading.Thread(target=serve, daemon=True)
        thread.start()
        _wait_for(lambda: len(runtime.controller.alive_nodes()) == 2, msg="the daemon")
        (node,) = [n for n in runtime.controller.alive_nodes() if "idle" in n.total]
        time.sleep(2.0)  # four dial timeouts without a frame from the head
        assert thread.is_alive()
        assert [n.node_id for n in runtime.controller.alive_nodes()
                if "idle" in n.total] == [node.node_id]

        @ray_tpu_torch.remote(resources={"idle": 1})
        def parent():
            return os.getppid()

        assert ray_tpu_torch.get(parent.remote(), timeout=T) == os.getpid()
    finally:
        ray_tpu_torch.shutdown()
        if daemon is not None:
            thread.join(timeout=30)
            assert not thread.is_alive()
