"""The port's dashboard, log plane and gauge history against the reference.

The counterparts of tests/test_logs_dashboard.py on ray_tpu_torch, with a
real `python -m ray_tpu_torch._private.node_daemon` joining the head; then
what this slice holds against the reference: every route's JSON keys for
the same state (a tiny GPT engine actor named `llm_engine:tiny` included,
on the CPU), `MetricsHistory`, the log buffer's cursor, the gauge suite's
names, and `include_dashboard=True` served on a free port.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ("/api/cluster", "/api/nodes", "/api/tasks", "/api/actors", "/api/objects",
          "/api/placement_groups", "/api/task_summary", "/api/logs", "/api/timeline",
          "/api/traces", "/api/metrics_history", "/api/llm", "/api/fleet", "/api/serve",
          "/api/train")


def _wait_for(predicate, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {msg}")


def _daemon_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def _reap(proc) -> None:
    """Wait for a daemon to exit (kill it after 30 s); a SIGKILLed one's
    pid-named segment is removed here."""
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


@pytest.fixture
def cluster():
    """Head (2 CPUs, no GPU) + one node daemon (4 CPUs, tagged nodeA),
    process isolation, dashboard on a free port."""
    runtime = ray_tpu_torch.init(
        num_cpus=2, num_gpus=0,
        _system_config={"isolation": "process", "worker_device": "cpu",
                        "include_dashboard": True, "dashboard_port": 0},
    )
    address = runtime.serve_clients(port=0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
         "--address", address, "--num-cpus", "4", "--resources", '{"nodeA": 1}',
         "--object-store-memory", str(64 << 20)],
        env=_daemon_env(), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    try:
        _wait_for(lambda: len(runtime.controller.alive_nodes()) == 2,
                  msg="daemon to register")
        yield runtime, address, proc
    finally:
        ray_tpu_torch.shutdown()
        _reap(proc)


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=30) as resp:
        assert resp.status == 200
        return json.loads(resp.read().decode())


def test_remote_worker_print_reaches_driver(cluster):
    runtime, _, _ = cluster

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    def chatty():
        print("hello-from-remote-worker")
        print("second-line", file=sys.stderr)
        return 1

    assert ray_tpu_torch.get(chatty.remote(), timeout=120) == 1
    _wait_for(lambda: any("hello-from-remote-worker" in row["line"]
                          for row in runtime.logs.tail()), msg="stdout line in log buffer")
    _wait_for(lambda: any(row["stream"] == "stderr" and "second-line" in row["line"]
                          for row in runtime.logs.tail()), msg="stderr line in log buffer")
    rows = [r for r in runtime.logs.tail() if "hello-from" in r["line"]]
    assert rows[0]["pid"] > 0
    assert rows[0]["hostname"] not in ("", "local")
    # The node filter finds it under the daemon's node id, and not the head's.
    node = rows[0]["node_id"]
    assert node != runtime.controller.head_node_id.hex()
    assert any("hello-from" in r["line"] for r in runtime.logs.tail(node_id=node))
    assert not any("hello-from" in r["line"]
                   for r in runtime.logs.tail(node_id=runtime.controller.head_node_id.hex()))


def test_local_process_worker_logs_captured():
    runtime = ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                                 _system_config={"isolation": "process"})
    try:
        @ray_tpu_torch.remote
        def speak():
            print("local-worker-speaks")
            return "ok"

        assert ray_tpu_torch.get(speak.remote(), timeout=120) == "ok"
        _wait_for(lambda: any("local-worker-speaks" in row["line"]
                              for row in runtime.logs.tail()),
                  msg="local worker line in buffer")
    finally:
        ray_tpu_torch.shutdown()


def test_dashboard_endpoints(cluster):
    """Every route answers over live state, and the daemon's node is listed
    with its resources, alive, then dead once its daemon is killed."""
    runtime, _, proc = cluster
    base = runtime.dashboard.url

    @ray_tpu_torch.remote
    class Counter:
        def bump(self):
            return 1

    counter = Counter.options(name="dash-counter").remote()
    assert ray_tpu_torch.get(counter.bump.remote(), timeout=120) == 1

    cluster_info = _get_json(f"{base}/api/cluster")
    assert cluster_info["alive_nodes"] == 2 and cluster_info["nodes"] == 2
    assert cluster_info["resources_total"]["nodeA"] == 1.0
    nodes = _get_json(f"{base}/api/nodes")
    assert len(nodes) == 2 and all(node["state"] == "ALIVE" for node in nodes)
    remote = [n for n in nodes if not n["is_head_node"]]
    assert len(remote) == 1
    assert remote[0]["resources_total"] == {"CPU": 4.0, "nodeA": 1.0}
    actors = _get_json(f"{base}/api/actors")
    assert any(a["name"] == "dash-counter" for a in actors)
    tasks = _get_json(f"{base}/api/tasks")
    assert any(t["name"].startswith("Counter") for t in tasks)
    assert _get_json(f"{base}/api/task_summary")
    assert isinstance(_get_json(f"{base}/api/timeline"), list)
    for route in ROUTES:
        _get_json(base + route)
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
        assert resp.status == 200
    with urllib.request.urlopen(base, timeout=10) as resp:
        assert "ray-tpu-torch dashboard" in resp.read().decode()
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/api/nonexistent", timeout=10)
    assert err.value.code == 404

    proc.kill()
    _wait_for(lambda: [n["state"] for n in _get_json(f"{base}/api/nodes")
                       if not n["is_head_node"]] == ["DEAD"], msg="the node listed dead")
    assert _get_json(f"{base}/api/cluster")["alive_nodes"] == 1


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_log_buffer_cursor_semantics(pkg):
    """The same appends give the same rows in both packages: the newest
    `limit`, and cursor paging that never skips a row; node, worker and pid
    filters."""
    from ray_tpu._private.log_aggregation import LogBuffer as JaxLogBuffer
    from ray_tpu_torch._private.log_aggregation import LogBuffer

    def fill(cls):
        buf = cls(capacity=100)
        for i in range(30):
            buf.append(node_id=f"n{i % 2}", hostname="h", wid=1 + i % 3, pid=9,
                       stream="stdout", lines=[f"line-{i}"])
        return buf

    buf, ref = fill(LogBuffer if pkg == "ray_tpu_torch" else JaxLogBuffer), fill(JaxLogBuffer)
    newest = buf.tail(limit=5)
    assert [r["line"] for r in newest] == [f"line-{i}" for i in range(25, 30)]
    seen, after = [], 0
    while rows := buf.tail(after_seq=after, limit=7):
        seen.extend(r["line"] for r in rows)
        after = rows[-1]["seq"]
    assert seen == [f"line-{i}" for i in range(30)]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ts"} for r in rows]
    for query in ({"limit": 4}, {"node_id": "n1", "limit": 6}, {"wid": 2},
                  {"pid": 9, "after_seq": 10, "limit": 5},
                  {"node_id": "n0", "wid": 3, "after_seq": 0}):
        assert strip(buf.tail(**query)) == strip(ref.tail(**query)), query


def test_logs_cli(cluster):
    """`python -m ray_tpu_torch.scripts.cli logs --address=...` polls the
    head's log buffer over the client protocol and prints attributed lines."""
    runtime, address, _ = cluster

    @ray_tpu_torch.remote(resources={"nodeA": 0.1})
    def talk():
        print("cli-visible-line")
        return 1

    assert ray_tpu_torch.get(talk.remote(), timeout=120) == 1
    _wait_for(lambda: any("cli-visible-line" in row["line"] for row in runtime.logs.tail()),
              msg="line in buffer")
    node = next(r["node_id"] for r in runtime.logs.tail() if "cli-visible" in r["line"])
    for extra in ((), ("--node-id", node)):
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "logs", "--address",
             address, *extra], capture_output=True, text=True, timeout=120,
            env=_daemon_env(), cwd=REPO)
        assert out.returncode == 0, out.stderr[-500:]
        assert "cli-visible-line" in out.stdout
        assert "node=" in out.stdout  # attribution prefix


def test_metrics_history_ring(cluster):
    """The gauge suite accumulates into a bounded ring served at
    /api/metrics_history, with since= filtering strictly newer samples."""
    runtime, _, _ = cluster
    base = runtime.dashboard.url
    from ray_tpu_torch.util.runtime_metrics import sample_runtime_metrics

    sampler = runtime._metrics_sampler
    for _ in range(3):
        sample_runtime_metrics(runtime)
        sampler.history.record()
    samples = _get_json(f"{base}/api/metrics_history")
    assert len(samples) >= 3
    last = samples[-1]
    assert "t" in last and isinstance(last["v"], dict)
    assert last["v"].get("nodes_alive") == 2.0
    assert last["v"].get("shm_objects") is not None
    newer = _get_json(f"{base}/api/metrics_history?since={last['t']}")
    assert all(s["t"] > last["t"] for s in newer)
    assert len(_get_json(f"{base}/api/metrics_history?limit=2")) == 2
    assert sampler.history._ring.maxlen == 720


# --------------------------------------------------- held against the reference

TINY = dict(vocab_size=128, num_layers=1, num_heads=2, embed_dim=32, max_seq_len=64)
ECFG = dict(block_size=8, num_blocks=32, max_decode_slots=2, max_blocks_per_seq=8,
            prefill_buckets=(8, 32))


def _engine_actor(pkg):
    """A tiny GPT LLMServer as the named engine actor the /api/llm and
    /api/fleet panels read (the port's on device="cpu")."""
    if pkg is ray_tpu:
        import jax.numpy as jnp

        from ray_tpu.llm import EngineConfig, LLMServer
        from ray_tpu.models.gpt import GPTConfig

        args = (GPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference"),
                EngineConfig(**ECFG))
        kwargs = {}
    else:
        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMServer
        from ray_tpu_torch.models import GPTConfig

        args = (GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference"),
                EngineConfig(**ECFG))
        kwargs = {"device": "cpu"}
    return pkg.remote(LLMServer).options(name="llm_engine:tiny", max_concurrency=4).remote(
        *args, **kwargs)


def _program(pkg):
    @pkg.remote
    def square(x):
        print("square", x)
        return x * x

    assert pkg.get([square.remote(i) for i in range(4)], timeout=120) == [0, 1, 4, 9]
    pg = pkg.util.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)
    engine = _engine_actor(pkg)
    out = pkg.get(engine.generate.remote([1, 2, 3, 4, 5], max_new_tokens=4), timeout=120)
    assert len(out["token_ids"]) == 4
    return pg, engine


HEX_ID = re.compile(r"[0-9a-f]{16,}")


def _shape(value, depth=0):
    """The JSON's structure: dict keys (recursively, three levels; an id
    inside a key masked), the last row of a list."""
    if depth > 2:
        return type(value).__name__
    if isinstance(value, dict):
        return {HEX_ID.sub("<id>", k): _shape(v, depth + 1) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(value[-1], depth + 1)] if value else []
    return "value"


def in_fresh_process(fn: str, *args):
    """This module's `fn(*args)` in a new interpreter (a test process may
    hold threads of an earlier test's runtime, a Serve router say, that
    would add tasks, actors and gauge series of their own), its JSON
    result."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import {mod} as m; "
            "print('RESULT ' + json.dumps(getattr(m, sys.argv[2])(*json.loads(sys.argv[3]))))"
            ).format(mod=os.path.splitext(os.path.basename(__file__))[0])
    proc = subprocess.run([sys.executable, "-c", code, here, fn, json.dumps(args)],
                          capture_output=True, text=True, timeout=240, env=_daemon_env())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


PKGS = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def route_shapes(name: str) -> dict:
    """The program on package `name` with its dashboard on a free port:
    each route's JSON structure and the ray_tpu_* gauge names of /metrics."""
    pkg = PKGS[name]
    rt = pkg.init(num_cpus=4, num_gpus=0, _system_config={
        "include_dashboard": True, "dashboard_port": 0})
    try:
        # The history holds the one sample taken below: a background tick
        # would add series that were live at its time.
        rt._metrics_sampler.stop()
        keep = _program(pkg)
        __import__(f"{name}.util.runtime_metrics", fromlist=["_"]).sample_runtime_metrics(rt)
        rt._metrics_sampler.history.record()
        base = rt.dashboard.url
        assert not base.endswith(":0")
        shapes = {r: _shape(_get_json(base + r)) for r in ROUTES}
        with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        gauges = sorted({line.split()[2] for line in text.splitlines()
                         if line.startswith("# TYPE ray_tpu_")})
        del keep
        return {"shapes": shapes, "gauges": gauges}
    finally:
        pkg.shutdown()


def test_route_keys_match_the_reference():
    """The same program on both packages, each with its dashboard on a free
    port: every route answers 200, and its JSON has the reference's keys;
    /metrics exposes the same ray_tpu_* gauge names."""
    got = {name: in_fresh_process("route_shapes", name) for name in PKGS}
    want, have = got["ray_tpu"]["shapes"], got["ray_tpu_torch"]["shapes"]
    # The engines' stats differ by one key: the port also reports the
    # engine's torch device. Both report the KV pools' layout (None at
    # tp=1).
    assert want["/api/llm"][0]["metrics"]["kv_pool_sharding"] == "NoneType"
    assert have["/api/llm"][0]["metrics"]["kv_pool_sharding"] == "NoneType"
    assert have["/api/llm"][0]["metrics"].pop("device") == "str"
    for route in ROUTES:
        assert have[route] == want[route], route
    assert have["/api/llm"] and have["/api/fleet"]["replicas"]
    assert got["ray_tpu_torch"]["gauges"] == got["ray_tpu"]["gauges"]
    assert "ray_tpu_shm_store_used_bytes" in got["ray_tpu_torch"]["gauges"]


def history_sample(name: str) -> dict:
    """MetricsHistory over package `name`'s runtime after three tasks: its
    bounds checked, the newest sample's values."""
    pkg = PKGS[name]
    rm = __import__(f"{name}.util.runtime_metrics", fromlist=["_"])
    rt = pkg.init(num_cpus=3, num_gpus=0)
    try:
        @pkg.remote
        def one():
            return 1

        refs = [one.remote() for _ in range(3)]  # held: three objects stored
        assert pkg.get(refs) == [1, 1, 1]
        sched = rt.scheduler
        _wait_for(lambda: not (sched._queue or sched._in_pass),
                  msg="the scheduler's pass to end")
        history = rm.MetricsHistory(max_samples=4)
        for _ in range(6):
            rm.sample_runtime_metrics(rt)
            history.record()
        snap = history.snapshot()
        assert len(snap) == 4 and snap == sorted(snap, key=lambda s: s["t"])
        assert len(history.snapshot(limit=2)) == 2
        assert all(s["t"] > snap[1]["t"] for s in history.snapshot(since=snap[1]["t"]))
        del refs
        return snap[-1]["v"]
    finally:
        pkg.shutdown()


def test_metrics_history_matches_the_reference():
    """MetricsHistory on the same runtime state: the same labels and
    values, bounded, newest last, `since` strictly newer."""
    samples = {name: in_fresh_process("history_sample", name) for name in PKGS}
    drop = ("object_store_used",)  # bytes of each side's pickles
    strip = lambda v: {k: x for k, x in v.items() if k not in drop}
    assert strip(samples["ray_tpu_torch"]) == strip(samples["ray_tpu"])
    assert samples["ray_tpu_torch"]["tasks:FINISHED"] == 3.0


def test_include_dashboard_accepted_and_port_zero_served():
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "include_dashboard": True, "dashboard_port": 0})
    try:
        assert rt.config.include_dashboard and rt.dashboard.port != 0
        url = rt.dashboard.url
        assert _get_json(url + "/api/cluster")["alive_nodes"] == 1
    finally:
        ray_tpu_torch.shutdown()
    assert rt.dashboard is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/api/cluster", timeout=5)
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        assert rt.dashboard is None  # off unless asked for
    finally:
        ray_tpu_torch.shutdown()
    np.testing.assert_equal(rt.config.dashboard_port, 8265)
