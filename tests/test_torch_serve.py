"""The port's Serve library against the reference's.

Each test runs one small Serve program twice, once on `ray_tpu` and once on
`ray_tpu_torch`, each package through its own public API (both runtimes up
at once), and compares the results exactly: both sides compute the same
Python values. `ray_tpu` is the oracle. Every program runs under a time
limit, and no assertion rests on a sleep being long enough: programs wait
on events, barriers or polled conditions with a deadline.
"""

import json
import sys
import textwrap
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu._private import fault_injection as jax_fi
from ray_tpu.serve import batching as jax_batching
from ray_tpu.serve import multiplex as jax_multiplex
from ray_tpu.serve._private import controller as jax_controller
from ray_tpu.serve._private import http_proxy as jax_proxy
from ray_tpu.serve._private import replica as jax_replica
from ray_tpu_torch import serve as port_serve
from ray_tpu_torch._private import fault_injection as port_fi
from ray_tpu_torch.serve import batching as port_batching
from ray_tpu_torch.serve import multiplex as port_multiplex
from ray_tpu_torch.serve._private import controller as port_controller
from ray_tpu_torch.serve._private import http_proxy as port_proxy
from ray_tpu_torch.serve._private import replica as port_replica

# Each program's limit: the whole of one package's run of a test.
LIMIT_S = 60.0

PKGS = {
    "ray_tpu": types.SimpleNamespace(
        name="ray_tpu", rt=ray_tpu, serve=jax_serve, fi=jax_fi,
        exceptions=ray_tpu.exceptions, batching=jax_batching,
        multiplex=jax_multiplex, controller=jax_controller,
        proxy=jax_proxy, replica=jax_replica,
    ),
    "ray_tpu_torch": types.SimpleNamespace(
        name="ray_tpu_torch", rt=ray_tpu_torch, serve=port_serve, fi=port_fi,
        exceptions=ray_tpu_torch.exceptions, batching=port_batching,
        multiplex=port_multiplex, controller=port_controller,
        proxy=port_proxy, replica=port_replica,
    ),
}


def _within(limit_s, fn, *args):
    """fn(*args) on a daemon thread; fails the test if it outlives the
    limit (a hung socket or replica must not hang the suite)."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit_s)
    assert not t.is_alive(), f"{getattr(fn, '__name__', fn)} ran past {limit_s}s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _compare(program, pkgs, limit_s=LIMIT_S):
    got = {name: _within(limit_s, program, pkg) for name, pkg in pkgs.items()}
    assert got["ray_tpu_torch"] == got["ray_tpu"], got
    return got["ray_tpu_torch"]


@pytest.fixture
def both():
    """Both runtimes up at once; Serve and the runtime shut down after."""
    for pkg in PKGS.values():
        pkg.rt.init(num_cpus=8, num_gpus=0)
        pkg.fi.clear()
    yield PKGS
    for pkg in PKGS.values():
        pkg.fi.clear()
        pkg.proxy.stop_proxy()
        pkg.serve.shutdown()
        pkg.rt.shutdown()


def _wait_for(cond, timeout_s=20.0, period_s=0.05):
    """Poll cond() until it returns a truthy value or the deadline passes;
    returns the last value."""
    deadline = time.monotonic() + timeout_s
    value = cond()
    while not value and time.monotonic() < deadline:
        time.sleep(period_s)
        value = cond()
    return value


def _post(host, port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://{host}:{port}/{path}", data=json.dumps(payload).encode(),
        headers=dict(headers or {}, **{"Content-Type": "application/json"}),
    )
    return urllib.request.urlopen(req, timeout=30)


# ---------------------------------------------------------------- deployments


def test_function_deployment(both):
    def program(pkg):
        @pkg.serve.deployment
        def echo(x):
            return {"echo": x}

        handle = pkg.serve.run(echo.bind())
        return handle.remote("hi").result(timeout_s=30)

    assert _compare(program, both) == {"echo": "hi"}


def test_class_deployment_and_methods(both):
    def program(pkg):
        @pkg.serve.deployment
        class Counter:
            def __init__(self, start):
                self.count = start

            def __call__(self, inc):
                self.count += inc
                return self.count

            def peek(self):
                return self.count

        handle = pkg.serve.run(Counter.bind(10))
        return handle.remote(5).result(timeout_s=30), handle.peek.remote().result(
            timeout_s=30)

    assert _compare(program, both) == (15, 15)


def test_multi_replica_round_robin(both):
    def program(pkg):
        @pkg.serve.deployment(num_replicas=3)
        class WhoAmI:
            def __init__(self):
                self.id = id(self)

            def __call__(self, _):
                return self.id

        handle = pkg.serve.run(WhoAmI.bind())
        return len({handle.remote(None).result(timeout_s=30) for _ in range(30)})

    assert _compare(program, both) == 3


def test_composed_deployments(both):
    def program(pkg):
        @pkg.serve.deployment
        class Downstream:
            def __call__(self, x):
                return x * 2

        @pkg.serve.deployment
        class Ingress:
            def __init__(self, downstream):
                self.downstream = downstream

            def __call__(self, x):
                return self.downstream.remote(x).result(timeout_s=30) + 1

        handle = pkg.serve.run(Ingress.bind(Downstream.bind()))
        return handle.remote(10).result(timeout_s=30)

    assert _compare(program, both) == 21


def test_user_config_reconfigure(both):
    """Same code, new user_config: the live replica is reconfigured in
    place (polled until the push lands)."""
    def program(pkg):
        @pkg.serve.deployment(user_config={"threshold": 1})
        class Model:
            def __init__(self):
                self.threshold = None

            def reconfigure(self, config):
                self.threshold = config["threshold"]

            def __call__(self, _):
                return self.threshold

        handle = pkg.serve.run(Model.bind())
        first = handle.remote(None).result(timeout_s=30)
        pkg.serve.run(Model.options(user_config={"threshold": 7}).bind())
        _wait_for(lambda: handle.remote(None).result(timeout_s=30) == 7)
        return first, handle.remote(None).result(timeout_s=30)

    assert _compare(program, both) == (1, 7)


def test_status_and_shutdown(both):
    def program(pkg):
        @pkg.serve.deployment
        def f(x):
            return x

        pkg.serve.run(f.bind(), name="app1")
        before = pkg.serve.status()["app1"]["f"]
        pkg.serve.shutdown()
        # A fresh controller comes up empty.
        return before["status"], before["num_replicas"], pkg.serve.status()

    assert _compare(program, both) == ("HEALTHY", 1, {})


def test_graceful_shutdown_hook_runs(both):
    """The replica's shutdown hook runs before it is killed. The hook sets
    an event, and the shutdown timeout is long enough that the stop
    thread always waits for the hook (no file, no sleep)."""
    def program(pkg):
        ran = threading.Event()

        @pkg.serve.deployment
        class WithCleanup:
            def __call__(self, _):
                return 1

            def shutdown(self):
                ran.set()

        pkg.serve.run(
            WithCleanup.options(graceful_shutdown_timeout_s=30.0).bind()
        ).remote(None).result(timeout_s=30)
        pkg.serve.shutdown()
        return ran.wait(30.0)

    assert _compare(program, both) is True


def test_replica_health_check_replaces_unhealthy(both):
    """A replica whose check_health turns False is killed and replaced by
    reconciliation; the replacement reports healthy."""
    def program(pkg):
        @pkg.serve.deployment
        class Flaky:
            def __init__(self):
                import uuid

                self.healthy = True
                # Not id(self): the replacement can be allocated at the
                # freed replica's address and so return the same id.
                self.id = uuid.uuid4().hex

            def poison(self):
                self.healthy = False
                return "poisoned"

            def check_health(self):
                return self.healthy

            def whoami(self):
                return self.id

            def __call__(self):
                return "ok"

        handle = pkg.serve.run(
            Flaky.options(num_replicas=1, health_check_period_s=0.2).bind(),
            name="flaky",
        )
        first = handle.whoami.remote().result(timeout_s=30)
        poisoned = handle.poison.remote().result(timeout_s=30)

        def replaced():
            st = pkg.serve.status()["flaky"]["Flaky"]
            if st["status"] != "HEALTHY" or st["num_replicas"] != 1:
                return False
            try:
                return handle.whoami.remote().result(timeout_s=5) != first
            except Exception:
                return False  # raced the replacement

        return poisoned, bool(_wait_for(replaced, 30.0, 0.1)), (
            handle.check_health.remote().result(timeout_s=10))

    assert _compare(program, both) == ("poisoned", True, True)


def test_declarative_config_apply(both, tmp_path):
    """Applications by import path with per-deployment overrides, and the
    three loud refusals."""
    for pkg in both.values():
        (tmp_path / f"cfg_app_{pkg.name}.py").write_text(textwrap.dedent(f"""
            from {pkg.name} import serve

            @serve.deployment
            class Echo:
                def __init__(self, prefix="e"):
                    self.prefix = prefix
                    self.tag = "default"

                def reconfigure(self, user_config):
                    self.tag = user_config.get("tag", "default")

                def __call__(self, x):
                    return f"{{self.prefix}}:{{x}}:{{self.tag}}"

            app = Echo.bind("cfg")

            def build_app(prefix="built"):
                return Echo.bind(prefix)
            """))

    def program(pkg):
        mod = f"cfg_app_{pkg.name}"
        handles = pkg.serve.schema.apply({"applications": [
            {"name": "echo-app", "import_path": f"{mod}:app",
             "deployments": [{"name": "Echo", "num_replicas": 2,
                              "user_config": {"tag": "from-config"}}]},
            {"name": "built-app", "import_path": f"{mod}:build_app",
             "args": {"prefix": "B"}},
        ]})
        out = [handles["echo-app"].remote("hi").result(timeout_s=30),
               handles["built-app"].remote("yo").result(timeout_s=30)]
        for bad in (
            {"applications": [{"name": "x", "import_path": f"{mod}:app",
                               "deployments": [{"name": "Nope", "num_replicas": 1}]}]},
            {"applications": [{"name": "y", "import_path": f"{mod}:app",
                               "args": {"prefix": "Z"}}]},
            {"applications": [{"import_path": f"{mod}:app"},
                              {"import_path": f"{mod}:app"}]},
        ):
            try:
                pkg.serve.schema.apply(bad)
                out.append(None)
            except ValueError as exc:
                out.append(str(exc).replace(pkg.name, "<pkg>"))
        # Overrides never leak into the module-level Application.
        out.append(sys.modules[mod].app.deployment._config.num_replicas)
        return out

    sys.path.insert(0, str(tmp_path))
    try:
        out = _compare(program, both)
    finally:
        sys.path.remove(str(tmp_path))
        for pkg in both.values():
            sys.modules.pop(f"cfg_app_{pkg.name}", None)
    assert out[:2] == ["cfg:hi:from-config", "B:yo:default"]
    assert "unknown deployment" in out[2]
    assert "already bound" in out[3]
    assert "Duplicate" in out[4]
    assert out[5] == 1


# ---------------------------------------------------------------- batching


def test_batching_deployment(both):
    def program(pkg):
        @pkg.serve.deployment(max_concurrent_queries=32)
        class Batched:
            @pkg.serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
            def __call__(self, items):
                return [x + 1 for x in items]

        handle = pkg.serve.run(Batched.bind())
        responses = [handle.remote(i) for i in range(8)]
        return sorted(r.result(timeout_s=30) for r in responses)

    assert _compare(program, both) == list(range(1, 9))


def _fire(fn, args, catch=()):
    """Call fn(arg) from one thread per arg, all released together;
    returns the results (or caught exceptions' strings) in arg order."""
    out = [None] * len(args)
    gate = threading.Barrier(len(args))

    def run(i):
        gate.wait(10)
        try:
            out[i] = fn(args[i])
        except catch as exc:
            out[i] = f"{type(exc).__name__}: {exc}"

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return out


def test_batch_pad_to_bucket():
    def program(pkg):
        calls = []

        @pkg.serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05,
                         pad_to_bucket=True)
        def process(items):
            calls.append(len(items))
            return [x * 2 for x in items]

        buckets = [pkg.batching._next_bucket(n, 8) for n in (1, 3, 5, 8, 9)]
        out = _fire(process, [0, 1, 2])
        return buckets, out, all(c in (1, 2, 4, 8) for c in calls)

    assert _compare(program, PKGS) == ([1, 4, 8, 8, 8], [0, 2, 4], True)


def test_batch_exactly_max_batch_size():
    """A full batch flushes on the size trigger (the 60 s timer would
    outlive the program's limit), is never padded past the cap, and fans
    every result back out."""
    def program(pkg):
        calls = []

        @pkg.serve.batch(max_batch_size=4, batch_wait_timeout_s=60.0,
                         pad_to_bucket=True)
        def process(items):
            calls.append(len(items))
            return [x * 10 for x in items]

        out = _fire(process, [0, 1, 2, 3])
        return out, max(calls) <= 4

    assert _compare(program, PKGS, limit_s=30) == ([0, 10, 20, 30], True)


def test_batch_of_one_pads_to_bucket_of_one():
    def program(pkg):
        calls = []

        @pkg.serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05,
                         pad_to_bucket=True)
        def process(items):
            calls.append(len(items))
            return [x + 100 for x in items]

        return process(7), calls

    assert _compare(program, PKGS) == (107, [1])


def test_batch_error_fans_out_to_all_waiters():
    def program(pkg):
        attempts = []

        @pkg.serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def explode(items):
            attempts.append(len(items))
            raise RuntimeError("batch failed")

        out = _fire(explode, [0, 1, 2], catch=(RuntimeError,))
        return out, sum(attempts)

    assert _compare(program, PKGS) == (["RuntimeError: batch failed"] * 3, 3)


def test_batch_wrong_result_count_raises_for_all():
    def program(pkg):
        @pkg.serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def short_changed(items):
            return items[:-1]  # one result missing

        out = _fire(short_changed, [0, 1], catch=(ValueError,))
        return [o.startswith("ValueError") and "results" in o for o in out]

    assert _compare(program, PKGS) == [True, True]


# ---------------------------------------------------------------- multiplex


def test_model_multiplexing(both):
    def program(pkg):
        serve = pkg.serve

        @serve.deployment(num_replicas=2)
        class MultiModel:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return {"id": model_id, "scale": int(model_id.split("-")[1])}

            def __call__(self, x):
                model = self.get_model()
                return x * model["scale"], serve.get_multiplexed_model_id()

        handle = serve.run(MultiModel.bind(), name="mux")
        return [
            tuple(handle.options(multiplexed_model_id=mid).remote(5).result(
                timeout_s=30))
            for mid in ("m-2", "m-3", "m-2", "m-5")
        ]

    assert _compare(program, both) == [(10, "m-2"), (15, "m-3"), (10, "m-2"),
                                       (25, "m-5")]


def test_multiplex_lru_eviction():
    def program(pkg):
        loads = []

        def loader(owner, model_id):
            loads.append(model_id)
            return model_id.upper()

        wrapper = pkg.multiplex._ModelMultiplexWrapper(loader, None, max_models=2)
        got = [wrapper("a"), wrapper("b"), wrapper("a")]  # third is a hit
        wrapper("c")  # evicts the least recently used, "b"
        wrapper("b")
        return got, loads

    assert _compare(program, PKGS) == (["A", "B", "A"], ["a", "b", "c", "b"])


def test_multiplex_async_loader(both):
    """An async loader on an async deployment method loads on a miss."""
    def program(pkg):
        serve = pkg.serve

        @serve.deployment
        class AsyncMux:
            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id: str):
                return model_id.upper()

            async def __call__(self):
                return self.get_model()

        handle = serve.run(AsyncMux.bind(), name="asyncmux")
        return handle.options(multiplexed_model_id="abc").remote().result(
            timeout_s=30)

    assert _compare(program, both) == "ABC"


def test_multiplex_concurrent_load_once():
    """Four concurrent misses on one id load it once: the loader holds
    every caller until all four have arrived at the wrapper."""
    def program(pkg):
        loads = []
        arrived = threading.Semaphore(0)

        def slow_loader(owner, model_id):
            loads.append(model_id)
            for _ in range(3):  # the other three callers are waiting
                arrived.acquire(timeout=10)
            return model_id

        wrapper = pkg.multiplex._ModelMultiplexWrapper(slow_loader, None,
                                                       max_models=4)

        def call(_):
            arrived.release()
            return wrapper("same")

        out = _fire(call, [0, 1, 2, 3])
        return out, loads

    assert _compare(program, PKGS) == (["same"] * 4, ["same"])


# ---------------------------------------------------------------- HTTP proxy


def test_http_proxy_blocking(both):
    def program(pkg):
        @pkg.serve.deployment
        def double(x):
            return x * 2

        pkg.serve.run(double.bind())
        host, port = pkg.proxy.start_proxy()
        with _post(host, port, "default", 21) as resp:
            return resp.status, json.loads(resp.read())

    assert _compare(program, both) == (200, {"result": 42})


def test_http_proxy_streaming(both):
    """?stream=1 answers with chunked ndjson, one {"result": item} line
    per item the generator ingress yields."""
    def program(pkg):
        @pkg.serve.deployment
        def counter(n):
            def gen():
                for i in range(int(n)):
                    yield {"i": i, "sq": i * i}
            return gen()

        pkg.serve.run(counter.bind(), name="streamer")
        host, port = pkg.proxy.start_proxy()
        with _post(host, port, "streamer?stream=1", 5) as resp:
            ctype = resp.headers.get("Content-Type")
            lines = [json.loads(x) for x in resp.read().splitlines() if x]
        return ctype, lines

    ctype, lines = _compare(program, both)
    assert ctype == "application/x-ndjson"
    assert lines == [{"result": {"i": i, "sq": i * i}} for i in range(5)]


def test_http_proxy_concurrent_inflight(both):
    """Eight requests are in flight in one replica at once: each call
    waits on a barrier of eight, which only opens if the proxy does not
    serialize them."""
    def program(pkg):
        gate = threading.Barrier(8)

        @pkg.serve.deployment(max_concurrent_queries=16)
        class Gathered:
            def __call__(self, x):
                gate.wait(20)  # BrokenBarrierError if fewer arrive
                return x

        pkg.serve.run(Gathered.options(num_replicas=1).bind(), name="gather")
        host, port = pkg.proxy.start_proxy()

        def one(i):
            with _post(host, port, "gather", i) as resp:
                return json.loads(resp.read())

        return _fire(one, list(range(8)))

    assert _compare(program, both) == [{"result": i} for i in range(8)]


def test_http_proxy_request_timeout(both):
    """X-Serve-Timeout-S gives a 504 while the replica is still working;
    the replica is then released."""
    def program(pkg):
        release = threading.Event()

        @pkg.serve.deployment
        def stuck(x):
            release.wait(30)
            return x

        pkg.serve.run(stuck.bind(), name="stuckapp")
        host, port = pkg.proxy.start_proxy()
        try:
            with _post(host, port, "stuckapp", 1, {"X-Serve-Timeout-S": "0.5"}):
                return "no timeout"
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())["error"]
        finally:
            release.set()

    assert _compare(program, both) == (504, "timed out after 0.5s")


def test_per_node_proxies(both):
    """serve.start(proxy_location="EveryNode") pins one proxy actor to
    every alive node; each serves the same application."""
    def program(pkg):
        from importlib import import_module

        runtime = import_module(f"{pkg.name}._private.runtime").get_runtime()
        runtime.add_node({"CPU": 2})  # a second logical node

        @pkg.serve.deployment
        def echo(x):
            return {"v": x}

        pkg.serve.run(echo.bind(), name="echoapp")
        addresses = pkg.serve.start(proxy_location="EveryNode")
        answers = []
        for host, port in addresses:
            with _post(host, port, "echoapp", 11) as resp:
                answers.append(json.loads(resp.read())["result"])
        return len(addresses) - len(runtime.controller.alive_nodes()), answers

    assert _compare(program, both) == (1, [{"v": 11}] * 3)


# ---------------------------------------------------------------- streaming


def test_streaming_handle_direct(both):
    def program(pkg):
        @pkg.serve.deployment
        def gen_app(n):
            def gen():
                for i in range(int(n)):
                    yield i * 10
            return gen()

        handle = pkg.serve.run(gen_app.bind(), name="genapp")
        return list(handle.options(stream=True).remote(4))

    assert _compare(program, both) == [0, 10, 20, 30]


def test_stream_cancel_releases_replica_slot(both):
    """Cancelling an endless stream frees the replica's only slot."""
    def program(pkg):
        @pkg.serve.deployment(max_concurrent_queries=1)
        class Infinite:
            def __call__(self, x):
                def gen():
                    i = 0
                    while True:
                        yield i
                        i += 1
                        time.sleep(0.01)

                return gen()

            def ping(self):
                return "pong"

        handle = pkg.serve.run(Infinite.bind(), name="cancelapp")
        gen = handle.options(stream=True).remote(0)
        it = iter(gen)
        first = [next(it), next(it)]
        gen.cancel()
        return first, handle.ping.remote().result(timeout_s=20)

    assert _compare(program, both) == ([0, 1], "pong")


# ---------------------------------------------------------------- controller


def test_listen_for_change_timeout_immune_to_wallclock(monkeypatch):
    """The long-poll deadline is monotonic: a frozen wall clock does not
    park the poller."""
    frozen = time.time()
    monkeypatch.setattr(time, "time", lambda: frozen)

    def program(pkg):
        ctrl = pkg.controller.ServeControllerActor.__new__(
            pkg.controller.ServeControllerActor)
        ctrl._lock = threading.RLock()
        ctrl._cv = threading.Condition(ctrl._lock)
        ctrl._version = 0
        ctrl._shutdown = False
        return ctrl.listen_for_change(known_version=5, timeout_s=0.3)

    assert _compare(program, PKGS, limit_s=5) == 0


def _fake_state(pkg, autoscaling_config):
    from importlib import import_module

    cfg_mod = import_module(f"{pkg.name}.serve.config")
    return pkg.controller._DeploymentState(
        "app", "dep",
        {"config": cfg_mod.DeploymentConfig(autoscaling_config=autoscaling_config)},
    )


def test_look_back_window_average_prevents_flap():
    """The controller feeds the policy the window average: one burst
    sample does not scale up, one idle sample does not scale down."""
    def program(pkg):
        cfg = pkg.serve.AutoscalingConfig(
            min_replicas=1, max_replicas=4,
            target_num_ongoing_requests_per_replica=1.0, look_back_period_s=1.0,
        )
        st = _fake_state(pkg, cfg)
        st.replicas = {"t0": object()}
        for i in range(20):
            st.observe_metrics_locked(i * 0.05, 0.5, [])
        st.observe_metrics_locked(1.0, 8.0, [])
        out = [st.target_replicas(now=1.0)]
        for i in range(21, 41):
            st.observe_metrics_locked(i * 0.05, 8.0, [])
        out.append(st.target_replicas(now=2.05))
        st2 = _fake_state(pkg, cfg)
        st2.replicas = {f"t{i}": object() for i in range(4)}
        for i in range(20):
            st2.observe_metrics_locked(i * 0.05, 4.0, [])
        st2.observe_metrics_locked(1.0, 0.0, [])
        out.append(st2.target_replicas(now=1.0))
        return out

    assert _compare(program, PKGS) == [1, 4, 4]


SIGNALS = {
    "hot_q": {"queue_time_p99_s": 0.2, "ttft_p99_s": 0.01,
              "prefill_backlog_tokens": 0, "window_complete": True},
    "cold": {"queue_time_p99_s": 0.01, "ttft_p99_s": 0.01,
             "prefill_backlog_tokens": 0, "window_complete": True},
    "idle": {"queue_time_p99_s": None, "ttft_p99_s": None,
             "prefill_backlog_tokens": 0, "window_complete": True},
    "partial": {"queue_time_p99_s": None, "ttft_p99_s": None,
                "prefill_backlog_tokens": 0, "window_complete": False},
    "warm": {"queue_time_p99_s": 0.08, "ttft_p99_s": 0.01,
             "prefill_backlog_tokens": 0, "window_complete": True},
    "backlogged": {"queue_time_p99_s": None, "ttft_p99_s": None,
                   "prefill_backlog_tokens": 500, "window_complete": True},
    "decode_bound": {"queue_time_p99_s": None, "ttft_p99_s": None,
                     "prefill_backlog_tokens": 0, "window_complete": True,
                     "decode_saturated": True},
    "burning": {"queue_time_p99_s": None, "ttft_p99_s": None,
                "prefill_backlog_tokens": 0, "window_complete": True,
                "slo_burn_rate": 3.0},
}


def test_llm_autoscaling_policy_decisions():
    """A pure function of its inputs: every signal bundle at every current
    count gives the reference's decision, and the same refusals."""
    def program(pkg):
        policies = [
            pkg.serve.LLMAutoscalingPolicy(
                min_replicas=1, max_replicas=3, target_queue_time_p99_s=0.1,
                target_ttft_p99_s=0.5, downscale_margin=0.5),
            pkg.serve.LLMAutoscalingPolicy(
                min_replicas=1, max_replicas=4,
                max_prefill_backlog_per_replica=100.0),
            pkg.serve.LLMAutoscalingPolicy(
                min_replicas=1, max_replicas=4, target_burn_rate=1.0),
        ]
        decisions = {
            (i, name, current): p.desired_replicas(sig, current)
            for i, p in enumerate(policies)
            for name, sig in SIGNALS.items()
            for current in (0, 1, 2, 3, 4)
        }
        errors = []
        for kwargs in ({}, {"min_replicas": 0, "target_ttft_p99_s": 1.0},
                       {"target_burn_rate": 0.0}):
            try:
                pkg.serve.LLMAutoscalingPolicy(**kwargs)
                errors.append(None)
            except ValueError as exc:
                errors.append(str(exc))
        return decisions, errors

    decisions, errors = _compare(program, PKGS)
    # Spot checks of the reference's semantics.
    assert decisions[(0, "hot_q", 1)] == 2 and decisions[(0, "hot_q", 3)] == 3
    assert decisions[(0, "cold", 2)] == 1 and decisions[(0, "partial", 2)] == 2
    assert decisions[(0, "warm", 2)] == 2 and decisions[(0, "decode_bound", 2)] == 2
    assert decisions[(1, "backlogged", 2)] == 3
    assert decisions[(2, "burning", 2)] == 3
    assert "at least one target" in errors[0] and "min_replicas" in errors[1]


def test_rendezvous_pick_matches_the_reference():
    """The router's affinity hash picks the reference's member for every
    key, and moves only the keys of a member that leaves."""
    def program(pkg):
        from importlib import import_module

        pick = import_module(f"{pkg.name}.util.consistent_hash").rendezvous_pick
        tags = [f"app#dep#{i}" for i in range(5)]
        keys = [f"prefix-{i}" for i in range(64)] + [7, (1, 2), None]
        before = [pick(k, tags) for k in keys]
        after = [pick(k, tags[:2] + tags[3:]) for k in keys]
        moved = {b for b, a in zip(before, after) if a != b}
        return before, after, moved, pick("x", [])

    before, after, moved, empty = _compare(program, PKGS)
    assert moved == {"app#dep#2"} and empty is None
    assert len(set(before)) == 5


def test_llm_signals_window_matches_the_reference():
    """The controller's windowed SLO signals (per-engine histogram deltas
    merged across engines, the p99 from the buckets, backlog, decode
    saturation, window completeness) from the same engine snapshots."""
    def program(pkg):
        from importlib import import_module

        metrics = import_module(f"{pkg.name}.util.metrics")
        policy = pkg.serve.LLMAutoscalingPolicy(
            min_replicas=1, max_replicas=4, target_ttft_p99_s=0.2,
            target_queue_time_p99_s=0.05, look_back_period_s=1.0)
        st = _fake_state(pkg, policy)
        st.replicas = {"r0": object(), "r1": object()}
        hists = {e: (metrics.Histogram(f"q_{pkg.name}_{e}", boundaries=[0.01, 0.1, 1.0]),
                     metrics.Histogram(f"t_{pkg.name}_{e}", boundaries=[0.05, 0.5, 5.0]))
                 for e in ("e0", "e1")}
        out = []
        for step in range(12):
            now = step * 0.25
            snaps = []
            for i, (e, (hq, ht)) in enumerate(hists.items()):
                hq.observe(0.002 * (step + 1) * (i + 1))
                ht.observe(0.03 * (step + 1))
                snaps.append({"engine_id": e, "queue_time": hq.snapshot(),
                              "ttft": ht.snapshot(), "num_running": 4 + i,
                              "max_decode_slots": 4 + i,
                              "prefill_backlog_tokens": 10 * step})
            st.observe_metrics_locked(now, float(step), snaps)
            signals = st.llm_signals(policy, now)
            out.append((signals, st.target_replicas(now=now, signals=signals)))
        out.append(metrics.percentile_from_buckets([1.0, 2.0], [1, 2, 1], 50.0))
        return out

    out = _compare(program, PKGS)
    assert out[-2][0]["window_complete"] and out[-2][0]["ttft_p99_s"] is not None
    assert out[-2][0]["decode_saturated"] is True


def _drain_program(timeout_s):
    def program(pkg):
        cleaned = []

        class Streamy:
            def __call__(self, n):
                try:
                    for i in range(n):
                        yield i
                finally:
                    cleaned.append(True)

        rep = pkg.replica.ReplicaActor("dep", "dep#0", Streamy, (), {})
        gen = rep.handle_request_streaming("__call__", (5,), {})
        out = [next(gen), rep.drain(timeout_s)]
        try:
            out.append(list(gen))
        except pkg.exceptions.ReplicaDrainingError:
            out.append("interrupted")
        out.append(list(cleaned))
        for call in (lambda: rep.handle_request("__call__", (3,), {}),
                     lambda: list(rep.handle_request_streaming("__call__", (3,), {}))):
            try:
                out.append(call())
            except pkg.exceptions.ReplicaDrainingError as exc:
                out.append(type(exc).__name__)
        m = rep.get_metrics()
        out.append({k: m[k] for k in ("draining", "num_drain_interrupted",
                                      "num_ongoing_requests")})
        return out
    return program


def test_replica_drain_rejects_new_and_interrupts_streams():
    """After drain(0) the in-flight stream is interrupted at its next pull,
    after the user generator's cleanup ran; new unary and streaming work
    bounces with the retryable ReplicaDrainingError."""
    out = _compare(_drain_program(0.0), PKGS)
    assert out == [0, True, "interrupted", [True], "ReplicaDrainingError",
                   "ReplicaDrainingError",
                   {"draining": True, "num_drain_interrupted": 1,
                    "num_ongoing_requests": 0}]


def test_replica_drain_lets_inflight_finish_within_timeout():
    out = _compare(_drain_program(30.0), PKGS)
    assert out[2:4] == [[1, 2, 3, 4], [True]]
    assert out[-1]["num_drain_interrupted"] == 0


def test_scale_down_publishes_shrunk_set_before_stop(both, monkeypatch):
    """The shrunk routing set reaches long-pollers before any stop RPC:
    the drain thread is parked at its first step (controller.drain_replica)
    on an event, and while it is parked the snapshot has already shrunk
    and the victim is alive and DRAINING. Released, the victim ends
    STOPPED."""
    parked = {name: threading.Event() for name in both}
    release = {name: threading.Event() for name in both}
    for name, pkg in both.items():
        original = pkg.fi.maybe_fail

        def gated(site, detail="", _name=name, _original=original):
            if site == "controller.drain_replica":
                parked[_name].set()
                release[_name].wait(30)
            return _original(site, detail)

        monkeypatch.setattr(pkg.fi, "maybe_fail", gated)

    def program(pkg):
        rt = pkg.rt

        @pkg.serve.deployment(num_replicas=2)
        def echo(x):
            return x

        pkg.serve.run(echo.bind(), name="drain-order")
        controller = pkg.controller.get_or_create_controller()
        snap = lambda: rt.get(  # noqa: E731
            controller.get_replica_snapshot.remote("drain-order", "echo"))[1]
        before = snap()
        pkg.serve.scale_deployment("echo", 1, app_name="drain-order")
        try:
            assert parked[pkg.name].wait(20), "drain never started"
            after = snap()
            (victim,) = set(before) - set(after)
            dep = rt.get(controller.get_observability.remote())["drain-order"]["echo"]
            alive = "draining" in rt.get(before[victim].get_metrics.remote(),
                                         timeout=5.0)
            seen = (len(before), len(after), dep["replica_states"][victim], alive)
        finally:
            release[pkg.name].set()

        def history():
            hist = rt.get(controller.get_replica_state_history.remote(
                "drain-order", "echo"))
            states = [h["state"] for h in hist if h["tag"] == victim]
            return states if states[-1] == "STOPPED" else None

        return seen, _wait_for(history, 20.0)

    assert _compare(program, both) == (
        (2, 1, "DRAINING", True), ["STARTING", "RUNNING", "DRAINING", "STOPPED"])


def test_router_ends_with_its_runtime_and_never_restarts_the_controller(monkeypatch):
    """The port's repair of the reference's router (ROADMAP §D6): after
    serve.shutdown() the handle's poll thread looks the controller up and
    finds none, instead of starting a new one in the runtime; after the
    runtime's shutdown the thread ends, releasing the runtime and the
    engines it holds. (The reference's router restarts the controller and
    polls forever.)"""
    lookups = []
    original = port_controller.get_controller

    def counted():
        found = original()
        lookups.append(found is not None)
        return found

    monkeypatch.setattr(port_controller, "get_controller", counted)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        @port_serve.deployment
        def echo(x):
            return x

        # The reference's routers of earlier tests still poll: only the
        # thread this handle starts is the port's.
        before = set(threading.enumerate())
        handle = port_serve.run(echo.bind(), name="router-life")
        assert handle.remote(7).result(timeout_s=30) == 7
        router_threads = [t for t in set(threading.enumerate()) - before
                          if t.name == "router-echo"]
        assert len(router_threads) == 1
        port_serve.shutdown()
        misses = len(lookups)
        # Three lookups after the shutdown, each finding no controller.
        assert _wait_for(lambda: lookups[misses:].count(False) >= 3, 20.0)
        runtime = ray_tpu_torch._private.runtime.get_runtime()
        assert runtime.controller.get_named_actor(
            port_controller.CONTROLLER_NAME, runtime.namespace) is None
    finally:
        ray_tpu_torch.shutdown()
    router_threads[0].join(20.0)
    assert not router_threads[0].is_alive()
