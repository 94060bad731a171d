"""The port's LLM Serve deployment against the reference's, on the CPU.

One app per package, both up at once in their own runtimes: `build_app` on
the same tiny GPT (f32, reference attention) with the same flax weights
(the port's through `params_from_flax`, on `device="cpu"`), two ingress
replicas in front of one named engine actor, and each package's HTTP
proxy. Every request goes to both apps, each through its own package's
public API. Tokens must be identical to each other and to `ray_tpu.llm`'s
in-process engine on the same weights; typed errors must match in type
and payload. Every program runs under a time limit.
"""

import json
import pickle
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu._private import fault_injection as jax_fi
from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.llm import serve as jax_llm_serve
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu.serve._private import controller as jax_controller
from ray_tpu.serve._private import http_proxy as jax_proxy
from ray_tpu_torch import serve as port_serve
from ray_tpu_torch._private import fault_injection as port_fi
from ray_tpu_torch.llm import EngineConfig
from ray_tpu_torch.llm import serve as port_llm_serve
from ray_tpu_torch.models import GPTConfig, params_from_flax
from ray_tpu_torch.serve._private import controller as port_controller
from ray_tpu_torch.serve._private import http_proxy as port_proxy

torch.set_num_threads(1)

LIMIT_S = 60.0
TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
JAX_TINY = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
PORT_TINY = GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference")
# Two prefill buckets keep both engines' warmup short.
ECFG = dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8,
            prefill_buckets=(8, 32))
APP = "llm"
ENGINE = "tiny"


def _within(limit_s, fn, *args):
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


def _compare(program, apps, limit_s=LIMIT_S):
    got = {name: _within(limit_s, program, pkg) for name, pkg in apps.items()}
    assert got["ray_tpu_torch"] == got["ray_tpu"], got
    return got["ray_tpu_torch"]


def _prompt(n, seed):
    rng = np.random.RandomState(seed)
    return list(map(int, rng.randint(0, 128, size=n)))


@pytest.fixture(scope="module")
def weights():
    params = JaxGPT(JAX_TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    return tree, params_from_flax(tree)


@pytest.fixture(scope="module")
def oracle(weights):
    """Greedy tokens of ray_tpu.llm's in-process engine on the weights."""
    engine = JaxLLMEngine(JAX_TINY, JaxEngineConfig(**ECFG), params=weights[0])
    lock = threading.Lock()

    def want(prompt, n):
        with lock:
            return engine.generate([prompt], max_new_tokens=n)[0]

    return want


@pytest.fixture(scope="module")
def apps(weights):
    tree, state = weights
    pkgs = {
        "ray_tpu": types.SimpleNamespace(
            name="ray_tpu", rt=ray_tpu, serve=jax_serve, fi=jax_fi,
            llm_serve=jax_llm_serve, controller=jax_controller, proxy=jax_proxy,
            exceptions=ray_tpu.exceptions,
            app=lambda: jax_llm_serve.build_app(
                JAX_TINY, JaxEngineConfig(**ECFG), params=tree,
                engine_name=ENGINE, num_replicas=2),
        ),
        "ray_tpu_torch": types.SimpleNamespace(
            name="ray_tpu_torch", rt=ray_tpu_torch, serve=port_serve, fi=port_fi,
            llm_serve=port_llm_serve, controller=port_controller, proxy=port_proxy,
            exceptions=ray_tpu_torch.exceptions,
            app=lambda: port_llm_serve.build_app(
                PORT_TINY, EngineConfig(**ECFG), params=state,
                engine_name=ENGINE, num_replicas=2, device="cpu"),
        ),
    }
    for pkg in pkgs.values():
        pkg.rt.init(num_cpus=8, num_gpus=0)
        pkg.fi.clear()
        pkg.handle = pkg.serve.run(pkg.app(), name=APP)
        pkg.host, pkg.port = pkg.proxy.start_proxy()
        # The engine actor warms up after the replicas report healthy: one
        # blocking request waits it out.
        pkg.handle.remote({"prompt_ids": [1, 2, 3], "max_new_tokens": 1}).result(
            timeout_s=120)
    yield pkgs
    for pkg in pkgs.values():
        pkg.fi.clear()
        pkg.proxy.stop_proxy()
        pkg.serve.shutdown()
        pkg.rt.shutdown()


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    for fi in (jax_fi, port_fi):
        fi.clear()
    yield
    for fi in (jax_fi, port_fi):
        fi.clear()


def _post(pkg, payload, stream=False):
    req = urllib.request.Request(
        f"http://{pkg.host}:{pkg.port}/{APP}" + ("?stream=1" if stream else ""),
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.headers.get("Content-Type"), resp.read()


# ---------------------------------------------------------------- requests


def test_blocking_through_handle(apps, oracle):
    prompt = _prompt(7, seed=7)

    def program(pkg):
        res = pkg.handle.remote({"prompt_ids": prompt, "max_new_tokens": 6}).result(
            timeout_s=30)
        return res["token_ids"], res["finish_reason"], res["num_preemptions"]

    assert _compare(program, apps) == (oracle(prompt, 6), "length", 0)


def test_streaming_through_handle(apps, oracle):
    prompt = _prompt(12, seed=8)

    def program(pkg):
        stream = pkg.handle.options(stream=True).remote(
            {"prompt_ids": prompt, "max_new_tokens": 6, "stream": True})
        return [item["token_id"] for item in stream]

    assert _compare(program, apps) == oracle(prompt, 6)


def test_blocking_over_http(apps, oracle):
    prompt = _prompt(9, seed=9)

    def program(pkg):
        ctype, body = _post(pkg, {"prompt_ids": prompt, "max_new_tokens": 5})
        result = json.loads(body)["result"]
        return ctype, sorted(result), result["token_ids"], result["finish_reason"]

    assert _compare(program, apps) == (
        "application/json",
        ["finish_reason", "num_preemptions", "request_id", "token_ids"],
        oracle(prompt, 5), "length")


def test_ndjson_over_http(apps, oracle):
    prompt = _prompt(10, seed=10)

    def program(pkg):
        ctype, body = _post(pkg, {"prompt_ids": prompt, "max_new_tokens": 5,
                                  "stream": True}, stream=True)
        lines = [json.loads(line) for line in body.splitlines() if line]
        return ctype, lines

    ctype, lines = _compare(program, apps)
    assert ctype == "application/x-ndjson"
    assert lines == [{"result": {"token_id": t}} for t in oracle(prompt, 5)]


def test_concurrent_handle_and_http_requests(apps, oracle):
    """Handle and HTTP requests, blocking and streaming, in flight at once
    on both replicas: each is identical to its unbatched greedy run."""
    prompts = [_prompt(n, seed=20 + n) for n in (5, 9, 14, 21)]

    def program(pkg):
        out = [None] * 4

        def run(i):
            req = {"prompt_ids": prompts[i], "max_new_tokens": 6}
            if i == 0:
                out[i] = pkg.handle.remote(req).result(timeout_s=30)["token_ids"]
            elif i == 1:
                out[i] = [d["token_id"] for d in pkg.handle.options(stream=True).remote(
                    dict(req, stream=True))]
            elif i == 2:
                out[i] = json.loads(_post(pkg, req)[1])["result"]["token_ids"]
            else:
                body = _post(pkg, dict(req, stream=True), stream=True)[1]
                out[i] = [json.loads(x)["result"]["token_id"]
                          for x in body.splitlines() if x]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        return out

    assert _compare(program, apps) == [oracle(p, 6) for p in prompts]


def test_repeated_prompt_hits_the_prefix_cache(apps, oracle):
    """The second run of a 20-token prompt reads its two full blocks from
    the prefix cache, with the same tokens."""
    prompt = _prompt(20, seed=11)

    def program(pkg):
        hits = lambda: pkg.handle.metrics.remote().result(timeout_s=30)[  # noqa: E731
            "prefix_cache_hit_tokens"]
        before = hits()
        runs = [pkg.handle.remote({"prompt_ids": prompt, "max_new_tokens": 4}).result(
            timeout_s=30)["token_ids"] for _ in range(2)]
        return runs, hits() - before

    runs, hit_tokens = _compare(program, apps)
    assert runs == [oracle(prompt, 4)] * 2
    assert hit_tokens > 0


def test_deadline_rejects_zero_budget_and_app_keeps_serving(apps, oracle):
    prompt = _prompt(5, seed=12)

    def program(pkg):
        try:
            pkg.handle.remote({"prompt_ids": prompt, "max_new_tokens": 4,
                               "timeout_s": 0.0}).result(timeout_s=30)
            rejected = None
        except TimeoutError as exc:
            rejected = "deadline" in str(exc)
        res = pkg.handle.remote({"prompt_ids": prompt, "max_new_tokens": 4,
                                 "timeout_s": 60.0}).result(timeout_s=30)
        return rejected, res["token_ids"], res["finish_reason"]

    assert _compare(program, apps) == (True, oracle(prompt, 4), "length")


def test_poisoned_request_isolated_through_serve_path(apps, oracle):
    """A request whose prefill raises (fault injected, matched by its
    pinned request id) fails alone with PoisonRequestError; the other
    request is unharmed, the dead letter names the culprit and the engine
    is not wedged."""
    prompts = [_prompt(5, seed=13), _prompt(6, seed=14)]

    def program(pkg):
        pkg.fi.inject("llm.prefill", match="poison-via-serve",
                      exc_factory=lambda: RuntimeError("poisoned via serve"))
        letters_before = len(pkg.handle.dead_letters.remote().result(timeout_s=30))
        ok = pkg.handle.remote({"prompt_ids": prompts[0], "max_new_tokens": 6})
        bad = pkg.handle.remote({"prompt_ids": prompts[1], "max_new_tokens": 6,
                                 "request_id": "poison-via-serve"})
        try:
            bad.result(timeout_s=30)
            culprit = None
        except pkg.exceptions.PoisonRequestError as exc:
            culprit = (exc.request_id, "poisoned via serve" in repr(exc.cause))
        letters = pkg.handle.dead_letters.remote().result(timeout_s=30)
        stats = pkg.handle.metrics.remote().result(timeout_s=30)
        return (culprit, ok.result(timeout_s=30)["token_ids"],
                [d["request_id"] for d in letters[letters_before:]],
                stats["wedged"])

    assert _compare(program, apps) == (
        ("poison-via-serve", True), oracle(prompts[0], 6), ["poison-via-serve"], False)


def test_retry_budget_exhaustion_raises_typed_error(apps):
    """Every dispatch to a replica fails (actor.submit fault): after the
    budget the router raises ReplicaUnavailableRetryExhausted with
    attempts == budget + 1; the app serves again once the fault is gone."""
    budget = 2

    def program(pkg):
        spec = pkg.fi.inject(
            "actor.submit", match="ReplicaActor.handle_request", times=None,
            exc_factory=lambda: pkg.exceptions.ActorDiedError(None, "injected"))
        tuned = pkg.handle.options(retry_budget=budget, backoff_initial_s=0.01,
                                   backoff_jitter_seed=1234)
        req = {"prompt_ids": [3, 1, 4, 1, 5], "max_new_tokens": 2}
        try:
            tuned.remote(req)
            err = None
        except pkg.exceptions.ReplicaUnavailableRetryExhausted as exc:
            err = (exc.deployment, exc.attempts,
                   type(exc.last_error).__name__)
        fires = spec.fires
        pkg.fi.remove(spec)
        return err, fires, len(tuned.remote(req).result(timeout_s=30)["token_ids"])

    assert _compare(program, apps) == (
        ("LLMIngress", budget + 1, "ActorDiedError"), budget + 1, 2)


def test_autoscaling_and_observability_snapshots_have_the_reference_keys(apps):
    def program(pkg):
        snap = pkg.handle.autoscaling_metrics.remote().result(timeout_s=30)
        obs = pkg.handle.observability_snapshot.remote().result(timeout_s=30)
        engine = pkg.rt.get_actor(f"llm_engine:{ENGINE}")
        direct = pkg.rt.get(engine.autoscaling_snapshot.remote())
        return {
            "autoscaling": sorted(snap),
            "histogram_fields": sorted(snap["ttft"]),
            "direct": sorted(direct),
            "observability": sorted(obs),
            "histograms": sorted(obs["histograms"]),
            "flight_record": sorted(obs["flight_record"]),
            "pending": pkg.rt.get(engine.num_pending.remote()),
            "max_decode_slots": snap["max_decode_slots"],
        }

    out = _compare(program, apps)
    assert out["autoscaling"] == out["direct"] == [
        "engine_id", "max_decode_slots", "num_running", "prefill_backlog_tokens",
        "queue_depth", "queue_time", "ttft"]
    assert out["observability"] == ["dead_letters", "flight_record", "histograms",
                                    "metrics", "shed_requests"]
    assert out["pending"] == 0


def test_stream_failover_after_a_real_replica_kill(apps, oracle):
    """The replica serving a stream is killed after three tokens; the
    router resumes it on the other replica (llm_stream_resume) and the
    stream stays contiguous and identical."""
    prompt = _prompt(9, seed=15)

    def program(pkg):
        gen = pkg.handle.options(
            stream=True, stream_resume_fn=pkg.llm_serve.llm_stream_resume,
        ).remote({"prompt_ids": prompt, "max_new_tokens": 10, "stream": True})
        it = iter(gen)
        received = [next(it)["token_id"] for _ in range(3)]
        serving = gen.replica_tag
        _, replicas = pkg.rt.get(
            pkg.controller.get_or_create_controller().get_replica_snapshot.remote(
                APP, "LLMIngress"))
        pkg.rt.kill(replicas[serving])
        received += [d["token_id"] for d in it]
        return received, gen.replica_tag != serving

    assert _compare(program, apps) == (oracle(prompt, 10), True)


# ---------------------------------------------------------------- the port alone


@pytest.mark.parametrize("name, args, fields", [
    ("ReplicaDrainingError", ("replica r#0 is draining",), {}),
    ("FleetOverloadedError", ("LLMIngress", 2, 0.25, RuntimeError("shed")),
     {"deployment": "LLMIngress", "attempts": 2, "retry_after_s": 0.25}),
    ("ReplicaUnavailableRetryExhausted", ("LLMIngress", 3, ValueError("dead")),
     {"deployment": "LLMIngress", "attempts": 3}),
])
def test_serve_exceptions_survive_pickle(name, args, fields):
    """Each of the three Serve errors keeps its payload through pickle,
    also as the TaskError-derived instance a remote raise becomes, and
    matches the reference's class in hierarchy and message."""
    port_cls = getattr(ray_tpu_torch.exceptions, name)
    jax_cls = getattr(ray_tpu.exceptions, name)
    port_exc = port_cls(*args)
    assert str(port_exc) == str(jax_cls(*args))
    assert [c.__name__ for c in port_cls.__mro__] == [
        c.__name__ for c in jax_cls.__mro__]
    derived = ray_tpu_torch.exceptions.TaskError(port_exc, "tb", "task").as_instanceof_cause()
    for exc in (port_exc, derived):
        back = pickle.loads(pickle.dumps(exc))
        assert isinstance(back, port_cls)
        for key, value in fields.items():
            assert getattr(back, key) == value
        if hasattr(port_exc, "last_error"):
            assert repr(back.last_error) == repr(port_exc.last_error)
    assert isinstance(pickle.loads(pickle.dumps(derived)),
                      ray_tpu_torch.exceptions.TaskError)


def test_build_app_defaults_to_cuda():
    """Without CUDA and without device=, build_app, LLMIngress and the
    engine actor raise instead of serving from the CPU."""
    if torch.cuda.is_available():
        assert port_llm_serve._serve_device(None) == "cuda"
        return
    ecfg = EngineConfig(**ECFG)
    for make in (lambda: port_llm_serve.build_app(PORT_TINY, ecfg),
                 lambda: port_llm_serve.build_app(PORT_TINY, ecfg, device="cuda"),
                 lambda: port_llm_serve.LLMIngress("x", PORT_TINY, ecfg),
                 lambda: port_llm_serve.get_or_create_engine_actor("x", PORT_TINY, ecfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()

