"""The port's replica drain and LLM autoscaling under live traffic.

The programs of the reference's `tests/test_chaos_autoscaling.py` that
need loadgen, run on `ray_tpu_torch` and held to the reference's
assertions: greedy streams that a mid-stream scale-down drains must stay
token-identical (to the reference's unbatched flax model on the same
weights, or to an undisturbed open-loop run of the same seeded schedule),
zero requests may drop, exactly one replica goes DRAINING -> STOPPED,
the pools come back to boot size, and an LLMAutoscalingPolicy scales up
under a ramp and back down after it. Every wait is a polled condition
with a deadline, and every program runs under a time limit.

`test_drain_fault_degrades_to_kill_failover_zero_drops` is the test of
ROADMAP §D17: a fault at either drain site must degrade to a kill with
failover and no dropped token.

`test_drain_migrates_streams_token_identical_pools_reclaimed` is also the
test of ROADMAP §D7: its poll of the engine's metrics needs
`LLMServer._lock`, which the engine loop released and re-took between
steps with no hand-off, so the poll waited out the streams and the
scale-down landed after they had finished (nothing migrated).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import ray_tpu_torch
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch import serve
from ray_tpu_torch._private import fault_injection as fi
from ray_tpu_torch.llm import EngineConfig
from ray_tpu_torch.llm.serve import build_app, llm_stream_resume
from ray_tpu_torch.loadgen import (
    LOOSE_SLO,
    ArrivalSpec,
    ScenarioSpec,
    ScheduledEvent,
    arrival_times,
    build_report,
    evaluate_slo,
    generate_requests,
    run_open_loop,
)
from ray_tpu_torch.models import GPTConfig, params_from_flax
from ray_tpu_torch.serve._private.controller import get_or_create_controller

torch.set_num_threads(1)

LIMIT_S = 50.0
TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
JAX_TINY = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
PORT_TINY = GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference")
ECFG = dict(block_size=8, num_blocks=64, max_decode_slots=8, max_blocks_per_seq=8,
            prefill_buckets=(8, 32))
ECFG_SERVE = EngineConfig(**ECFG)
# Per-token decode delay: slows streams enough that a drain deadline
# lands mid-stream on the CPU, without changing a single token.
DECODE_DELAY_S = 0.01


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


@pytest.fixture(scope="module")
def weights():
    """The reference's seed-0 init (the engine's own probe shape), and the
    same weights for the port."""
    model = JaxGPT(JAX_TINY)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, ECFG["block_size"]), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    return model, params, params_from_flax(tree)


@pytest.fixture
def rt():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    fi.clear()
    yield
    fi.clear()
    serve.shutdown()
    ray_tpu_torch.shutdown()


def reference_greedy(model, params, prompt, n_tokens, pad_to=64):
    """The reference's unbatched greedy loop on the flax model."""
    toks = list(prompt)
    out = []
    for _ in range(n_tokens):
        padded = np.zeros((1, pad_to), np.int32)
        padded[0, : len(toks)] = toks
        logits = model.apply(params, jnp.asarray(padded))
        t = int(jnp.argmax(logits[0, len(toks) - 1]))
        out.append(t)
        toks.append(t)
    return out


def random_prompts(lengths, vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, vocab, size=n))) for n in lengths]


def _build_llm_app(state, engine_name, app_name, num_replicas=2, drain_timeout_s=0.15):
    return serve.run(
        build_app(
            PORT_TINY, ECFG_SERVE, params=state, engine_name=engine_name,
            num_replicas=num_replicas, graceful_shutdown_timeout_s=drain_timeout_s,
            device="cpu",
        ),
        name=app_name,
    )


def _await_history(app, deployment, predicate, timeout_s=20.0):
    controller = get_or_create_controller()
    deadline = time.monotonic() + timeout_s
    hist = []
    while time.monotonic() < deadline:
        hist = ray_tpu_torch.get(
            controller.get_replica_state_history.remote(app, deployment))
        if predicate(hist):
            return hist
        time.sleep(0.05)
    return hist


def _engine_metrics(name):
    return ray_tpu_torch.get(
        ray_tpu_torch.get_actor(f"llm_engine:{name}").metrics.remote(), timeout=10.0)


def test_drain_migrates_streams_token_identical_pools_reclaimed(rt, weights):
    """6 concurrent greedy streams across 2 replicas; once the engine runs
    at least 4 of them, a scale-down to 1 drains the victim mid-stream.
    Every stream completes token-identical to the reference's unbatched
    loop, at least one was interrupted and migrated, the victim walks
    DRAINING -> STOPPED, and the pools are back at boot size."""
    model, params, state = weights
    n_new = 20
    prompts = random_prompts((5, 6, 7, 8, 5, 6), seed=11)
    want = [reference_greedy(model, params, p, n_new) for p in prompts]

    def program():
        handle = _build_llm_app(state, "drain-mig", "llmdrain1")
        delay = fi.inject("llm.decode.seq", action="delay", delay_s=DECODE_DELAY_S,
                          every=1, times=None)
        got = [None] * len(prompts)
        errors = []
        running = []

        def consume(i):
            try:
                stream = handle.options(
                    stream=True, stream_resume_fn=llm_stream_resume
                ).remote({"prompt_ids": prompts[i], "max_new_tokens": n_new,
                          "stream": True})
                got[i] = [d["token_id"] for d in stream]
            except BaseException as exc:  # noqa: BLE001 — the drop IS the bug
                errors.append((i, repr(exc)))

        threads = [threading.Thread(target=consume, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                running.append(_engine_metrics("drain-mig")["num_running"])
                if running[-1] >= 4:
                    break
                time.sleep(0.02)
            serve.scale_deployment("LLMIngress", 1, app_name="llmdrain1")
            for t in threads:
                t.join(timeout=40)
            assert not any(t.is_alive() for t in threads)
        finally:
            fi.remove(delay)
        hist = _await_history("llmdrain1", "LLMIngress",
                              lambda h: any(x["state"] == "STOPPED" for x in h))
        obs = ray_tpu_torch.get(get_or_create_controller().get_observability.remote())
        return got, errors, running, hist, obs["llmdrain1"]["LLMIngress"], \
            _engine_metrics("drain-mig")

    got, errors, running, hist, dep, stats = _within(LIMIT_S, program)
    assert errors == []  # zero dropped requests
    # The poll saw the streams running: it was not starved of the
    # engine's lock until they had finished.
    assert max(running) >= 4, running
    for i, tokens in enumerate(got):
        assert tokens == want[i], f"stream {i} diverged across the drain"
    drained_tags = {x["tag"] for x in hist if x["state"] == "DRAINING"}
    assert len(drained_tags) == 1  # exactly one victim
    (victim,) = drained_tags
    states = [h["state"] for h in hist if h["tag"] == victim]
    assert states[-1] == "STOPPED" and "DRAINING" in states
    assert dep["state_counts"]["RUNNING"] == 1
    assert dep["state_counts"]["DRAINING"] == 0
    assert dep["num_drained_replicas"] == 1
    # The victim held ~3 of 6 slow streams; the 0.15 s deadline cannot
    # let 20-token streams finish, so at least one migrated.
    assert dep["num_migrated_requests"] >= 1
    assert stats["kv_pool_allocated"] == 0
    assert stats["spec_draft_pool_allocated"] == 0
    assert stats["wedged"] is False


def test_drain_under_open_loop_traffic_token_identical_to_baseline(rt, weights):
    """The same seeded open-loop multiturn schedule twice: undisturbed,
    then with a scale-down fired mid-sweep. The chaos run drops nothing
    and delivers, per request id, the baseline's tokens; the drain shows
    in the controller's history."""
    state = weights[2]
    spec = ScenarioSpec.for_engine(
        ECFG_SERVE.max_model_len, ECFG_SERVE.buckets()[-1], vocab_size=128,
        name="multiturn", num_requests=10, seed=3, max_new_tokens=10,
    )
    requests = generate_requests(spec)
    offsets = arrival_times(ArrivalSpec(process="uniform", rate=6.0, seed=3),
                            len(requests))

    def program():
        delay = fi.inject("llm.decode.seq", action="delay", delay_s=0.005,
                          every=1, times=None)
        try:
            results = {}
            for label, events in (
                ("baseline", []),
                ("chaos", [ScheduledEvent(
                    offset_s=offsets[len(offsets) // 2], name="scale_down",
                    fn=lambda: serve.scale_deployment("LLMIngress", 1,
                                                      app_name="lg-chaos"))]),
            ):
                handle = _build_llm_app(state, f"lg-{label}", f"lg-{label}",
                                        drain_timeout_s=0.1)
                results[label] = run_open_loop(
                    handle, requests, offsets, timeout_s=30.0, settle_timeout_s=30.0,
                    events=events, stream_resume_fn=llm_stream_resume,
                    record_tokens=True,
                )
        finally:
            fi.remove(delay)
        hist = _await_history("lg-chaos", "LLMIngress",
                              lambda h: any(x["state"] == "STOPPED" for x in h))
        return results, hist, _engine_metrics("lg-chaos")

    results, hist, stats = _within(LIMIT_S, program)
    chaos = results["chaos"]
    (event,) = chaos.events
    assert event.error is None and event.fired_s is not None
    for run in results.values():
        assert all(s.error is None for s in run.samples), [
            (s.request_id, s.error) for s in run.samples if s.error]
    base_tokens = {s.request_id: s.token_ids for s in results["baseline"].samples}
    for s in chaos.samples:
        assert s.token_ids == base_tokens[s.request_id], (
            f"{s.request_id} diverged under the mid-sweep scale-down")
        assert len(s.token_ids) == 10
    assert any(x["state"] == "DRAINING" for x in hist)
    assert stats["kv_pool_allocated"] == 0
    assert stats["spec_draft_pool_allocated"] == 0


@pytest.mark.parametrize("site", ["controller.drain_replica", "replica.drain"])
def test_drain_fault_degrades_to_kill_failover_zero_drops(rt, weights, site):
    """ROADMAP §D17: a fault injected into the drain conversation, on the
    controller's side (`controller.drain_replica`) or the replica's
    (`replica.drain`), degrades the drain to the plain stop path: the
    victim is killed, its streams fail over to the survivor, and every
    stream still delivers each token exactly once, token-identical to the
    reference's unbatched loop. Premises asserted: the engine ran at least
    3 of the 4 slow streams when the scale-down fired, the fault fired
    exactly once, and the victim went DRAINING before it STOPPED."""
    model, params, state = weights
    suffix = site.split(".")[-1].replace("_", "")
    engine, app = f"drainfault-{suffix}", f"llmdrainfault-{suffix}"
    n_new = 16
    prompts = random_prompts((5, 7, 6, 8), seed=23)
    want = [reference_greedy(model, params, p, n_new) for p in prompts]

    def program():
        handle = _build_llm_app(state, engine, app)
        delay = fi.inject("llm.decode.seq", action="delay", delay_s=DECODE_DELAY_S,
                          every=1, times=None)
        fault = fi.inject(site, times=1)
        got = [None] * len(prompts)
        errors = []
        running = []

        def consume(i):
            try:
                stream = handle.options(
                    stream=True, stream_resume_fn=llm_stream_resume
                ).remote({"prompt_ids": prompts[i], "max_new_tokens": n_new,
                          "stream": True})
                got[i] = [d["token_id"] for d in stream]
            except BaseException as exc:  # noqa: BLE001 — the drop IS the bug
                errors.append((i, repr(exc)))

        threads = [threading.Thread(target=consume, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                running.append(_engine_metrics(engine)["num_running"])
                if running[-1] >= 3:
                    break
                time.sleep(0.02)
            serve.scale_deployment("LLMIngress", 1, app_name=app)
            for t in threads:
                t.join(timeout=40)
            assert not any(t.is_alive() for t in threads)
        finally:
            fi.remove(delay)
            fi.remove(fault)
        hist = _await_history(app, "LLMIngress",
                              lambda h: any(x["state"] == "STOPPED" for x in h))
        obs = ray_tpu_torch.get(get_or_create_controller().get_observability.remote())
        return got, errors, running, fault.fires, hist, obs[app]["LLMIngress"]

    got, errors, running, fires, hist, dep = _within(LIMIT_S, program)
    assert max(running) >= 3, running  # the streams were live at the scale-down
    assert fires == 1  # the drain conversation really failed
    assert errors == []  # degradation still drops nothing
    for i, tokens in enumerate(got):
        assert tokens == want[i], f"stream {i} diverged across the failed drain"
    drained_tags = {x["tag"] for x in hist if x["state"] == "DRAINING"}
    assert len(drained_tags) == 1  # it tried to drain exactly one victim
    (victim,) = drained_tags
    states = [h["state"] for h in hist if h["tag"] == victim]
    assert states[-1] == "STOPPED", states
    assert dep["state_counts"]["RUNNING"] == 1


def _engine_loops() -> int:
    return sum(t.name == "llm-engine-loop" and t.is_alive() for t in threading.enumerate())


def test_serve_shutdown_stops_every_owned_engine(weights):
    """ROADMAP §D15: an app whose replicas own their engines
    (engine_per_replica) torn down by serve.shutdown() and, at once, the
    runtime's shutdown leaves no engine loop running. serve.shutdown()
    used to return once the replicas' stop threads had started, so the
    runtime went down under them and a replica that had not yet stopped
    its engine left the engine's loop thread (and on the card its weights
    and pools) alive. Three rounds; the premise (two engines up) is
    asserted in each."""
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.util.runtime_metrics import list_llm_engine_actors

    state = weights[2]
    for round_ in range(3):
        loops_before = _engine_loops()
        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
        try:
            handle = serve.run(
                build_app(PORT_TINY, ECFG_SERVE, params=state, engine_name="owned",
                          num_replicas=2, engine_per_replica=True, device="cpu"),
                name="owned")
            out = handle.remote({"prompt_ids": [1, 2, 3], "max_new_tokens": 2}).result(
                timeout_s=60)
            assert len(out["token_ids"]) == 2
            assert len(list_llm_engine_actors(get_runtime())) == 2
            assert _engine_loops() == loops_before + 2
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
        deadline = time.monotonic() + 5.0
        while _engine_loops() > loops_before and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _engine_loops() == loops_before, (round_, _engine_loops(), loops_before)


def test_llm_autoscaling_ramp_scales_up_then_down(rt, weights):
    """Under a ramp arrival an LLM deployment with LLMAutoscalingPolicy
    scales up on the engine's windowed queue-time p99 while the loose SLO
    still passes, and scales back down after the burst — both read from
    the controller's replica-state history."""
    state = weights[2]
    policy = serve.LLMAutoscalingPolicy(
        min_replicas=1, max_replicas=2, target_queue_time_p99_s=0.05,
        look_back_period_s=1.0, upscale_cooldown_s=0.2, downscale_cooldown_s=0.3,
    )
    spec = ScenarioSpec.for_engine(
        ECFG_SERVE.max_model_len, ECFG_SERVE.buckets()[-1], vocab_size=128,
        name="multiturn", num_requests=24, seed=7, max_new_tokens=8,
    )
    requests = generate_requests(spec)
    offsets = arrival_times(
        ArrivalSpec(process="ramp", rate=3.0, ramp_to_rate=24.0, seed=7), len(requests))

    def program():
        handle = serve.run(
            build_app(PORT_TINY, ECFG_SERVE, params=state, engine_name="autoscale",
                      autoscaling_config=policy, graceful_shutdown_timeout_s=0.5,
                      device="cpu"),
            name="llmauto",
        )
        # Saturate the 8 decode slots so admissions queue: the windowed
        # queue-time p99 is the signal the policy scales on.
        delay = fi.inject("llm.decode.seq", action="delay", delay_s=0.008,
                          every=1, times=None)
        try:
            result = run_open_loop(handle, requests, offsets, timeout_s=30.0,
                                   settle_timeout_s=30.0,
                                   stream_resume_fn=llm_stream_resume)
        finally:
            fi.remove(delay)
        up = _await_history(
            "llmauto", "LLMIngress",
            lambda h: len({x["tag"] for x in h if x["state"] == "RUNNING"}) >= 2,
            timeout_s=10.0)
        down = _await_history(
            "llmauto", "LLMIngress",
            lambda h: any(x["state"] == "DRAINING" for x in h)
            and any(x["state"] == "STOPPED" for x in h),
            timeout_s=30.0)
        obs = ray_tpu_torch.get(get_or_create_controller().get_observability.remote())
        return result, up, down, obs["llmauto"]["LLMIngress"], \
            _engine_metrics("autoscale")

    result, up, down, dep, stats = _within(LIMIT_S, program)
    assert all(s.error is None for s in result.samples), [
        (s.request_id, s.error) for s in result.samples if s.error]
    # The burst still met the loose SLO: the fleet scaled before p99
    # burned, not after the gate failed.
    assert evaluate_slo(LOOSE_SLO, build_report(result))["passed"] is True
    running_tags = {x["tag"] for x in up if x["state"] == "RUNNING"}
    assert len(running_tags) >= 2, f"autoscaler never scaled up under the ramp: {up}"
    assert any(x["state"] == "DRAINING" for x in down)
    assert any(x["state"] == "STOPPED" for x in down)
    assert dep["state_counts"]["RUNNING"] == 1
    # The SLO signal plumbing is live end to end: the controller computed
    # windowed signals from the engine's histogram snapshots.
    assert dep["autoscaling_signals"] is not None
    assert stats["kv_pool_allocated"] == 0


def test_server_lock_hands_off_to_its_oldest_waiter():
    """ROADMAP §D7, deterministically: a holder that releases with a thread
    queued cannot take the lock straight back (a plain threading.Lock lets
    it, which starved the metrics poll above); the waiter gets it first,
    and a Condition built on the lock waits and wakes as on a plain one."""
    from ray_tpu_torch.llm import engine as engine_mod

    lock = engine_mod._HandoffLock()
    order = []
    lock.acquire()
    waiter = threading.Thread(target=lambda: (lock.acquire(), order.append("waiter"),
                                              lock.release()), daemon=True)
    waiter.start()
    deadline = time.monotonic() + 10.0
    while not lock._waiters and time.monotonic() < deadline:
        time.sleep(0.001)
    assert len(lock._waiters) == 1
    lock.release()
    assert lock.acquire(blocking=False) is False  # handed to the waiter
    assert lock.acquire(timeout=10.0) is True
    order.append("holder")
    lock.release()
    waiter.join(10.0)
    assert order == ["waiter", "holder"]
    assert lock.acquire(blocking=False) is True
    lock.release()
    with pytest.raises(RuntimeError):
        lock.release()

    cond = threading.Condition(lock)
    ready = []

    def wait_for_item():
        with cond:
            assert cond.wait_for(lambda: ready, timeout=10.0)

    t = threading.Thread(target=wait_for_item, daemon=True)
    t.start()
    with cond:
        ready.append(1)
        cond.notify_all()
    t.join(10.0)
    assert not t.is_alive()


def test_server_lock_under_contention_loses_no_update():
    """More threads than cores hammer a read-modify-write under the
    hand-off lock with a short switch interval: no update is lost and the
    lock ends free with no waiter left queued."""
    import sys

    from ray_tpu_torch.llm import engine as engine_mod

    lock = engine_mod._HandoffLock()
    counter = {"n": 0}
    threads_n, iters = 16, 500

    def work():
        for _ in range(iters):
            with lock:
                n = counter["n"]
                if n % 97 == 0:
                    time.sleep(0)  # yield inside the critical section
                counter["n"] = n + 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, daemon=True) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter["n"] == threads_n * iters
    assert not lock._held and not lock._waiters
