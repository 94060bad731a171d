"""The engine's wedge path (ROADMAP §D16) on the port's GPT-2 engine.

K consecutive step failures that no request can be blamed for wedge the
engine: the error reaches every waiter (a blocking generate and a stream),
check_health() turns false, the flight recorder shows K - 1 retries and
the wedge, and a later submission fails at once. The reference's own test
(tests/test_chaos_serving.py) arms its fault from the third engine step,
before it knows both requests are in flight. On the reference the second
submission can wait for the server's lock until the first request has
nearly finished (the loop re-takes the lock between steps with no hand-off,
§D7), so the first one often finishes cleanly before the wedge. Here the
fault is armed only once the engine decodes both requests, each with tokens
still to come (decode is slowed by an injected per-token delay, one spec a
request so each one's decode hits are counted apart): the fixture asserts
that premise, and every wait is a polled condition under a deadline.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import fault_injection as fi
from ray_tpu_torch.llm import EngineConfig, LLMServer
from ray_tpu_torch.models import GPTConfig

torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
ECFG = dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8,
            max_consecutive_step_failures=2)
N_NEW = 48
DECODE_DELAY_S = 0.01


def _wait_for(cond, timeout_s: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_engine_wedges_after_k_consecutive_failing_steps():
    """A blocking generate and a stream both in flight; then every engine
    step fails with no culprit. After K = 2 such steps the engine is
    wedged: both waiters get the injected fault (not a timeout, not a
    finish), check_health() is false, metrics say wedged, the flight
    recorder holds one retry then the wedge, and a new submission fails
    with "not running" at once."""
    cfg = GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference")
    server = LLMServer(cfg, EngineConfig(**ECFG), seed=0, warmup=False, device="cpu")
    fi.clear()
    rng = np.random.RandomState(5)
    prompts = [list(map(int, rng.randint(1, 128, size=n))) for n in (5, 7)]
    # One delay a request, so each one's decode hits are counted apart.
    delays = {rid: fi.inject("llm.decode.seq", match=rid, action="delay",
                             delay_s=DECODE_DELAY_S, every=1, times=None)
              for rid in ("wedge-g", "wedge-s")}
    out = {"stream": [], "stream_error": None, "generate": None}

    def run_generate():
        try:
            out["generate"] = server.generate(prompts[0], max_new_tokens=N_NEW, timeout_s=60.0,
                                              request_id="wedge-g")
        except BaseException as exc:  # noqa: BLE001 - the outcome under test
            out["generate"] = exc

    def run_stream():
        try:
            for tok in server.generate_stream(prompts[1], max_new_tokens=N_NEW, timeout_s=60.0,
                                              request_id="wedge-s"):
                out["stream"].append(tok)
        except BaseException as exc:  # noqa: BLE001 - the outcome under test
            out["stream_error"] = exc

    threads = [threading.Thread(target=f, daemon=True) for f in (run_generate, run_stream)]
    fault = None
    try:
        for t in threads:
            t.start()
        # Premise: both requests are decoding and the stream has tokens.
        assert _wait_for(lambda: all(d.hits >= 2 for d in delays.values()) and out["stream"]), (
            {rid: d.hits for rid, d in delays.items()}, out)
        armed_at = {rid: d.hits for rid, d in delays.items()}
        fault = fi.inject("llm.step", times=None, message="engine meltdown")
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        for d in delays.values():
            fi.remove(d)
        if fault is not None:
            fi.remove(fault)
    assert fault.fires == 2  # K failing steps, then no more steps
    # Premise: neither request finished before the fault armed.
    assert 0 < len(out["stream"]) < N_NEW, len(out["stream"])
    assert all(n < N_NEW - 2 for n in armed_at.values()), armed_at
    assert all(d.hits < N_NEW - 1 for d in delays.values())
    assert isinstance(out["generate"], fi.InjectedFault), out["generate"]
    assert isinstance(out["stream_error"], fi.InjectedFault), out["stream_error"]
    assert server.check_health() is False
    assert server.metrics()["wedged"] is True
    actions = [f["action"] for f in server.flight_record()["failures"]]
    assert actions == ["retry", "wedged"], actions
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="not running"):
        server.generate([1, 2], max_new_tokens=1, timeout_s=10.0)
    assert time.monotonic() - t0 < 5.0
    server.shutdown()
