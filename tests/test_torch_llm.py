"""ray_tpu_torch.llm (runner, engine, server) against ray_tpu.llm on the
same converted weights, on the CPU.

Greedy tokens must be identical to the JAX engine's across mixed lengths,
repeated prompts (partial prefill through the prefix cache), copy-on-write,
chunked prefill, and preemption under a small block pool; the runner's step
programs must leave the same pool contents behind.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import GPTRunner as JaxGPTRunner
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch.llm import EngineConfig, GPTRunner, LLMEngine, LLMServer
from ray_tpu_torch.models import GPTConfig, params_from_flax

# Tiny shapes: one intra-op thread, so the suite's parallel workers keep
# their cores (several reference tests are timing-sensitive).
torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
JAX_TINY = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
PORT_TINY = GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference")


@pytest.fixture(scope="module")
def weights():
    """(flax variables as numpy, the port's converted state_dict)."""
    params = JaxGPT(JAX_TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    return tree, params_from_flax(tree)


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, 128, size=n))) for n in lengths]


def _engines(weights, **ecfg):
    tree, state = weights
    jax_eng = JaxLLMEngine(JAX_TINY, JaxEngineConfig(**ecfg), params=tree)
    port_eng = LLMEngine(PORT_TINY, EngineConfig(**ecfg), params=state, device="cpu")
    return jax_eng, port_eng


# ---------------------------------------------------------------- runner


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_runner_programs_match_jax(weights, kv):
    """Each step program's sampled token and the pools it leaves behind:
    full prefill, partial prefill at an offset, batched decode with an
    idle slot, and the copy-on-write block copy. f32 pools within 1e-5;
    int8 codes within one step (a K/V value within f32 noise of a
    rounding boundary may quantize either way) and scales within bf16."""
    tree, state = weights
    ecfg = dict(block_size=4, num_blocks=16, max_decode_slots=3,
                max_blocks_per_seq=8, kv_cache_dtype=kv)
    jr = JaxGPTRunner(JAX_TINY, JaxEngineConfig(**ecfg), params=tree)
    tr = GPTRunner(PORT_TINY, EngineConfig(**ecfg), params=state, device="cpu")
    assert tr.attn_impl == "reference" and tr.num_params == jr.num_params
    a, b = _prompts((6, 11), seed=2)

    def pools_match():
        for name in ("k_cache", "v_cache", "k_scale", "v_scale"):
            want, got = getattr(jr, name), getattr(tr, name)
            if want is None:
                assert got is None
                continue
            want = np.asarray(want, np.float32)
            got = got.float().numpy()
            if kv == "int8" and name.endswith("cache"):
                assert np.abs(got - want).max() <= 1.0
                assert (got != want).mean() < 1e-3
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-2 if kv == "int8" else 0)

    assert tr.prefill(a, [1, 2]) == jr.prefill(a, [1, 2])
    pools_match()
    # b's first 8 tokens sit in blocks 3, 4 (written by a full prefill);
    # its 3-token suffix goes through the partial-prefill program.
    assert tr.prefill(b[:8], [3, 4]) == jr.prefill(b[:8], [3, 4])
    assert tr.prefill_suffix(b[8:], [3, 4, 5], 8) == jr.prefill_suffix(b[8:], [3, 4, 5], 8)
    pools_match()
    tables = np.zeros((3, 8), np.int32)
    tables[0, :2] = [1, 2]
    tables[2, :3] = [3, 4, 5]
    args = (np.array([a[-1], 0, b[-1]], np.int32), np.array([6, 0, 11], np.int32),
            tables, np.array([6, 0, 11], np.int32))
    np.testing.assert_array_equal(tr.decode(*args), jr.decode(*args))
    pools_match()
    tr.copy_block(4, 9)
    jr.copy_block(4, 9)
    pools_match()
    assert tr.kv_block_bytes() == jr.kv_block_bytes()
    assert tr.kv_pool_bytes() == jr.kv_pool_bytes()
    assert tr.kv_cache_dtype_str == jr.kv_cache_dtype_str


# ---------------------------------------------------------------- engine


ENGINE_CASES = {
    # Mixed lengths + a repeated 11-token prompt (partial prefill through
    # the prefix cache) + a repeated 16-token prompt (2 full blocks: the
    # whole prompt is cached, so its last block is copied on write). The
    # auto chunk budget (a quarter of max_model_len = 16 tokens) splits
    # the 23- and 40-token prompts into chunks.
    "mixed_prefix_cow_chunked": dict(
        ecfg=dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8),
        lengths=(5, 11, 16, 23, 40), repeat=(1, 2), new=6,
    ),
    # Far too few blocks for the working set: preemption and recompute.
    "preemption": dict(
        ecfg=dict(block_size=4, num_blocks=10, max_decode_slots=4, max_blocks_per_seq=8),
        lengths=(6, 7, 5, 6), repeat=(), new=12,
    ),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_identical_to_jax(weights, case):
    spec = ENGINE_CASES[case]
    jax_eng, port_eng = _engines(weights, **spec["ecfg"])
    prompts = _prompts(spec["lengths"], seed=31)
    prompts += [list(prompts[i]) for i in spec["repeat"]]
    want = jax_eng.generate(prompts, max_new_tokens=spec["new"])
    got = port_eng.generate(prompts, max_new_tokens=spec["new"])
    assert got == want
    js, ps = jax_eng.stats(), port_eng.stats()
    for key in ("prefix_cache_hit_tokens", "cow_blocks", "preemptions",
                "chunked_prefill_requests", "prefill_chunk_dispatches", "steps"):
        assert ps[key] == js[key], key
    if case == "preemption":
        assert ps["preemptions"] > 0
    else:
        assert ps["prefix_cache_hit_tokens"] > 0
        assert ps["cow_blocks"] > 0
        assert ps["chunked_prefill_requests"] > 0
    assert port_eng.allocator.num_allocated == 0
    steps = port_eng.flight_recorder.snapshot()["steps"]
    assert steps and all(s["attn_impl"] == "reference" for s in steps)


def test_engine_flash_prefill_and_cuda_wrapper_match_jax(weights):
    """The kernel route end to end on the CPU: flash full prefill and the
    paged kernel's wrapper (attn_impl='cuda' runs its plain version on
    CPU tensors) give the JAX engine's tokens (JAX: flash via Pallas
    interpret, paged reference)."""
    tree, state = weights
    ecfg = dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=4)
    prompts = _prompts((5, 11, 16), seed=5)
    prompts += [list(prompts[1])]
    jcfg = dataclasses.replace(JAX_TINY, attention_impl="flash")
    want = JaxLLMEngine(jcfg, JaxEngineConfig(**ecfg), params=tree).generate(
        prompts, max_new_tokens=4
    )
    pcfg = dataclasses.replace(PORT_TINY, attention_impl="flash")
    eng = LLMEngine(pcfg, EngineConfig(**ecfg, attn_impl="cuda"), params=state, device="cpu")
    assert eng.generate(prompts, max_new_tokens=4) == want
    assert eng.stats()["attn_impl"] == "cuda"


def test_llm_server_concurrent_requests_match_jax(weights):
    """LLMServer on device='cpu': warmup, then 3 concurrent requests from
    threads, each token-identical to the JAX engine's greedy output."""
    tree, state = weights
    ecfg = dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8)
    prompts = _prompts((7, 19, 30), seed=9)
    want = JaxLLMEngine(JAX_TINY, JaxEngineConfig(**ecfg), params=tree).generate(
        prompts, max_new_tokens=5
    )
    server = LLMServer(PORT_TINY, EngineConfig(**ecfg), params=state, device="cpu")
    try:
        warm = server.flight_record()["compile_events"]
        assert {c["program"] for c in warm} >= {"prefill", "partial_prefill", "cow"}
        out = [None] * 3

        def client(i):
            out[i] = server.generate(prompts[i], max_new_tokens=5)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [o["token_ids"] for o in out] == want
        assert all(o["finish_reason"] == "length" for o in out)
        from ray_tpu_torch.util import tracing
        from ray_tpu_torch.util.metrics import prometheus_text

        with tracing.span("client") as root:
            streamed = list(server.generate_stream(prompts[0], max_new_tokens=5))
        assert streamed == want[0]
        # The request's lifecycle spans join the caller's trace, and the
        # engine's metric families are exported.
        names = {s["name"] for s in tracing.traces(root.trace_id)}
        assert {"client", "llm.request", "llm.prefill", "llm.decode"} <= names
        text = prometheus_text()
        assert "llm_request_ttft_seconds_bucket" in text
        assert "llm_engine_generated_tokens" in text
        m = server.metrics()
        assert m["wedged"] is False and m["kv_pool_allocated"] == 0
        assert m["device"] == "cpu"
    finally:
        server.shutdown()


def test_server_warmup_skips_only_inadmissible_buckets(weights, monkeypatch):
    """Warmup skips a bucket that admission would refuse (the pool is
    smaller than it) and warms the rest; a ValueError from a kernel
    wrapper during warmup is not taken for such a refusal and stops the
    server's start."""
    import sys

    _, state = weights
    ecfg = EngineConfig(block_size=8, num_blocks=8, max_decode_slots=2,
                        max_blocks_per_seq=16, max_prefill_tokens_per_step=0)
    server = LLMServer(PORT_TINY, ecfg, params=state, device="cpu")
    try:
        warm = {(c["program"], c["bucket"])
                for c in server.flight_record()["compile_events"]}
    finally:
        server.shutdown()
    engine = server.engine
    full = {b for p, b in warm if p == "prefill"}
    assert full and all(engine.admission_refusal(b, 2) is None for b in full)
    skipped = [b for b in ecfg.buckets() if b not in full]
    assert skipped and all(engine.admission_refusal(b, 2) for b in skipped)
    assert ("cow", 0) in warm

    def refuse(*args, **kwargs):
        raise ValueError("kernel refuses these inputs")

    monkeypatch.setattr(
        sys.modules["ray_tpu_torch.models.gpt"], "paged_attention_impl", refuse
    )
    with pytest.raises(ValueError, match="kernel refuses"):
        LLMServer(PORT_TINY, ecfg, params=state, device="cpu")


def test_engine_refuses_unported_options(weights):
    _, state = weights
    base = dict(block_size=8, num_blocks=16, max_blocks_per_seq=4)
    refused = [
        (dict(tensor_parallel_size=2), "NCCL"),
    ]
    for extra, item in refused:
        with pytest.raises(NotImplementedError, match=item):
            LLMEngine(PORT_TINY, EngineConfig(**base, **extra), device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        EngineConfig(attn_impl="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GPTRunner(PORT_TINY, EngineConfig(**base))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LLMEngine(PORT_TINY, EngineConfig(**base))


def test_server_isolates_a_poisoned_request_and_sheds_typed(weights):
    """The loop's poison isolation through the port's own fault injection
    and exceptions: the culprit fails alone with PoisonRequestError (its
    blocks released, a dead letter recorded), the next request is served,
    and bounded admission sheds with a typed error. Both errors keep their
    payload across a pickle round trip."""
    import pickle

    from ray_tpu_torch._private import fault_injection as fi
    from ray_tpu_torch.exceptions import EngineOverloadedError, PoisonRequestError

    _, state = weights
    ecfg = EngineConfig(block_size=8, num_blocks=32, max_decode_slots=2,
                        max_blocks_per_seq=4, max_queue_len=1)
    a, b = _prompts((9, 12), seed=4)
    server = LLMServer(PORT_TINY, ecfg, params=state, device="cpu", warmup=False)
    spec = fi.inject("llm.prefill", match="bad", exc_factory=lambda: RuntimeError("boom"))
    try:
        with pytest.raises(PoisonRequestError) as err:
            server.generate(a, max_new_tokens=3, request_id="bad")
        assert err.value.request_id == "bad" and spec.fires == 1
        assert server.generate(b, max_new_tokens=3)["finish_reason"] == "length"
        assert [d["request_id"] for d in server.dead_letters()] == ["bad"]
        m = server.metrics()
        assert not m["wedged"] and m["kv_pool_allocated"] == 0
        engine = server.engine
        with server._lock:  # hold the loop so the first request stays queued
            engine.add_request(a, max_new_tokens=2, request_id="queued")
            with pytest.raises(EngineOverloadedError) as shed:
                engine.add_request(b, max_new_tokens=2)
            engine.abort("queued")
        assert shed.value.queue_len == 1 and shed.value.retry_after_s > 0
        assert server.shed_requests()[-1]["reason"].startswith("queue_len")
        for exc in (err.value, shed.value):
            back = pickle.loads(pickle.dumps(exc))
            assert type(back) is type(exc) and str(back) == str(exc)
    finally:
        fi.clear()
        server.shutdown()
