"""The port's async step loop (EngineConfig(async_scheduling=True)) against
ray_tpu.llm's, on the same converted weights, on the CPU.

`GPTRunner.decode_async` must give the JAX runner's tokens, fresh and
chained, and leave the same pools behind. The async engine must be
token-identical to the JAX package's async engine and to the port's own
sync engine across prefix caching, chunked prefill, int8 pools, preemption
pressure, EOS and max-tokens overshoot, and abort; its flight records and
stats() carry the loop's fields (a chained dispatch's host gap is exactly
0), and steady decode allocates no fresh host buffers in either mode.
"""

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
from ray_tpu_torch.llm import EngineConfig, GPTRunner, LLMEngine
from ray_tpu_torch.llm.model_runner import DeviceTokens
from ray_tpu_torch.models import GPTConfig, params_from_flax

# Tiny shapes: one intra-op thread, so the suite's parallel workers keep
# their cores (several reference tests are timing-sensitive).
torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
JAX_TINY = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
PORT_TINY = GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference")

BASE = dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8)


@pytest.fixture(scope="module")
def weights():
    """(flax variables as numpy, the port's converted state_dict)."""
    params = JaxGPT(JAX_TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    return tree, params_from_flax(tree)


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, 128, size=n))) for n in lengths]


def _jax(weights, **ecfg):
    return JaxLLMEngine(JAX_TINY, JaxEngineConfig(**ecfg), params=weights[0])


def _port(weights, **ecfg):
    return LLMEngine(PORT_TINY, EngineConfig(**ecfg), params=weights[1], device="cpu")


def _pools_match(jr, tr, kv):
    """f32 pools within 1e-5 relative L2; int8 codes within one step on
    at most 0.1% of elements (an f32-noise-level K/V value may round either
    way) and scales within bf16."""
    for name in ("k_cache", "v_cache", "k_scale", "v_scale"):
        want, got = getattr(jr, name), getattr(tr, name)
        if want is None:
            assert got is None
            continue
        # Block 0 is the null block: padded lanes and idle slots write
        # garbage there that nothing reads, in either package's order.
        want = np.asarray(want, np.float32)[:, 1:]
        got = got.float().numpy()[:, 1:]
        if kv == "int8" and name.endswith("cache"):
            assert np.abs(got - want).max() <= 1.0
            assert (got != want).mean() < 1e-3
        elif kv == "int8":
            np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-5)
        else:
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= 1e-5, (name, rel)


# ---------------------------------------------------------------- runner


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_runner_decode_async_matches_jax(weights, kv):
    """A fresh dispatch from numpy tokens, then two chained dispatches fed
    the previous step's device tokens: each step's fetched tokens equal
    the JAX runner's, the pools match afterwards, and chained token inputs
    never count as host bytes."""
    tree, state = weights
    ecfg = dict(block_size=4, num_blocks=16, max_decode_slots=3,
                max_blocks_per_seq=8, kv_cache_dtype=kv)
    jr = JaxGPTRunner(JAX_TINY, JaxEngineConfig(**ecfg), params=tree)
    tr = GPTRunner(PORT_TINY, EngineConfig(**ecfg), params=state, device="cpu")
    a, b = _prompts((6, 9), seed=3)
    assert tr.prefill(a, [1, 2]) == jr.prefill(a, [1, 2])
    assert tr.prefill(b, [3, 4, 5]) == jr.prefill(b, [3, 4, 5])
    tables = np.zeros((3, 8), np.int32)
    tables[0, :3] = [1, 2, 6]
    tables[2, :4] = [3, 4, 5, 7]
    lens = np.array([6, 0, 9], np.int32)
    tokens = np.array([a[-1], 0, b[-1]], np.int32)
    j_tok, t_tok = tokens, tokens
    for step in range(3):
        pos = np.where(lens > 0, lens + step, 0).astype(np.int32)
        before = tr.host_bytes_in
        j_tok = jr.decode_async(j_tok, pos, tables, pos)
        t_tok = tr.decode_async(t_tok, pos, tables, pos)
        assert isinstance(t_tok, DeviceTokens) and not t_tok.pending()
        np.testing.assert_array_equal(t_tok.fetch(), np.asarray(j_tok))
        # positions, context lens, block ids, offsets and the tables; the
        # tokens only on the fresh dispatch.
        fed = tr.host_bytes_in - before
        assert fed == (0 if step else tokens.nbytes) + 4 * pos.nbytes + tables.nbytes
    _pools_match(jr, tr, kv)


# ---------------------------------------------------------------- engine


ASYNC_CASES = {
    # Repeated prompts: partial prefill through the prefix cache and a
    # whole-prompt hit (copy-on-write), then the same batch again.
    "prefix_cow": dict(ecfg=BASE, lengths=(9, 16, 5), repeat=(0, 1), new=6),
    "chunked": dict(ecfg=dict(BASE, max_prefill_tokens_per_step=8,
                              prefill_buckets=(8, 32)),
                    lengths=(9, 20, 5), repeat=(1,), new=6),
    "int8": dict(ecfg=dict(BASE, kv_cache_dtype="int8"), lengths=(9, 8, 5),
                 repeat=(), new=6),
    # Far too few blocks for the working set: preempt-resume, and chained
    # steps that the lookahead cannot cover flush instead.
    "preemption": dict(ecfg=dict(block_size=4, num_blocks=10, max_decode_slots=4,
                                 max_blocks_per_seq=8),
                       lengths=(6, 7, 5, 6), repeat=(), new=12),
}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_engine_identical_to_jax_and_sync(weights, case):
    spec = ASYNC_CASES[case]
    prompts = _prompts(spec["lengths"], seed=6)
    prompts += [list(prompts[i]) for i in spec["repeat"]]
    on = dict(spec["ecfg"], async_scheduling=True)
    want = _jax(weights, **on).generate(prompts, max_new_tokens=spec["new"])
    sync = _port(weights, **spec["ecfg"]).generate(prompts, max_new_tokens=spec["new"])
    eng = _port(weights, **on)
    got = eng.generate(prompts, max_new_tokens=spec["new"])
    assert got == want == sync
    stats = eng.stats()
    assert stats["async_scheduling"] is True and stats["inflight_steps"] == 0
    assert eng.allocator.num_allocated == 0
    steps = eng.flight_recorder.snapshot()["steps"]
    assert any(s["chained"] for s in steps), "the async loop never chained"
    if case == "preemption":
        assert stats["preemptions"] > 0
    if case in ("prefix_cow", "chunked"):
        assert stats["prefix_cache_hit_tokens"] > 0
    if case == "chunked":
        assert stats["chunked_prefill_requests"] > 0


def _eos_fixture(weights):
    """A prompt and an EOS position taken from its own greedy stream: the
    first of 12 seeded prompts whose stream has a token, at index >= 3
    (chained steps precede it), that did not occur before it (the tiny
    random model often repeats one token). The premise is asserted, not
    assumed."""
    prompts = _prompts((6,) * 12, seed=21)
    streams = _port(weights, **BASE).generate(prompts, max_new_tokens=12)
    for prompt, want in zip(prompts, streams):
        k = next((i for i in range(3, len(want)) if want[i] not in want[:i]), None)
        if k is not None:
            return prompt, want, k
    raise AssertionError(("no stream has a fresh token to stop on", streams))


def test_async_eos_overshoot_never_emitted(weights):
    """EOS is seen one step late under async: when step N's commit reads
    the EOS, the chained step N+1 has already run. Its token must never
    reach the client: the stream ends exactly at the EOS, as the sync
    engine's and JAX's async engine's do, and the overshoot record is
    drained with zero tokens."""
    prompt, want, k = _eos_fixture(weights)
    eos = want[k]
    assert eos not in want[:k]
    jax_eng = _jax(weights, **BASE, async_scheduling=True)
    assert jax_eng.generate([prompt], max_new_tokens=12, eos_id=eos)[0] == want[: k + 1]
    for mode in (False, True):
        eng = _port(weights, **BASE, async_scheduling=mode)
        stream = []
        eng.add_request(prompt, max_new_tokens=12, eos_id=eos, on_token=stream.append)
        while eng.has_work():
            eng.step()
        assert stream == want[: k + 1], (mode, stream)
        assert eng.allocator.num_allocated == 0
        if mode:
            steps = eng.flight_recorder.snapshot()["steps"]
            assert any(s["chained"] for s in steps)
            drained = [c for s in steps for c in s["commits"] if c["tokens"] == 0]
            assert drained, "the overshoot step was never drained"


def test_async_max_tokens_overshoot_not_emitted(weights):
    prompts = _prompts((7, 5), seed=9)
    want = _jax(weights, **BASE, async_scheduling=True).generate(prompts, max_new_tokens=3)
    got = _port(weights, **BASE, async_scheduling=True).generate(prompts, max_new_tokens=3)
    assert got == want and all(len(o) == 3 for o in got)


def test_async_abort_mid_flight(weights):
    """Abort one of two requests while a decode step is in flight: the
    other's tokens stay identical to sync and to JAX's async engine, the
    aborted stream is a prefix of its sync output, the in-flight orphan
    token is dropped, and every block returns."""
    prompts = _prompts((6, 9), seed=14)
    sync = _port(weights, **BASE).generate(prompts, max_new_tokens=10)
    streams = {}
    for name, eng in (("jax", _jax(weights, **BASE, async_scheduling=True)),
                      ("port", _port(weights, **BASE, async_scheduling=True))):
        out = [[], []]
        rids = [eng.add_request(p, max_new_tokens=10, on_token=o.append)
                for p, o in zip(prompts, out)]
        for _ in range(4):
            eng.step()
        assert eng.stats()["inflight_steps"] == 1
        assert eng.abort(rids[0])
        while eng.has_work():
            eng.step()
        assert eng.allocator.num_allocated == 0
        assert eng.stats()["inflight_steps"] == 0
        streams[name] = out
    assert streams["port"] == streams["jax"]
    assert streams["port"][1] == sync[1]
    assert 0 < len(streams["port"][0]) < 10
    assert streams["port"][0] == sync[0][: len(streams["port"][0])]


def test_async_commit_failure_attributed_to_its_dispatch_step(weights):
    """A fault in the commit loop surfaces one step after its dispatch:
    failure_step() names the dispatch index, the culprit fails alone with
    that step in its dead letter, and the other request finishes
    token-identical to the sync engine."""
    from ray_tpu_torch._private import fault_injection as fi

    prompts = _prompts((6, 9), seed=15)
    sync = _port(weights, **BASE).generate(prompts, max_new_tokens=8)
    eng = _port(weights, **BASE, async_scheduling=True)
    out = [[], []]
    for p, o, rid in zip(prompts, out, ("good", "bad")):
        eng.add_request(p, max_new_tokens=8, request_id=rid, on_token=o.append)
    for _ in range(3):
        eng.step()
    spec = fi.inject("llm.decode.seq", match="bad",
                     exc_factory=lambda: RuntimeError("poison"), times=1)
    try:
        with pytest.raises(RuntimeError, match="poison"):
            eng.step()
        culprit = eng.culprit_for(RuntimeError("poison"))
        assert culprit == "bad" and spec.fires == 1
        assert eng.failure_step() == eng._steps - 1
        assert eng.fail_request(culprit, RuntimeError("poison"))
        assert eng.dead_letters()[-1]["step"] == eng._steps - 1
    finally:
        fi.clear()
    while eng.has_work():
        eng.step()
    assert out[0] == sync[0]
    assert out[1] == sync[1][: len(out[1])]
    assert eng.allocator.num_allocated == 0


@pytest.mark.parametrize("mode", [False, True])
def test_steady_decode_allocates_no_fresh_host_buffers(weights, mode):
    """The decode inputs are preallocated and reused: steady decode steps
    make no np.zeros allocation in either loop mode, and the buffer
    objects stay the same."""
    eng = _port(weights, **BASE, async_scheduling=mode)
    for p in _prompts((5, 9), seed=12):
        eng.add_request(p, max_new_tokens=16)
    eng.step()
    eng.step()  # both admitted: the loop is now pure decode
    bufs = [id(b) for b in (eng._dec_tokens, eng._dec_positions,
                            eng._dec_block_tables, eng._dec_context_lens)]
    calls = []
    real_zeros = np.zeros
    np.zeros = lambda *a, **kw: (calls.append(a), real_zeros(*a, **kw))[1]
    try:
        for _ in range(6):
            eng.step()
    finally:
        np.zeros = real_zeros
    assert calls == [], f"steady decode allocated host buffers: {calls}"
    assert bufs == [id(b) for b in (eng._dec_tokens, eng._dec_positions,
                                    eng._dec_block_tables, eng._dec_context_lens)]
    while eng.has_work():
        eng.step()


def test_host_gap_stats_and_flight_record(weights):
    """Both loops stamp dispatch and commits; async records carry `loop`,
    `chained` and `inflight_depth`, chained dispatches record a gap of
    exactly 0 and the sync loop a positive one; the histogram exports."""
    from ray_tpu_torch.util.metrics import prometheus_text

    prompts = _prompts((5, 9), seed=3)
    gaps = {}
    for mode in (False, True):
        eng = _port(weights, **BASE, async_scheduling=mode)
        eng.generate(prompts, max_new_tokens=8)
        stats = eng.stats()
        assert stats["async_scheduling"] is mode and stats["inflight_steps"] == 0
        assert stats["host_gap_samples"] > 0 and stats["host_gap_last_s"] is not None
        gaps[mode] = stats["host_gap_mean_s"]
        steps = [s for s in eng.flight_recorder.snapshot()["steps"] if s["commits"]]
        assert steps
        for s in steps:
            for c in s["commits"]:
                assert c["dispatch_step"] <= s["step"] and "time" in c
        if mode:
            chained = [s for s in steps if s["chained"]]
            assert chained and all(s["host_gap_s"] == 0.0 for s in chained)
            assert all(s["loop"] == "async" and s["inflight_depth"] in (0, 1)
                       for s in steps)
            # A chained step commits the record it chained from.
            assert all(c["dispatch_step"] == s["step"] - 1
                       for s in chained for c in s["commits"])
        else:
            assert all("loop" not in s and "chained" not in s for s in steps)
            measured = [s["host_gap_s"] for s in steps if s["host_gap_s"] is not None]
            assert measured and all(g > 0.0 for g in measured)
    assert gaps[True] < gaps[False]
    assert "llm_engine_step_host_gap_seconds_bucket" in prometheus_text()
