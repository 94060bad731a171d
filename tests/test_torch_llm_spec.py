"""The port's speculative decoding (EngineConfig(speculation="ngram" |
"draft")) against ray_tpu.llm's, on the same converted weights, on the CPU.

The proposers must propose what the JAX package's propose on the same
histories and draft weights; `GPTRunner.verify` must give the JAX runner's
argmax on every fed lane and leave the same pools behind; and the engine
must be token-identical to the JAX engine with the same proposed, accepted
and emitted counts at every verify step — under preemption, with EOS and
budget, with int8 pools, with async scheduling — and release the draft
mirror's blocks on abort. A draft sharing the target's weights accepts
everything; the server's warmup runs every verify bucket.
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
from ray_tpu.llm import NgramProposer as JaxNgramProposer
from ray_tpu.llm import build_proposer as jax_build_proposer
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch.llm import (
    EngineConfig,
    GPTRunner,
    LLMEngine,
    LLMServer,
    NgramProposer,
    build_proposer,
)
from ray_tpu_torch.models import GPTConfig, params_from_flax

# Tiny shapes: one intra-op thread, so the suite's parallel workers keep
# their cores (several reference tests are timing-sensitive).
torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
DRAFT = dict(TINY, num_layers=1)
JAX_TINY = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
PORT_TINY = GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference")
JAX_DRAFT = JaxGPTConfig(**DRAFT, dtype=jnp.float32, attention_impl="reference")
PORT_DRAFT = GPTConfig(**DRAFT, dtype=torch.float32, attention_impl="reference")

KW = dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8)


def _init(cfg, seed):
    params = JaxGPT(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


@pytest.fixture(scope="module")
def weights():
    """Target and draft weights: (flax trees, the port's state dicts)."""
    tree, dtree = _init(JAX_TINY, 0), _init(JAX_DRAFT, 1)
    return (tree, dtree), (params_from_flax(tree), params_from_flax(dtree))


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, 128, size=n))) for n in lengths]


def _engines(weights, mode, **ecfg):
    """(JAX engine, port engine) with speculation `mode` on the same
    target (and draft) weights."""
    (tree, dtree), (state, dstate) = weights
    jkw, pkw = dict(ecfg, speculation=mode), dict(ecfg, speculation=mode)
    jd = pd = None
    if mode == "draft":
        jkw.setdefault("draft_model_config", JAX_DRAFT)
        pkw.setdefault("draft_model_config", PORT_DRAFT)
        jd, pd = dtree, dstate
    jax_eng = JaxLLMEngine(JAX_TINY, JaxEngineConfig(**jkw), params=tree, draft_params=jd)
    port_eng = LLMEngine(PORT_TINY, EngineConfig(**pkw), params=state, device="cpu",
                         draft_params=pd)
    return jax_eng, port_eng


def _verify_records(eng):
    return [r["speculation"] for r in eng.flight_recorder.snapshot()["steps"]
            if "speculation" in r]


def _assert_same_run(jax_eng, port_eng):
    """Same proposed / accepted / emitted counts (and fed bucket) at every
    verify step, and the same totals."""
    assert _verify_records(port_eng) == _verify_records(jax_eng)
    js, ps = jax_eng.stats(), port_eng.stats()
    for key in ("spec_verify_steps", "spec_proposed_tokens", "spec_accepted_tokens",
                "spec_tokens_per_verify_step", "steps", "preemptions"):
        assert ps[key] == js[key], key
    assert port_eng.allocator.num_allocated == 0


# ---------------------------------------------------------------- proposers


def test_ngram_proposals_match_jax():
    rng = np.random.RandomState(5)
    histories = [list(map(int, rng.randint(0, 6, size=n))) for n in (0, 1, 4, 9, 17, 40)]
    histories += [[7, 8, 9, 1, 2, 3, 7, 8, 9], [6] * 8, [5, 1, 9, 9, 5, 2, 9, 9, 5]]
    for nmax, nmin in ((3, 1), (2, 2), (4, 1)):
        port, ref = NgramProposer(nmax, nmin), JaxNgramProposer(nmax, nmin)
        for tokens in histories:
            for k in (0, 1, 3, 8):
                assert port.match(tokens, k) == ref.match(tokens, k), (tokens, k)
    with pytest.raises(ValueError, match="ngram_min"):
        NgramProposer(ngram_max=0)
    assert build_proposer(EngineConfig()) is None


class _Req:
    def __init__(self, rid, max_new_tokens=16):
        self.request_id = rid
        self.max_new_tokens = max_new_tokens
        self.eos_id = None


class _Seq:
    def __init__(self, ids, rid):
        self.prefill_ids = list(ids)
        self.request = _Req(rid)
        self.generated = []


def test_draft_proposals_match_jax(weights):
    """The draft proposer on the same draft weights (through
    params_from_flax): first contact (full prefill, chains crossing a
    block boundary, a block-aligned prompt), then catch-up after commits
    (partial prefill of the accepted tokens), a step retry on unchanged
    state, and release."""
    (_, dtree), (_, dstate) = weights
    kw = dict(KW, speculation="draft", num_speculative_tokens=4)
    ref = jax_build_proposer(JaxEngineConfig(**kw, draft_model_config=JAX_DRAFT),
                             draft_params=dtree)
    port = build_proposer(EngineConfig(**kw, draft_model_config=PORT_DRAFT),
                          draft_params=dstate, device="cpu")
    assert port.name == "draft" and port.runner.device.type == "cpu"
    seqs = {name: [_Seq(ids, rid) for rid, ids in
                   (("a", range(1, 9)), ("b", range(20, 27)), ("c", [3, 4] * 7))]
            for name in ("jax", "port")}
    for step in range(3):
        want = ref.propose(seqs["jax"], 4)
        got = port.propose(seqs["port"], 4)
        assert got == want and all(len(p) == 4 for p in got), step
        for name in seqs:  # commit the first proposal + a correction
            for s, p in zip(seqs[name], want):
                s.prefill_ids += [p[0], 42 + step]
                s.generated += [p[0], 42 + step]
    assert port.propose(seqs["port"], 4) == ref.propose(seqs["jax"], 4)
    assert port.propose(seqs["port"], 4) == ref.propose(seqs["jax"], 4)  # retry
    assert port.allocator.num_allocated == ref.allocator.num_allocated > 0
    for rid in "abc":
        port.release(rid)
    assert port.allocator.num_allocated == 0 and port._state == {}


# ---------------------------------------------------------------- runner


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_runner_verify_matches_jax(weights, kv):
    """Verify at fed widths 5 (the split kernel's side of SPLIT_MAX_S on
    the card) and 9 (the suffix kernel's): a slot with 4 proposals, one
    with 1, an idle slot (true_len 0, its lanes on the null block), one
    at a block edge. The argmax on every fed lane equals JAX's; the pools
    match afterwards (f32 within 1e-5 relative L2; int8 codes within one
    step on < 0.1% of elements, scales within bf16)."""
    (tree, _), (state, _) = weights
    ecfg = dict(block_size=4, num_blocks=24, max_decode_slots=4,
                max_blocks_per_seq=8, kv_cache_dtype=kv)
    jr = JaxGPTRunner(JAX_TINY, JaxEngineConfig(**ecfg), params=tree)
    tr = GPTRunner(PORT_TINY, EngineConfig(**ecfg), params=state, device="cpu")
    a, b, c = _prompts((6, 9, 8), seed=8)
    for ids, blocks in ((a, [1, 2]), (b, [3, 4, 5]), (c, [6, 7])):
        assert tr.prefill(ids, blocks) == jr.prefill(ids, blocks)
    tables = np.zeros((4, 8), np.int32)
    tables[0, :4] = [1, 2, 8, 9]
    tables[1, :4] = [3, 4, 5, 10]
    tables[3, :5] = [6, 7, 11, 12, 13]
    rng = np.random.RandomState(4)
    for width, fed in ((5, (5, 2, 0, 5)), (9, (9, 2, 0, 9))):
        lens = np.array([6, 9, 0, 8], np.int32)
        if width == 9:
            lens = lens + np.array([5, 2, 0, 5], np.int32)
        tokens = rng.randint(0, 128, size=(4, width)).astype(np.int32)
        true_lens = np.array(fed, np.int32)
        tokens[np.arange(width)[None, :] >= true_lens[:, None]] = 0
        want = np.asarray(jr.verify(tokens, tables, lens, true_lens))
        got = tr.verify(tokens, tables, lens, true_lens)
        assert got.shape == want.shape == (4, width)
        for i, n in enumerate(fed):
            np.testing.assert_array_equal(got[i, :n], want[i, :n])
        _pools_match(jr, tr, kv)


def _pools_match(jr, tr, kv):
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


# ---------------------------------------------------------------- engine


def _workload():
    """Random lengths (full prefill), a repeated prompt (partial prefill
    through the prefix cache), a repeated 2-block prompt (copy-on-write),
    and repetitive prompts the n-gram proposer can hit."""
    prompts = _prompts((5, 11, 16, 3), seed=2)
    prompts += [list(prompts[1]), list(prompts[2]), [7, 8, 9, 10] * 5, [3, 4] * 8]
    return prompts


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_engine_speculation_identical_to_jax(weights, mode):
    prompts = _workload()
    jax_eng, port_eng = _engines(weights, mode, **KW)
    want = jax_eng.generate(prompts, max_new_tokens=8)
    got = port_eng.generate(prompts, max_new_tokens=8)
    assert got == want
    _assert_same_run(jax_eng, port_eng)
    stats = port_eng.stats()
    assert stats["speculation"] == mode
    assert stats["spec_verify_steps"] > 0 and stats["spec_accepted_tokens"] > 0
    assert stats["prefix_cache_hit_tokens"] > 0 and stats["cow_blocks"] > 0
    assert stats["spec_draft_pool_allocated"] == 0
    plain = LLMEngine(PORT_TINY, EngineConfig(**KW), params=weights[1][0], device="cpu")
    assert plain.generate(prompts, max_new_tokens=8) == got


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_engine_speculation_identical_under_preemption(weights, mode):
    kw = dict(block_size=4, num_blocks=10, max_decode_slots=4, max_blocks_per_seq=8)
    prompts = _prompts((6, 7, 5), seed=1) + [[9, 2] * 3]
    jax_eng, port_eng = _engines(weights, mode, **kw)
    want = jax_eng.generate(prompts, max_new_tokens=12)
    assert port_eng.generate(prompts, max_new_tokens=12) == want
    _assert_same_run(jax_eng, port_eng)
    assert port_eng.stats()["preemptions"] > 0
    if mode == "draft":
        assert port_eng._spec.allocator.num_allocated == 0
        assert port_eng._spec._state == {}


def test_engine_speculation_eos_and_budget(weights):
    """An EOS taken from the stream (asserted not to occur before its
    position) truncates a verify commit exactly where the plain loop
    stops; a budget shorter than k + 1 is never overshot."""
    # The first of 8 seeded repetitive prompts whose stream has a fresh
    # token at index >= 2 (the tiny random model often repeats one token).
    phrases = [[11, 12, 13]] + _prompts((3,) * 7, seed=17)
    candidates = [p * 6 for p in phrases]
    jax_eng, port_eng = _engines(weights, "ngram", **KW)
    plain_eng = LLMEngine(PORT_TINY, EngineConfig(**KW), params=weights[1][0], device="cpu")
    streams = plain_eng.generate(candidates, max_new_tokens=10)
    fresh = [next((i for i in range(2, len(s)) if s[i] not in s[:i]), None)
             for s in streams]
    assert any(k is not None for k in fresh), ("no fresh token to stop on", streams)
    rep, plain, k = next((c, s, k) for c, s, k in zip(candidates, streams, fresh)
                         if k is not None)
    eos = plain[k]
    assert eos not in plain[:k]
    got = port_eng.generate([rep], max_new_tokens=10, eos_id=eos)[0]
    assert got == jax_eng.generate([rep], max_new_tokens=10, eos_id=eos)[0] == plain[: k + 1]
    assert port_eng.generate([rep], max_new_tokens=3)[0] == plain[:3]
    jax_eng.generate([rep], max_new_tokens=3)
    _assert_same_run(jax_eng, port_eng)
    assert port_eng.stats()["spec_verify_steps"] > 0


def test_engine_speculation_int8_identical_to_jax_and_plain_int8(weights):
    """int8 pools: verify lanes attend each other in full precision while
    decode reads them back quantized, so the contract is argmax identity
    on the tested prompts, as the reference's."""
    kw = dict(KW, kv_cache_dtype="int8")
    prompts = _prompts((5, 11), seed=32) + [[5, 6, 7] * 5]
    jax_eng, port_eng = _engines(weights, "ngram", **kw)
    want = jax_eng.generate(prompts, max_new_tokens=4)
    assert port_eng.generate(prompts, max_new_tokens=4) == want
    _assert_same_run(jax_eng, port_eng)
    plain = LLMEngine(PORT_TINY, EngineConfig(**kw), params=weights[1][0], device="cpu")
    assert plain.generate(prompts, max_new_tokens=4) == want


def test_draft_sharing_target_weights_accepts_everything(weights):
    (tree, _), (state, _) = weights
    kw = dict(KW, speculation="draft", num_speculative_tokens=3)
    eng = LLMEngine(PORT_TINY, EngineConfig(**kw, draft_model_config=PORT_TINY),
                    params=state, device="cpu", draft_params=state)
    jax_eng = JaxLLMEngine(JAX_TINY, JaxEngineConfig(**kw, draft_model_config=JAX_TINY),
                           params=tree, draft_params=tree)
    prompts = _prompts((5, 9), seed=4)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == jax_eng.generate(prompts, max_new_tokens=8)
    _assert_same_run(jax_eng, eng)
    stats = eng.stats()
    assert stats["spec_acceptance_rate"] == 1.0
    assert stats["spec_accepted_tokens"] == stats["spec_proposed_tokens"] > 0
    assert stats["spec_tokens_per_verify_step"] > 1.0


def test_abort_releases_draft_blocks(weights):
    """Abort while the draft mirror holds blocks (asserted after one
    step, before the request could finish)."""
    _, port_eng = _engines(weights, "draft", **KW)
    rid = port_eng.add_request([1, 2, 3] * 4, max_new_tokens=16)
    port_eng.step()
    assert port_eng.scheduler.is_active(rid)
    assert port_eng._spec.allocator.num_allocated > 0  # the mirror is live
    assert port_eng.abort(rid)
    assert port_eng.allocator.num_allocated == 0
    assert port_eng._spec.allocator.num_allocated == 0 and port_eng._spec._state == {}


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_async_with_speculation_identical_to_jax(weights, mode):
    """Speculation under async scheduling flushes the pipeline every
    step (the proposer reads committed tokens): token-identical to JAX's
    async engine and to the port's sync spec engine, with the same verify
    records, and no step chains."""
    prompts = _workload()[4:] + _prompts((6,), seed=3)
    jax_eng, port_eng = _engines(weights, mode, **KW, async_scheduling=True)
    want = jax_eng.generate(prompts, max_new_tokens=8)
    assert port_eng.generate(prompts, max_new_tokens=8) == want
    _assert_same_run(jax_eng, port_eng)
    steps = port_eng.flight_recorder.snapshot()["steps"]
    assert all(s["loop"] == "async" and not s["chained"] for s in steps)
    assert port_eng.stats()["inflight_steps"] == 0
    _, sync_eng = _engines(weights, mode, **KW)
    assert sync_eng.generate(prompts, max_new_tokens=8) == want


def test_speculation_metrics_and_flight_records(weights):
    from ray_tpu_torch.util.metrics import prometheus_text

    _, eng = _engines(weights, "ngram", **KW)
    eng.generate([[4, 5, 6] * 5], max_new_tokens=8)
    stats = eng.stats()
    assert stats["spec_verify_steps"] > 0 and stats["spec_tokens_per_verify_step"] > 1.0
    text = prometheus_text()
    for name in ("llm_engine_spec_proposed_tokens", "llm_engine_spec_accepted_tokens",
                 "llm_engine_spec_acceptance_rate"):
        assert name in text
    assert 'phase="verify"' in text
    records = [r for r in eng.flight_recorder.snapshot()["steps"] if "speculation" in r]
    rec = records[-1]["speculation"]
    assert rec["mode"] == "ngram" and rec["proposed"] >= rec["accepted"] >= 0
    assert rec["emitted"] >= 1 and "verify" in records[-1]["phase"]


def test_server_warmup_runs_every_verify_bucket(weights):
    """LLMServer's warmup runs every verify width and the draft's programs
    (recorded as compile events), then serves token-identically to the
    JAX engine."""
    kw = dict(KW, prefill_buckets=(8, 32), num_speculative_tokens=8)
    jax_eng, _ = _engines(weights, "draft", **kw)
    (_, _), (state, dstate) = weights
    server = LLMServer(PORT_TINY, EngineConfig(**kw, speculation="draft",
                                               draft_model_config=PORT_DRAFT),
                       params=state, device="cpu", draft_params=dstate)
    try:
        events = {(e["program"], e["bucket"])
                  for e in server.flight_record()["compile_events"]}
        for s_bucket in (2, 3, 5, 9):
            assert ("verify", s_bucket) in events
        assert ("proposer:draft", 0) in events
        prompt = [1, 2, 3] * 4
        out = server.generate(prompt, max_new_tokens=6)
        assert out["token_ids"] == jax_eng.generate([prompt], max_new_tokens=6)[0]
        m = server.metrics()
        assert m["spec_verify_steps"] > 0 and m["spec_draft_pool_allocated"] == 0
    finally:
        server.shutdown()


def test_speculation_config_is_validated_and_no_longer_refused(weights):
    with pytest.raises(ValueError, match="draft_model_config"):
        EngineConfig(speculation="draft")
    assert EngineConfig(speculation="ngram", num_speculative_tokens=8).verify_buckets() == (
        2, 3, 5, 9)
    eng = LLMEngine(PORT_TINY, EngineConfig(**KW, speculation="ngram",
                                            async_scheduling=True),
                    params=weights[1][0], device="cpu")
    assert eng.stats()["speculation"] == "ngram" and eng.stats()["async_scheduling"]
    # The draft model takes the engine's device.
    eng = LLMEngine(PORT_TINY, EngineConfig(**KW, speculation="draft",
                                            draft_model_config=PORT_DRAFT),
                    params=weights[1][0], device="cpu")
    assert eng._spec.runner.device == eng.runner.device
