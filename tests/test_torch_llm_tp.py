"""ray_tpu_torch.llm at tensor_parallel_size 2, over gloo on the CPU,
against ray_tpu.llm at tp=1 and tp=2 on the same weights (the counterparts
of tests/test_llm_tp.py; this file: the plain engine, prefix caching and
copy-on-write, the host-transfer series, the collectives of one decode
step, preemption and chunked prefill).

The port's engine process is rank 0 and one spawned process is rank 1;
the weights are the reference engine's (seed 0), converted by
`params_from_flax`, f32 with the plain attention, so greedy tokens must be
identical to both reference engines'. Ranks are started once for the file
(`group`) and every port engine here runs on them; each engine frees its
shard on the ranks at its `shutdown()`. A hung rank fails a test after
the group's collective timeout (`parallel.TP_TIMEOUT_S`, 60 s) instead of
hanging the run.
"""

import jax
import numpy as np
import pytest
import torch
from flax.linen import meta

import jax.numpy as jnp
from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch.llm import EngineConfig, LLMEngine
from ray_tpu_torch.llm import engine as engine_module
from ray_tpu_torch.models import GPTConfig, params_from_flax
from ray_tpu_torch.parallel import tensor_parallel_group

torch.set_num_threads(1)

SHAPE = dict(vocab_size=64, num_layers=1, num_heads=4, embed_dim=32, max_seq_len=128)
JAX_TINY = JaxGPTConfig(**SHAPE, dtype=jnp.float32, attention_impl="reference")
TINY = GPTConfig(**SHAPE, dtype=torch.float32, attention_impl="reference")
BASE = dict(block_size=4, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=16)
HEAD_SPEC = "PartitionSpec(None, None, None, 'tp')"


def random_prompts(lengths, vocab=64, seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=n))) for n in lengths]


def host_params(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, meta.unbox(params)))


@pytest.fixture(scope="module")
def _ranks():
    g = tensor_parallel_group(2, "cpu")
    yield g
    g.close()


@pytest.fixture
def group(_ranks, monkeypatch):
    """The file's two CPU ranks, handed to every tp=2 engine the test
    makes in place of the engine's own spawn; an engine's shutdown then
    drops only its runners' shards and leaves the ranks up."""
    monkeypatch.setattr(engine_module, "tensor_parallel_group", lambda tp, device: _ranks)
    monkeypatch.setattr(_ranks, "close", lambda: None)
    return _ranks


def reference(tp, **overrides):
    return JaxLLMEngine(
        JAX_TINY, JaxEngineConfig(tensor_parallel_size=tp, **{**BASE, **overrides}), seed=0
    )


def port(tp, params, **overrides):
    return LLMEngine(
        TINY, EngineConfig(tensor_parallel_size=tp, **{**BASE, **overrides}),
        params=params, device="cpu",
    )


def triple(group, prompts, n_new, **overrides):
    """Reference tp=1 and tp=2 and the port's tp=2 on the same prompts:
    (tokens, port engine). Asserts all three agree."""
    r1, r2 = reference(1, **overrides), reference(2, **overrides)
    want = r1.generate(prompts, max_new_tokens=n_new)
    assert r2.generate(prompts, max_new_tokens=n_new) == want
    e2 = port(2, host_params(r1.runner.params), **overrides)
    assert e2.generate(prompts, max_new_tokens=n_new) == want
    return want, e2


def _steps(engine):
    return engine.flight_recorder.snapshot()["steps"]


def test_tp2_parity_reference_prefix_cow_and_flat_host_bytes(group):
    """Tokens equal both reference engines'; the per-step host-transfer
    series is the same at tp=1 and tp=2 (rank 0 feeds and fetches what
    tp=1 does; the other ranks get their inputs by broadcast); a repeated
    workload hits the prefix cache and a fully cached block-aligned prompt
    takes the copy-on-write path, every rank copying its own heads."""
    prompts = random_prompts((5, 11, 3, 8), seed=1)
    r1, r2 = reference(1), reference(2)
    w = host_params(r1.runner.params)
    p1, p2 = port(1, w), port(2, w)
    want = r1.generate(prompts, max_new_tokens=8)
    assert r2.generate(prompts, max_new_tokens=8) == want
    assert p2.generate(prompts, max_new_tokens=8) == want
    assert p1.generate(prompts, max_new_tokens=8) == want
    s1 = [(s["phase"], s["host_transfer_bytes"]) for s in _steps(p1)]
    s2 = [(s["phase"], s["host_transfer_bytes"]) for s in _steps(p2)]
    assert s1 == s2
    assert any(b > 0 for _, b in s1)
    assert all(s["tensor_parallel_size"] == 2 for s in _steps(p2))
    want = r1.generate(prompts, max_new_tokens=6)
    assert p2.generate(prompts, max_new_tokens=6) == want
    assert p2.stats()["prefix_cache_hit_tokens"] > 0
    cow = random_prompts((8,), seed=3)[0]
    want = r1.generate([cow, cow], max_new_tokens=6)
    assert r2.generate([cow, cow], max_new_tokens=6) == want
    assert p2.generate([cow, cow], max_new_tokens=6) == want
    assert p2.scheduler.num_cow_blocks > 0
    assert p2.runner.pool_sharding_spec() == HEAD_SPEC
    assert p2.stats()["kv_pool_sharding"] == HEAD_SPEC
    assert p1.runner.pool_sharding_spec() is None
    assert tuple(p2.runner.k_cache.shape) == (1, 64, 4, 2, 8)
    p2.shutdown()


class _Counting:
    """Stands in for a process group's backend and counts the collectives
    called on it by name."""

    def __init__(self, inner):
        self.inner, self.calls = inner, {}

    def __getattr__(self, name):
        attr = getattr(self.inner, name)

        def call(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            return attr(*args, **kwargs)

        return call


def test_tp2_decode_step_is_2L_all_reduces_plus_the_input_broadcast(group):
    """The counterpart of the reference's zero-all-gather HLO check: one
    decode step at tp=2 issues, on rank 0's backend, exactly 2 * L
    all-reduces (after attn_proj and mlp_out of every block) and one
    broadcast (the packed inputs), and nothing else — no all-gather; rank
    1 issues the same all-reduces."""
    deep = GPTConfig(**{**SHAPE, "num_layers": 3}, dtype=torch.float32,
                     attention_impl="reference")
    e = LLMEngine(deep, EngineConfig(tensor_parallel_size=2, **BASE), device="cpu")
    r, slots = e.runner, BASE["max_decode_slots"]
    zeros = np.zeros((slots,), np.int32)
    table = np.zeros((slots, BASE["max_blocks_per_seq"]), np.int32)
    r.decode(zeros, zeros, table, zeros)  # the first step's lazy setup
    before = group.report()[0]["collectives"]
    counting = group.backend = _Counting(group.backend)
    try:
        out = r.decode(zeros, zeros, table, zeros)
    finally:
        group.backend = counting.inner
    after = group.report()[0]["collectives"]
    assert out.shape == (slots,)
    assert counting.calls == {"allreduce": 2 * deep.num_layers, "broadcast": 1}
    assert after["all_reduce"] - before["all_reduce"] == 2 * deep.num_layers
    assert after["broadcast"] - before["broadcast"] == 1
    assert after["gather"] == before["gather"]
    e.shutdown()


def test_tp2_parity_preempt_resume(group):
    """A pool far too small for the working set forces recompute-style
    preemption; resume re-prefills through the split programs."""
    prompts = random_prompts((6, 7, 5, 6), seed=4)
    _, e2 = triple(group, prompts, 10, num_blocks=10, max_blocks_per_seq=8)
    assert e2.stats()["preemptions"] > 0
    assert e2.allocator.num_allocated == 0
    e2.shutdown()


def test_tp2_parity_chunked_prefill(group):
    prompts = random_prompts((30, 5, 17), seed=5)
    _, e2 = triple(group, prompts, 8, max_prefill_tokens_per_step=8)
    assert e2.stats()["chunked_prefill_requests"] > 0
    e2.shutdown()


def test_tp2_async_scheduling_chains_tokens_through_the_broadcast(group):
    """Async stepping at tp=2: chained decode inputs reach rank 1 inside
    the input broadcast (they never cross the host), tokens equal the
    reference's and the host-transfer series equals tp=1's."""
    prompts = random_prompts((5, 9, 4), seed=12)
    r1 = reference(1)
    want = r1.generate(prompts, max_new_tokens=8)
    w = host_params(r1.runner.params)
    p1 = port(1, w, async_scheduling=True)
    p2 = port(2, w, async_scheduling=True)
    assert p1.generate(prompts, max_new_tokens=8) == want
    assert p2.generate(prompts, max_new_tokens=8) == want
    assert p2.stats()["host_gap_samples"] > 0
    s1 = [(s["phase"], s["host_transfer_bytes"]) for s in _steps(p1)]
    s2 = [(s["phase"], s["host_transfer_bytes"]) for s in _steps(p2)]
    assert s1 == s2
    assert any(s.get("chained") for s in _steps(p2))
    p2.shutdown()
