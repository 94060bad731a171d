"""ray_tpu_torch.llm at tensor_parallel_size 2 against ray_tpu.llm at tp=1
and tp=2 on the same weights (counterparts of tests/test_llm_tp.py; this
file: n-gram and draft speculation, the int8 cache, the kernel wrappers,
the multi-layer runner, and an MoE model).

As in tests/test_torch_llm_tp.py: the reference engines are seeded (0),
the port loads their weights through `params_from_flax`, f32, and one
group of two CPU ranks (gloo) serves every port engine of the file.
"""

import jax
import numpy as np
import pytest
import torch
from flax.linen import meta

import jax.numpy as jnp
from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import GPTRunner as JaxGPTRunner
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch.llm import EngineConfig, GPTRunner, LLMEngine
from ray_tpu_torch.llm import engine as engine_module
from ray_tpu_torch.models import GPTConfig, params_from_flax
from ray_tpu_torch.parallel import tensor_parallel_group

torch.set_num_threads(1)

SHAPE = dict(vocab_size=64, num_layers=1, num_heads=4, embed_dim=32, max_seq_len=128)
DRAFT_SHAPE = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=16, max_seq_len=128)
JAX_DRAFT = JaxGPTConfig(**DRAFT_SHAPE, dtype=jnp.float32, attention_impl="reference")
DRAFT = GPTConfig(**DRAFT_SHAPE, dtype=torch.float32, attention_impl="reference")
BASE = dict(block_size=4, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=16)
HEAD_SPEC = "PartitionSpec(None, None, None, 'tp')"


def configs(attention_impl="reference", **shape):
    shape = {**SHAPE, **shape}
    return (JaxGPTConfig(**shape, dtype=jnp.float32, attention_impl=attention_impl),
            GPTConfig(**shape, dtype=torch.float32, attention_impl=attention_impl))


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


def triple(group, prompts, n_new, *, jax_cfg=None, port_cfg=None, jax_overrides=None,
           **overrides):
    """Reference tp=1 and tp=2 and the port's tp=2 (the draft too, with
    speculation="draft"), on the same prompts; asserts they agree and
    returns (tokens, port engine)."""
    dj, dp = configs()
    jax_cfg, port_cfg = jax_cfg or dj, port_cfg or dp
    jax_kw = {**BASE, **overrides, **(jax_overrides or {})}
    if overrides.get("speculation") == "draft":
        jax_kw["draft_model_config"] = JAX_DRAFT
    refs = [JaxLLMEngine(jax_cfg, JaxEngineConfig(tensor_parallel_size=tp, **jax_kw), seed=0)
            for tp in (1, 2)]
    want = refs[0].generate(prompts, max_new_tokens=n_new)
    assert refs[1].generate(prompts, max_new_tokens=n_new) == want
    kw = {**BASE, **overrides}
    draft = None
    if overrides.get("speculation") == "draft":
        kw["draft_model_config"] = DRAFT
        draft = host_params(refs[0]._spec.runner.params)
    e2 = LLMEngine(port_cfg, EngineConfig(tensor_parallel_size=2, **kw),
                   params=host_params(refs[0].runner.params), draft_params=draft,
                   device="cpu")
    assert e2.generate(prompts, max_new_tokens=n_new) == want
    return want, e2


def test_tp2_parity_speculation_ngram(group):
    prompts = [[7, 8, 9] * 5, [1, 2] * 8]
    _, e2 = triple(group, prompts, 8, speculation="ngram")
    assert e2.stats()["spec_verify_steps"] > 0
    e2.shutdown()


def test_tp2_parity_speculation_draft(group):
    """The draft runs on the same ranks as the target, its mirror pool
    split on its own head axis."""
    prompts = random_prompts((6, 9), seed=6)
    _, e2 = triple(group, prompts, 8, speculation="draft")
    assert e2.stats()["spec_verify_steps"] > 0
    assert e2._spec.runner.pool_sharding_spec() == HEAD_SPEC
    assert tuple(e2._spec.runner.k_cache.shape)[3] == 1  # 2 heads over 2 ranks
    assert e2.stats()["spec_draft_pool_allocated"] == 0
    e2.shutdown()


def test_tp2_parity_int8_kv(group):
    """int8 pools split values and per-token scales on the head axis;
    each rank quantizes its own heads at every scatter."""
    prompts = random_prompts((5, 12), seed=7)
    _, e2 = triple(group, prompts, 8, kv_cache_dtype="int8")
    assert tuple(e2.runner.k_scale.shape) == (1, 64, 4, 2)
    assert e2.runner.pool_sharding_spec() == HEAD_SPEC
    e2.shutdown()


def test_tp2_parity_kernel_wrappers(group):
    """The counterpart of the reference's pallas-in-interpret-mode case:
    the port's kernel wrappers (K1 through attn_impl="cuda", K2 through
    attention_impl="flash") on each rank's two heads, which on CPU tensors
    run their plain versions, against the reference's Pallas kernel in
    interpret mode at tp=1 and tp=2."""
    jax_cfg, _ = configs()
    _, port_cfg = configs(attention_impl="flash")
    prompts = random_prompts((5,), seed=8)
    _, e2 = triple(group, prompts, 3, jax_cfg=jax_cfg, port_cfg=port_cfg,
                   attn_impl="cuda", jax_overrides={"attn_impl": "pallas"})
    assert e2.runner.attn_impl == "cuda"
    e2.shutdown()


def test_tp2_runner_parity_multi_layer(group):
    """Two layers, the runner driven directly: a prefill and three decode
    steps at tp=2 equal the reference's runner at tp=1 and tp=2, and every
    layer's pool slice is written (each rank's heads)."""
    jax_deep, port_deep = configs(num_layers=2)
    ecfg = lambda tp: dict(tensor_parallel_size=tp, **BASE)
    r1 = JaxGPTRunner(jax_deep, JaxEngineConfig(**ecfg(1)), seed=0)
    r2 = JaxGPTRunner(jax_deep, JaxEngineConfig(**ecfg(2)), seed=0)
    p2 = GPTRunner(port_deep, EngineConfig(**ecfg(2)), params=host_params(r1.params),
                   device="cpu", tp_group=group)
    prompt = [1, 5, 9, 2, 7]
    want = r1.prefill(prompt, [1, 2])
    assert r2.prefill(prompt, [1, 2]) == want == p2.prefill(prompt, [1, 2])
    toks = np.zeros(BASE["max_decode_slots"], np.int32)
    pos = np.zeros_like(toks)
    bt = np.zeros((len(toks), BASE["max_blocks_per_seq"]), np.int32)
    cl = np.zeros_like(toks)
    toks[0], pos[0], bt[0, :2], cl[0] = 3, 5, [1, 2], 5
    for _ in range(3):
        o1 = np.asarray(r1.decode(toks, pos, bt, cl))
        o2 = np.asarray(r2.decode(toks.copy(), pos.copy(), bt.copy(), cl.copy()))
        o3 = p2.decode(toks.copy(), pos.copy(), bt.copy(), cl.copy())
        assert (o1 == o2).all() and (o1 == o3).all()
        toks, pos, cl = o1, pos + 1, cl + 1
    # Rank 0's heads (0, 1) of the reference's pools, every layer.
    want_k = np.asarray(r1.k_cache)[:, 1:3, :, :2]
    np.testing.assert_allclose(p2.k_cache[:, 1:3].numpy(), want_k, atol=1e-5)
    assert p2.pool_sharding_spec() == HEAD_SPEC
    p2.close()


def test_tp2_parity_moe(group):
    """An MoE model at tp=2 serves, as the reference's does (its rules map
    `expert` to no axis and `mlp` to tp): every rank routes the same tokens
    through the replicated router and runs its half of each expert's MLP,
    reduced after the experts' second product."""
    jax_cfg, port_cfg = configs(num_layers=2, num_experts=4, moe_every=2)
    prompts = random_prompts((5, 11, 3), seed=0)
    _, e2 = triple(group, prompts, 6, jax_cfg=jax_cfg, port_cfg=port_cfg)
    moe = e2.runner.model.h[1].moe_mlp
    assert tuple(moe.w_in.shape) == (4, 32, 64) and tuple(moe.w_out.shape) == (4, 64, 32)
    e2.shutdown()


class _SumWith:
    """A two-rank all-reduce in one process: adds the other rank's f32
    partial (for two operands the sum is the same in either order, as a
    real two-rank all-reduce gives); with no partner yet it records the
    partial it is given."""

    def __init__(self, rank, partner=None):
        self.rank, self.size, self.partner, self.seen = rank, 2, partner, None

    def all_reduce(self, t):
        self.seen = t.clone()
        if self.partner is not None:
            t += self.partner.seen
        return t


def test_row_parallel_sums_partials_in_f32_and_adds_the_bias_once():
    """ROADMAP §D37. In bf16, each rank's partial product is kept in f32,
    all-reduced in f32, and the bias is added once after the sum, before
    the one cast: the output is one card's bf16 product rounded once (f32
    accumulation, then bf16), except where the two f32 sums' order tips a
    rounding — while summing bf16-rounded partials rounds twice."""
    from ray_tpu_torch.models.gpt import Dense
    from ray_tpu_torch.parallel import RowParallelDense

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 256, generator=gen).to(torch.bfloat16)
    full = Dense(256, 96, torch.bfloat16)
    with torch.no_grad():
        full.weight.copy_(torch.randn(96, 256, generator=gen) * 0.05)
        full.bias.copy_(torch.randn(96, generator=gen))
    full.cast_for_inference()
    w, b = full.weight, full.bias
    once = (x.float() @ w.float().t() + b.float()).to(torch.bfloat16)

    def rank(group):
        cols = slice(group.rank * 128, (group.rank + 1) * 128)
        layer = RowParallelDense(256, 96, torch.bfloat16, group=group)
        with torch.no_grad():
            layer.weight.copy_(w[:, cols].float())
            layer.bias.copy_(b.float())
        layer.cast_for_inference()
        return layer, x[:, cols], x[:, cols] @ w[:, cols].t()

    g1 = _SumWith(1)
    layer1, x1, p1 = rank(g1)
    layer1(x1)  # records rank 1's partial
    g0 = _SumWith(0, partner=g1)
    layer0, x0, p0 = rank(g0)
    y0 = layer0(x0)
    assert g0.seen.dtype == torch.float32 and y0.dtype == torch.bfloat16
    ulp = (once.float().abs() * 2.0**-7).clamp_min(2.0**-126)
    assert ((y0.float() - once.float()).abs() <= ulp).all()
    twice = ((p0 + p1) + b).to(torch.bfloat16)  # bf16 partials, bias in bf16
    exact_f32 = (y0 == once).float().mean().item()
    exact_bf16 = (twice == once).float().mean().item()
    assert exact_f32 >= 0.99 and exact_f32 > exact_bf16, (exact_f32, exact_bf16)


def test_a_rank_holds_the_seeded_models_slice_and_skips_the_head():
    """ROADMAP §D36. A seeded shard is the seeded full model's slice
    (drawn at full size on the CPU, then sliced), so every tp serves the
    same weights; a rank other than 0 returns no logits (only rank 0
    samples) but its layers' K/V for its own heads."""
    import types

    from ray_tpu_torch.models import GPT
    from ray_tpu_torch.parallel import llm_shard_params

    _, cfg = configs(num_layers=2)
    full = GPT(cfg, device="cpu", seed=3)
    want = llm_shard_params(full.state_dict(), 1, 2)
    rank1 = types.SimpleNamespace(rank=1, size=2, all_reduce=lambda t: t)
    shard = GPT(cfg, device="cpu", seed=3, group=rank1)
    got = shard.state_dict()
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert tuple(got["h.0.attn_qkv.weight"].shape) == (48, 32)
    assert tuple(got["h.0.attn_proj.weight"].shape) == (32, 16)
    assert tuple(got["h.0.mlp_out.bias"].shape) == (32,)  # replicated
    # Rank 1's heads 2 and 3 of the packed projection: from each third.
    w = full.state_dict()["h.0.attn_qkv.weight"]
    assert torch.equal(got["h.0.attn_qkv.weight"][16:24], w[32 + 16:32 + 24])
    logits, kvs = shard(torch.tensor([[1, 2, 3]]), return_kv=True)
    assert logits is None
    assert tuple(kvs[0][0].shape) == (1, 3, 2, 8)
