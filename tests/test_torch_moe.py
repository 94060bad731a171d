"""ray_tpu_torch's MoE (models/moe.py, the MoE GPT, its converter and its
serving) against ray_tpu's on the same weights, on the CPU.

The port computes the MoE MLP by index (gather the kept (token, choice)
pairs into [E, C, d], two batched products, a gate-weighted sum back); the
reference by dense one-hot einsums. Tight capacity (cf 0.5) drops pairs,
and each case asserts that it does, so the choice-major priority and the
discard slot are exercised. The engine cases hold the runner to the
reference's padded shapes: capacity counts padded tokens, so a row padded
or trimmed differently changes tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import GPTRunner as JaxGPTRunner
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models import GPT as JaxGPT
from ray_tpu.models import GPTConfig as JaxGPTConfig
from ray_tpu.models import collect_moe_losses as jax_collect
from ray_tpu.models import cross_entropy_loss as jax_ce
from ray_tpu.models.moe import MoEConfig as JaxMoEConfig
from ray_tpu.models.moe import MoEMlp as JaxMoEMlp
from ray_tpu.ops.fused_optim import fused_adamw as jax_fused_adamw
from ray_tpu_torch.llm import EngineConfig, GPTRunner, LLMEngine
from ray_tpu_torch.models import (
    GPT,
    GPTConfig,
    MoEConfig,
    MoEMlp,
    collect_moe_losses,
    cross_entropy_loss,
    params_from_flax,
)
from ray_tpu_torch.models.moe import capacity, moe_mlp, moe_mlp_dense
from ray_tpu_torch.ops import fused_adamw

torch.set_num_threads(1)

D, M, E = 16, 32, 4
TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128,
            num_experts=4, moe_every=2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _mlp_pair(k, cf, dtype="float32", zero_router=False):
    """(flax MoEMlp, its numpy params, the port's MoEMlp on them)."""
    jm = JaxMoEMlp(embed_dim=D, mlp_dim=M, dtype=getattr(jnp, dtype),
                   moe=JaxMoEConfig(num_experts=E, num_experts_per_tok=k, capacity_factor=cf))
    x = jnp.zeros((2, 12, D), getattr(jnp, dtype))
    p = jax.tree_util.tree_map(np.asarray, meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(1), x)))
    p = p["params"]
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    mod = MoEMlp(D, M, MoEConfig(num_experts=E, num_experts_per_tok=k, capacity_factor=cf),
                 dtype=getattr(torch, dtype), device="cpu")
    mod.load_state_dict({n: torch.from_numpy(np.array(v, np.float32)).to(getattr(mod, n).dtype)
                         for n, v in p.items()})
    return jm, p, mod


def _x(seed=0, shape=(2, 12, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_mlp_matches_reference_f32(k, cf):
    """Output and both aux losses within 1e-5; the gradients of x, router,
    w_in and w_out (of sum(out * r) + the aux losses) within 1e-4."""
    jm, p, mod = _mlp_pair(k, cf)
    x = _x()
    r = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def jloss(params, xx):
        out, aux = jm.apply({"params": params}, xx)
        return jnp.sum(out * r) + aux["router_z_loss"] + aux["load_balance_loss"], (out, aux)

    (_, (want, want_aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, aux, stats = mod(xt, with_stats=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for name in ("router_z_loss", "load_balance_loss"):
        np.testing.assert_allclose(aux[name].item(), float(want_aux[name]), rtol=1e-5)
    loss = (got * torch.from_numpy(r)).sum() + aux["router_z_loss"] + aux["load_balance_loss"]
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4)
    for name in ("router", "w_in", "w_out"):
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(), np.asarray(gp[name]),
                                   atol=1e-4, err_msg=name)
    dropped = stats["dropped_share"].item()
    if cf == 0.5:
        assert dropped > 0.3  # capacity int(0.5 * 24 * k / 4) holds half the pairs
    else:
        assert dropped == 0.0


def test_moe_mlp_bf16_within_tolerance():
    """bf16 experts (bf16 parameters, as the reference creates them) under
    tight capacity: the routing runs in f32 on both sides, so the aux
    losses agree within 1e-6 and the same pairs are kept; the expert
    products and the GELU round to bf16 in different places, so the output
    is held to 2e-2 relative L2 (measured ~3e-3) and the x gradient to
    3e-2."""
    jm, p, mod = _mlp_pair(2, 0.5, dtype="bfloat16")
    assert mod.router.dtype == torch.float32
    assert mod.w_in.dtype == mod.w_out.dtype == torch.bfloat16
    x = _x(seed=4)

    def jloss(xx):
        out, aux = jm.apply({"params": p}, xx)
        return jnp.sum(out.astype(jnp.float32)), (out, aux)

    (_, (want, want_aux)), gx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    got, aux = mod(xt)
    assert got.dtype == torch.bfloat16
    assert _rel(got.detach().float(), np.asarray(want, np.float32)) < 2e-2
    for name in aux:
        np.testing.assert_allclose(aux[name].item(), float(want_aux[name]), rtol=1e-6)
    got.float().sum().backward()
    assert _rel(xt.grad.float(), np.asarray(gx, np.float32)) < 3e-2


@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_pick_the_lowest_experts(k):
    """A zero router makes every probability equal: jax.lax.top_k then
    picks experts 0..k-1 for every token, and so must the port."""
    from ray_tpu_torch.models.moe import _route

    jm, p, mod = _mlp_pair(k, 2.0, zero_router=True)
    x = _x(seed=5)
    routing = _route(torch.from_numpy(x).reshape(-1, D), mod.router, mod.moe, torch.float32)
    expert_idx = routing[2]
    assert torch.equal(expert_idx, torch.arange(k).expand_as(expert_idx))
    want, _ = jm.apply({"params": p}, jnp.asarray(x))
    got, _ = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_form_matches_dense_form(dtype):
    """The index form against the dense one-hot form (the plain version)
    at tight capacity: both sum at most k nonzero products per token, so
    the outputs and every gradient agree to f32 rounding."""
    dt = getattr(torch, dtype)
    cfg = MoEConfig(num_experts=E, num_experts_per_tok=2, capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    router = (torch.randn(D, E, generator=gen) * 0.5).requires_grad_(True)
    w_in = (torch.randn(E, D, M, generator=gen) * 0.2).to(dt).requires_grad_(True)
    w_out = (torch.randn(E, M, D, generator=gen) * 0.2).to(dt).requires_grad_(True)
    x = torch.from_numpy(_x(seed=6)).to(dt)
    results = []
    for fn in (moe_mlp, moe_mlp_dense):
        xx = x.clone().requires_grad_(True)
        out, aux = fn(xx, router, w_in, w_out, cfg, dt)
        (out.float().sum() + sum(aux.values())).backward()
        results.append((out.detach().float(), xx.grad.float(), router.grad.clone(),
                        w_in.grad.float(), w_out.grad.float()))
        for t in (router, w_in, w_out):
            t.grad = None
    tol = 1e-6 if dtype == "float32" else 1e-2
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert capacity(cfg, 24) == 6


# ---------------------------------------------------------------- GPT


@pytest.fixture(scope="module")
def moe_tree():
    cfg = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
    params = jax.jit(JaxGPT(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 128, size=(b, s)).astype(np.int32)


def test_gpt_moe_matches_reference_f32(moe_tree):
    """The test_parallel.py training loss (CE + collect_moe_losses) of a
    2-layer GPT with 4 experts in its second block: logits within 1e-4, the
    loss within 1e-5, every gradient within 1e-4."""
    jcfg = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
    jm = JaxGPT(jcfg)
    toks = _tokens(2, 16)

    def jloss(params):
        logits, state = jm.apply(params, jnp.asarray(toks), mutable=["intermediates"])
        return (jax_ce(logits[:, :-1], jnp.asarray(toks[:, 1:]))
                + jax_collect(state["intermediates"]), logits)

    (loss_ref, logits_ref), grads_ref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        moe_tree)
    model = GPT(GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference"),
                device="cpu")
    assert not model.h[0].use_moe and model.h[1].use_moe
    model.load_state_dict(params_from_flax(moe_tree))
    logits, inter = model(torch.from_numpy(toks), return_aux=True)
    assert set(inter) == {"h_1"}
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref), atol=1e-4)
    loss = cross_entropy_loss(logits[:, :-1], torch.from_numpy(toks[:, 1:])) \
        + collect_moe_losses(inter)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = params_from_flax(grads_ref)
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, err_msg=name)
    assert sum(float((g ** 2).sum()) for n, g in grads.items() if "moe_mlp" in n) > 0
    # The default call is as it was: logits alone.
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(toks)), logits.detach())


def test_gpt_moe_bf16_experts_take_the_reference_fused_adamw_step(moe_tree):
    """In a bf16 model the experts are bf16 parameters on both sides (every
    other parameter an f32 master). The bf16 forwards agree within bf16
    rounding (logits 5e-2 absolute, the loss 1e-2 relative); one fused_adamw
    step on the same gradients (the reference's) leaves every parameter
    within one rounding of its dtype of the reference's (2^-8 relative for
    the bf16 experts, 1e-6 for f32) and f32 moments."""
    jcfg = JaxGPTConfig(**TINY, dtype=jnp.bfloat16, attention_impl="reference")
    jm = JaxGPT(jcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(jparams))
    w_in = tree["params"]["h_1"]["moe_mlp"]["w_in"]
    assert w_in.dtype == jnp.bfloat16
    toks = _tokens(2, 16, seed=1)

    def jloss(params):
        logits, state = jm.apply(params, jnp.asarray(toks), mutable=["intermediates"])
        return (jax_ce(logits[:, :-1], jnp.asarray(toks[:, 1:]))
                + jax_collect(state["intermediates"]), logits)

    (loss_ref, logits_ref), grads_ref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    model = GPT(GPTConfig(**TINY, attention_impl="reference"), device="cpu")
    sd = params_from_flax(tree)
    assert sd["h.1.moe_mlp.w_in"].dtype == torch.bfloat16
    assert sd["h.1.moe_mlp.router"].dtype == torch.float32
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    assert {n for n, p in params.items() if p.dtype == torch.bfloat16} == {
        "h.1.moe_mlp.w_in", "h.1.moe_mlp.w_out"}
    with torch.no_grad():
        logits, inter = model(torch.from_numpy(toks), return_aux=True)
        loss = cross_entropy_loss(logits[:, :-1], torch.from_numpy(toks[:, 1:])) \
            + collect_moe_losses(inter)
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(logits_ref, np.float32),
                               atol=5e-2)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-2)

    jopt = jax_fused_adamw(1e-2)
    jp, js = jopt.apply(grads_ref, jopt.init(tree), tree)
    opt = fused_adamw(1e-2)
    _, state = opt.apply(params_from_flax(grads_ref), opt.init(params), params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in params.items():
        assert p.dtype == want[name].dtype, name
        rtol = 2.0 ** -8 if p.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(p.detach().float().numpy(), want[name].float().numpy(),
                                   rtol=rtol, atol=1e-7, err_msg=name)
        assert state.mu[name].dtype == torch.float32
    np.testing.assert_allclose(
        state.mu["h.1.moe_mlp.w_in"].numpy(),
        np.asarray(js.mu["params"]["h_1"]["moe_mlp"]["w_in"]), rtol=1e-6, atol=1e-8)


def test_collect_moe_losses_sums_only_moe_aux():
    """Other diagnostics (the routing stats the port returns beside the aux
    losses, an attention entropy) never reach the objective, in the port's
    form and in the reference's sown form."""
    inter = {
        "h_0": {"moe_aux": ({"z": torch.tensor(0.5)},), "attn_entropy": (torch.tensor(99.0),)},
        "h_1": {"moe_aux": ({"z": torch.tensor(0.25)},),
                "moe_stats": {"dropped_share": torch.tensor(7.0)}},
    }
    total = collect_moe_losses(inter)
    assert total.dtype == torch.float32 and total.item() == 0.75
    assert collect_moe_losses({}).item() == 0.0


def test_params_from_flax_moe_tree_and_serving_copy(moe_tree):
    """The converter carries moe_mlp/{router, w_in, w_out} in their own
    layouts; the cast-once serving copy casts the experts and the dense
    layers to the compute dtype and leaves the router f32."""
    sd = params_from_flax(moe_tree)
    model = GPT(GPTConfig(**TINY), device="cpu")
    assert set(sd) == set(model.state_dict())
    assert "h.1.mlp_in.weight" not in sd and "h.0.mlp_in.weight" in sd
    block = moe_tree["params"]["h_1"]["moe_mlp"]
    for name in ("router", "w_in", "w_out"):
        np.testing.assert_array_equal(sd[f"h.1.moe_mlp.{name}"].numpy(), block[name])
    model.load_state_dict(sd)
    model.cast_for_inference()
    moe = model.h[1].moe_mlp
    assert moe.router.dtype == torch.float32
    assert moe.w_in.dtype == moe.w_out.dtype == torch.bfloat16
    assert model.h[1].attn_qkv.weight.dtype == torch.bfloat16


# ---------------------------------------------------------------- serving

TIGHT = dict(moe_capacity_factor=0.5)
JAX_MOE = JaxGPTConfig(**TINY, **TIGHT, dtype=jnp.float32, attention_impl="reference")
PORT_MOE = GPTConfig(**TINY, **TIGHT, dtype=torch.float32, attention_impl="reference")


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, 128, size=n))) for n in lengths]


def _count_drops(model):
    """Wrap each MoE MLP of `model` to record its dropped share per call."""
    seen = []
    for block in model.h:
        if block.use_moe:
            inner = block.moe_mlp.forward

            def forward(x, with_stats=False, inner=inner):
                out, aux, stats = inner(x, with_stats=True)
                seen.append(stats["dropped_share"].item())
                return (out, aux, stats) if with_stats else (out, aux)

            block.moe_mlp.forward = forward
    return seen


def test_runner_programs_match_reference_under_tight_capacity(moe_tree):
    """Each step program at the reference's padded shapes: full prefill (a
    bucket of zeros past the prompt), partial prefill (the suffix bucket),
    decode over all max_decode_slots with an idle slot, and k-token verify:
    the same sampled tokens and the same pools."""
    ecfg = dict(block_size=4, num_blocks=16, max_decode_slots=3, max_blocks_per_seq=8)
    jr = JaxGPTRunner(JAX_MOE, JaxEngineConfig(**ecfg), params=moe_tree)
    tr = GPTRunner(PORT_MOE, EngineConfig(**ecfg), params=params_from_flax(moe_tree),
                   device="cpu")
    assert tr.num_params == jr.num_params
    assert tr.model.h[1].moe_mlp.router.dtype == torch.float32
    drops = _count_drops(tr.model)
    a, b = _prompts((6, 11), seed=2)

    def pools_match():
        for name in ("k_cache", "v_cache"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), atol=1e-5)

    assert tr.prefill(a, [1, 2]) == jr.prefill(a, [1, 2])
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
    vtoks = np.array([[a[-1], 5, 9, 0], [0, 0, 0, 0], [b[-1], 3, 0, 0]], np.int32)
    vargs = (vtoks, tables, np.array([7, 0, 12], np.int32), np.array([3, 0, 2], np.int32))
    np.testing.assert_array_equal(tr.verify(*vargs), jr.verify(*vargs))
    pools_match()
    assert max(drops) > 0


def test_padding_rows_change_real_rows_under_tight_capacity(moe_tree):
    """Why the runner must pad as the reference does: capacity counts the
    padded tokens (and choice-major order lets a pad's first choice evict a
    real token's second), so a 5-token prompt run in its prefill bucket of
    8 (zeros past the prompt, the runner's shape) and run trimmed to its 5
    tokens gives different logits at the real positions."""
    model = GPT(PORT_MOE, device="cpu")
    model.load_state_dict(params_from_flax(moe_tree))
    prompt = _prompts((5,), seed=3)[0]
    bucket = EngineConfig(block_size=4, num_blocks=16, max_blocks_per_seq=8).bucket_for(5)
    assert bucket == 8
    padded = torch.zeros((1, bucket), dtype=torch.long)
    padded[0, :5] = torch.tensor(prompt)
    with torch.no_grad():
        in_bucket = model(padded)[:, :5]
        trimmed = model(padded[:, :5])
    assert not torch.allclose(in_bucket, trimmed, atol=1e-3)


ENGINE_CASES = {
    # Mixed lengths, a repeated 11-token prompt (partial prefill through the
    # prefix cache), a repeated block-aligned 16-token prompt (copy on
    # write), and 23- and 40-token prompts that the chunk budget splits.
    "mixed_prefix_cow_chunked": dict(
        ecfg=dict(block_size=8, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=8),
        lengths=(5, 11, 16, 23, 40), repeat=(1, 2), new=6,
    ),
    # Two requests over 6 decode slots: every decode step has idle slots.
    "idle_slots": dict(
        ecfg=dict(block_size=4, num_blocks=32, max_decode_slots=6, max_blocks_per_seq=8),
        lengths=(7, 12), repeat=(), new=10,
    ),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_identical_to_reference_under_tight_capacity(moe_tree, case):
    spec = ENGINE_CASES[case]
    jax_eng = JaxLLMEngine(JAX_MOE, JaxEngineConfig(**spec["ecfg"]), params=moe_tree)
    port_eng = LLMEngine(PORT_MOE, EngineConfig(**spec["ecfg"]),
                         params=params_from_flax(moe_tree), device="cpu")
    drops = _count_drops(port_eng.runner.model)
    prompts = _prompts(spec["lengths"], seed=31)
    prompts += [list(prompts[i]) for i in spec["repeat"]]
    want = jax_eng.generate(prompts, max_new_tokens=spec["new"])
    got = port_eng.generate(prompts, max_new_tokens=spec["new"])
    assert got == want
    js, ps = jax_eng.stats(), port_eng.stats()
    for key in ("prefix_cache_hit_tokens", "cow_blocks", "chunked_prefill_requests", "steps"):
        assert ps[key] == js[key], key
    if case == "mixed_prefix_cow_chunked":
        assert ps["prefix_cache_hit_tokens"] > 0 and ps["cow_blocks"] > 0
        assert ps["chunked_prefill_requests"] > 0
    assert max(drops) > 0  # the tight capacity dropped pairs on the way
    assert port_eng.allocator.num_allocated == 0


def test_moe_gpt_default_capacity_is_the_reference_default():
    cfg = GPTConfig(num_experts=8)
    moe = GPT(dataclasses.replace(cfg, num_layers=2, embed_dim=64, num_heads=4,
                                  vocab_size=128), device="cpu").h[1].moe_mlp.moe
    assert (moe.num_experts_per_tok, moe.capacity_factor) == (2, 1.25)
    assert (cfg.moe_every, cfg.num_experts_per_tok, cfg.moe_capacity_factor) == (
        JaxGPTConfig().moe_every, JaxGPTConfig().num_experts_per_tok,
        JaxGPTConfig().moe_capacity_factor)
    assert capacity(moe, 8 * 1024) == 2560
