"""ray_tpu_torch.models.gpt against the flax GPT on converted weights.

The flax params are made once from a seed, unboxed, passed across as
numpy, and converted with `params_from_flax`; both models then see the same
tokens. Each numerical trap between the frameworks (LayerNorm epsilon,
tanh GELU, bf16 compute with f32 params, bf16 logits) is held here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu.models.gpt import collect_kv_caches
from ray_tpu_torch.models import GPT, GPTConfig, gpt2_125m, params_from_flax
from ray_tpu_torch.models.gpt import LN_EPS, cross_entropy_loss

# Tiny shapes: one intra-op thread, so the suite's parallel workers keep
# their cores (several reference tests are timing-sensitive).
torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)


def _flax_params(cfg, seed=0):
    params = JaxGPT(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


@pytest.fixture(scope="module")
def numpy_params():
    return _flax_params(JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference"))


def _models(numpy_params, dtype="float32", attention_impl="reference"):
    jax_cfg = JaxGPTConfig(**TINY, dtype=getattr(jnp, dtype), attention_impl=attention_impl)
    cfg = GPTConfig(**TINY, dtype=getattr(torch, dtype), attention_impl=attention_impl)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(params_from_flax(numpy_params))
    return JaxGPT(jax_cfg), model


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 128, size=(b, s)).astype(np.int32)


def test_converter_layout_and_config_presets(numpy_params):
    sd = params_from_flax(numpy_params)
    assert set(sd) == set(GPT(GPTConfig(**TINY), device="cpu").state_dict())
    kernel = numpy_params["params"]["h_0"]["attn_qkv"]["kernel"]
    np.testing.assert_array_equal(sd["h.0.attn_qkv.weight"].numpy(), kernel.T)
    assert LN_EPS == 1e-6
    for name in ("num_layers", "num_heads", "embed_dim", "vocab_size", "max_seq_len"):
        assert getattr(gpt2_125m(), name) == getattr(JaxGPTConfig(), name)
    assert gpt2_125m().head_dim == 64


def test_logits_match_flax_f32(numpy_params):
    """f32 logits within 1e-4 (same math, different summation order)."""
    jax_model, model = _models(numpy_params)
    toks = _tokens(2, 24)
    want = np.asarray(jax_model.apply(numpy_params, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # The loss matches on the same logits.
    tgt = _tokens(2, 24, seed=1)
    from ray_tpu.models.gpt import cross_entropy_loss as jax_ce

    np.testing.assert_allclose(
        cross_entropy_loss(torch.from_numpy(want), torch.from_numpy(tgt)).item(),
        float(jax_ce(jnp.asarray(want), jnp.asarray(tgt))), rtol=1e-5,
    )


def test_logits_match_flax_bf16(numpy_params):
    """bf16 compute: the logits come out bf16 in both (argmax runs on
    them), within 2e-2 of each other — the two frameworks round to bf16
    at different places (fused bias adds, GELU, the f32-vs-bf16 matmul
    accumulation), a few bf16 ulps at these logit magnitudes."""
    jax_model, model = _models(numpy_params, dtype="bfloat16")
    toks = _tokens(2, 24)
    want = jax_model.apply(numpy_params, jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=2e-2
    )


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_return_kv_matches_flax(numpy_params, attention_impl):
    """The full-prefill generation path: per-layer K/V as flax sows them,
    through the reference op or the flash kernel (JAX: Pallas interpret;
    port: the wrapper's plain blockwise version)."""
    jax_model, model = _models(numpy_params, attention_impl=attention_impl)
    toks = _tokens(1, 16)
    logits, state = jax_model.apply(
        numpy_params, jnp.asarray(toks), return_kv=True, mutable=["intermediates"]
    )
    want_kvs = collect_kv_caches(state["intermediates"], TINY["num_layers"])
    with torch.no_grad():
        got, kvs = model(torch.from_numpy(toks), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4)
    for (k, v), (wk, wv) in zip(kvs, want_kvs):
        np.testing.assert_allclose(k.numpy(), np.asarray(wk), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=1e-5)


@pytest.mark.parametrize("shape", ["decode", "suffix"])
def test_paged_forward_matches_flax(numpy_params, shape):
    """Decode (S=1 over 3 slots, one idle) and partial prefill (S=6 at an
    offset) over random paged pools: logits and the new K/V."""
    jax_model, model = _models(numpy_params)
    rng = np.random.RandomState(7)
    L, N, bs, H, D = 2, 13, 4, 4, 16
    kc = rng.randn(L, N, bs, H, D).astype(np.float32)
    vc = rng.randn(L, N, bs, H, D).astype(np.float32)
    if shape == "decode":
        toks = _tokens(3, 1, seed=3)
        lens = np.array([9, 0, 14], np.int32)
        tables = np.array([[1, 2, 3, 0], [0, 0, 0, 0], [4, 5, 6, 7]], np.int32)
        positions = lens[:, None].astype(np.int32)
    else:
        toks = _tokens(1, 6, seed=4)
        lens = np.array([7], np.int32)
        tables = np.array([[8, 9, 10, 11]], np.int32)
        positions = (7 + np.arange(6))[None].astype(np.int32)
    logits, state = jax_model.apply(
        numpy_params, jnp.asarray(toks), positions=jnp.asarray(positions),
        paged_caches=tuple(jnp.asarray(x) for x in (kc, vc, tables, lens)),
        paged_impl="reference", mutable=["intermediates"],
    )
    want_kvs = collect_kv_caches(state["intermediates"], L)
    with torch.no_grad():
        got, kvs = model(
            torch.from_numpy(toks), positions=torch.from_numpy(positions),
            paged_caches=tuple(torch.from_numpy(x) for x in (kc, vc, tables, lens)),
            paged_impl="cuda", return_kv=True,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4)
    for (k, v), (wk, wv) in zip(kvs, want_kvs):
        np.testing.assert_allclose(k.numpy(), np.asarray(wk), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=1e-5)


def test_unported_paths_raise(numpy_params):
    """The plain forward with attention_impl='flash' now runs the packed
    kernels' path (JAX: Pallas interpret; port: the plain versions) and
    matches flax at f32; ring attention still raises, naming its slice,
    and an entry point without device= still needs CUDA."""
    jax_model, model = _models(numpy_params, attention_impl="flash")
    toks = _tokens(2, 24)
    want = np.asarray(jax_model.apply(numpy_params, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    _, ring = _models(numpy_params, attention_impl="ring")
    with pytest.raises(NotImplementedError, match="ring attention"):
        ring(torch.from_numpy(_tokens(1, 8)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GPT(GPTConfig(**TINY))


def test_seeded_init_is_deterministic():
    a = GPT(GPTConfig(**TINY, dtype=torch.float32), device="cpu", seed=3)
    b = GPT(GPTConfig(**TINY, dtype=torch.float32), device="cpu", seed=3)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert torch.all(a.h[0].ln_1.weight == 1) and torch.all(a.h[0].attn_qkv.bias == 0)
    assert abs(a.wte.weight.std().item() - 0.02) < 0.005


def test_f32_masters_and_runner_cast_once_copy(numpy_params):
    """Every parameter of a bf16 GPT is f32 (flax's param_dtype) and is cast
    at each use; GPTRunner serves a cast-once bf16 copy of the dense layers
    and embeddings (LayerNorm stays f32), which gives the same logits
    bit for bit."""
    from ray_tpu_torch.llm import EngineConfig, GPTRunner
    from ray_tpu_torch.models.gpt import Dense, Embed

    _, model = _models(numpy_params, dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    runner = GPTRunner(
        GPTConfig(**TINY, dtype=torch.bfloat16, attention_impl="reference"),
        EngineConfig(block_size=8, num_blocks=8, max_blocks_per_seq=4),
        params=params_from_flax(numpy_params), device="cpu",
    )
    for name, p in runner.model.named_parameters():
        owner = runner.model.get_submodule(name.rsplit(".", 1)[0])
        want = torch.bfloat16 if isinstance(owner, (Dense, Embed)) else torch.float32
        assert p.dtype == want, name
    toks = torch.from_numpy(_tokens(2, 24))
    with torch.no_grad():
        assert torch.equal(runner.model(toks), model(toks))
