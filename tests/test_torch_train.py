"""The training slice of ray_tpu_torch against the JAX reference package.

One training step is built as the reference's benchmark builds it: the GPT
forward, `cross_entropy_loss` on the shifted tokens, the gradient of every
parameter, and a `fused_adamw` update. Weights are made once by the flax
model from a seed and converted with `params_from_flax`; tokens, gradients
and optimizer inputs come from numpy seeds. JAX runs its Pallas kernels in
interpret mode on the CPU; the port runs its kernel wrappers' plain
versions on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu.models.gpt import cross_entropy_loss as jax_cross_entropy
from ray_tpu.ops.fused_optim import fused_adamw as jax_fused_adamw
from ray_tpu_torch.models import GPT, GPTConfig, params_from_flax
from ray_tpu_torch.models.gpt import cross_entropy_loss
from ray_tpu_torch.ops import FusedAdamWState, fused_adamw

# Tiny shapes: one intra-op thread, so the suite's parallel workers keep
# their cores (several reference tests are timing-sensitive).
torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
# The long-context branch (S > 2048): one narrow layer.
LONG = dict(vocab_size=128, num_layers=1, num_heads=2, embed_dim=32, max_seq_len=2304)
LR = 1e-3


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _flax_params(shape, seed=0):
    cfg = JaxGPTConfig(**shape, dtype=jnp.float32, attention_impl="reference")
    params = JaxGPT(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return _numpy_tree(params)


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 128, size=(b, s)).astype(np.int32)


def _jax_loss_and_grad(shape, dtype, attention_impl):
    model = JaxGPT(JaxGPTConfig(**shape, dtype=dtype, attention_impl=attention_impl))

    def loss_fn(params, tokens):
        logits = model.apply(params, tokens)
        return jax_cross_entropy(logits[:, :-1], tokens[:, 1:])

    return jax.jit(jax.value_and_grad(loss_fn))


def _port_model(shape, numpy_params, dtype=torch.float32, attention_impl="flash"):
    model = GPT(GPTConfig(**shape, dtype=dtype, attention_impl=attention_impl), device="cpu")
    model.load_state_dict(params_from_flax(numpy_params))
    return model


def _port_loss_and_grad(model, tokens):
    """The step's forward and backward: (loss, {name: grad})."""
    params = dict(model.named_parameters())
    logits = model(tokens)
    loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads))


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    want = torch.from_numpy(np.asarray(want, np.float32))
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adamw_matches_jax(dtype):
    """Three `apply` steps on the same numpy params and grads: parameters
    (in their own dtype) and f32 moments against the reference's
    fused_adamw. f32: the same f32 arithmetic, ulp-level differences in pow
    and fused multiply-adds (1e-6 relative; 1e-8 absolute where the two
    terms of b1·mu + (1 - b1)·g nearly cancel). bf16 params: the f32
    update is cast to bf16 in both, so they agree to one bf16 rounding
    (2^-8 relative); the moments stay f32."""
    rng = np.random.RandomState(0)
    shapes = {"w": (3, 4), "b": (4,), "e": (5, 2, 3)}
    params_np = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    grads_np = [{k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
                for _ in range(3)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jopt, topt = jax_fused_adamw(1e-2, weight_decay=1e-2), fused_adamw(1e-2, weight_decay=1e-2)
    jp = {k: jnp.asarray(v, jdt) for k, v in params_np.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params_np.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert all(m.dtype == torch.float32 for m in (*ts.mu.values(), *ts.nu.values()))
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
    for g in grads_np:
        jp, js = jopt.apply({k: jnp.asarray(v, jdt) for k, v in g.items()}, js, jp)
        tp, ts = topt.apply({k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts, tp)
        for k in shapes:
            assert tp[k].dtype == tdt
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k], np.float32), rtol=rtol, atol=1e-7
            )
            for mine, ref in ((ts.mu, js.mu), (ts.nu, js.nu)):
                np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-8)
    assert int(ts.count) == int(js.count) == 3


def test_fused_adamw_update_api():
    """`update` returns new - old and leaves the parameters as they are;
    `apply` writes the same values into them."""
    opt = fused_adamw(1e-1)
    params = {"w": torch.ones(2, 2)}
    grads = {"w": torch.full((2, 2), 0.5)}
    updates, state = opt.update(grads, opt.init(params), params)
    assert isinstance(state, FusedAdamWState) and torch.equal(params["w"], torch.ones(2, 2))
    new, _ = opt.apply(grads, opt.init(params), params)
    torch.testing.assert_close(torch.ones(2, 2) + updates["w"], new["w"], rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="requires params"):
        opt.update(grads, state)


def test_fused_adamw_state_is_not_advanced_in_place():
    """The optimizer state is functional, as the reference's is: `update`
    twice from one state gives equal results, and a step retried with
    `apply` from an earlier state repeats the same values; the state passed
    in keeps its moments and count."""
    rng = np.random.RandomState(1)
    params = {"w": torch.from_numpy(rng.randn(3, 4).astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.randn(3, 4).astype(np.float32))}
    opt = fused_adamw(1e-2)
    _, state = opt.update(grads, opt.init(params), params)
    before = {k: (state.mu[k].clone(), state.nu[k].clone()) for k in params}
    (u1, s1), (u2, s2) = (opt.update(grads, state, params) for _ in range(2))
    assert torch.equal(u1["w"], u2["w"])
    assert torch.equal(s1.mu["w"], s2.mu["w"]) and torch.equal(s1.nu["w"], s2.nu["w"])
    p1, _ = opt.apply(grads, state, {k: p.clone() for k, p in params.items()})
    p2, _ = opt.apply(grads, state, {k: p.clone() for k, p in params.items()})
    assert torch.equal(p1["w"], p2["w"])
    torch.testing.assert_close(p1["w"], params["w"] + u1["w"], rtol=1e-6, atol=1e-7)
    assert int(state.count) == 1
    for k, (mu, nu) in before.items():
        assert torch.equal(state.mu[k], mu) and torch.equal(state.nu[k], nu)


# ---------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def tiny_params():
    return _flax_params(TINY)


def _key_third(embed_dim):
    return slice(embed_dim, 2 * embed_dim)


def _assert_params_close(params, want, rel, *, embed_dim, matrices_only=False):
    """Every parameter within `rel` relative L2 of the reference's after
    the optimizer steps, but the key third of each attn_qkv bias: q·b_k
    is the same for every key and cancels in the softmax, so its exact
    gradient is zero (checked in `_train_and_compare`) and both sides' Adam
    steps there follow rounding noise, which no limit tighter than the
    steps' own size (lr each) could hold."""
    for name, p in params.items():
        assert p.dtype == torch.float32, name
        got, ref = p.detach().clone(), want[name].clone()
        if name.endswith("attn_qkv.bias"):
            got[_key_third(embed_dim)] = ref[_key_third(embed_dim)] = 0.0
        if matrices_only and got.dim() < 2:
            continue
        assert _rel_l2(got, ref.numpy()) < rel, name


def _train_and_compare(shape, numpy_params, tokens, *, jax_impl, dtype, loss_rtol,
                       grad_rel, param_rel, matrices_only=False):
    """Loss and every gradient at step 0, then 3 fused_adamw steps on both
    sides with the loss compared after each; returns the port's model and
    losses."""
    step = _jax_loss_and_grad(shape, getattr(jnp, dtype), jax_impl)
    model = _port_model(shape, numpy_params, dtype=getattr(torch, dtype))
    jopt, topt = jax_fused_adamw(LR), fused_adamw(LR)
    jparams = numpy_params
    params = dict(model.named_parameters())
    js, ts = jopt.init(jparams), topt.init(params)
    toks = torch.from_numpy(tokens)
    losses = []
    for i in range(4):
        want_loss, want_grads = step(jparams, jnp.asarray(tokens))
        loss, grads = _port_loss_and_grad(model, toks)
        losses.append(float(loss.detach()))
        np.testing.assert_allclose(losses[-1], float(want_loss), rtol=loss_rtol)
        if i == 0:
            want = params_from_flax(_numpy_tree(want_grads))
            assert set(want) == set(grads)
            for name, g in grads.items():
                assert g.dtype == torch.float32, name
                assert _rel_l2(g, want[name].numpy()) < grad_rel, name
                if name.endswith("attn_qkv.bias"):
                    # The key third's gradient is zero but for rounding:
                    # ~1e-9 of the leaf's largest in f32, ~3e-5 in bf16.
                    key = g[_key_third(shape["embed_dim"])].abs().max()
                    limit = 1e-6 if dtype == "float32" else 1e-3
                    assert float(key) <= limit * float(g.abs().max()), name
        if i == 3:
            break
        jparams, js = jopt.apply(want_grads, js, jparams)
        _, ts = topt.apply(grads, ts, params)
    _assert_params_close(
        params, params_from_flax(_numpy_tree(jparams)), param_rel,
        embed_dim=shape["embed_dim"], matrices_only=matrices_only,
    )
    return model, losses


def test_tiny_gpt_training_matches_jax_f32(tiny_params):
    """f32, attention_impl='flash' on both sides (JAX: the packed Pallas
    kernels in interpret mode; port: the packed path's plain versions):
    the loss within 1e-5 relative, every parameter's gradient within 1e-4
    relative L2, then three fused_adamw steps with the losses within 1e-5
    and the parameters within 1e-5 relative L2. Same math, f32 summation
    order."""
    _, losses = _train_and_compare(
        TINY, tiny_params, _tokens(2, 32), jax_impl="flash", dtype="float32",
        loss_rtol=1e-5, grad_rel=1e-4, param_rel=1e-5,
    )
    assert losses[-1] < losses[0]  # the same batch: the loss falls


def test_long_context_branch_training_matches_jax():
    """S = 2304 > 2048 takes the blockwise branch: K2 forward, K4/K5
    backward on the card; here the plain blockwise versions. The JAX side
    runs attention_impl='reference' (the same function; it keeps interpret
    mode off a 9 x 9-block grid). f32: loss within 1e-5 relative, gradients
    within 1e-4 relative L2, parameters after three steps within 1e-5."""
    params = _flax_params(LONG, seed=1)
    _train_and_compare(
        LONG, params, _tokens(1, 2304, seed=2), jax_impl="reference",
        dtype="float32", loss_rtol=1e-5, grad_rel=1e-4, param_rel=1e-5,
    )


def test_tiny_gpt_training_bf16_keeps_f32_masters(tiny_params):
    """bf16 compute on f32 master parameters, as flax keeps them: every
    parameter is f32 before and after fused_adamw steps, every gradient is
    f32, the logits are bf16, and three steps track JAX's bf16 training.
    The two frameworks round to bf16 at different places (fused bias adds,
    GELU, matmul accumulation), a few bf16 ulps of the logits, which the
    mean over 62 tokens x 2 rows mostly averages out: the losses agree
    within 2e-3 relative and the gradients within 5e-2 relative L2. The
    weight matrices after three steps agree within 1e-2 relative L2; the
    vectors (zero-initialised biases, LayerNorm) are left out there: their
    bf16 gradients carry ~1% noise, and Adam's first steps move each
    element by about lr whatever its gradient's size, so where those
    gradients are small the two sides' steps differ by that noise."""
    model, losses = _train_and_compare(
        TINY, tiny_params, _tokens(2, 32, seed=3), jax_impl="flash",
        dtype="bfloat16", loss_rtol=2e-3, grad_rel=5e-2, param_rel=1e-2,
        matrices_only=True,
    )
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        logits = model(torch.from_numpy(_tokens(1, 8)))
    assert logits.dtype == torch.bfloat16
    assert losses[-1] < losses[0]
