"""K1's split algorithm on the CPU: the port's plain split version
(`paged_attention_split_reference`: per-partition partials merged in
partition order) against the port's plain `paged_attention`, against the
JAX package's `paged_attention`, and against the same partials built and
merged by the JAX package's `_chunk_attn_partial`, `merge_partials` and
`finalize_partial`; and the split kernel's plan, which follows from the
shapes alone.

Inputs are made from a numpy seed and handed to both packages. The kernel
itself is held against these on the card by tests/test_torch_kernels.py.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jax_paged_attention
from ray_tpu.ops import quantize_kv as jax_quantize_kv
from ray_tpu.ops.attention import _chunk_attn_partial as jax_chunk_partial
from ray_tpu.ops.attention import finalize_partial as jax_finalize
from ray_tpu.ops.attention import merge_partials as jax_merge
from ray_tpu_torch.ops import paged_attention, quantize_kv
from ray_tpu_torch.ops.attention import NEG_INF, finalize_partial, merge_partials
from ray_tpu_torch.ops.paged_flash import (
    PART_PAGES,
    SPLIT_MAX_S,
    _check_kernel_inputs,
    paged_attention_split_reference,
    split_plan,
)

torch.set_num_threads(1)

BS, NB, H, D = 4, 40, 2, 16  # 16 pages a partition: 64 tokens, 3 partitions
PT = PART_PAGES * BS
# Contexts 0, 1, 15 and 16 (page edges), one below, at and one above a
# partition edge, and the full table.
CONTEXTS = (0, 1, 15, 16, PT - 1, PT, PT + 1, NB * BS)
# f32: the same math in another order. bf16: one bf16 rounding step of the
# output (|O| < 2) apart, or P rounded to bf16 where the plain version
# rounds it and the split version does not.
TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}


def _case(kv: str, s: int, seed: int = 0):
    """numpy inputs: q, pools (int8 with their scales), tables in random
    page order null-padded past each context, new K/V."""
    rng = np.random.RandomState(seed)
    b = len(CONTEXTS)
    n = b * NB + 1
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    q, nk, nv = f(b, s, H, D), f(b, s, H, D), f(b, s, H, D)
    kc, vc = f(n, BS, H, D), f(n, BS, H, D)
    tables = rng.permutation(np.arange(1, n)).reshape(b, NB).astype(np.int32)
    lens = np.asarray(CONTEXTS, np.int32)
    used = -(-lens // BS)
    tables = np.where(np.arange(NB)[None] < used[:, None], tables, 0).astype(np.int32)
    return q, kc, vc, tables, lens, nk, nv


def _torch_inputs(kv, q, kc, vc, tables, lens, nk, nv):
    t = [torch.from_numpy(x) for x in (q, kc, vc, tables, lens, nk, nv)]
    q, kc, vc, tables, lens, nk, nv = t
    scales = {}
    if kv == "int8":
        kc, ks = quantize_kv(kc)
        vc, vs = quantize_kv(vc)
        scales = dict(k_scale=ks, v_scale=vs)
    elif kv == "bf16":
        kc, vc = kc.bfloat16(), vc.bfloat16()
    if kv != "f32":
        q, nk, nv = q.bfloat16(), nk.bfloat16(), nv.bfloat16()
    return (q, kc, vc, tables, lens), dict(new_k=nk, new_v=nv, **scales)


def _jax_inputs(kv, q, kc, vc, tables, lens, nk, nv):
    j = [jnp.asarray(x) for x in (q, kc, vc, tables, lens, nk, nv)]
    q, kc, vc, tables, lens, nk, nv = j
    scales = {}
    if kv == "int8":
        kc, ks = jax_quantize_kv(kc)
        vc, vs = jax_quantize_kv(vc)
        scales = dict(k_scale=ks, v_scale=vs)
    elif kv == "bf16":
        kc, vc = kc.astype(jnp.bfloat16), vc.astype(jnp.bfloat16)
    if kv != "f32":
        q, nk, nv = (x.astype(jnp.bfloat16) for x in (q, nk, nv))
    return (q, kc, vc, tables, lens), dict(new_k=nk, new_v=nv, **scales)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


_CASES = [(kv, s) for kv in ("f32", "bf16", "int8") for s in (1, 5, 40)]


@pytest.mark.parametrize("kv,s", _CASES)
def test_split_reference_matches_plain(kv, s):
    """The split version equals the port's plain paged attention (one
    softmax over the whole gathered context) at every context of CONTEXTS,
    decode, verify and suffix shapes, every pool dtype."""
    args, kw = _torch_inputs(kv, *_case(kv, s))
    got = paged_attention_split_reference(*args, **kw)
    want = paged_attention(*args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[kv])


@pytest.mark.parametrize("kv,s", _CASES)
def test_split_reference_matches_jax_paged_attention(kv, s):
    """The split version against the JAX package's paged attention on the
    same numpy inputs (int8: both packages quantize them alike)."""
    raw = _case(kv, s, seed=1)
    args, kw = _torch_inputs(kv, *raw)
    jargs, jkw = _jax_inputs(kv, *raw)
    got = paged_attention_split_reference(*args, **kw)
    want = jax_paged_attention(*jargs, **jkw)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[kv])


def _jax_split(q, kc, vc, tables, lens, new_k, new_v, k_scale=None, v_scale=None):
    """The split algorithm composed from the JAX package's own partial,
    merge and finalize: the context gathered and dequantized as its
    paged_attention does, cut into partitions of PART_PAGES pages, the new
    tokens in partition 0 under the causal mask."""
    b, s, h, d = q.shape
    k_ctx = kc[tables].reshape(b, NB * BS, h, d)
    v_ctx = vc[tables].reshape(b, NB * BS, h, d)
    if k_scale is not None:
        k_ctx = (k_ctx.astype(jnp.float32)
                 * k_scale[tables].reshape(b, NB * BS, h)[..., None].astype(jnp.float32)
                 ).astype(q.dtype)
        v_ctx = (v_ctx.astype(jnp.float32)
                 * v_scale[tables].reshape(b, NB * BS, h)[..., None].astype(jnp.float32)
                 ).astype(q.dtype)
    causal = jnp.tril(jnp.ones((s, s), bool))
    acc = None
    for t0 in range(0, NB * BS, PT):
        pos = jnp.arange(t0, min(t0 + PT, NB * BS))
        mask = jnp.broadcast_to((pos[None] < lens[:, None])[:, None, None, :],
                                (b, 1, s, pos.shape[0]))
        k, v = k_ctx[:, t0:t0 + PT], v_ctx[:, t0:t0 + PT]
        if t0 == 0:
            k = jnp.concatenate([k.astype(jnp.float32), new_k.astype(jnp.float32)], 1)
            v = jnp.concatenate([v.astype(jnp.float32), new_v.astype(jnp.float32)], 1)
            mask = jnp.concatenate(
                [mask, jnp.broadcast_to(causal[None, None], (b, 1, s, s))], -1)
        part = jax_chunk_partial(q.astype(jnp.float32), k.astype(jnp.float32),
                                 v, 1.0 / np.sqrt(d), mask)
        acc = part if acc is None else jax_merge(*acc, *part)
    return jax_finalize(*acc).astype(q.dtype)


@pytest.mark.parametrize("kv,s", _CASES)
def test_split_reference_matches_jax_merge(kv, s):
    """The port's split version against the same partitions built and
    merged by the JAX package's `_chunk_attn_partial`, `merge_partials` and
    `finalize_partial`: the same algorithm in f32, so f32 agrees to
    summation order and bf16 to one rounding of the output."""
    raw = _case(kv, s, seed=2)
    args, kw = _torch_inputs(kv, *raw)
    jargs, jkw = _jax_inputs(kv, *raw)
    got = paged_attention_split_reference(*args, **kw)
    want = _jax_split(*jargs, **jkw)
    tol = 1e-5 if kv == "f32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


@pytest.mark.parametrize("both_empty", [False, True])
def test_empty_partition_merges_to_nothing(both_empty):
    """A partition with no visible key (m = NEG_INF, l = 0, o = 0) merges
    to nothing in either order, in the port and in the JAX package alike;
    two empty ones finalize to exact zeros, never NaN."""
    rng = np.random.RandomState(3)
    o = rng.randn(2, 3, 2, 4).astype(np.float32)
    m = rng.randn(2, 2, 3).astype(np.float32)
    l = rng.rand(2, 2, 3).astype(np.float32) + 0.5
    if both_empty:
        o, m, l = np.zeros_like(o), np.full_like(m, NEG_INF), np.zeros_like(l)
    empty = (np.zeros_like(o), np.full_like(m, NEG_INF), np.zeros_like(l))
    full = (o, m, l)
    for a, b in ((full, empty), (empty, full)):
        got = finalize_partial(*merge_partials(*(torch.from_numpy(x) for x in a + b)))
        want = jax_finalize(*jax_merge(*(jnp.asarray(x) for x in a + b)))
        alone = finalize_partial(*(torch.from_numpy(x) for x in full))
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=1e-6)
        if both_empty:
            assert np.all(got.numpy() == 0.0)


@pytest.mark.parametrize("nb,bs,s", [(1, 16, 1), (16, 16, 1), (17, 16, 5),
                                     (64, 16, 8), (40, 4, 1), (64, 16, 9)])
def test_split_plan_follows_from_shapes_alone(nb, bs, s):
    """The split kernel's grid and workspace come from nb, bs and S (and
    B, H, D), never from the context lengths: `split_plan` takes no
    lengths; PART_PAGES pages a partition; one partition covering the table
    needs no workspace; S above SPLIT_MAX_S is the suffix kernels'."""
    assert "context_lens" not in inspect.signature(split_plan).parameters
    b, h, d = 3, 12, 64
    plan = split_plan(b, s, h, d, nb, bs)
    if s > SPLIT_MAX_S:
        assert plan is None
        return
    n_part = -(-nb // PART_PAGES)
    assert plan.part_pages == PART_PAGES and plan.part_tokens == PART_PAGES * bs
    assert plan.n_part == n_part and plan.grid == (b * h, n_part)
    assert plan.workspace == (None if n_part == 1 else (b, h, n_part, s, d + 2))
    assert plan == split_plan(b, s, h, d, nb, bs)


def test_split_reference_decode_at_context_zero_is_the_new_value():
    """Decode of a slot with no cached token: every partition is empty
    (m = NEG_INF, l = 0) but partition 0, which holds the new token alone,
    so the merge must give that token's V row exactly."""
    q, kc, vc, tables, lens, nk, nv = _case("f32", 1, seed=4)
    args, kw = _torch_inputs("f32", q, kc, vc, tables, lens, nk, nv)
    got = paged_attention_split_reference(*args, **kw).numpy()
    empty = np.asarray(CONTEXTS) == 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[empty], nv[empty], atol=1e-6)


def test_bf16_suffix_refuses_other_head_dims():
    """The kernel wrapper's checks refuse a bf16 suffix (S > SPLIT_MAX_S)
    at a head_dim the tensor-core suffix kernel is not built for, and take
    it at S <= SPLIT_MAX_S (the split kernel) or with f32 pools."""
    def inputs(s, d, pool=torch.bfloat16):
        q = torch.zeros(2, s, 2, d, dtype=torch.bfloat16)
        kc = torch.zeros(5, 4, 2, d, dtype=pool)
        tables = torch.zeros(2, 2, dtype=torch.int32)
        lens = torch.zeros(2, dtype=torch.int32)
        return q, kc, kc.clone(), tables, lens, q.clone(), q.clone(), None, None

    with pytest.raises(ValueError, match="suffix kernel"):
        _check_kernel_inputs(*inputs(SPLIT_MAX_S + 1, 48))
    _check_kernel_inputs(*inputs(SPLIT_MAX_S, 48))
    _check_kernel_inputs(*inputs(SPLIT_MAX_S + 1, 64))
    f32_pools = list(inputs(SPLIT_MAX_S + 1, 48, torch.float32))
    _check_kernel_inputs(*f32_pools)
