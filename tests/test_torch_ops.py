"""ray_tpu_torch.ops against the JAX reference package on the same inputs.

Inputs are made from a numpy seed and handed to both packages. The JAX
Pallas kernels run in interpret mode on the CPU (as the reference's own
tests run them); the port's kernel wrappers run their plain versions on
CPU tensors. The kernels themselves are tested on the card by
tests/test_torch_kernels.py.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jax_attention_fn
from ray_tpu.ops import flash_attention as jax_flash_attention
from ray_tpu.ops import paged_attention as jax_paged_attention
from ray_tpu.ops import paged_flash_attention as jax_paged_flash_attention
from ray_tpu.ops import quantize_kv as jax_quantize_kv
from ray_tpu.ops.attention import _chunk_attn_partial as jax_chunk_partial
from ray_tpu.ops.attention import finalize_partial as jax_finalize
from ray_tpu.ops.attention import merge_partials as jax_merge
from ray_tpu.ops.flash_attention import _flash_bwd as jax_flash_bwd
from ray_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from ray_tpu.ops.flash_attention import _pick_block as jax_pick_block
from ray_tpu.ops.flash_attention import _packed_bwd as jax_packed_bwd
from ray_tpu.ops.flash_attention import _packed_fwd as jax_packed_fwd
from ray_tpu.ops.flash_attention import _packed_n_sub as jax_packed_n_sub
from ray_tpu.ops.paged_flash import kv_pool_bytes as jax_kv_pool_bytes
from ray_tpu_torch.ops import (
    attention,
    dequantize_kv,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_fused,
    flash_attention_bwd_fused_reference,
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_packed_bwd,
    flash_attention_packed_fwd,
    flash_attention_reference,
    mha_reference,
    paged_attention,
    paged_attention_impl,
    paged_flash_attention,
    quantize_kv,
)
from ray_tpu_torch.ops.attention import (
    _chunk_attn_partial,
    finalize_partial,
    merge_partials,
    validate_tp_heads,
)
from ray_tpu_torch.ops.paged_flash import kv_pool_bytes, resolve_paged_impl

# Tiny shapes: one intra-op thread, so the suite's parallel workers keep
# their cores (several reference tests are timing-sensitive).
torch.set_num_threads(1)

F32_TOL = 1e-5  # same f32 math, different summation order


def _paged_case(seed, b, s, h=4, d=16, bs=4, nb=4):
    """Random paged-attention inputs as numpy: pools, 0-padded tables
    (distinct non-null blocks per row), new K/V."""
    num_blocks = b * nb + 1
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    kc = rng.randn(num_blocks, bs, h, d).astype(np.float32)
    vc = rng.randn(num_blocks, bs, h, d).astype(np.float32)
    nk = rng.randn(b, s, h, d).astype(np.float32)
    nv = rng.randn(b, s, h, d).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_blocks))
    tables = perm[: b * nb].reshape(b, nb).astype(np.int32)
    return q, kc, vc, tables, nk, nv


def _null_pad(tables, lens, bs):
    """Zero each row's table past its context (the engine's padding)."""
    used = -(-np.asarray(lens) // bs)
    return np.where(np.arange(tables.shape[1])[None] < used[:, None], tables, 0).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------- paged


PAGED_CASES = {
    # name: (b, s, context lengths, null-padded tables)
    "decode_ctx0_partial_max": (4, 1, (9, 2, 16, 0), False),
    "decode_block_edges_full": (4, 1, (8, 4, 12, 16), False),
    "decode_null_padded": (3, 1, (6, 0, 13), True),
    "partial_prefill": (3, 5, (9, 0, 16), True),
    "verify_shape": (4, 5, (0, 8, 16, 9), True),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("with_new", [True, False])
def test_paged_attention_matches_jax(case, with_new):
    """The plain paged op equals the JAX oracle at f32 (tolerance: same
    math, summation order) — ctx 0, block edges, the full table, null-
    padded tables, the multi-query partial-prefill and verify shapes, and
    cache-only queries whose empty rows must be exact zeros."""
    b, s, lens, pad = PAGED_CASES[case]
    q, kc, vc, tables, nk, nv = _paged_case(sorted(PAGED_CASES).index(case), b, s)
    if pad:
        tables = _null_pad(tables, lens, kc.shape[1])
    lens = np.asarray(lens, np.int32)
    kw_j = dict(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv)) if with_new else {}
    kw_t = dict(new_k=torch.from_numpy(nk), new_v=torch.from_numpy(nv)) if with_new else {}
    want = jax_paged_attention(*_j(q, kc, vc, tables, lens), **kw_j)
    got = paged_attention(*_t(q, kc, vc, tables, lens), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    if not with_new:
        empty = lens == 0
        assert np.all(got.numpy()[empty] == 0.0)


@pytest.mark.parametrize("variant", ["bf16", "int8", "mixed"])
def test_paged_attention_dtypes_match_jax(variant):
    """bf16 pools and queries (tolerance: bf16 rounding at different
    places, 2e-2), int8 pools with bf16 scales (bit-identical inputs,
    f32 math: 1e-5), and bf16 pools under f32 queries (promotion)."""
    q, kc, vc, tables, nk, nv = _paged_case(8, b=4, s=5)
    lens = np.asarray([0, 8, 16, 9], np.int32)
    jq, jk, jv, jt, jl, jnk, jnv = _j(q, kc, vc, tables, lens, nk, nv)
    tq, tk, tv, tt, tl, tnk, tnv = _t(q, kc, vc, tables, lens, nk, nv)
    kw_j, kw_t, atol = {}, {}, F32_TOL
    if variant == "bf16":
        jq, jk, jv, jnk, jnv = (x.astype(jnp.bfloat16) for x in (jq, jk, jv, jnk, jnv))
        tq, tk, tv, tnk, tnv = (x.bfloat16() for x in (tq, tk, tv, tnk, tnv))
        atol = 2e-2
    elif variant == "int8":
        jk, jks = jax_quantize_kv(jk)
        jv, jvs = jax_quantize_kv(jv)
        tk, tks = quantize_kv(tk)
        tv, tvs = quantize_kv(tv)
        kw_j = dict(k_scale=jks, v_scale=jvs)
        kw_t = dict(k_scale=tks, v_scale=tvs)
    else:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    want = jax_paged_attention(jq, jk, jv, jt, jl, new_k=jnk, new_v=jnv, **kw_j)
    got = paged_attention(tq, tk, tv, tt, tl, new_k=tnk, new_v=tnv, **kw_t)
    assert got.dtype == {"bf16": torch.bfloat16}.get(variant, torch.float32)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=atol
    )


def test_quantize_kv_bit_identical_to_jax():
    """Same values, same bf16 scales, same int8 codes: both round half to
    even and divide by the bf16-rounded scale. Includes exact .5 ties and
    all-zero rows; the round trip stays within half a step."""
    rng = np.random.RandomState(5)
    x = (rng.randn(7, 3, 4, 32) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 0, 0, :4] = [127.0, 63.5, -0.5, 1.5]  # amax 127 -> scale 1: ties
    jq, js = jax_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        ts.float().numpy(), np.asarray(js, np.float32)
    )
    back = dequantize_kv(tq, ts).numpy()
    amax = np.abs(x).max(axis=-1, keepdims=True)
    assert np.all(np.abs(back - x) <= amax / 127.0 + 1e-6)


@pytest.mark.parametrize(
    "shape",
    [
        (4, 1, (9, 2, 16, 0), "f32"),   # decode: partial, tiny, max, empty
        (3, 5, (9, 0, 16), "f32"),      # partial prefill
        (3, 2, (9, 16, 0), "int8"),     # int8 pools
    ],
)
def test_paged_flash_attention_wrapper_matches_jax_kernel(shape):
    """The kernel wrapper on CPU tensors (its plain version on the
    prescaled q) against JAX's Pallas kernel in interpret mode (narrow
    tables keep the interpret-mode grid small). f32 tolerance; int8 has
    identical quantized inputs."""
    b, s, lens, variant = shape
    q, kc, vc, tables, nk, nv = _paged_case(b * 10 + s, b, s)
    lens = np.asarray(lens, np.int32)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    kw_j, kw_t = {}, {}
    if variant == "int8":
        jk, jks = jax_quantize_kv(jk)
        jv, jvs = jax_quantize_kv(jv)
        tk, tks = quantize_kv(tk)
        tv, tvs = quantize_kv(tv)
        kw_j, kw_t = dict(k_scale=jks, v_scale=jvs), dict(k_scale=tks, v_scale=tvs)
    want = jax_paged_flash_attention(
        jnp.asarray(q), jk, jv, *_j(tables, lens),
        new_k=jnp.asarray(nk), new_v=jnp.asarray(nv), **kw_j,
    )
    got = paged_flash_attention(
        torch.from_numpy(q), tk, tv, *_t(tables, lens),
        new_k=torch.from_numpy(nk), new_v=torch.from_numpy(nv), **kw_t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_paged_wrapper_contract(monkeypatch):
    """new_k/new_v are required; scale/pool dtype mismatches raise in both
    implementations; the dispatcher resolves by device and rejects unknown
    knobs; the wrapper's launch count does not move on the CPU."""
    q, kc, vc, tables, nk, nv = _t(*_paged_case(6, b=1, s=1))
    lens = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="new_k/new_v"):
        paged_flash_attention(q, kc, vc, tables, lens, new_k=None, new_v=None)
    kq, ks = quantize_kv(kc)
    vq, vs = quantize_kv(vc)
    for op in (paged_flash_attention, paged_attention):
        with pytest.raises(ValueError, match="non-int8"):
            op(q, kc, vc, tables, lens, new_k=nk, new_v=nv, k_scale=ks, v_scale=vs)
        with pytest.raises(ValueError, match="require k_scale/v_scale"):
            op(q, kq, vq, tables, lens, new_k=nk, new_v=nv)
    assert resolve_paged_impl("auto", "cpu") == "reference"
    assert resolve_paged_impl("auto", torch.device("cuda")) == "cuda"
    assert resolve_paged_impl("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError, match="Unknown"):
        resolve_paged_impl("pallas")
    before = paged_flash_attention.launches
    auto = paged_attention_impl(q, kc, vc, tables, lens, new_k=nk, new_v=nv)
    forced = paged_attention_impl(
        q, kc, vc, tables, lens, new_k=nk, new_v=nv, impl="cuda"
    )
    np.testing.assert_allclose(auto.numpy(), forced.numpy(), atol=F32_TOL)
    assert paged_flash_attention.launches == before
    # A cache-only query goes to the kernel whenever the kernel is chosen,
    # and the kernel refuses it: never a quiet fall back to the reference.
    with pytest.raises(ValueError, match="new_k/new_v"):
        paged_attention_impl(q, kc, vc, tables, lens, impl="cuda")
    cache_only = paged_attention_impl(q, kc, vc, tables, lens)
    assert cache_only.shape == q.shape
    # 'auto' with pools on the card (resolution forced, as there is no card
    # here) takes the kernel for a cache-only query too, which raises.
    monkeypatch.setattr(
        sys.modules["ray_tpu_torch.ops.paged_flash"], "resolve_paged_impl",
        lambda impl, device=None: "cuda",
    )
    with pytest.raises(ValueError, match="new_k/new_v"):
        paged_attention_impl(q, kc, vc, tables, lens)
    with pytest.raises(ValueError, match="divisible"):
        validate_tp_heads(12, 5)


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_kv_pool_bytes_matches_jax(dtype):
    jax_dtype = {"float32": jnp.float32, "int8": jnp.int8, "bfloat16": jnp.bfloat16}[dtype]
    want = jax_kv_pool_bytes(1024, 16, 12, 64, jax_dtype, dtype == "int8")
    assert kv_pool_bytes(1024, 16, 12, 64, getattr(torch, dtype), dtype == "int8") == want


# ---------------------------------------------------------------- dense


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [16, 64])
def test_flash_attention_matches_jax_kernel(causal, s):
    """O and lse of the flash wrapper (plain blockwise version on CPU)
    against JAX's Pallas forward in interpret mode, f32."""
    rng = np.random.RandomState(s + causal)
    q, k, v = (rng.randn(2, s, 3, 16).astype(np.float32) for _ in range(3))
    sm = 1.0 / math.sqrt(16)
    want_o, res = jax_flash_fwd(*_j(q, k, v), sm, causal, s, s)
    want_lse = np.asarray(res[-1])  # [B*H, S]
    got_o, got_lse = flash_attention_fwd(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=F32_TOL)
    out = jax_flash_attention(*_j(q, k, v), causal=causal)
    np.testing.assert_allclose(
        flash_attention(*_t(q, k, v), causal=causal).numpy(), np.asarray(out),
        atol=F32_TOL,
    )


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_and_dispatcher_match_jax(causal):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 24, 4, 8).astype(np.float32) for _ in range(3))
    want = jax_attention_fn(*_j(q, k, v), causal=causal, impl="reference")
    for impl in ("reference", "auto", "flash"):
        got = attention(*_t(q, k, v), causal=causal, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    np.testing.assert_allclose(
        mha_reference(*_t(q, k, v), causal=causal).numpy(), np.asarray(want),
        atol=F32_TOL,
    )
    with pytest.raises(ValueError, match="Unknown attention impl"):
        attention(*_t(q, k, v), impl="ring")


def test_flash_reference_blockwise_across_tiles_and_grad_refusal():
    """S past one key tile: the blockwise recurrence equals the full-
    matrix reference, and so does the gradient of `flash_attention` (its
    plain blockwise backward on the CPU) against autograd through the
    full-matrix op. The forward kernel wrapper alone records no graph, so
    an input that requires grad is refused there, never detached."""
    rng = np.random.RandomState(4)
    q, k, v = _t(*(rng.randn(1, 300, 2, 8).astype(np.float32) for _ in range(3)))
    o, lse = flash_attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(
        o.numpy(), mha_reference(q, k, v, causal=True).numpy(), atol=F32_TOL
    )
    assert lse.shape == (2, 300)
    g = torch.from_numpy(rng.randn(1, 300, 2, 8).astype(np.float32))
    grads = []
    for op in (flash_attention, mha_reference):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        op(*x, causal=True).backward(g)
        grads.append([t.grad.numpy() for t in x])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(RuntimeError, match="records no autograd graph"):
        flash_attention_fwd(q.requires_grad_(), k, v, causal=True)


# ------------------------------------------------------------- training


def _qkv_packed(seed, b, s, h, d):
    return np.random.RandomState(seed).randn(b, s, 3 * h * d).astype(np.float32)


PACKED_CASES = {
    # name: (S, causal); B2 H4 D32. S384 runs JAX's packed kernels with
    # n_sub = 1, S512 with n_sub = 2 (causal half-split subtiles).
    "s256_causal": (256, True),
    "s256_full": (256, False),
    "s384_causal": (384, True),
    "s512_causal": (512, True),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_flash_attention_packed_matches_jax(case):
    """The packed path against JAX's Pallas packed kernels (K6, K7) in
    interpret mode, f32: O and lse of the forward wrapper within 2e-5, dqkv
    of the backward wrapper and of autograd through `flash_attention_packed`
    within 5e-3 (test_ops.py's tolerances for the same kernels)."""
    s, causal = PACKED_CASES[case]
    b, h, d = 2, 4, 32
    if s in (384, 512):
        assert jax_packed_n_sub(s, causal) == {384: 1, 512: 2}[s]
    qkv = _qkv_packed(s + causal, b, s, h, d)
    do = np.random.RandomState(1).randn(b, s, h * d).astype(np.float32)
    sm = 1.0 / math.sqrt(d)
    want_o, res = jax_packed_fwd(jnp.asarray(qkv), h, sm, causal)
    (want_dqkv,) = jax_packed_bwd(h, sm, causal, res, jnp.asarray(do))
    got_o, got_lse = flash_attention_packed_fwd(torch.from_numpy(qkv), h, causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[2]), atol=2e-5)
    got_dqkv = flash_attention_packed_bwd(
        torch.from_numpy(qkv), got_o, torch.from_numpy(do), got_lse, h, causal=causal
    )
    np.testing.assert_allclose(got_dqkv.numpy(), np.asarray(want_dqkv), rtol=5e-3, atol=5e-3)
    x = torch.from_numpy(qkv).requires_grad_()
    out = flash_attention_packed(x, h, causal=causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), atol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dqkv), rtol=5e-3, atol=5e-3)


def test_flash_attention_packed_bf16_rounding_matches_jax():
    """bf16 packed forward and backward against JAX's kernels. Both round
    q's prescale, P and dS to bf16 at the same points, so what is left is
    f32 summation order flipping the final bf16 rounding of an output here
    and there: one or two bf16 ulps at these magnitudes (|dqkv| < 4), which
    2e-2 bounds. The rounding points show in how many outputs are
    bit-identical to JAX's: O 1.0, dQ 0.9998, dK 0.9999, dV 0.9996 here,
    now that the plain forward takes each row's max in one pass as JAX's
    packed kernel does (O 0.943 and ~75% of dQ and dK with the former
    128-key running max); with dS kept f32, ~58% of dQ and dK; with P too,
    about half of dV."""
    b, s, h, d = 1, 256, 2, 32
    qkv = _qkv_packed(7, b, s, h, d)
    do = np.random.RandomState(8).randn(b, s, h * d).astype(np.float32)
    sm = 1.0 / math.sqrt(d)
    jq, jdo = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(do, jnp.bfloat16)
    want_o, res = jax_packed_fwd(jq, h, sm, True)
    (want_dqkv,) = jax_packed_bwd(h, sm, True, res, jdo)
    x = torch.from_numpy(qkv).bfloat16().requires_grad_()
    out = flash_attention_packed(x, h, causal=True)
    out.backward(torch.from_numpy(do).bfloat16())
    assert out.dtype == x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.detach().float().numpy(), np.asarray(want_o, np.float32), atol=2e-2
    )
    np.testing.assert_allclose(
        x.grad.float().numpy(), np.asarray(want_dqkv, np.float32), atol=2e-2
    )
    same = x.grad.float().numpy() == np.asarray(want_dqkv, np.float32)
    e = h * d
    # O: P rounded before P·V against the same one-pass row max on both
    # sides (0.623 with P kept f32).
    assert _bf16_share(out.detach(), want_o) >= 0.99
    assert same[..., 2 * e:].mean() > 0.99  # dV: P rounded
    assert same[..., :e].mean() > 0.99 and same[..., e:2 * e].mean() > 0.99  # dS rounded


def _bf16_share(got: torch.Tensor, want) -> float:
    """Share of bf16 outputs bit-identical to the reference's."""
    return float((got.float().numpy() == np.asarray(want, np.float32)).mean())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_reference_bf16_rounds_p_as_jax(causal):
    """K2's plain forward against JAX's `_fwd_kernel` (interpret mode) in
    bf16 at B1 S256 H2 D32 with 128-token blocks on both sides: both round
    q's prescale and, before P·V, the unnormalised P to v's dtype, with the
    same running max at the same tile edges, so O is bit-identical but for
    summation order (measured: 1.0 causal, 0.9999 not; 0.63 and 0.60 with P
    kept f32) and lse within 2e-6 (4.8e-7)."""
    b, s, h, d = 1, 256, 2, 32
    rng = np.random.RandomState(5 + causal)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    sm = 1.0 / math.sqrt(d)
    want_o, res = jax_flash_fwd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                sm, causal, 128, 128)
    got_o, got_lse = flash_attention_fwd(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=causal,
        block_k=128)
    assert got_o.dtype == torch.bfloat16
    assert _bf16_share(got_o, want_o) >= 0.99
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[-1]), atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_packed_reference_bf16_rounds_p_as_jax(causal):
    """K6's plain forward against JAX's `_packed_fwd_kernel` (interpret
    mode) in bf16 at B1 S256 H2 D32: P rounded to v's dtype before P·V on
    both sides, against each row's max over all its keys taken in one pass
    on both sides (measured: 1.0 causal, 0.9995 not; 0.93 and 0.81 when the
    plain version took a running max over 128-key tiles; 0.63 and 0.60 with
    P kept f32). lse within 2e-6."""
    b, s, h, d = 1, 256, 2, 32
    qkv = _qkv_packed(7 + causal, b, s, h, d)
    want_o, res = jax_packed_fwd(jnp.asarray(qkv, jnp.bfloat16), h, 1.0 / math.sqrt(d), causal)
    got_o, got_lse = flash_attention_packed_fwd(
        torch.from_numpy(qkv).bfloat16(), h, causal=causal)
    assert got_o.dtype == torch.bfloat16
    assert _bf16_share(got_o, want_o) >= 0.99
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[2]), atol=2e-6)


@pytest.mark.parametrize("kernel", ["K2", "K6"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 1024])
def test_plain_forwards_round_p_at_the_reference_tile_edges(s, causal, kernel):
    """The plain forwards at the reference's DEFAULT blocks, bf16, B1 H2
    D32: K2's against `_fwd_kernel` with `_pick_block(S)` blocks (one key
    tile of S here), K6's against `_packed_fwd_kernel` (one pass over all
    keys). P is rounded against the same max on both sides, so O is
    bit-identical but for summation order. Measured: K2 0.9998 / 0.9999 at
    S256 (causal / not), 0.9996 / 0.9989 at S1024; K6 1.0 / 0.9995 and
    0.9996 / 0.9991. With the plain version's former 128-key tiles K2 read
    0.944 / 0.803 and 0.757 / 0.676. lse within 2e-6 (9.5e-7 measured)."""
    b, h, d = 1, 2, 32
    sm = 1.0 / math.sqrt(d)
    if kernel == "K2":
        rng = np.random.RandomState(s + causal)
        q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
        block = jax_pick_block(s)
        want_o, res = jax_flash_fwd(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), sm, causal, block, block)
        want_lse = res[-1]
        got_o, got_lse = flash_attention_fwd(
            *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=causal)
    else:
        qkv = _qkv_packed(s + 7 + causal, b, s, h, d)
        want_o, res = jax_packed_fwd(jnp.asarray(qkv, jnp.bfloat16), h, sm, causal)
        want_lse = res[2]
        got_o, got_lse = flash_attention_packed_fwd(
            torch.from_numpy(qkv).bfloat16(), h, causal=causal)
    assert _bf16_share(got_o, want_o) >= 0.99
    np.testing.assert_allclose(
        got_lse.numpy().ravel(), np.asarray(want_lse).ravel(), atol=2e-6)


@pytest.mark.parametrize("s,block", [(256, 128), (128, None)])
def test_flash_attention_grad_matches_jax(s, block):
    """Gradients of `flash_attention` against JAX's: at S256 with 128-token
    blocks JAX runs its dQ and dK/dV kernels (K4, K5), at S128 in one block
    its fused one-program kernel (K3); the port runs its plain blockwise
    backward on the CPU either way. f32, test_ops.py's 5e-4. Blocks that do
    not divide S raise in both."""
    rng = np.random.RandomState(s)
    q, k, v, g = (rng.randn(2, s, 2, 32).astype(np.float32) for _ in range(4))
    kw = dict(causal=True, block_q=block, block_k=block)
    out, vjp = jax.vjp(lambda *x: jax_flash_attention(*x, **kw), *_j(q, k, v))
    want = vjp(jnp.asarray(g))
    x = [t.requires_grad_() for t in _t(q, k, v)]
    got = flash_attention(*x, **kw)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=2e-5)
    for t, w in zip(x, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-4)
    # The kernel-level entry computes the same three gradients.
    o, lse = flash_attention_fwd(*_t(q, k, v), causal=True)
    direct = flash_attention_bwd(*_t(q, k, v), o, torch.from_numpy(g), lse, causal=True)
    for t, w in zip(direct, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=5e-4)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(*_t(q, k, v), causal=True, block_q=96)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 512])
def test_plain_blockwise_backward_bf16_rounds_as_jax(s, causal):
    """The plain blockwise backward (the plain versions of K4 and K5, which
    the bf16 tensor-core kernels are held to on the card) against JAX's
    `_dq_kernel` and `_dkv_kernel` (interpret mode) in bf16 at B2 H2 D64
    with 128-token blocks, both from JAX's own forward residuals (O, lse).
    Both prescale q, round P to bf16 before dV += Pᵀ dO and dS (from the
    unrounded f32 P) before dQ += dS K and dK += dSᵀ q_scaled, and scale dQ
    once at the end, so dq, dk and dv are bit-identical but for f32
    summation order. Held: ≥ 0.99 of each output's elements bit-identical
    and relative L2 ≤ 1e-3 (measured: 0.9975 – 0.9999 and ≤ 1.4e-4)."""
    b, h, d, block = 2, 2, 64, 128
    rng = np.random.RandomState(s + causal)
    q, k, v, g = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    sm = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    out, res = jax_flash_fwd(jq, jk, jv, sm, causal, block, block)
    want = jax_flash_bwd(sm, causal, block, block, res, jg)
    lse = torch.from_numpy(np.array(res[-1]))  # [B*H, S] f32
    o = torch.from_numpy(np.asarray(out, np.float32)).bfloat16()
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    got = flash_attention_bwd(tq, tk, tv, o, tg, lse, causal=causal)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == torch.bfloat16, name
        w32 = np.asarray(w, np.float32)
        rel = np.linalg.norm(t.float().numpy() - w32) / np.linalg.norm(w32)
        assert _bf16_share(t, w) >= 0.99 and rel <= 1e-3, (name, _bf16_share(t, w), rel)


# ------------------------------------------------- one-block backward (K3)

K3_CASES = {
    # name: (B, S, H, D, causal, dtype). S96 is not a multiple of the
    # kernel's 64-row key tile, so its plain version meets a tail too.
    "s128_causal": (2, 128, 2, 64, True, "float32"),
    "s128_full": (2, 128, 2, 64, False, "float32"),
    "s96_causal": (2, 96, 2, 64, True, "float32"),
    "s96_full": (2, 96, 2, 64, False, "float32"),
    "s128_causal_bf16": (2, 128, 2, 64, True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_flash_bwd_fused_matches_jax_k3(case):
    """The one-block backward against JAX's `_bwd_fused_kernel` (K3) in
    interpret mode: JAX's `flash_attention(..., block_q=S, block_k=S)`
    gradient, which runs K3 because one block covers S. Both the port's
    plain K3 (`flash_attention_bwd_fused` on CPU tensors) and the autograd
    path through `flash_attention` (default blocks: one block at these S)
    are held to it. Tolerances: f32 5e-4 (test_ops.py's for the same
    kernels); bf16 3e-2 over gradients below 4 in magnitude, one or two bf16
    ulps, since both round P, dS and q's prescale at the same points and
    differ only in f32 summation order."""
    b, s, h, d, causal, dtype = K3_CASES[case]
    rng = np.random.RandomState(s + causal)
    q, k, v, g = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(x, jdt) for x in (q, k, v)]
    kw = dict(causal=causal, block_q=s, block_k=s)
    out, vjp = jax.vjp(lambda *x: jax_flash_attention(*x, **kw), *jx)
    want = [np.asarray(w, np.float32) for w in vjp(jnp.asarray(g, jdt))]
    tol = 5e-4 if dtype == "float32" else 3e-2
    tx = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    tg = torch.from_numpy(g).to(tdt)
    o, lse = flash_attention_fwd(*tx, causal=causal)
    direct = flash_attention_bwd_fused(*tx, o, tg, lse, causal=causal)
    plain = flash_attention_bwd_fused_reference(*tx, o, tg, lse, causal=causal)
    leaves = [t.clone().requires_grad_() for t in tx]
    got = flash_attention(*leaves, causal=causal)
    got.backward(tg)
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(out, np.float32), atol=tol
    )
    for grads in (direct, plain, [t.grad for t in leaves]):
        for t, w in zip(grads, want):
            assert t.dtype == tdt
            np.testing.assert_allclose(t.float().numpy(), w, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 1000])
def test_plain_fused_backward_bf16_rounds_as_jax(s, causal):
    """The plain one-block backward (the plain version of K3, which the bf16
    tensor-core kernel is held to on the card) against JAX's
    `_bwd_fused_kernel` (interpret mode) in bf16 at B1 H2 D64, with one block
    of S on the JAX side, both from JAX's own forward residuals (O, lse).
    Both prescale q, round P to dO's type before dV = Pᵀ dO, compute delta
    in f32, round dS (from the unrounded f32 P) to q's type before
    dK = dSᵀ q_scaled and dQ = dS K, and scale dQ once at the end, so dq, dk
    and dv are bit-identical but for f32 summation order. Held: ≥ 0.99 of
    each output's elements bit-identical and relative L2 ≤ 1e-3 (measured:
    0.9992 – 1.0 and ≤ 9.5e-5)."""
    b, h, d = 1, 2, 64
    rng = np.random.RandomState(s + causal)
    q, k, v, g = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    sm = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    out, res = jax_flash_fwd(jq, jk, jv, sm, causal, s, s)
    want = jax_flash_bwd(sm, causal, s, s, res, jg)
    lse = torch.from_numpy(np.array(res[-1]))  # [B*H, S] f32
    o = torch.from_numpy(np.asarray(out, np.float32)).bfloat16()
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    got = flash_attention_bwd_fused(tq, tk, tv, o, tg, lse, causal=causal)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == torch.bfloat16, name
        w32 = np.asarray(w, np.float32)
        rel = np.linalg.norm(t.float().numpy() - w32) / np.linalg.norm(w32)
        assert _bf16_share(t, w) >= 0.99 and rel <= 1e-3, (name, _bf16_share(t, w), rel)


# S: the reference's `_pick_block` gives one block at 64, 96, 128, 1000,
# 1024 and 2500 (128 does not divide 1000 or 2500), several at 1536, 2048
# and 2304.
SINGLE_BLOCK_S = [64, 96, 128, 1000, 1024, 1536, 2048, 2304, 2500]


def _jax_takes_one_block(monkeypatch, s, block) -> bool:
    """Which backward the reference picks at S with these blocks: trace
    `jax.grad` through its `flash_attention` (no kernel runs) and record
    which Pallas wrapper its `_flash_bwd` calls."""
    jax_fa = sys.modules["ray_tpu.ops.flash_attention"]
    called = []
    for name in ("_flash_bwd_fused_pallas", "_flash_bwd_pallas"):
        real = getattr(jax_fa, name)
        monkeypatch.setattr(jax_fa, name, lambda *a, _n=name, _f=real, **kw:
                            called.append(_n) or _f(*a, **kw))
    x = jnp.zeros((1, s, 1, 8), jnp.float32)
    loss = lambda q: jax_flash_attention(q, x, x, causal=True, block_q=block,
                                         block_k=block).sum()
    jax.make_jaxpr(jax.grad(loss))(x)
    assert len(called) == 1, called
    return called == ["_flash_bwd_fused_pallas"]


@pytest.mark.parametrize("s", SINGLE_BLOCK_S)
@pytest.mark.parametrize("blocks", ["default", "explicit_128", "explicit_s"])
def test_single_block_rule_matches_jax(monkeypatch, s, blocks):
    """The port's choice between the one-block backward (K3) and K4 + K5 is
    the reference's (`_flash_bwd`, flash_attention.py:674) over default and
    explicit blocks: the port's predicate names the backward that the
    reference's own dispatch calls, and `flash_attention`'s backward calls
    the wrapper the predicate names."""
    fa = sys.modules["ray_tpu_torch.ops.flash_attention"]
    block = {"default": None, "explicit_128": 128, "explicit_s": s}[blocks]
    pb = fa._pick_block(s) if block is None else block
    assert fa._pick_block(s) == jax_pick_block(s)
    if s % min(pb, s):
        # An explicit block that does not divide S raises in both.
        with pytest.raises(ValueError, match="divisible"):
            flash_attention(*_t(*(np.zeros((1, s, 1, 8), np.float32),) * 3),
                            block_q=block, block_k=block)
        return
    want = _jax_takes_one_block(monkeypatch, s, block)
    assert fa.single_block(s, s, min(pb, s), min(pb, s)) == want
    if blocks == "default":
        assert want == (s not in (1536, 2048, 2304))
    if s > 128:
        return  # the dispatch itself is shown at the short lengths
    called = []
    real = {n: getattr(fa, n) for n in ("flash_attention_bwd_fused", "flash_attention_bwd")}
    x = [t.requires_grad_() for t in _t(*(np.random.RandomState(s).randn(1, s, 2, 8)
                                        .astype(np.float32) for _ in range(3)))]
    try:
        for n, f in real.items():
            setattr(fa, n, lambda *a, _n=n, _f=f, **kw: called.append(_n) or _f(*a, **kw))
        flash_attention(*x, causal=True, block_q=block, block_k=block).sum().backward()
    finally:
        for n, f in real.items():
            setattr(fa, n, f)
    assert called == ["flash_attention_bwd_fused" if want else "flash_attention_bwd"]


def test_partials_merge_match_jax():
    """Blockwise partials, their merge and finalization (the ring/flash
    update rule) against JAX, including a fully-masked chunk."""
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(2, 6, 3, 8).astype(np.float32) for _ in range(3))
    mask = np.ones((1, 1, 6, 3), bool)
    mask[..., :3, :] = False  # rows 0-2 see nothing in chunk 1
    jp1 = jax_chunk_partial(*_j(q, k[:, :3], v[:, :3]), 0.3, jnp.asarray(mask))
    jp2 = jax_chunk_partial(*_j(q, k[:, 3:], v[:, 3:]), 0.3, None)
    tp1 = _chunk_attn_partial(*_t(q, k[:, :3], v[:, :3]), 0.3, torch.from_numpy(mask))
    tp2 = _chunk_attn_partial(*_t(q, k[:, 3:], v[:, 3:]), 0.3, None)
    want = jax_finalize(*jax_merge(*jp1, *jp2))
    got = finalize_partial(*merge_partials(*tp1, *tp2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    assert np.all(tp1[2].numpy()[:, :, :3] == 0.0)
