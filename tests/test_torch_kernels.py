"""The hand-written CUDA kernels of ray_tpu_torch against their plain
PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode): each
carries the `cuda` marker and skips with a reason without one. The file
imports neither jax nor ray_tpu, so it runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_packed_bwd,
    flash_attention_packed_bwd_reference,
    flash_attention_packed_fwd,
    flash_attention_packed_reference,
    flash_attention_reference,
    paged_attention,
    paged_flash_attention,
    quantize_kv,
)
from ray_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_fused,
    flash_attention_bwd_fused_reference,
    flash_attention_bwd_reference,
    flash_bwd_delta,
    flash_bwd_delta_reference,
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
)

# f32: the kernel and the plain version differ in summation order only.
# bf16: the kernels round P (and, backward, dS) where the plain versions do,
# but the bf16 forward walks 64-key tiles against the plain version's 128,
# so P is rounded against another running max here and there, and
# summation order flips a bf16 rounding here and there. Gradients are held
# relative to their largest magnitude (they sum over up to S rows).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_close(got, want, dtype):
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _paged_inputs(device, dtype, kv, b=3, s=5, h=4, d=64, bs=16, nb=4):
    rng = np.random.RandomState(11)
    t = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    q, nk, nv = t(b, s, h, d), t(b, s, h, d), t(b, s, h, d)
    kc, vc = t(b * nb + 1, bs, h, d), t(b * nb + 1, bs, h, d)
    lens = torch.tensor([0, 17, 64][:b], dtype=torch.int32)
    tables = torch.from_numpy(rng.permutation(np.arange(1, b * nb + 1)).reshape(b, nb))
    used = (lens + bs - 1) // bs
    tables = torch.where(torch.arange(nb)[None] < used[:, None], tables, 0).int()
    ks = vs = None
    if kv == "int8":
        kc, ks = quantize_kv(kc)
        vc, vs = quantize_kv(vc)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    out = [q.to(dtype), kc, vc, tables, lens, nk.to(dtype), nv.to(dtype), ks, vs]
    return [None if x is None else x.to(device) for x in out]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("s", [1, 5, 40])
def test_paged_kernel_matches_plain(cuda, kv, s):
    """Decode (S=1), verify-shaped (S=5) and a suffix longer than one key
    chunk (S=40), at context 0, mid-block and a full table; int8 against
    the int8 plain version. The launch counter moves once per launch."""
    dtype = torch.float32 if kv == "f32" else torch.bfloat16
    q, kc, vc, tables, lens, nk, nv, ks, vs = _paged_inputs(cuda, dtype, kv, s=s)
    before = paged_flash_attention.launches
    got = paged_flash_attention(q, kc, vc, tables, lens, new_k=nk, new_v=nv,
                                k_scale=ks, v_scale=vs)
    assert paged_flash_attention.launches == before + 1
    qs = (q.float() / 8.0).to(q.dtype)  # the wrapper's prescale, D = 64
    want = paged_attention(qs, kc, vc, tables, lens, new_k=nk, new_v=nv,
                           sm_scale=1.0, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_paged_kernel_refuses_what_it_cannot_take(cuda):
    q, kc, vc, tables, lens, nk, nv, _, _ = _paged_inputs(cuda, torch.float32, "f32")
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_attention(q, kc, vc, tables, lens, new_k=nk.transpose(1, 2).contiguous().transpose(1, 2), new_v=nv)
    with pytest.raises(ValueError, match="int32"):
        paged_flash_attention(q, kc, vc, tables.long(), lens, new_k=nk, new_v=nv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, causal):
    """O and lse at a length that is not a tile multiple, from the strided
    q/k/v views of a packed projection (as the model passes them)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 200, 3 * 4 * 64, generator=g, device=cuda).to(dtype)
    q, k, v = (t.view(2, 200, 4, 64) for t in qkv.split(256, dim=-1))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    assert flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype]


def _packed(cuda, dtype, b=2, s=200, h=4, d=64, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    do = torch.randn(b, s, h * d, generator=g, device=cuda).to(dtype)
    return qkv, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_packed_forward_kernel_matches_plain(cuda, dtype, causal, d):
    """K6: O [B, S, E] and lse [B, H, S] from a packed qkv at a length that
    is not a tile multiple, q prescaled in the kernel (D = 32 and 64, so a
    misplaced sm_scale cannot pass)."""
    qkv, _ = _packed(cuda, dtype, d=d)
    before = flash_attention_packed_fwd.launches
    o, lse = flash_attention_packed_fwd(qkv, 4, causal=causal)
    assert flash_attention_packed_fwd.launches == before + 1
    o_ref, lse_ref = flash_attention_packed_reference(qkv, 4, causal=causal)
    torch.cuda.synchronize()
    assert o.shape == (2, 200, 4 * d) and lse.shape == (2, 4, 200)
    _assert_close(o, o_ref, dtype)
    _assert_close(lse, lse_ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_backward_kernels_match_plain(cuda, dtype, causal, d):
    """K4 (dQ), K5 (dK, dV) and the delta pre-pass, each against its plain
    version on the strided q/k/v views of a packed projection."""
    qkv, do = _packed(cuda, dtype, d=d, seed=1)
    q, k, v = (t.unflatten(-1, (4, d)) for t in qkv.split(4 * d, dim=-1))
    do = do.unflatten(-1, (4, d))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    counts = [f.launches for f in (flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)]
    delta = flash_bwd_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    assert [f.launches for f in (flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)] == [
        c + 1 for c in counts
    ]
    kw = dict(causal=causal)
    _assert_close(delta, flash_bwd_delta_reference(o, do), dtype)
    _assert_close(dq, flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw), dtype)
    dk_ref, dv_ref = flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    _assert_close(dk, dk_ref, dtype)
    _assert_close(dv, dv_ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_backward_kernel_matches_plain(cuda, dtype):
    """K7: dqkv written by the dQ and dK/dV kernels straight into one
    [B, S, 3E] tensor, against the plain packed backward."""
    qkv, do = _packed(cuda, dtype, seed=2)
    o, lse = flash_attention_packed_fwd(qkv, 4, causal=True)
    before = flash_attention_packed_bwd.launches
    dqkv = flash_attention_packed_bwd(qkv, o, do, lse, 4, causal=True)
    assert flash_attention_packed_bwd.launches == before + 1
    assert dqkv.shape == qkv.shape and dqkv.is_contiguous()
    want = flash_attention_packed_bwd_reference(qkv, o, do, lse, 4, causal=True)
    torch.cuda.synchronize()
    _assert_close(dqkv, want, dtype)


@pytest.mark.cuda
def test_autograd_launches_the_kernels(cuda):
    """On CUDA tensors that require grad, both autograd functions run the
    forward and backward kernels (never the plain versions), and their
    gradients equal the plain backward's; a transposed (non-contiguous)
    upstream gradient is taken as it comes. `flash_attention` at S = 200
    with 100-token blocks (several blocks, by the reference's rule) runs
    K4 + K5; its one-block default runs K3 (test below)."""
    qkv, do = _packed(cuda, torch.float32, seed=3)
    x = qkv.clone().requires_grad_()
    fwd, bwd = flash_attention_packed_fwd.launches, flash_attention_packed_bwd.launches
    out = flash_attention_packed(x, 4, causal=True)
    out.backward(do.transpose(0, 1).contiguous().transpose(0, 1))
    assert flash_attention_packed_fwd.launches == fwd + 1
    assert flash_attention_packed_bwd.launches == bwd + 1
    o, lse = flash_attention_packed_reference(qkv, 4, causal=True)
    want = flash_attention_packed_bwd_reference(qkv, o, do, lse, 4, causal=True)
    _assert_close(x.grad, want, torch.float32)
    q, k, v = (t.unflatten(-1, (4, 64)).detach().clone().requires_grad_()
               for t in qkv.split(256, dim=-1))
    counts = flash_attention_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches
    out = flash_attention(q, k, v, causal=True, block_q=100, block_k=100)
    out.backward(do.unflatten(-1, (4, 64)))
    assert (flash_attention_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    o, lse = flash_attention_reference(q, k, v, causal=True)
    grads = flash_attention_bwd_reference(
        q, k, v, o, do.unflatten(-1, (4, 64)), lse, causal=True
    )
    for t, g in zip((q, k, v), grads):
        _assert_close(t.grad, g, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(200, 64), (96, 32), (256, 64)])
def test_fused_backward_kernel_matches_plain(cuda, dtype, causal, s, d):
    """K3 (the one-pass backward, delta inside, dQ by atomics) against its
    plain version on the strided q/k/v views of a packed projection; S = 200
    and 96 end in a partial 64-row key tile."""
    qkv, do = _packed(cuda, dtype, s=s, d=d, seed=4)
    q, k, v = (t.unflatten(-1, (4, d)) for t in qkv.split(4 * d, dim=-1))
    do = do.unflatten(-1, (4, d))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    before = flash_attention_bwd_fused.launches
    grads = flash_attention_bwd_fused(q, k, v, o, do, lse, causal=causal)
    assert flash_attention_bwd_fused.launches == before + 1
    want = flash_attention_bwd_fused_reference(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    for got, w in zip(grads, want):
        assert got.shape == w.shape and got.dtype == dtype
        _assert_close(got, w, dtype)


@pytest.mark.cuda
def test_single_block_gradient_runs_k3_not_k4_k5(cuda):
    """`flash_attention`'s gradient at a one-block length (S = 200, default
    blocks) launches K3 once and neither K4, K5 nor the delta pre-pass, and
    equals the plain two-kernel backward's."""
    qkv, do = _packed(cuda, torch.float32, seed=5)
    q, k, v = (t.unflatten(-1, (4, 64)).detach().clone().requires_grad_()
               for t in qkv.split(256, dim=-1))
    kernels = (flash_attention_bwd_fused, flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)
    counts = [f.launches for f in kernels]
    out = flash_attention(q, k, v, causal=True)
    out.backward(do.unflatten(-1, (4, 64)))
    assert [f.launches - c for f, c in zip(kernels, counts)] == [1, 0, 0, 0]
    o, lse = flash_attention_reference(q, k, v, causal=True)
    grads = flash_attention_bwd_reference(
        q, k, v, o, do.unflatten(-1, (4, 64)), lse, causal=True
    )
    for t, g in zip((q, k, v), grads):
        _assert_close(t.grad, g, torch.float32)


def _assert_limits(got, want, what):
    """chip_smoke.py's check of a kernel output against its plain version:
    relative L2 and per-element rounding steps plus a floor of the RMS, by
    the output's dtype (LIMITS)."""
    out = chip_smoke.compare(got, want)
    lim = chip_smoke.LIMITS[want.dtype]
    assert out["rel_l2"] <= lim["rel_l2"] and out["floor_rms"] <= lim["floor_rms"], (
        what, out, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 200, 1000, 1024])
def test_bf16_forward_tensor_core_kernel_matches_plain(cuda, s, d, causal, b):
    """The bf16 forward (tensor cores) against the plain versions, o and lse
    apart, by chip_smoke.py's LIMITS: K2 on the strided q/k/v views of a
    packed projection (batch stride 3E, as the trainer passes them) and on
    contiguous copies, K6 on the projection itself. S = 1, 63, 65, 200 and
    1000 end inside a 64-row tile; 1024 fills 16."""
    h = 3
    g = torch.Generator(device=cuda).manual_seed(s * 1000 + d + causal + 7 * b)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    want_o, want_lse = flash_attention_reference(q, k, v, causal=causal)
    for label, args in (("strided", (q, k, v)),
                        ("contiguous", tuple(t.contiguous() for t in (q, k, v)))):
        before = flash_attention_fwd.launches
        o, lse = flash_attention_fwd(*args, causal=causal)
        assert flash_attention_fwd.launches == before + 1
        torch.cuda.synchronize()
        assert o.dtype == torch.bfloat16 and lse.shape == (b * h, s)
        _assert_limits(o, want_o, ("K2", label, "o"))
        _assert_limits(lse, want_lse, ("K2", label, "lse"))
    o, lse = flash_attention_packed_fwd(qkv, h, causal=causal)
    want_o, want_lse = flash_attention_packed_reference(qkv, h, causal=causal)
    torch.cuda.synchronize()
    assert o.shape == (b, s, h * d) and lse.shape == (b, h, s)
    _assert_limits(o, want_o, ("K6", "o"))
    _assert_limits(lse, want_lse, ("K6", "lse"))


@pytest.mark.cuda
def test_bf16_forward_refuses_head_dims_it_was_not_built_for(cuda):
    """bf16 head_dim 48 (16-byte rows, but no tensor-core instantiation) is
    refused by both forward entries, naming the head_dims it takes; f32 at
    the same head_dim runs on the CUDA-core kernel."""
    g = torch.Generator(device=cuda).manual_seed(9)
    qkv = torch.randn(2, 70, 3 * 2 * 48, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = qkv.to(dtype)
        q, k, v = (t.unflatten(-1, (2, 48)) for t in x.split(96, dim=-1))
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match=r"head_dim 48.*\(32, 64, 128\)"):
                flash_attention_fwd(q, k, v, causal=True)
            with pytest.raises(ValueError, match=r"head_dim 48.*\(32, 64, 128\)"):
                flash_attention_packed_fwd(x, 2, causal=True)
        else:
            o, lse = flash_attention_fwd(q, k, v, causal=True)
            want_o, want_lse = flash_attention_reference(q, k, v, causal=True)
            torch.cuda.synchronize()
            _assert_limits(o, want_o, "o")
            _assert_limits(lse, want_lse, "lse")
