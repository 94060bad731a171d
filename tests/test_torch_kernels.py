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
from ray_tpu_torch.ops import attn_profile as ap
from ray_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
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
# but the bf16 forward walks 64-key tiles against the plain version's (the
# reference's: up to 1024 keys), so P is rounded against another running
# max here and there, and
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


def _paged_inputs(device, dtype, kv, b=3, s=5, h=4, d=64, bs=16, nb=4,
                  lens=(0, 17, 64)):
    rng = np.random.RandomState(11)
    t = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    q, nk, nv = t(b, s, h, d), t(b, s, h, d), t(b, s, h, d)
    kc, vc = t(b * nb + 1, bs, h, d), t(b * nb + 1, bs, h, d)
    lens = torch.tensor(list(lens)[:b], dtype=torch.int32)
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
    qs = (q.float() / 8.0).to(q.dtype)  # the kernels' prescale, D = 64
    want = paged_attention(qs, kc, vc, tables, lens, new_k=nk, new_v=nv,
                           sm_scale=1.0, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 40])
def test_paged_kernel_takes_q_as_a_view_of_qkv(cuda, s):
    """The model hands the kernel q as a strided view of its packed qkv
    projection: the same output as a contiguous q, on the split (S = 1) and
    the suffix (S = 40) paths."""
    q, kc, vc, tables, lens, nk, nv, _, _ = _paged_inputs(
        cuda, torch.bfloat16, "bf16", s=s)
    qkv = torch.cat([q, nk, nv], dim=-1)  # [B, S, H, 3D]
    view = qkv[..., :64]
    assert not view.is_contiguous()
    got = paged_flash_attention(view, kc, vc, tables, lens, new_k=nk, new_v=nv)
    want = paged_flash_attention(q, kc, vc, tables, lens, new_k=nk, new_v=nv)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_paged_kernel_refuses_what_it_cannot_take(cuda):
    q, kc, vc, tables, lens, nk, nv, _, _ = _paged_inputs(cuda, torch.float32, "f32")
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_attention(q, kc, vc, tables, lens, new_k=nk.transpose(1, 2).contiguous().transpose(1, 2), new_v=nv)
    with pytest.raises(ValueError, match="int32"):
        paged_flash_attention(q, kc, vc, tables.long(), lens, new_k=nk, new_v=nv)


# Contexts at the split kernel's partition edges (PART_PAGES pages of 16
# tokens: 256 tokens a partition), at 0, and a full table of 48 pages.
_SPLIT_CTX = [0, 1, 255, 256, 257, 511, 512, 768]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("s", [1, 5, 8, 9, 40])
def test_paged_split_and_suffix_kernels_match_plain_twice(cuda, kv, s):
    """Both sides of the decode/suffix threshold (SPLIT_MAX_S = 8): the
    split kernel and its merge (S <= 8) and the suffix kernels (S > 8), with
    pages in random order, contexts at 0 and at the partition edges, every
    pool dtype. Held to chip_smoke's LIMITS against the plain version, and
    the same bit for bit on a second run (the partitions merge in a fixed
    order, without atomics)."""
    from ray_tpu_torch.ops.paged_flash import SPLIT_MAX_S, split_plan

    dtype = torch.float32 if kv == "f32" else torch.bfloat16
    b, nb = len(_SPLIT_CTX), 48
    q, kc, vc, tables, lens, nk, nv, ks, vs = _paged_inputs(
        cuda, dtype, kv, b=b, s=s, nb=nb, lens=_SPLIT_CTX)
    plan = split_plan(b, s, 4, 64, nb, 16)
    assert (plan is None) == (s > SPLIT_MAX_S)
    call = lambda: paged_flash_attention(q, kc, vc, tables, lens, new_k=nk,
                                         new_v=nv, k_scale=ks, v_scale=vs)
    before = paged_flash_attention.launches
    got, again = call(), call()
    assert paged_flash_attention.launches == before + 2
    qs = (q.float() / 8.0).to(q.dtype)  # the kernels' prescale, D = 64
    want = paged_attention(qs, kc, vc, tables, lens, new_k=nk, new_v=nv,
                           sm_scale=1.0, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_limits(got, want, ("K1", kv, s))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("d", [32, 128])
def test_paged_suffix_kernel_head_dims(cuda, kv, d):
    """The bf16 suffix kernel at its other head_dims (64 above), a suffix of
    70 rows (two query tiles, the second partial) over contexts that end
    inside a key tile."""
    q, kc, vc, tables, lens, nk, nv, ks, vs = _paged_inputs(
        cuda, torch.bfloat16, kv, b=3, s=70, d=d, nb=8, lens=[0, 37, 128])
    got = paged_flash_attention(q, kc, vc, tables, lens, new_k=nk, new_v=nv,
                                k_scale=ks, v_scale=vs)
    qs = (q.float() * d ** -0.5).to(q.dtype)
    want = paged_attention(qs, kc, vc, tables, lens, new_k=nk, new_v=nv,
                           sm_scale=1.0, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    _assert_limits(got, want, ("K1 suffix", kv, d))


@pytest.mark.cuda
def test_paged_suffix_kernel_refuses_other_head_dims(cuda):
    """A bf16 suffix at a head_dim the tensor-core kernel is not built for
    raises before any launch; decode at that head_dim takes the split
    kernel."""
    q, kc, vc, tables, lens, nk, nv, _, _ = _paged_inputs(
        cuda, torch.bfloat16, "bf16", s=40, d=48)
    before = paged_flash_attention.launches
    with pytest.raises(ValueError, match="suffix kernel"):
        paged_flash_attention(q, kc, vc, tables, lens, new_k=nk, new_v=nv)
    assert paged_flash_attention.launches == before
    one = [t[:, :1].contiguous() for t in (q, nk, nv)]
    got = paged_flash_attention(one[0], kc, vc, tables, lens, new_k=one[1],
                                new_v=one[2])
    qs = (one[0].float() * 48 ** -0.5).to(q.dtype)
    want = paged_attention(qs, kc, vc, tables, lens, new_k=one[1],
                           new_v=one[2], sm_scale=1.0)
    torch.cuda.synchronize()
    _assert_limits(got, want, ("K1 split", 48))


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


# K4, K5 and K7: (dtype, causal, head_dim, S, B). The first cases, f32 and
# bf16 at B2 S200; then the bf16 tensor-core kernels at every head_dim they
# are built for, at lengths that end inside a 64-row tile (1, 63, 65, 200,
# 1000) or fill 16 (1024).
_BWD_CASES = [(dt, causal, d, 200, 2) for dt in ("float32", "bfloat16")
              for causal in (True, False) for d in (32, 64)]
_BWD_CASES += [("bfloat16", causal, d, s, b) for causal in (True, False)
               for d in (32, 64, 128) for s in (1, 63, 65, 200, 1000, 1024)
               for b in (1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,d,s,b", _BWD_CASES)
def test_backward_kernels_match_plain(cuda, dtype, causal, d, s, b):
    """K4 (dQ), K5 (dK, dV) and the delta pre-pass, each against its plain
    version on the strided q/k/v views of a packed projection, and K7 (the
    same kernels on the packed strides) on the projection itself. Each
    gradient is held by the absolute bound, and in bf16 also on its own by
    chip_smoke.py's LIMITS; at S = 1 each query sees one key, so dS =
    dP - delta and with it dQ and dK are zero but for rounding, and only
    dV (= dO) is held by LIMITS there."""
    dtype, h = getattr(torch, dtype), 4
    qkv, do = _packed(cuda, dtype, b=b, s=s, h=h, d=d, seed=1)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    do4 = do.unflatten(-1, (h, d))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    counts = [f.launches for f in (flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)]
    delta = flash_bwd_delta(o, do4)
    dq = flash_bwd_dq(q, k, v, do4, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do4, lse, delta, causal=causal)
    assert [f.launches for f in (flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)] == [
        c + 1 for c in counts
    ]
    o6, lse6 = flash_attention_packed_fwd(qkv, h, causal=causal)
    before = flash_attention_packed_bwd.launches
    dqkv = flash_attention_packed_bwd(qkv, o6, do, lse6, h, causal=causal)
    assert flash_attention_packed_bwd.launches == before + 1
    kw = dict(causal=causal)
    _assert_close(delta, flash_bwd_delta_reference(o, do4), dtype)
    want = {"dq": flash_bwd_dq_reference(q, k, v, do4, lse, delta, **kw)}
    want.update(zip(("dk", "dv"), flash_bwd_dkv_reference(q, k, v, do4, lse, delta, **kw)))
    want7 = flash_attention_packed_bwd_reference(qkv, o6, do, lse6, h, **kw)
    torch.cuda.synchronize()
    got7 = dict(zip(("dq", "dk", "dv"), dqkv.split(h * d, dim=-1)))
    for kernel, got, ref in (
            ("K4/K5", {"dq": dq, "dk": dk, "dv": dv}, want),
            ("K7", got7, dict(zip(("dq", "dk", "dv"), want7.split(h * d, dim=-1))))):
        for name in ("dq", "dk", "dv"):
            _assert_close(got[name], ref[name], dtype)
            if dtype == torch.bfloat16 and (s > 1 or name == "dv"):
                _assert_limits(got[name], ref[name], (kernel, name))


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


# K3: (dtype, causal, head_dim, S, B). The first cases, f32 and bf16 at B2
# S200, S96 and S256; then the bf16 tensor-core kernel at every head_dim it
# is built for, at lengths that end inside a key tile of 64 (f32) or 128
# (bf16) keys (1, 63, 65, 200, 1000) or fill them (1024).
_K3_CASES = [(dt, causal, d, s, 2) for dt in ("float32", "bfloat16")
             for causal in (True, False) for s, d in ((200, 64), (96, 32), (256, 64))]
_K3_CASES += [("bfloat16", causal, d, s, b) for causal in (True, False)
              for d in (32, 64, 128) for s in (1, 63, 65, 200, 1000, 1024)
              for b in (1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,d,s,b", _K3_CASES)
def test_fused_backward_kernel_matches_plain(cuda, dtype, causal, d, s, b):
    """K3 (the one-pass backward, delta inside, dQ by fixed-order sums of
    the key tiles' partials) against its plain version on the strided q/k/v
    views of a packed projection. Each gradient is held by the absolute bound,
    and in bf16 also on its own by chip_smoke.py's LIMITS; at S = 1 dQ and
    dK are zero but for rounding, and only dV is held by LIMITS there."""
    dtype, h = getattr(torch, dtype), 4
    qkv, do = _packed(cuda, dtype, b=b, s=s, d=d, seed=4)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    do = do.unflatten(-1, (h, d))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    want = flash_attention_bwd_fused_reference(q, k, v, o, do, lse, causal=causal)
    before = flash_attention_bwd_fused.launches
    grads = flash_attention_bwd_fused(q, k, v, o, do, lse, causal=causal)
    assert flash_attention_bwd_fused.launches == before + 1
    torch.cuda.synchronize()
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.shape == w.shape and got.dtype == dtype
        _assert_close(got, w, dtype)
        if dtype == torch.bfloat16 and (s > 1 or name == "dv"):
            _assert_limits(got, w, ("K3", name))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_block_gradient_runs_k3_not_k4_k5(cuda, dtype):
    """`flash_attention`'s gradient at a one-block length (S = 200, default
    blocks) launches K3 once and neither K4, K5 nor the delta pre-pass, and
    equals the plain backward's: in f32 the plain two-kernel backward's, in
    bf16 the plain K3's (also by chip_smoke.py's LIMITS)."""
    qkv, do = _packed(cuda, dtype, seed=5)
    q, k, v = (t.unflatten(-1, (4, 64)).detach().clone().requires_grad_()
               for t in qkv.split(256, dim=-1))
    kernels = (flash_attention_bwd_fused, flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)
    counts = [f.launches for f in kernels]
    out = flash_attention(q, k, v, causal=True)
    out.backward(do.unflatten(-1, (4, 64)))
    assert [f.launches - c for f, c in zip(kernels, counts)] == [1, 0, 0, 0]
    if dtype == torch.float32:
        o, lse = flash_attention_reference(q, k, v, causal=True)
        grads = flash_attention_bwd_reference(
            q, k, v, o, do.unflatten(-1, (4, 64)), lse, causal=True
        )
    else:
        qkv3 = [t.detach() for t in (q, k, v)]
        o, lse = flash_attention_fwd(*qkv3, causal=True)
        grads = flash_attention_bwd_fused_reference(
            *qkv3, o, do.unflatten(-1, (4, 64)), lse, causal=True
        )
    for name, t, g in zip(("dq", "dk", "dv"), (q, k, v), grads):
        _assert_close(t.grad, g, dtype)
        if dtype == torch.bfloat16:
            _assert_limits(t.grad, g, ("K3", name))


def _assert_limits(got, want, what, per_row=False):
    """chip_smoke.py's check of a kernel output against its plain version:
    relative L2 and per-element rounding steps plus a floor of the RMS, by
    the output's dtype (LIMITS); with `per_row`, each row's own scale too."""
    out = chip_smoke.compare(got, want, per_row)
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_is_the_same_bit_for_bit_twice(cuda, dtype, causal, d):
    """K3 run twice on the same inputs gives dq, dk and dv bit for bit: the
    key tiles' partial dQ sums are added in a fixed order, not by atomics.
    B2 S1000 H4 (a partial last key tile)."""
    qkv, do = _packed(cuda, dtype, b=2, s=1000, d=d, seed=6)
    q, k, v = (t.unflatten(-1, (4, d)) for t in qkv.split(4 * d, dim=-1))
    do = do.unflatten(-1, (4, d))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    first = flash_attention_bwd_fused(q, k, v, o, do, lse, causal=causal)
    second = flash_attention_bwd_fused(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_fused_backward_refuses_head_dims_it_was_not_built_for(cuda):
    """bf16 head_dim 48 (16-byte rows, but no tensor-core instantiation) is
    refused by K3's wrapper before anything launches; f32 at head_dim 48
    runs on the CUDA-core kernel and matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn(2, 70, 3 * 2 * 48, generator=g, device=cuda)
    do = torch.randn(2, 70, 2, 48, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.unflatten(-1, (2, 48)) for t in qkv.to(dtype).split(96, dim=-1))
        o, lse = flash_attention_reference(q, k, v, causal=True)
        args = (q, k, v, o, do.to(dtype), lse.contiguous())
        before = flash_attention_bwd_fused.launches
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match=r"head_dim 48.*\(32, 64, 128\)"):
                flash_attention_bwd_fused(*args, causal=True)
            assert flash_attention_bwd_fused.launches == before
        else:
            got = flash_attention_bwd_fused(*args, causal=True)
            want = flash_attention_bwd_fused_reference(*args, causal=True)
            torch.cuda.synchronize()
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                _assert_limits(a, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_kernels_are_the_same_bit_for_bit_twice(cuda, d, causal):
    """The bf16 dQ and dK/dV kernels (K4, K5, and K7 on the packed strides)
    run twice on the same inputs give dq, dk and dv bit for bit: their
    outputs are disjoint, so no atomics. B2 S1000 H4 (a partial last
    tile)."""
    qkv, do = _packed(cuda, torch.bfloat16, b=2, s=1000, d=d, seed=8)
    q, k, v = (t.unflatten(-1, (4, d)) for t in qkv.split(4 * d, dim=-1))
    do4 = do.unflatten(-1, (4, d))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    o6, lse6 = flash_attention_packed_fwd(qkv, 4, causal=causal)
    runs = [(flash_attention_bwd(q, k, v, o, do4, lse, causal=causal),
             flash_attention_packed_bwd(qkv, o6, do, lse6, 4, causal=causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    (grads, dqkv), (grads2, dqkv2) = runs
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)
    assert torch.equal(dqkv, dqkv2)


@pytest.mark.cuda
def test_bf16_backward_refuses_head_dims_it_was_not_built_for(cuda):
    """bf16 head_dim 48 (16-byte rows, but no tensor-core instantiation) is
    refused by every backward entry (K4, K5, their pair, K7), naming the
    head_dims they take, before anything launches; f32 at the same
    head_dim runs on the CUDA-core kernels and matches the plain
    backward."""
    g = torch.Generator(device=cuda).manual_seed(10)
    qkv = torch.randn(2, 70, 3 * 2 * 48, generator=g, device=cuda)
    do = torch.randn(2, 70, 2 * 48, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x, dx = qkv.to(dtype), do.to(dtype)
        q, k, v = (t.unflatten(-1, (2, 48)) for t in x.split(96, dim=-1))
        do4 = dx.unflatten(-1, (2, 48))
        # The plain forward: the bf16 forward kernel refuses head_dim 48 too.
        o, lse = flash_attention_reference(q, k, v, causal=True)
        lse = lse.contiguous()
        delta = flash_bwd_delta_reference(o, do4)
        calls = {
            "K4": lambda: flash_bwd_dq(q, k, v, do4, lse, delta, causal=True),
            "K5": lambda: flash_bwd_dkv(q, k, v, do4, lse, delta, causal=True),
            "K4 + K5": lambda: flash_attention_bwd(q, k, v, o, do4, lse, causal=True),
            "K7": lambda: flash_attention_packed_bwd(
                x, o.reshape(2, 70, 96), dx, lse, 2, causal=True),
        }
        if dtype == torch.bfloat16:
            counts = [f.launches for f in (flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)]
            for name, call in calls.items():
                with pytest.raises(ValueError, match=r"head_dim 48.*\(32, 64, 128\)"):
                    call()
            assert counts == [f.launches for f in (flash_bwd_delta, flash_bwd_dq,
                                                   flash_bwd_dkv)]
        else:
            got = calls["K4 + K5"]()
            want = flash_attention_bwd_reference(q, k, v, o, do4, lse, causal=True)
            torch.cuda.synchronize()
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                _assert_limits(a, w, name)


def _bhsd(device, s, d=64, bh=6, seed=0, head_scales=None):
    g = torch.Generator(device=device).manual_seed(seed)
    out = [torch.randn(bh, s, d, generator=g, device=device) for _ in range(3)]
    if head_scales is not None:
        scale = torch.tensor(head_scales, device=device)[:, None, None]
        out = [t * scale for t in out]
    return [t.to(torch.bfloat16) for t in out]


# K8's and K10's lengths: 64 and 192 end in a partial 128-key tile (and a
# half block of query rows); 1024 is the profiling shape; 2048 sweeps 16
# key tiles through the two-stage ring.
_PROFILE_S = [64, 128, 192, 1024, 2048]
_DISSECT_VARIANTS = [
    (0, False), (1, False), (2, False), (3, False), (4, False), (3, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", _PROFILE_S)
@pytest.mark.parametrize("level,two_heads", _DISSECT_VARIANTS)
@pytest.mark.parametrize("bh", [6, 3])
def test_dissect_kernel_matches_plain(cuda, s, level, two_heads, d, bh):
    """K8 at every level and the two-head variant against its plain version
    by chip_smoke's LIMITS (relative to the output's RMS, which reaches
    ~1e31 at levels 1-2; there each row is also held to its own RMS, so
    the rows with no masked key, ~1e2, are checked too). An odd BH is
    taken by the single-head levels; the two-head variant refuses it."""
    q, k, v = _bhsd(cuda, s, d=d, bh=bh, seed=level)
    if two_heads and bh % 2:
        with pytest.raises(ValueError, match="even BH"):
            ap.attn_dissect(q, k, v, level, two_heads=True)
        return
    before = ap.attn_dissect.launches
    got = ap.attn_dissect(q, k, v, level, two_heads=two_heads)
    assert ap.attn_dissect.launches == before + 1
    want = ap.attn_dissect_reference(q, k, v, level, two_heads=two_heads)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _assert_limits(got, want, ("K8", level, two_heads, d, s, bh),
                   per_row=level in (1, 2) and not two_heads)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_dissect_level4_pad_keys_stay_out_of_each_row(cuda, d):
    """Level 4 at S192: the last 128-key tile is half past S, and TMA fills
    those keys with zeros. A zero score is not a masked one: had exp(0 - m)
    entered a row's sum, that row's O would shrink. Every row is held to
    its own RMS against the plain version."""
    q, k, v = _bhsd(cuda, 192, d=d, bh=5, seed=40 + d)
    got = ap.attn_dissect(q, k, v, 4)
    want = ap.attn_dissect_reference(q, k, v, 4)
    torch.cuda.synchronize()
    _assert_limits(got, want, ("K8", 4, d), per_row=True)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 4])
def test_dissect_reads_only_its_own_head(cuda, level):
    """Levels 0 and 4 at S192 with three heads whose inputs differ in scale
    (x1, x4, x16), each row held to its own RMS: a key tile running past
    S into the next head's rows (a 2-D [BH*S, D] tensor map would) puts
    keys of another scale into a row, which shows in O."""
    q, k, v = _bhsd(cuda, 192, bh=3, seed=50 + level, head_scales=[1.0, 4.0, 16.0])
    got = ap.attn_dissect(q, k, v, level)
    want = ap.attn_dissect_reference(q, k, v, level)
    torch.cuda.synchronize()
    _assert_limits(got, want, ("K8", level, "scaled heads"), per_row=True)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [192, 1024])
def test_profiling_wgmma_kernels_repeat_bit_for_bit(cuda, s):
    """K8 (every level, two heads) and K10 (every T whose chunks are whole
    64-row tiles) give the same bits twice on the same inputs: each output
    element is summed in one fixed order."""
    q, k, v = _bhsd(cuda, s, seed=60)
    for level, two_heads in _DISSECT_VARIANTS:
        first = ap.attn_dissect(q, k, v, level, two_heads=two_heads)
        assert torch.equal(first, ap.attn_dissect(q, k, v, level, two_heads=two_heads)), (
            level, two_heads)
    for T in (1, 2, 3, 4, 8):
        if s % T or (s // T) % 64:
            continue
        first = ap.attn_subtile(q, k, v, T)
        again = ap.attn_subtile(q, k, v, T)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), T


@pytest.mark.cuda
@pytest.mark.parametrize("s", [128, 1024])
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (64, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("d", [32, 64])
def test_slim_kernel_matches_plain(cuda, s, block_q, block_k, d):
    """K9 at every tile against its plain version with block_k = the
    kernel's key tile: O and lse by LIMITS."""
    q, k, v = _bhsd(cuda, s, d=d, seed=block_q + block_k)
    o, lse = ap.flash_fwd_slim(q, k, v, block_q=block_q, block_k=block_k)
    want_o, want_lse = ap.flash_fwd_slim_reference(q, k, v, block_k=block_k)
    torch.cuda.synchronize()
    _assert_limits(o, want_o, ("K9", "o"))
    _assert_limits(lse, want_lse, ("K9", "lse"))


@pytest.mark.cuda
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (64, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("d", [32, 64])
def test_slim_kernel_head_group_tail_repeats_bit_for_bit(cuda, block_q, block_k, d):
    """K9 with BH = 19: one group of 16 heads and a tail of 3 (block_tile
    takes the heads 16 at a time). Every tile and both D, held to LIMITS
    against the plain version and the same bit for bit on a second run."""
    q, k, v = _bhsd(cuda, 256, d=d, bh=19, seed=70 + d)
    o, lse = ap.flash_fwd_slim(q, k, v, block_q=block_q, block_k=block_k)
    o2, lse2 = ap.flash_fwd_slim(q, k, v, block_q=block_q, block_k=block_k)
    want_o, want_lse = ap.flash_fwd_slim_reference(q, k, v, block_k=block_k)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _assert_limits(o, want_o, ("K9", "o", block_q, block_k, d))
    _assert_limits(lse, want_lse, ("K9", "lse", block_q, block_k, d))


@pytest.mark.cuda
def test_slim_prescale_is_the_plain_prescale(cuda):
    """K9's wrapper prescales q in one pass (bf16 times the scale); on the
    card that gives the bits of the plain versions' `_prescale` (f32
    product, one rounding)."""
    from ray_tpu_torch.ops.flash_attention import _prescale

    q = _bhsd(cuda, 1024)[0] * 3
    for scale in (0.125, 64 ** -0.5, 32 ** -0.5, 0.3):
        assert torch.equal(q * scale, _prescale(q, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", _PROFILE_S)
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("bh", [6, 3])
def test_subtile_kernel_matches_plain(cuda, s, T, d, bh):
    """K10 at every T against its plain version: O and lse by LIMITS. T
    must cut S into chunks of whole 64-row tiles (at S192 only T = 1 and
    3, at S128 T = 1 and 2, at S64 T = 1); the others are refused."""
    q, k, v = _bhsd(cuda, s, d=d, bh=bh, seed=T)
    if s % T or (s // T) % 64:
        with pytest.raises(ValueError, match="whole 64-row tiles"):
            ap.attn_subtile(q, k, v, T)
        return
    o, lse = ap.attn_subtile(q, k, v, T)
    want_o, want_lse = ap.attn_subtile_reference(q, k, v, T)
    torch.cuda.synchronize()
    _assert_limits(o, want_o, ("K10", "o", T, d, s, bh))
    _assert_limits(lse, want_lse, ("K10", "lse", T, d, s, bh))


@pytest.mark.cuda
def test_profiling_kernels_refuse_what_they_cannot_take(cuda):
    """Each wrapper raises on a CUDA tensor its kernel cannot take: f32, a
    head_dim outside {32, 64}, an S its tiles do not divide, inputs that
    require grad; nothing falls back to the plain version."""
    calls = {
        "K8": lambda q, k, v: ap.attn_dissect(q, k, v, 4),
        "K9": lambda q, k, v: ap.flash_fwd_slim(q, k, v, block_q=128),
        "K10": lambda q, k, v: ap.attn_subtile(q, k, v, 2),
    }
    counts = (ap.attn_dissect.launches, ap.flash_fwd_slim.launches,
              ap.attn_subtile.launches)
    for name, call in calls.items():
        q, k, v = _bhsd(cuda, 128)
        with pytest.raises(ValueError, match="bf16"):
            call(q.float(), k.float(), v.float())
        with pytest.raises(ValueError, match="head_dim 128"):
            call(*_bhsd(cuda, 128, d=128))
        with pytest.raises(ValueError, match="not a multiple"):
            call(*_bhsd(cuda, 96))
        with pytest.raises(RuntimeError, match="autograd"):
            call(q.requires_grad_(), k, v)
    assert counts == (ap.attn_dissect.launches, ap.flash_fwd_slim.launches,
                      ap.attn_subtile.launches)
    with pytest.raises(ValueError, match="even BH"):
        ap.attn_dissect(*_bhsd(cuda, 128, bh=3), 3, two_heads=True)


@pytest.mark.cuda
def test_slim_attention_gradient_matches_flash(cuda):
    """`slim_attention` (K9 forward, K4 + K5 backward) against
    `flash_attention` (K2, K3) at B2 S256 H4 D64 bf16: O and gradients
    within the bf16 tolerance (the two forwards round P at other tile
    edges)."""
    qkv, do = _packed(cuda, torch.bfloat16, b=2, s=256, seed=7)
    outs = []
    for fn in (lambda a, b, c: ap.slim_attention(a, b, c, block_q=128, block_k=64),
               lambda a, b, c: flash_attention(a, b, c, causal=True)):
        x = [t.unflatten(-1, (4, 64)).detach().clone().requires_grad_()
             for t in qkv.split(256, dim=-1)]
        o = fn(*x)
        o.backward(do.unflatten(-1, (4, 64)))
        outs.append([o.detach()] + [t.grad for t in x])
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        _assert_close(got, want, torch.bfloat16)


# ---------------------------------------------------------------- serving modes


def _tiny_gpt(dtype):
    from ray_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=256, num_layers=2, num_heads=4, embed_dim=256,
                     max_seq_len=256, dtype=dtype)


_MODES_ECFG = dict(block_size=16, num_blocks=128, max_decode_slots=4,
                   max_blocks_per_seq=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_takes_both_k1_routes_and_matches_plain(cuda, dtype):
    """GPTRunner.verify at fed widths 5 (split kernel + merge) and 9 (the
    suffix kernel: tensor cores in bf16, CUDA cores in f32) against the
    same runner's plain attention: the argmax on every fed lane (f32
    identical; bf16 on >= 95% of lanes, near-ties may flip) and the route
    counters of both sides of SPLIT_MAX_S."""
    from ray_tpu_torch.llm import EngineConfig, GPTRunner

    kern = GPTRunner(_tiny_gpt(dtype), EngineConfig(**_MODES_ECFG, attn_impl="cuda"),
                     device=cuda)
    plain = GPTRunner(_tiny_gpt(dtype), EngineConfig(**_MODES_ECFG, attn_impl="reference"),
                      params=kern.model.state_dict(), device=cuda)
    rng = np.random.RandomState(3)
    # Slots 0, 1 and 3 hold 40, 17 and 70 cached tokens (tables with room
    # for 9 more); slot 2 is idle (its lanes go to the null block).
    prompts = {0: list(rng.randint(0, 256, 40)), 1: list(rng.randint(0, 256, 17)),
               3: list(rng.randint(0, 256, 70))}
    blocks = {0: [1, 2, 3, 4], 1: [5, 6, 7], 3: [8, 9, 10, 11, 12, 13]}
    tables = np.zeros((4, 16), np.int32)
    lens = np.zeros(4, np.int32)
    for i, p in prompts.items():
        tables[i, : len(blocks[i])] = blocks[i]
        lens[i] = len(p)
        for r in (kern, plain):
            r.prefill(p, blocks[i][: -(-len(p) // 16)])
    fed_sets = {5: (5, 2, 0, 5), 9: (9, 3, 0, 9)}
    routes = paged_flash_attention.routes
    for width, fed in fed_sets.items():
        tokens = rng.randint(0, 256, size=(4, width)).astype(np.int32)
        true_lens = np.array(fed, np.int32)
        before = dict(routes)
        got = kern.verify(tokens, tables, lens, true_lens)
        delta = {k: routes[k] - before[k] for k in routes}
        want = plain.verify(tokens, tables, lens, true_lens)
        lanes = [(i, j) for i, n in enumerate(fed) for j in range(n)]
        agree = np.mean([got[i, j] == want[i, j] for i, j in lanes])
        if dtype == torch.float32:
            assert agree == 1.0
        else:
            assert agree >= 0.95, agree
        if width <= 8:
            assert delta["split"] == 2 and delta["split"] == sum(delta.values())
        else:
            route = "suffix_mma" if dtype == torch.bfloat16 else "suffix_f32"
            assert delta[route] == 2 and delta[route] == sum(delta.values())


@pytest.mark.cuda
def test_decode_async_chains_without_a_sync_and_matches_decode(cuda):
    """decode_async on the card: enqueued with the card parked (its step
    still pending when it returns) under the sync debug mode "error";
    fresh and chained dispatches give decode's tokens."""
    from ray_tpu_torch.llm import EngineConfig, GPTRunner

    runner = GPTRunner(_tiny_gpt(torch.float32), EngineConfig(**_MODES_ECFG), device=cuda)
    tokens = np.array([3, 14, 15, 92], np.int32)
    pos = np.zeros(4, np.int32)
    tables = np.zeros((4, 16), np.int32)
    want = runner.decode(tokens, pos, tables, pos)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = runner.decode_async(tokens, pos, tables, pos)
        second = runner.decode_async(first, pos, tables, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert first.pending() and second.pending()
    got = first.fetch()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(second.fetch(), runner.decode(got, pos, tables, pos))


@pytest.mark.cuda
def test_serving_modes_token_identical_on_card(cuda):
    """f32 on the kernels: async, ngram k = 4, a draft with the target's
    weights at k = 8 (every proposal accepted) and async + ngram give the
    sync engine's tokens."""
    import dataclasses

    from ray_tpu_torch.llm import EngineConfig, LLMEngine

    cfg = _tiny_gpt(torch.float32)
    base = EngineConfig(**_MODES_ECFG)
    ref = LLMEngine(cfg, base, device=cuda)
    weights = ref.runner.model.state_dict()
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(0, 256, n)) for n in (9, 33, 20)]
    prompts.append((list(rng.randint(0, 256, 5)) * 6)[:28])
    want = ref.generate(prompts, max_new_tokens=24)
    for extra in (dict(async_scheduling=True), dict(speculation="ngram"),
                  dict(speculation="draft", num_speculative_tokens=8,
                       draft_model_config=cfg),
                  dict(async_scheduling=True, speculation="ngram")):
        eng = LLMEngine(cfg, dataclasses.replace(base, **extra), params=weights,
                        device=cuda,
                        draft_params=weights if "draft_model_config" in extra else None)
        assert eng.generate(prompts, max_new_tokens=24) == want, extra
        stats = eng.stats()
        if "draft_model_config" in extra:
            assert stats["spec_accepted_tokens"] == stats["spec_proposed_tokens"] > 0
        assert stats["inflight_steps"] == 0 and eng.allocator.num_allocated == 0
