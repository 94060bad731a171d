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

from ray_tpu_torch.ops import (
    flash_attention_fwd,
    flash_attention_reference,
    paged_attention,
    paged_flash_attention,
    quantize_kv,
)

# f32: the kernel and the plain version differ in summation order only.
# bf16: the kernel keeps P in f32, the plain version rounds it to bf16.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
