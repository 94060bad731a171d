"""Flash attention forward: a hand-written CUDA kernel (``csrc/flash_fwd.cu``).

Blockwise causal online-softmax attention. One thread block owns a tile
of query rows of one (batch, head); it walks the key tiles up to the causal
diagonal, keeps the running max / sum / accumulator in f32, and writes O
and the per-row logsumexp. No S×S logits ever reach device memory. The
kernel reads q/k/v [B, S, H, D] through their strides, so the head split of
the packed qkv projection costs no transpose.

Inference only in this slice: the backward kernels (ROADMAP kernels B3/B4)
and the `autograd.Function` arrive with the training slice, so an input
that requires grad is refused rather than silently detached.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.attention import NEG_INF, mha_reference

_ARGTYPES = {
    "flash_fwd_launch": [ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 9
    + [ctypes.c_int, ctypes.c_void_p],
}

# Key-tile width of the plain blockwise version (any width gives the same
# result up to f32 summation order).
_REF_BLOCK_K = 128


def _prescale(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Scale q once in its storage dtype (the kernel path's order)."""
    return (q.float() * sm_scale).to(q.dtype)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain blockwise version of the kernel: same prescaling, same
    online-softmax recurrence over key tiles in f32. q,k,v [B, S, H, D] →
    (O [B, S, H, D] in q's dtype, lse [B*H, S] f32)."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = _prescale(q, sm_scale).float().permute(0, 2, 1, 3)  # [B, H, Sq, D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, s_q, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_q, 1), device=q.device)
    acc = torch.zeros((b, h, s_q, d), device=q.device)
    q_ids = torch.arange(s_q, device=q.device)[:, None]
    for k0 in range(0, s_k, _REF_BLOCK_K):
        k1 = min(k0 + _REF_BLOCK_K, s_k)
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)  # [B, H, Sq, bk]
        if causal:
            valid = q_ids >= torch.arange(k0, k1, device=q.device)[None, :]
        else:
            valid = torch.ones((s_q, k1 - k0), dtype=torch.bool, device=q.device)
        s = s.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # Masked keys contribute exact zeros: a row whose keys are all
        # masked in this tile would otherwise see exp(NEG_INF - NEG_INF) = 1.
        p = torch.exp(s - m_new) * valid
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vf[:, :, k0:k1]
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(safe)).reshape(b * h, s_q)
    return out, lse


def _check_kernel_inputs(q, k, v) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}: "
                "the kernel takes self-attention of equal lengths"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {q.dtype}: the kernel takes f32 or bf16")
    d = q.shape[-1]
    if d > 128:
        raise ValueError(f"head_dim {d} > 128 is not supported")
    # The kernel stages K/V rows in 16-byte units through the strides.
    if (d * q.element_size()) % 16:
        raise ValueError(
            f"rows of head_dim {d} x {q.element_size()} bytes are not a "
            "multiple of 16 bytes, which the kernel's loads need"
        )
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(
            (st * t.element_size()) % 16 for st in t.stride()[:3]
        ):
            raise ValueError(f"{name} rows must start 16-byte aligned")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (O [B, S, H, D], lse [B*H, S] f32). q is prescaled
    by sm_scale in its storage dtype before the launch. CUDA tensors launch
    the kernel (or raise); CPU tensors run `flash_attention_reference`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.requires_grad:
            raise NotImplementedError(
                f"flash_attention: {name} requires grad, but the backward "
                "kernels are not ported yet (ROADMAP kernels B3/B4); run "
                "under torch.no_grad() or use impl='reference'"
            )
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, sm_scale=sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_kernel_inputs(q, k, v)
    b, s, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q = _prescale(q, sm_scale)  # contiguous [B, S, H, D]
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if b * s == 0:
        return out, lse
    lib = _kernels.library("flash_fwd", _ARGTYPES)
    err = lib.flash_fwd_launch(
        _kernels.dtype_code(q.dtype),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention. q,k,v: [B, S, H, D] → [B, S, H, D] (the output of
    `flash_attention_fwd`; its lse is kept for the training slice)."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatcher: the flash kernel on CUDA, the reference on the CPU
    (impl='auto'); 'flash' forces the kernel wrapper, 'reference' the
    full-matrix op."""
    if impl == "reference" or (impl == "auto" and q.device.type == "cpu"):
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"Unknown attention impl {impl!r}")
