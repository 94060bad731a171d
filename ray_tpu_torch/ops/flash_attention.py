"""Flash attention: hand-written CUDA kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``), their plain PyTorch versions, and the autograd
functions that join them.

Forward (K2, and K6 on a packed qkv): one thread block owns a tile of query
rows of one (batch, head), walks the key tiles up to the causal diagonal,
keeps the running max / sum / accumulator in f32, and writes O and the
per-row logsumexp. q is prescaled by sm_scale inside the kernel, rounded to
its storage type as the reference rounds it, and P is rounded to v's type
before P·V, as the reference rounds it. bf16 runs both products on the
tensor cores (head_dim 32, 64 or 128); f32 keeps f32 math on the CUDA
cores.

Backward (K4, K5, and K7 on a packed qkv): a pre-pass writes
delta = rowsum(dO * O); one kernel accumulates dQ over the key tiles, the
other dK and dV over the query tiles, each recomputing P from the saved
logsumexp. When one block covers the whole sequence (the reference's rule,
`_pick_block`), `flash_attention`'s gradient is the one-pass backward K3
(``csrc/flash_bwd_fused.cu``) instead: one recompute of P per pair feeds
dQ, dK and dV, delta is computed inside it, and dQ is summed over the key
tiles with atomics. No S x S matrix reaches device memory in either
direction.

Every kernel reads its operands through (batch, seq, head) strides, so the
head split of the packed qkv projection costs no transpose, and the packed
backward writes dq, dk and dv straight into one dqkv [B, S, 3E]. The
residuals are saved in the kernels' layout: the strided q/k/v views (or the
packed qkv), O and lse.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.attention import NEG_INF, mha_reference

_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGTYPES = {
    "flash_fwd_launch": [ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_fwd_packed_launch": [ctypes.c_int]
    + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_GRAD_ARGTYPES = (
    [ctypes.c_int]
    + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 4
    + [_STRIDES, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_BWD_ARGTYPES = {
    "flash_bwd_delta_launch": [ctypes.c_int]
    + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 4
    + [_STRIDES, ctypes.c_void_p],
    "flash_bwd_dq_launch": _GRAD_ARGTYPES,
    "flash_bwd_dkv_launch": _GRAD_ARGTYPES,
}
_FUSED_ARGTYPES = {
    "flash_bwd_fused_launch": [ctypes.c_int]
    + [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 4
    + [_STRIDES, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}

# Key-tile width of the plain blockwise versions (any width gives the same
# result up to f32 summation order).
_REF_BLOCK_K = 128


def _scale(sm_scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else sm_scale


def _pick_block(s: int) -> int:
    """The reference's default block: the largest power-of-two block <= 1024
    that divides the sequence length, else the length itself."""
    for block in (1024, 512, 256, 128):
        if s % block == 0:
            return block
    return s


def _prescale(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Scale q once in its storage dtype (the kernels' order)."""
    return (q.float() * sm_scale).to(q.dtype)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> f32 [B, H, S, D]."""
    return t.float().permute(0, 2, 1, 3)


def _causal_mask(s_q: int, k0: int, k1: int, device) -> torch.Tensor:
    return (
        torch.arange(s_q, device=device)[:, None]
        >= torch.arange(k0, k1, device=device)[None, :]
    )


# ---------------------------------------------------------------- plain


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain blockwise version of the forward kernel: same prescaling, same
    online-softmax recurrence over key tiles in f32, and P rounded to v's
    dtype before P·V where the reference's `_fwd_kernel` rounds it (exact
    in f32); l sums the unrounded P. q,k,v [B, S, H, D] → (O [B, S, H, D]
    in q's dtype, lse [B*H, S] f32)."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    qf = _heads_first(_prescale(q, _scale(sm_scale, d)))  # [B, H, Sq, D]
    kf, vf = _heads_first(k), _heads_first(v)
    m = torch.full((b, h, s_q, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_q, 1), device=q.device)
    acc = torch.zeros((b, h, s_q, d), device=q.device)
    for k0 in range(0, s_k, _REF_BLOCK_K):
        k1 = min(k0 + _REF_BLOCK_K, s_k)
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)  # [B, H, Sq, bk]
        if causal:
            valid = _causal_mask(s_q, k0, k1, q.device)
        else:
            valid = torch.ones((s_q, k1 - k0), dtype=torch.bool, device=q.device)
        s = s.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # Masked keys contribute exact zeros: a row whose keys are all
        # masked in this tile would otherwise see exp(NEG_INF - NEG_INF) = 1.
        p = torch.exp(s - m_new) * valid
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, k0:k1]
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(safe)).reshape(b * h, s_q)
    return out, lse


def flash_bwd_delta_reference(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32: [B, S, H, D] pair → [B*H, S]."""
    b, s, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)


def _bwd_tiles(q, k, v, do, lse, delta, causal, sm_scale):
    """The plain backward's shared part: for every key tile [k0, k1), P and
    dS of all queries against it, rounded to the input dtype as the
    reference rounds them before its products (exact in f32). Yields
    (k0, k1, p, ds) with the prescaled q, K and dO alongside as f32
    [B, H, S, D]."""
    b, s, h, d = q.shape
    qs = _heads_first(_prescale(q, _scale(sm_scale, d)))
    kf, vf, dof = _heads_first(k), _heads_first(v), _heads_first(do)
    lse = lse.reshape(b, h, s, 1)
    delta = delta.reshape(b, h, s, 1)
    for k0 in range(0, s, _REF_BLOCK_K):
        k1 = min(k0 + _REF_BLOCK_K, s)
        scores = qs @ kf[:, :, k0:k1].transpose(-1, -2)
        p = torch.exp(scores - lse)
        if causal:
            # Masked pairs get exactly zero, not exp(NEG_INF - lse).
            p = torch.where(_causal_mask(s, k0, k1, q.device), p, 0.0)
        dp = dof @ vf[:, :, k0:k1].transpose(-1, -2)
        ds = p * (dp - delta)
        yield k0, k1, p.to(q.dtype).float(), ds.to(q.dtype).float(), qs, kf, dof


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal=False, sm_scale=None):
    """Plain version of the dQ kernel (K4): dQ = sm_scale * dS K, summed over
    key tiles. [B, S, H, D] in, q's dtype out."""
    dq = None
    for k0, k1, _, ds, _, kf, _ in _bwd_tiles(q, k, v, do, lse, delta, causal, sm_scale):
        part = ds @ kf[:, :, k0:k1]
        dq = part if dq is None else dq + part
    dq = dq * _scale(sm_scale, q.shape[-1])
    return dq.permute(0, 2, 1, 3).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal=False, sm_scale=None):
    """Plain version of the dK/dV kernel (K5): per key tile, dK = dSᵀ q_scaled
    (which carries sm_scale) and dV = Pᵀ dO. Returns (dk, dv) [B, S, H, D]."""
    b, s, h, d = k.shape
    dk = torch.empty((b, h, s, d), device=k.device)
    dv = torch.empty((b, h, s, d), device=k.device)
    for k0, k1, p, ds, qs, _, dof in _bwd_tiles(q, k, v, do, lse, delta, causal, sm_scale):
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qs
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ dof
    return dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def flash_attention_bwd_reference(
    q, k, v, o, do, lse, *, causal: bool = False, sm_scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain blockwise backward: (dq, dk, dv) [B, S, H, D] from the forward's
    O and lse [B*H, S], never forming the S x S matrix at once."""
    delta = flash_bwd_delta_reference(o, do)
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def flash_attention_bwd_fused_reference(
    q, k, v, o, do, lse, *, causal: bool = False, sm_scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the one-pass backward (K3), the reference's
    `_bwd_fused_kernel` step by step over the whole [S, S] score matrix:
    P rounded to dO's type before dV = Pᵀ dO, delta = rowsum(dO · O) in f32,
    dS = P ∘ (dP − delta) rounded to q's type before dK = dSᵀ q_scaled and
    dQ = sm_scale · dS K. (dq, dk, dv) [B, S, H, D] in the inputs' dtype."""
    b, s, h, d = q.shape
    scale = _scale(sm_scale, d)
    qs = _heads_first(_prescale(q, scale))
    kf, vf, dof = _heads_first(k), _heads_first(v), _heads_first(do)
    scores = qs @ kf.transpose(-1, -2)
    p = torch.exp(scores - lse.reshape(b, h, s, 1))
    if causal:
        p = torch.where(_causal_mask(s, 0, s, q.device), p, 0.0)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * _heads_first(o)).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dk = ds.transpose(-1, -2) @ qs
    dq = (ds @ kf) * scale
    unfold = lambda t, like: t.permute(0, 2, 1, 3).to(like.dtype)
    return unfold(dq, q), unfold(dk, k), unfold(dv, v)


def _packed_views(qkv: torch.Tensor, num_heads: int):
    """q, k, v [B, S, H, D] views of a packed [B, S, 3E] projection."""
    b, s, three_e = qkv.shape
    if three_e % (3 * num_heads):
        raise ValueError(f"qkv last dim {three_e} not divisible by 3*heads")
    d = three_e // (3 * num_heads)
    return [t.unflatten(-1, (num_heads, d)) for t in qkv.split(three_e // 3, dim=-1)]


def flash_attention_packed_reference(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed forward (K6): qkv [B, S, 3E] →
    (O [B, S, E], lse [B, H, S] f32)."""
    q, k, v = _packed_views(qkv, num_heads)
    b, s, h, d = q.shape
    o, lse = flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return o.reshape(b, s, h * d), lse.view(b, h, s)


def flash_attention_packed_bwd_reference(
    qkv, o, do, lse, num_heads: int, *, causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the packed backward (K7): dqkv [B, S, 3E] from qkv,
    O and dO [B, S, E] and lse [B, H, S]."""
    q, k, v = _packed_views(qkv, num_heads)
    b, s, h, d = q.shape
    grads = flash_attention_bwd_reference(
        q, k, v, o.reshape(b, s, h, d), do.reshape(b, s, h, d),
        lse.reshape(b * h, s), causal=causal, sm_scale=sm_scale,
    )
    return torch.cat([g.reshape(b, s, h * d) for g in grads], dim=-1)


# ---------------------------------------------------------------- kernels


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {t.device}")
    return False


def _refuse_graph(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper records no autograd graph: an input that requires
    grad under grad mode is refused, never silently detached."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a kernel wrapper and records no autograd graph; "
            "call flash_attention / flash_attention_packed for gradients"
        )


def _check_kernel_inputs(q: torch.Tensor, **others: torch.Tensor) -> None:
    """Device, dtype, shape and layout of [B, S, H, D] kernel operands."""
    for name, t in others.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}: "
                "the kernels take self-attention of equal lengths"
            )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {q.dtype}: the kernels take f32 or bf16")
    d = q.shape[-1]
    if d > 128:
        raise ValueError(f"head_dim {d} > 128 is not supported")
    # The kernels stage rows in 16-byte units through the strides.
    if (d * q.element_size()) % 16:
        raise ValueError(
            f"rows of head_dim {d} x {q.element_size()} bytes are not a "
            "multiple of 16 bytes, which the kernels' loads need"
        )
    for name, t in (("q", q), *others.items()):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if t.data_ptr() % 16 or any(
            (st * t.element_size()) % 16 for st in t.stride()[:3]
        ):
            raise ValueError(f"{name} rows must start 16-byte aligned")


# head_dims the bf16 forward (tensor cores) is instantiated for.
_MMA_HEAD_DIMS = (32, 64, 128)


def _check_fwd_head_dim(q: torch.Tensor) -> None:
    """The bf16 forward kernel is compiled per head_dim; another bf16
    head_dim is refused, never sent to the f32 kernel."""
    d = q.shape[-1]
    if q.dtype == torch.bfloat16 and d not in _MMA_HEAD_DIMS:
        raise ValueError(
            f"bf16 head_dim {d}: the forward kernel takes head_dim in "
            f"{_MMA_HEAD_DIMS} in bf16"
        )


def _check_rows(name: str, t: torch.Tensor, b: int, h: int, s: int) -> None:
    """lse / delta: contiguous f32 [B*H, S] (or [B, H, S])."""
    if t.dtype != torch.float32 or t.numel() != b * h * s or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous f32 with B*H*S = {b * h * s} elements")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _strides(*views: Optional[torch.Tensor]):
    """(batch, seq, head) element strides of each [B, S, H, D] view (zeros
    for an operand the entry does not use), as a C array."""
    vals = [st for t in views for st in (t.stride()[:3] if t is not None else (0, 0, 0))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel wrapper (K2): (O [B, S, H, D], lse [B*H, S] f32) from
    q, k, v [B, S, H, D] read through their strides; q is prescaled in the
    kernel. CUDA tensors launch the kernel (or raise); CPU tensors run
    `flash_attention_reference`."""
    _refuse_graph("flash_attention_fwd", q, k, v)
    if _on_cpu(q):
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    _check_kernel_inputs(q, k=k, v=v)
    _check_fwd_head_dim(q)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if b * s == 0:
        return out, lse
    lib = _kernels.library("flash_fwd", _FWD_ARGTYPES)
    err = lib.flash_fwd_launch(
        _kernels.dtype_code(q.dtype),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _scale(sm_scale, d), int(causal), _stream(q),
    )
    _kernels.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_packed_fwd(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed forward kernel wrapper (K6): qkv [B, S, 3E] → (O [B, S, E],
    lse [B, H, S] f32); the kernel slices the heads and prescales q itself.
    CPU tensors run `flash_attention_packed_reference`."""
    _refuse_graph("flash_attention_packed_fwd", qkv)
    if _on_cpu(qkv):
        return flash_attention_packed_reference(
            qkv, num_heads, causal=causal, sm_scale=sm_scale
        )
    q, k, v = _packed_views(qkv, num_heads)
    if not qkv.is_contiguous():
        raise ValueError("the packed kernel takes a contiguous qkv [B, S, 3E]")
    _check_kernel_inputs(q, k=k, v=v)
    _check_fwd_head_dim(q)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qkv.device)
    if b * s == 0:
        return out, lse
    lib = _kernels.library("flash_fwd", _FWD_ARGTYPES)
    err = lib.flash_fwd_packed_launch(
        _kernels.dtype_code(qkv.dtype), qkv.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, d, _scale(sm_scale, d), int(causal),
        _stream(qkv),
    )
    _kernels.check(err, "flash_fwd_packed")
    flash_attention_packed_fwd.launches += 1
    return out, lse


flash_attention_packed_fwd.launches = 0


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Backward pre-pass kernel wrapper: delta = rowsum(dO * O) in f32,
    [B, S, H, D] pair → [B*H, S]. CPU tensors run the plain version."""
    if _on_cpu(o):
        return flash_bwd_delta_reference(o, do)
    _check_kernel_inputs(o, do=do)
    b, s, h, d = o.shape
    delta = torch.empty((b * h, s), dtype=torch.float32, device=o.device)
    if b * s == 0:
        return delta
    lib = _kernels.library("flash_bwd", _BWD_ARGTYPES)
    err = lib.flash_bwd_delta_launch(
        _kernels.dtype_code(o.dtype), o.data_ptr(), do.data_ptr(),
        delta.data_ptr(), b, s, h, d, _strides(o, do), _stream(o),
    )
    _kernels.check(err, "flash_bwd_delta")
    flash_bwd_delta.launches += 1
    return delta


flash_bwd_delta.launches = 0


def _launch_grad(entry, q, k, v, do, lse, delta, dq, dk, dv, causal, sm_scale):
    """One launch of the dQ or the dK/dV kernel, writing the given outputs
    ([B, S, H, D] views, unit last stride) through their strides."""
    _check_kernel_inputs(q, k=k, v=v, do=do)
    b, s, h, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        _check_rows(name, t, b, h, s)
    for t in (dq, dk, dv):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype
                              or t.device != q.device or t.stride(-1) != 1):
            raise ValueError("gradient outputs must match q and have a unit last stride")
    if b * s == 0:
        return
    lib = _kernels.library("flash_bwd", _BWD_ARGTYPES)
    err = getattr(lib, entry)(
        _kernels.dtype_code(q.dtype),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(dq), _ptr(dk), _ptr(dv),
        b, s, h, d, _strides(q, k, v, do, dq, dk, dv),
        _scale(sm_scale, d), int(causal), _stream(q),
    )
    _kernels.check(err, entry)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=False, sm_scale=None, out=None):
    """dQ kernel wrapper (K4): q (not prescaled), k, v, dO [B, S, H, D],
    lse / delta [B*H, S] f32 → dq, written into `out` (a [B, S, H, D] view)
    when given. CPU tensors run `flash_bwd_dq_reference`."""
    if _on_cpu(q):
        dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale)
        return dq if out is None else out.copy_(dq)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if out is None else out
    _launch_grad("flash_bwd_dq_launch", q, k, v, do, lse, delta, dq, None, None,
                 causal, sm_scale)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=False, sm_scale=None, out=None):
    """dK/dV kernel wrapper (K5): the same inputs as `flash_bwd_dq` →
    (dk, dv), written into `out = (dk, dv)` views when given. CPU tensors
    run `flash_bwd_dkv_reference`."""
    if _on_cpu(q):
        dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale)
        return (dk, dv) if out is None else (out[0].copy_(dk), out[1].copy_(dv))
    if out is None:
        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (k, v))
    _launch_grad("flash_bwd_dkv_launch", q, k, v, do, lse, delta, None, *out,
                 causal, sm_scale)
    flash_bwd_dkv.launches += 1
    return out


flash_bwd_dkv.launches = 0


def flash_attention_bwd(
    q, k, v, o, do, lse, *, causal: bool = False, sm_scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of `flash_attention`: (dq, dk, dv) [B, S, H, D] from the
    forward's inputs, O and lse [B*H, S]. On CUDA tensors: the delta
    pre-pass, then the dQ (K4) and dK/dV (K5) kernels. dO may come in any
    layout (autograd's); it is made contiguous here. CPU tensors run
    `flash_attention_bwd_reference`."""
    if _on_cpu(q):
        return flash_attention_bwd_reference(q, k, v, o, do, lse, causal=causal, sm_scale=sm_scale)
    do = do.contiguous()
    delta = flash_bwd_delta(o, do)
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def flash_attention_bwd_fused(
    q, k, v, o, do, lse, *, causal: bool = False, sm_scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass backward kernel wrapper (K3): (dq, dk, dv) [B, S, H, D] from
    the forward's inputs (strided views), O and lse [B*H, S], with delta
    computed inside the kernel. Two launches (the pass over the pairs, which
    adds dQ into an f32 workspace with atomics, then dQ's scale and cast).
    dO may come in any layout; it is made contiguous here. CPU tensors run
    `flash_attention_bwd_fused_reference`."""
    _refuse_graph("flash_attention_bwd_fused", q, k, v, o, do)
    if _on_cpu(q):
        return flash_attention_bwd_fused_reference(
            q, k, v, o, do, lse, causal=causal, sm_scale=sm_scale
        )
    do = do.contiguous()
    _check_kernel_inputs(q, k=k, v=v, o=o, do=do)
    b, s, h, d = q.shape
    _check_rows("lse", lse, b, h, s)
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))
    if b * s == 0:
        return dq, dk, dv
    workspace = torch.empty((b * h, s, d), dtype=torch.float32, device=q.device)
    lib = _kernels.library("flash_bwd_fused", _FUSED_ARGTYPES)
    err = lib.flash_bwd_fused_launch(
        _kernels.dtype_code(q.dtype),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), workspace.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, h, d, _strides(q, k, v, o, do, dk, dv, dq),
        _scale(sm_scale, d), int(causal), _stream(q),
    )
    _kernels.check(err, "flash_bwd_fused")
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


flash_attention_bwd_fused.launches = 0


def flash_attention_packed_bwd(
    qkv, o, do, lse, num_heads: int, *, causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Packed backward wrapper (K7): dqkv [B, S, 3E] from qkv [B, S, 3E], O
    and dO [B, S, E] and lse [B, H, S]. On CUDA tensors the delta pre-pass
    and the dQ / dK/dV kernels run on the packed strides and write dq, dk
    and dv straight into the column ranges [0, E), [E, 2E), [2E, 3E) of one
    dqkv: no split, transpose or concatenation. CPU tensors run
    `flash_attention_packed_bwd_reference`."""
    if _on_cpu(qkv):
        return flash_attention_packed_bwd_reference(
            qkv, o, do, lse, num_heads, causal=causal, sm_scale=sm_scale
        )
    q, k, v = _packed_views(qkv, num_heads)
    b, s, h, d = q.shape
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    dq, dk, dv = _packed_views(dqkv, num_heads)
    o4 = o.view(b, s, h, d)
    do4 = do.contiguous().view(b, s, h, d)
    delta = flash_bwd_delta(o4, do4)
    kw = dict(causal=causal, sm_scale=sm_scale)
    flash_bwd_dq(q, k, v, do4, lse, delta, out=dq, **kw)
    flash_bwd_dkv(q, k, v, do4, lse, delta, out=(dk, dv), **kw)
    flash_attention_packed_bwd.launches += 1
    return dqkv


flash_attention_packed_bwd.launches = 0


# ---------------------------------------------------------------- autograd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, single_block):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        # Residuals in the kernels' layout: the strided views as given (no
        # prescaled or transposed copy), O and lse.
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.single_block = single_block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The reference's dispatch: one block over the sequence takes the
        # one-pass backward (K3), longer ones the two kernels (K4, K5).
        bwd = flash_attention_bwd_fused if ctx.single_block else flash_attention_bwd
        dq, dk, dv = bwd(
            q, k, v, o, do, lse, causal=ctx.causal, sm_scale=ctx.sm_scale
        )
        return dq, dk, dv, None, None, None


class _PackedFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, causal, sm_scale):
        o, lse = flash_attention_packed_fwd(
            qkv, num_heads, causal=causal, sm_scale=sm_scale
        )
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.causal, ctx.sm_scale = num_heads, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        dqkv = flash_attention_packed_bwd(
            qkv, o, do, lse, ctx.num_heads, causal=ctx.causal,
            sm_scale=ctx.sm_scale,
        )
        return dqkv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention. q,k,v: [B, S, H, D] → [B, S, H, D], differentiable
    through the backward kernels. block_q / block_k resolve as the
    reference's do (default `_pick_block`; an explicit block must divide the
    sequence) and choose the backward as the reference's blocks choose
    theirs: one block over the whole sequence takes the one-pass backward
    (K3), anything else K4 + K5. The kernels' tiles are their own."""
    s_q, s_k = q.shape[1], k.shape[1]
    bq = min(_pick_block(s_q) if block_q is None else block_q, s_q)
    bk = min(_pick_block(s_k) if block_k is None else block_k, s_k)
    if s_q % bq or s_k % bk:
        raise ValueError(
            f"seq lengths ({s_q},{s_k}) must be divisible by blocks ({bq},{bk})"
        )
    return _FlashAttention.apply(q, k, v, causal, sm_scale, single_block(s_q, s_k, bq, bk))


def single_block(s_q: int, s_k: int, block_q: int, block_k: int) -> bool:
    """The reference's test for its one-program backward
    (`_flash_bwd`: min(block_q, S) == S == S_k == min(block_k, S))."""
    return min(block_q, s_q) == s_q == s_k == min(block_k, s_q)


def flash_attention_packed(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention on a packed [B, S, 3E] qkv projection → [B, S, E].
    The kernels slice the heads themselves, and the backward returns dqkv
    in the same packed layout, ready for the projection's grad matmul."""
    three_e = qkv.shape[-1]
    if three_e % (3 * num_heads):
        raise ValueError(f"qkv last dim {three_e} not divisible by 3*heads")
    sm_scale = _scale(sm_scale, three_e // (3 * num_heads))
    return _PackedFlashAttention.apply(qkv, num_heads, causal, sm_scale)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatcher: the flash kernels on CUDA, the reference on the CPU
    (impl='auto'); 'flash' forces the kernel wrappers, 'reference' the
    full-matrix op."""
    if impl == "reference" or (impl == "auto" and q.device.type == "cpu"):
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"Unknown attention impl {impl!r}")
