"""The attention profiling kernels: hand-written CUDA kernels for the
functions the reference's profiling scripts run on the TPU, their plain
PyTorch versions, and the slim variant's autograd function.

- K8 `attn_dissect` (``csrc/attn_dissect.cu``): the forward dissected,
  levels 0-4 (`benchmarks/profile_attn_dissect.py::make`) and two heads per
  block (`::make2h(3)`), on wgmma with TMA loads (``csrc/wgmma_tiles.cuh``).
- K9 `flash_fwd_slim` (``csrc/attn_slim.cu``): the slim causal forward on
  prescaled q (`benchmarks/profile_attn_variants.py::slim_fwd`), over query
  and key tiles in {64, 128}; `slim_attention` is `make_variant`'s
  counterpart, K9 forward and the K4 + K5 backward.
- K10 `attn_subtile` (``csrc/attn_subtile.cu``): causal attention without
  sm_scale whose rows are cut into T chunks, each scoring keys up to its
  chunk's edge (`benchmarks/profile_attn_subtile.py::make_subtiled`), on
  wgmma with TMA loads like K8.

All take contiguous [BH, S, D] bf16 (the scripts' layout). On CPU tensors
each wrapper runs its plain version; on CUDA tensors it launches its kernel
or raises: a dtype other than bf16, a head_dim outside {32, 64}, or an S
the kernel's tiles do not divide is refused, never sent elsewhere. The
profiling entry points that drive them are ``ray_tpu_torch.profiling``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.attention import NEG_INF
from ray_tpu_torch.ops.flash_attention import (
    _on_cpu,
    _prescale,
    _refuse_graph,
    _scale,
    _stream,
    flash_attention_bwd,
    flash_attention_reference,
)

_PTRS = [ctypes.c_void_p]
_ARGTYPES = {
    "attn_dissect": {
        "attn_dissect_launch": [ctypes.c_int] * 2 + _PTRS * 4
        + [ctypes.c_int] * 3 + _PTRS,
    },
    "attn_slim": {
        "attn_slim_launch": [ctypes.c_int] * 2 + _PTRS * 5
        + [ctypes.c_int] * 3 + _PTRS,
    },
    "attn_subtile": {
        "attn_subtile_launch": [ctypes.c_int] + _PTRS * 5
        + [ctypes.c_int] * 3 + _PTRS,
    },
}
HEAD_DIMS = (32, 64)  # head_dims the kernels are instantiated for
ROW_TILE = 64  # query rows of a K8 / K10 warpgroup; S and K10's chunks take whole tiles
SLIM_TILES = (64, 128)  # K9's query and key tile sizes
DISSECT_LEVELS = (0, 1, 2, 3, 4)

# Bytes of the [chunk, S, S] f32 scores the plain versions hold at once on
# the card.
_PLAIN_SCORE_BYTES = 512 << 20


def _head_chunks(bh: int, s: int, device: torch.device):
    """Head ranges of the plain versions: all heads at once on the CPU,
    chunks whose [S, S] f32 scores fit _PLAIN_SCORE_BYTES on the card."""
    step = bh if device.type == "cpu" else max(1, _PLAIN_SCORE_BYTES // (4 * s * s))
    return [(h0, min(h0 + step, bh)) for h0 in range(0, bh, step)]


def _tril(s_q: int, q0: int, s_k: int, device) -> torch.Tensor:
    """Causal mask of query rows q0 .. q0 + s_q - 1 against keys 0 .. s_k - 1."""
    return (torch.arange(q0, q0 + s_q, device=device)[:, None]
            >= torch.arange(s_k, device=device)[None, :])


# ---------------------------------------------------------------- plain


def attn_dissect_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, level: int,
    two_heads: bool = False,
) -> torch.Tensor:
    """Plain version of K8, the script's `make(level)` whole-row op by op per
    head: s = q kᵀ in f32 with no scale; level ≥ 1 masks keys past the
    diagonal with -1e30; ≥ 2 subtracts each row's max; ≥ 3 takes exp; ≥ 4
    divides by the row's sum; O = bf16(s) v in f32, rounded to q's dtype.
    `two_heads` is `make2h(3)`, which computes make(4)'s function.
    [BH, S, D] in, [BH, S, D] out."""
    _check_level(level, two_heads)
    if two_heads:
        level = 4
    bh, s, _ = q.shape
    out = torch.empty_like(q)
    causal = _tril(s, 0, s, q.device)
    for h0, h1 in _head_chunks(bh, s, q.device):
        sc = q[h0:h1].float() @ k[h0:h1].float().transpose(-1, -2)
        if level >= 1:
            sc = torch.where(causal, sc, NEG_INF)
        if level >= 2:
            sc = sc - sc.amax(dim=-1, keepdim=True)
        if level >= 3:
            sc = torch.exp(sc)
        if level >= 4:
            sc = sc / sc.sum(dim=-1, keepdim=True)
        out[h0:h1] = (sc.to(v.dtype).float() @ v[h0:h1].float()).to(q.dtype)
    return out


def attn_subtile_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, T: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10, the script's `make_subtiled(T)`: for each chunk
    t of C = S / T rows, the scores against keys [0, (t + 1) C) masked with
    -1e30 past the diagonal, m the row's exact max, p = exp(s - m) in f32,
    l = sum(p), O = (bf16(p) v) / l in q's dtype, lse = m + log(l).
    [BH, S, D] in; (O [BH, S, D], lse [BH, S] f32) out."""
    bh, s, _ = q.shape
    if T < 1 or s % T:
        raise ValueError(f"T = {T} must divide S = {s}")
    c = s // T
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    for t in range(T):
        rows, lim = slice(t * c, (t + 1) * c), (t + 1) * c
        causal = _tril(c, t * c, lim, q.device)
        for h0, h1 in _head_chunks(bh, s, q.device):
            sc = q[h0:h1, rows].float() @ k[h0:h1, :lim].float().transpose(-1, -2)
            sc = torch.where(causal, sc, NEG_INF)
            m = sc.amax(dim=-1, keepdim=True)
            p = torch.exp(sc - m)
            l = p.sum(dim=-1, keepdim=True)
            o = p.to(v.dtype).float() @ v[h0:h1, :lim].float()
            out[h0:h1, rows] = (o / l).to(q.dtype)
            lse[h0:h1, rows] = (m + torch.log(l))[..., 0]
    return out, lse


def flash_fwd_slim_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    sm_scale: Optional[float] = None, block_k: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9, the script's `slim_fwd` as its variants call it
    (causal): q prescaled by sm_scale and rounded to its dtype, then K2's
    plain forward with sm_scale = 1 and key tiles of `block_k` (P is
    rounded against their running max).
    [BH, S, D] in; (O [BH, S, D], lse [BH, S] f32) out."""
    qs = _prescale(q, _scale(sm_scale, q.shape[-1]))
    as_bshd = lambda t: t.transpose(0, 1).unsqueeze(0)  # [1, S, BH, D]
    o, lse = flash_attention_reference(
        as_bshd(qs), as_bshd(k), as_bshd(v), causal=True, sm_scale=1.0,
        block_k=block_k,
    )
    return o[0].transpose(0, 1).contiguous(), lse


# ---------------------------------------------------------------- kernels


def _check_level(level: int, two_heads: bool) -> None:
    if level not in DISSECT_LEVELS:
        raise ValueError(f"dissection level {level} not in {DISSECT_LEVELS}")
    if two_heads and level != 3:
        raise ValueError("the two-head variant is the script's make2h(3): level 3")


def _check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  s_multiple: int) -> None:
    """What every profiling kernel takes: CUDA, contiguous [BH, S, D] bf16,
    q, k and v alike, D in HEAD_DIMS, S a multiple of the tiles."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not {q.device}")
    for n, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {n} must match q's shape, dtype and device")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: dtype {q.dtype}: the kernel takes bf16")
    if q.dim() != 3:
        raise ValueError(f"{name}: takes [BH, S, D], got {tuple(q.shape)}")
    bh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d}: the kernel is built for {HEAD_DIMS}")
    if s < s_multiple or s % s_multiple:
        raise ValueError(f"{name}: S = {s} is not a multiple of the tile {s_multiple}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be contiguous [BH, S, D]")


def attn_dissect(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, level: int,
    two_heads: bool = False,
) -> torch.Tensor:
    """K8 wrapper: the dissected forward at `level` (0-4), or the two-head
    variant (`two_heads`, level 3), on q, k, v [BH, S, D] → O [BH, S, D].
    CPU tensors run `attn_dissect_reference`."""
    _refuse_graph("attn_dissect", q, k, v)
    _check_level(level, two_heads)
    if _on_cpu(q):
        return attn_dissect_reference(q, k, v, level, two_heads)
    _check_inputs("attn_dissect", q, k, v, ROW_TILE)
    bh, s, d = q.shape
    if two_heads and bh % 2:
        raise ValueError(f"attn_dissect: two heads per block need an even BH, got {bh}")
    out = torch.empty_like(q)
    lib = _kernels.library("attn_dissect", _ARGTYPES["attn_dissect"])
    err = lib.attn_dissect_launch(
        level, int(two_heads), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), bh, s, d, _stream(q),
    )
    _kernels.check(err, "attn_dissect")
    attn_dissect.launches += 1
    return out


attn_dissect.launches = 0


def flash_fwd_slim(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    sm_scale: Optional[float] = None, block_q: int = 64, block_k: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 wrapper: the slim causal forward over block_q x block_k tiles
    (each in {64, 128}) on q, k, v [BH, S, D] → (O [BH, S, D], lse [BH, S]
    f32). q is prescaled by sm_scale and rounded to bf16 here, as
    `slim_fwd` does before its kernel (a time of this call includes that
    pass). CPU tensors run `flash_fwd_slim_reference` with block_k."""
    _refuse_graph("flash_fwd_slim", q, k, v)
    if block_q not in SLIM_TILES or block_k not in SLIM_TILES:
        raise ValueError(f"flash_fwd_slim: tiles ({block_q}, {block_k}) not in {SLIM_TILES}")
    if _on_cpu(q):
        return flash_fwd_slim_reference(q, k, v, sm_scale=sm_scale, block_k=block_k)
    _check_inputs("flash_fwd_slim", q, k, v, max(block_q, block_k))
    bh, s, d = q.shape
    # One elementwise pass with the bits of `_prescale`: bf16 times a
    # scalar is computed in f32 and rounded once.
    qs = q * _scale(sm_scale, d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    lib = _kernels.library("attn_slim", _ARGTYPES["attn_slim"])
    err = lib.attn_slim_launch(
        block_q, block_k, qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), bh, s, d, _stream(q),
    )
    _kernels.check(err, "attn_slim")
    flash_fwd_slim.launches += 1
    return out, lse


flash_fwd_slim.launches = 0


def attn_subtile(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, T: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 wrapper: causal attention without sm_scale, rows cut into T
    chunks, on q, k, v [BH, S, D] → (O [BH, S, D], lse [BH, S] f32). The
    kernel takes T dividing S into chunks of whole 64-row tiles. CPU
    tensors run `attn_subtile_reference`."""
    _refuse_graph("attn_subtile", q, k, v)
    if _on_cpu(q):
        return attn_subtile_reference(q, k, v, T)
    _check_inputs("attn_subtile", q, k, v, ROW_TILE)
    bh, s, d = q.shape
    if T < 1 or s % T or (s // T) % ROW_TILE:
        raise ValueError(
            f"attn_subtile: T = {T} must cut S = {s} into chunks of whole "
            f"{ROW_TILE}-row tiles")
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    lib = _kernels.library("attn_subtile", _ARGTYPES["attn_subtile"])
    err = lib.attn_subtile_launch(
        T, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, s, d, _stream(q),
    )
    _kernels.check(err, "attn_subtile")
    attn_subtile.launches += 1
    return out, lse


attn_subtile.launches = 0


# ---------------------------------------------------------------- autograd


def _fold(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> contiguous [B*H, S, D]."""
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


class _SlimAttention(torch.autograd.Function):
    """`make_variant(block)`'s counterpart: K9 forward on the folded heads;
    the backward is the port's K4 + K5 (`flash_attention_bwd`), as the
    script's `_bwd` calls `_flash_bwd_pallas` directly. The script hands
    those kernels the unscaled folded q where they expect it prescaled;
    `flash_attention_bwd` prescales q itself, so this gradient is the
    attention's."""

    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k):
        b, s, h, d = q.shape
        qf, kf, vf = _fold(q), _fold(k), _fold(v)
        of, lse = flash_fwd_slim(qf, kf, vf, block_q=block_q, block_k=block_k)
        unfold = lambda t: t.view(b, h, s, d).permute(0, 2, 1, 3)
        ctx.save_for_backward(qf, kf, vf, of, lse)
        ctx.shape = (b, s, h, d)
        return unfold(of)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, of, lse = ctx.saved_tensors
        b, s, h, d = ctx.shape
        unfold = lambda t: t.view(b, h, s, d).permute(0, 2, 1, 3)
        dq, dk, dv = flash_attention_bwd(
            unfold(qf), unfold(kf), unfold(vf), unfold(of), do, lse, causal=True)
        return dq, dk, dv, None, None


def slim_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    block_q: int = 64, block_k: int = 64,
) -> torch.Tensor:
    """Causal attention through the slim forward (K9) and the K4 + K5
    backward, with sm_scale 1/sqrt(D). q, k, v [B, S, H, D] → [B, S, H, D]."""
    return _SlimAttention.apply(q, k, v, block_q, block_k)
