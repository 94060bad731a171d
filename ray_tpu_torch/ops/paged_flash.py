"""Fused paged attention for the serving hot path: hand-written CUDA
kernels (``csrc/paged_attention.cu``) walking each sequence's block table.

The plain path (`ops.paged_attention`) gathers whole pages —
``k_cache[block_tables]`` materializes [B, nb*bs, H, D] every step — and
runs a full-matrix softmax over [B, H, Q, K] logits. The kernels read each
cache block through the table once, mask at the context length, and fold it
into an f32 online softmax; neither the gathered pages nor the logits reach
device memory. The new tokens' K/V (not yet scattered into the pool) are
folded in causally. Rows with no valid key come out as exact zeros,
matching `finalize_partial`'s l == 0 hygiene.

Covers both generation shapes of ray_tpu_torch.llm, by the number of query
rows S:
- decode and verify (S <= SPLIT_MAX_S): the context is split into
  partitions of PART_PAGES pages, one block each, whose partial softmax
  states a second kernel merges in partition order (`split_plan`; the plain
  form of that algorithm is `paged_attention_split_reference`);
- prefix-aware partial prefill (S > SPLIT_MAX_S: the uncached suffix
  attends the cached prefix through the table and itself causally): tiles
  of 64 query rows on the tensor cores for bf16 q with bf16 or int8 pools
  (head_dim 32, 64 or 128), CUDA-core f32 math for f32 q or f32 pools.

int8 KV cache: the pools store int8 with per-token, per-head bf16 scales
(written by `quantize_kv` at scatter time — per-token scales are the only
granularity a one-token decode scatter can maintain). Dequantization is
folded into the block loop: K's scale multiplies the score columns and V's
scale the softmax weights, so no dequantized block is ever materialized.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.attention import (
    _chunk_attn_partial,
    dequantize_kv,
    finalize_partial,
    merge_partials,
    paged_attention,
    validate_kv_scales,
)

# Storage dtype for the KV-cache scale tensors. bf16 keeps the scale
# overhead at 2 bytes per (token, head). All scale MATH is f32;
# quantization divides by the bf16-rounded scale so the round trip is
# consistent with what the kernel will dequantize with.
KV_SCALE_DTYPE = torch.bfloat16

_ARGTYPES = {
    "paged_attention_launch": [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
}

# Decode and verify: up to this many query rows go through the split kernel
# (its SPLIT_MAX_ROWS); longer suffixes through the suffix kernels.
SPLIT_MAX_S = 8
# Pages of the context a partition of the split kernel covers.
PART_PAGES = 16
# head_dims of the bf16 suffix kernel (tensor cores).
SUFFIX_HEAD_DIMS = (32, 64, 128)


class SplitPlan(NamedTuple):
    """How the split kernel cuts a call: `part_pages` pages (`part_tokens`
    tokens) a partition, `n_part` partitions, a grid of (B * H, n_part)
    blocks, and the f32 partials' workspace [B, H, n_part, S, D + 2], None
    when one partition covers the whole table (each slot is then written
    directly). Everything follows from the shapes alone — the table's width
    nb, the page size bs and S — never from the context lengths, so the host
    reads nothing back from the card."""

    part_pages: int
    part_tokens: int
    n_part: int
    grid: Tuple[int, int]
    workspace: Optional[Tuple[int, int, int, int, int]]


def split_plan(
    b: int, s: int, h: int, d: int, nb: int, bs: int
) -> Optional[SplitPlan]:
    """The split kernel's plan for q [b, s, h, d] over tables of nb pages of
    bs tokens, or None when S is above SPLIT_MAX_S (the suffix kernels)."""
    if s > SPLIT_MAX_S:
        return None
    n_part = -(-nb // PART_PAGES)
    workspace = (b, h, n_part, s, d + 2) if n_part > 1 else None
    return SplitPlan(
        PART_PAGES, PART_PAGES * bs, n_part, (b * h, n_part), workspace
    )


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token, per-head int8 quantization of K or V.

    x: [..., H, D] (any leading shape) → (values int8 [..., H, D],
    scales KV_SCALE_DTYPE [..., H]). Scales are amax/127 per (token, head)
    so a single decode token's scatter writes its own scale slot and never
    touches neighbors. Bit-identical to the reference: torch.round, like
    jnp.round, rounds half to even.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8).to(KV_SCALE_DTYPE)
    # Quantize with the *stored* (bf16-rounded) scale; clip because the
    # rounding can shrink the scale by ~0.4%, pushing x/scale past 127.
    q = torch.clamp(
        torch.round(xf / scale.float()[..., None]), -127.0, 127.0
    ).to(torch.int8)
    return q, scale


def resolve_paged_impl(impl: str, device=None) -> str:
    """Resolve the `impl` knob to a concrete implementation: 'auto' picks
    the CUDA kernel when the pools live on a CUDA device and the plain
    reference on the CPU. The single owner of that policy — the runner
    (tagging metrics/flight records) and the dispatcher below both call
    this, so they can never disagree."""
    if impl not in ("auto", "cuda", "reference"):
        raise ValueError(f"Unknown paged attention impl {impl!r}")
    if impl == "auto":
        device = torch.device(device if device is not None else "cpu")
        return "cuda" if device.type == "cuda" else "reference"
    return impl


def _check_kernel_inputs(q, k_cache, v_cache, block_tables, context_lens,
                         new_k, new_v, k_scale, v_scale) -> None:
    b, s, h, d = q.shape
    tensors = {
        "q": q, "k_cache": k_cache, "v_cache": v_cache,
        "block_tables": block_tables, "context_lens": context_lens,
        "new_k": new_k, "new_v": new_v,
    }
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype}: the kernel takes f32 or bf16")
    if new_k.dtype != q.dtype or new_v.dtype != q.dtype:
        raise ValueError("new_k/new_v must share q's dtype")
    if k_cache.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"pool dtype {k_cache.dtype} is not f32/bf16/int8")
    if k_scale is not None and (
        k_scale.dtype != KV_SCALE_DTYPE or v_scale.dtype != KV_SCALE_DTYPE
    ):
        raise ValueError(f"scales must be {KV_SCALE_DTYPE}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables/context_lens must be int32")
    if new_k.shape != q.shape or new_v.shape != q.shape:
        raise ValueError("new_k/new_v must have q's shape [B, S, H, D]")
    if k_cache.dim() != 4 or k_cache.shape[2:] != (h, d):
        raise ValueError(f"pool shape {tuple(k_cache.shape)} != [N, bs, {h}, {d}]")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache/v_cache shapes differ")
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("block_tables [B, nb] / context_lens [B] mismatch q")
    if d > 128:
        raise ValueError(f"head_dim {d} > 128 is not supported by the kernel")
    if (s > SPLIT_MAX_S and q.dtype == torch.bfloat16
            and k_cache.dtype != torch.float32 and d not in SUFFIX_HEAD_DIMS):
        raise ValueError(
            f"head_dim {d}: the bf16 suffix kernel (S > {SPLIT_MAX_S}) is "
            f"built for {SUFFIX_HEAD_DIMS}"
        )
    # The kernel stages rows in 16-byte units.
    for name in ("q", "k_cache", "new_k"):
        t = tensors[name]
        if (d * t.element_size()) % 16:
            raise ValueError(
                f"{name}: rows of head_dim {d} x {t.element_size()} bytes are "
                "not a multiple of 16 bytes, which the kernel's loads need"
            )
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")


def paged_flash_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused paged attention over the block-table KV cache.

    Same contract as :func:`ray_tpu_torch.ops.paged_attention` — q
    [B, S, H, D], k/v_cache [N, bs, H, D] pools, block_tables [B, nb]
    (0-padded), context_lens [B] — except `new_k`/`new_v` are REQUIRED.
    q is prescaled by sm_scale and rounded to its storage dtype (by the
    kernels as they stage it; the reference scales the f32 logits instead,
    and the two round differently).

    CUDA tensors launch the kernels (or raise): the split kernel and its
    merge at S <= SPLIT_MAX_S (`split_plan`), else a suffix kernel; the
    launch counter moves once per call, and the count of its route
    (`routes`) with it. CPU tensors run the plain version,
    `paged_attention`, on the same prescaled q.
    """
    if new_k is None or new_v is None:
        raise ValueError(
            "paged_flash_attention requires new_k/new_v (the engine always "
            "carries the new tokens' K/V); use ops.paged_attention for "
            "cache-only queries"
        )
    validate_kv_scales(k_cache, v_cache, k_scale, v_scale)
    b, s, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        q = (q.float() * sm_scale).to(q.dtype)
        return paged_attention(
            q, k_cache, v_cache, block_tables, context_lens,
            new_k=new_k, new_v=new_v, sm_scale=1.0,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: unsupported device {q.device}")
    q = q.contiguous()  # the model's q is a view of its qkv projection
    _check_kernel_inputs(q, k_cache, v_cache, block_tables, context_lens,
                         new_k, new_v, k_scale, v_scale)
    out = torch.empty_like(q)
    if b * s == 0:
        return out
    nb, bs = block_tables.shape[1], k_cache.shape[1]
    plan = split_plan(b, s, h, d, nb, bs)
    workspace = None
    if plan is not None and plan.workspace is not None:
        workspace = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    lib = _kernels.library("paged_attention", _ARGTYPES)
    err = lib.paged_attention_launch(
        _kernels.dtype_code(q.dtype), _kernels.dtype_code(k_cache.dtype),
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        b, s, h, d, bs, nb, 0 if plan is None else plan.part_pages, sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(err, "paged_attention")
    paged_flash_attention.launches += 1
    paged_flash_attention.routes[_route(plan, q.dtype, k_cache.dtype)] += 1
    return out


def _route(plan: Optional[SplitPlan], q_dtype, kv_dtype) -> str:
    """Which of K1's kernels a launch takes (the keys of
    `paged_flash_attention.routes`)."""
    if plan is not None:
        return "split"
    if q_dtype == torch.bfloat16 and kv_dtype != torch.float32:
        return "suffix_mma"
    return "suffix_f32"


paged_flash_attention.launches = 0
# Launches by route: the split kernel (+ merge) at S <= SPLIT_MAX_S, the
# tensor-core suffix kernel, or the CUDA-core one. They sum to `launches`.
paged_flash_attention.routes = {"split": 0, "suffix_mma": 0, "suffix_f32": 0}


def paged_attention_split_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the split kernel's algorithm (tests use it; the
    serving path does not): the gathered context cut into the partitions of
    `split_plan` (PART_PAGES pages each, whatever S), partition 0 also
    holding the new tokens under the causal mask; one f32 partial
    (o, m, l) per partition (`_chunk_attn_partial`), merged in partition
    order by `merge_partials` and normalised by `finalize_partial`. A
    partition past the context has m = NEG_INF and l = 0 and merges to
    nothing. Same contract as `paged_attention` with new_k / new_v required;
    int8 pools are dequantized as there. Returns [B, S, H, D] in q's dtype."""
    validate_kv_scales(k_cache, v_cache, k_scale, v_scale)
    b, s, h, d = q.shape
    nb, bs = block_tables.shape[1], k_cache.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    tables = block_tables.long()
    k_ctx = k_cache[tables].reshape(b, nb * bs, h, d)
    v_ctx = v_cache[tables].reshape(b, nb * bs, h, d)
    if k_scale is not None:
        k_ctx = dequantize_kv(k_ctx, k_scale[tables].reshape(b, nb * bs, h)).to(q.dtype)
        v_ctx = dequantize_kv(v_ctx, v_scale[tables].reshape(b, nb * bs, h)).to(q.dtype)
    pt = PART_PAGES * bs
    lens = context_lens.to(q.device).clamp(0, nb * bs)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    acc = None
    for t0 in range(0, nb * bs, pt):
        pos = torch.arange(t0, min(t0 + pt, nb * bs), device=q.device)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :].expand(b, 1, s, -1)
        k, v = k_ctx[:, t0:t0 + pt], v_ctx[:, t0:t0 + pt]
        if t0 == 0:  # partition 0 also folds the new tokens, causally
            k = torch.cat([k.float(), new_k.float()], dim=1)
            v = torch.cat([v.float(), new_v.float()], dim=1)
            mask = torch.cat([mask, causal[None, None].expand(b, 1, s, s)], dim=-1)
        part = _chunk_attn_partial(q, k, v, sm_scale, mask)
        acc = part if acc is None else merge_partials(*acc, *part)
    return finalize_partial(acc[0], acc[1], acc[2]).to(q.dtype)


def paged_attention_impl(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    new_k: Optional[torch.Tensor] = None,
    new_v: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatcher: the CUDA kernel for pools on a CUDA device, the plain
    reference on the CPU (impl='auto'); 'cuda' forces the kernel wrapper
    (its plain version on CPU tensors), 'reference' forces the gather +
    softmax op. A cache-only query (new_k=None) is outside the kernel's
    contract, so whenever the kernel is chosen it raises."""
    resolved = resolve_paged_impl(impl, k_cache.device)
    op = paged_attention if resolved == "reference" else paged_flash_attention
    return op(
        q, k_cache, v_cache, block_tables, context_lens,
        new_k=new_k, new_v=new_v, sm_scale=sm_scale,
        k_scale=k_scale, v_scale=v_scale,
    )


def kv_pool_bytes(
    num_blocks: int, block_size: int, heads: int, head_dim: int,
    kv_dtype, with_scales: bool,
) -> int:
    """Total bytes of one K or V pool (+ its scale tensor when int8):
    the honest denominator for capacity-ratio claims. `kv_dtype` is a
    torch or numpy dtype."""
    values = num_blocks * block_size * heads * head_dim * _itemsize(kv_dtype)
    if with_scales:
        values += num_blocks * block_size * heads * _itemsize(KV_SCALE_DTYPE)
    return values


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize
