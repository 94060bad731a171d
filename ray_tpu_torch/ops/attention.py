"""Reference attention math (plain PyTorch).

Ground truth for the hand-written CUDA kernels and the CPU path. Array
layout is [batch, seq, heads, head_dim] everywhere in the ops package, as
in the reference package, so the parity tests compare like with like.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# Finite on purpose: masked logits stay finite, so max/exp never meet
# inf - inf. A row whose keys are ALL masked sees exp(NEG_INF - NEG_INF) = 1
# and must be zeroed explicitly (see _chunk_attn_partial / paged_attention).
NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """[B, Sq, H, D] x [B, Sk, H, D] -> f32 logits [B, H, Sq, Sk], scaled
    after the product (the reference order; the kernels prescale q)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-matrix multi-head attention. q,k,v: [B, S, H, D] → [B, S, H, D]."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _scores(q, k, sm_scale)
    if bias is not None:
        logits = logits + bias
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(
            (q_len, k_len), dtype=torch.bool, device=q.device
        ).tril(k_len - q_len)
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
    return out.to(q.dtype)


def validate_tp_heads(
    num_heads: int, tensor_parallel_size: int, role: str = "model"
) -> None:
    """The head count must divide evenly across the tensor-parallel axis:
    attention heads (and with them the paged KV pools) shard on the head
    axis, so every device must own the same number of heads."""
    if tensor_parallel_size > 1 and num_heads % tensor_parallel_size:
        raise ValueError(
            f"{role} num_heads {num_heads} is not divisible by "
            f"tensor_parallel_size {tensor_parallel_size}: attention heads "
            "(and with them the paged KV pools) shard on the head axis, so "
            "every device must own the same number of heads"
        )


def validate_kv_scales(k_cache, v_cache, k_scale, v_scale) -> None:
    """One shared contract for both paged-attention implementations, so
    impl='auto' can never accept inputs on one device that the other
    rejects: pools must share a dtype, int8 pools require BOTH dequant
    scales, and scales require int8 pools (silently dropping or applying
    them would diverge)."""
    if k_cache.dtype != v_cache.dtype:
        raise ValueError(
            f"k_cache/v_cache dtypes differ ({k_cache.dtype} vs "
            f"{v_cache.dtype}); the pools must share one storage dtype"
        )
    if (k_scale is not None or v_scale is not None) and k_cache.dtype != torch.int8:
        raise ValueError(
            f"k_scale/v_scale passed with non-int8 cache pools "
            f"({k_cache.dtype}): dequant scales only apply to int8 pools"
        )
    if k_cache.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("int8 k_cache/v_cache require k_scale/v_scale")


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of ops.paged_flash.quantize_kv, in f32: values [..., H, D]
    * scales [..., H]."""
    return values.float() * scales.float()[..., None]


def paged_attention(
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
) -> torch.Tensor:
    """Attention over the paged KV cache through per-sequence block tables:
    the gather + mask oracle of the paged-attention kernel.

    q:            [B, S, H, D]  new-token queries per batch slot.
    k_cache:      [N, bs, H, D] shared block pool (block 0 is the null block).
    block_tables: [B, nb] int32, padded with 0 past each sequence's blocks.
    context_lens: [B] int32 — tokens already written to the cache.
    new_k/new_v:  [B, S, H, D] the new tokens' K/V, not yet scattered into
                  the cache: extra always-gathered slots under a causal
                  (j <= i) mask.
    k_scale/v_scale: [N, bs, H] per-token dequant scales for int8 pools;
                  the gathered pages are dequantized in f32 before use.

    Decode is S == 1; partial prefill is S > 1 (queries at suffix offset i
    attend every cached position plus new tokens 0..i). Fully-masked rows
    (context_len 0 and no new tokens) return exact zeros. Returns
    [B, S, H, D].
    """
    b, q_len, h, d = q.shape
    nb = block_tables.shape[1]
    bs = k_cache.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    validate_kv_scales(k_cache, v_cache, k_scale, v_scale)
    tables = block_tables.long()
    # Gather the pages: [B, nb, bs, H, D] -> [B, nb*bs, H, D].
    k_ctx = k_cache[tables].reshape(b, nb * bs, h, d)
    v_ctx = v_cache[tables].reshape(b, nb * bs, h, d)
    if k_scale is not None:
        k_ctx = dequantize_kv(
            k_ctx, k_scale[tables].reshape(b, nb * bs, h)
        ).to(q.dtype)
    if v_scale is not None:
        v_ctx = dequantize_kv(
            v_ctx, v_scale[tables].reshape(b, nb * bs, h)
        ).to(q.dtype)
    # [B, Q, K] mask: every query sees every valid cached position.
    slots = torch.arange(nb * bs, device=q.device)
    valid = (slots[None, :] < context_lens.to(q.device)[:, None])[:, None, :]
    valid = valid.expand(b, q_len, nb * bs)
    if new_k is not None:
        s_new = new_k.shape[1]
        # Concatenation promotes (bf16 pools + f32 new tokens -> f32), as
        # jnp.concatenate does in the reference.
        kv_dtype = torch.promote_types(k_ctx.dtype, new_k.dtype)
        k_ctx = torch.cat([k_ctx.to(kv_dtype), new_k.to(kv_dtype)], dim=1)
        v_ctx = torch.cat([v_ctx.to(kv_dtype), new_v.to(kv_dtype)], dim=1)
        causal = torch.ones(
            (q_len, s_new), dtype=torch.bool, device=q.device
        ).tril(s_new - q_len)
        valid = torch.cat(
            [valid, causal[None].expand(b, q_len, s_new)], dim=2
        )
    logits = _scores(q, k_ctx, sm_scale)
    logits = logits.masked_fill(~valid[:, None, :, :], NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    if new_k is None or new_k.shape[1] < q_len:
        # Softmax over an all-NEG_INF row degrades to uniform weights over
        # whatever the null block holds; masked/empty slots contribute
        # exact zeros instead (the finalize_partial l == 0 hygiene).
        any_valid = valid.any(dim=-1)  # [B, Q]
        weights = weights * any_valid[:, None, :, None]
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v_ctx.dtype), v_ctx)
    return out.to(q.dtype)


def _chunk_attn_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    mask: Optional[torch.Tensor],
):
    """One blockwise-attention partial: returns (o_unnorm, m, l) in f32 so
    partials from different KV chunks can be merged with log-sum-exp algebra.

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D]; mask: broadcastable to [B, H, Sq, Sk].
    """
    logits = _scores(q, k, sm_scale)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1)  # [B, H, Sq]
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = p * mask  # kill exp(0)=1 rows when everything was masked
    l = p.sum(dim=-1)  # [B, H, Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def merge_partials(o1, m1, l1, o2, m2, l2):
    """Merge two blockwise softmax partials (the flash/ring update rule)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    # o is [B, Sq, H, D]; scales are [B, H, Sq] -> [B, Sq, H, 1]
    s1 = a1.permute(0, 2, 1)[..., None]
    s2 = a2.permute(0, 2, 1)[..., None]
    o = o1 * s1 + o2 * s2
    return o, m, l


def finalize_partial(o, m, l):
    """Normalize an accumulated partial into the final attention output."""
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    scale = (1.0 / denom).permute(0, 2, 1)[..., None]
    return o * scale
