"""How the serving engine's GPT weights and KV pools split over the
tensor-parallel ranks (the reference's ``LLM_TP_RULES``,
``llm_shard_params`` and ``LLM_POOL_SPEC``,
``ray_tpu/parallel/sharding.py:159-212``).

Megatron's layout: attention heads and the MLP's intermediate dim split,
so ``attn_qkv`` and ``mlp_in`` are column-parallel (each rank computes its
own output columns) and ``attn_proj`` and ``mlp_out`` row-parallel (each
rank holds the input rows that match its columns and produces a partial
sum, which the block all-reduces). Embeddings, layernorms and the tied LM
head are replicated. An MoE block does what the reference's rules give it
(``expert`` replicated, ``mlp`` split): each expert's ``w_in`` is split on
its output columns and ``w_out`` on its input rows; the router is
replicated. The KV pools split on the head axis, so block ids mean the
same on every rank and the host-side allocator stays global.

Weights are torch ``[out, in]`` (numpy arrays are accepted as well); the
rank r slice of a full state dict is contiguous and owns its storage.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

# Module name -> how its weight splits; anything not named is replicated.
LLM_TP_RULES: Dict[str, str] = {
    "attn_qkv": "column",  # heads, from each of the q, k and v thirds
    "attn_proj": "row",
    "mlp_in": "column",
    "mlp_out": "row",
    "moe_mlp.w_in": "column",  # [E, d, m]: m splits
    "moe_mlp.w_out": "row",  # [E, m, d]: m splits
}

# The pools' layout in the reference's words: [L, N, bs, H, D] (scales
# [L, N, bs, H]) split on H, dim 3.
LLM_POOL_SPEC = "PartitionSpec(None, None, None, 'tp')"


def param_rule(name: str) -> str:
    """"column", "row" or "replicated" for a GPT state-dict key."""
    for module, rule in LLM_TP_RULES.items():
        if f".{module}." in f".{name}.":
            return rule
    return "replicated"


def _split_dim(name: str) -> Any:
    """The dim of `name`'s tensor that splits, or None (replicated: a
    row-parallel bias is added once, after the all-reduce)."""
    rule = param_rule(name)
    if rule == "replicated":
        return None
    if name.endswith("moe_mlp.w_in"):
        return 2
    if name.endswith("moe_mlp.w_out"):
        return 1
    if rule == "column":
        return 0  # weight [out, in] and bias [out]: output features
    return 1 if name.endswith(".weight") else None  # row: input features


def _slice(x, dim: int, rank: int, tp: int):
    size = x.shape[dim]
    if size % tp:
        raise ValueError(f"dim {dim} of size {size} does not split over {tp} ranks")
    step = size // tp
    index = [slice(None)] * x.ndim
    index[dim] = slice(rank * step, (rank + 1) * step)
    part = x[tuple(index)]
    return np.ascontiguousarray(part) if isinstance(x, np.ndarray) else part.contiguous().clone()


def shard_param(name: str, x, rank: int, tp: int):
    """Rank `rank`'s slice of the full parameter `x` named `name`."""
    if tp == 1:
        return x
    dim = _split_dim(name)
    if dim is None:
        return x
    if name.endswith("attn_qkv.weight") or name.endswith("attn_qkv.bias"):
        # Packed q | k | v: the rank's heads come from each third, so view
        # the thirds apart, split each, and pack them again.
        thirds = x.reshape((3, x.shape[0] // 3) + tuple(x.shape[1:]))
        part = _slice(thirds, 1, rank, tp)
        return part.reshape((-1,) + tuple(x.shape[1:]))
    return _slice(x, dim, rank, tp)


def full_numel(name: str, numel: int, tp: int) -> int:
    """Elements of the full parameter whose rank slice has `numel`."""
    return numel if _split_dim(name) is None else numel * tp


def llm_shard_params(state_dict: Mapping[str, Any], rank: int, tp: int) -> Dict[str, Any]:
    """Rank `rank`'s shard of a full GPT state dict under LLM_TP_RULES."""
    return {name: shard_param(name, x, rank, tp) for name, x in state_dict.items()}


def llm_pool_shape(
    num_layers: int, num_blocks: int, block_size: int, num_heads: int,
    head_dim: int, tp: int,
) -> Tuple[int, ...]:
    """One rank's KV pool: [L, N, bs, H/tp, D] (its scales drop D). The
    rank's own tensor, not a view of a full pool: the kernels read
    contiguous pools."""
    if num_heads % tp:
        raise ValueError(f"num_heads {num_heads} does not split over {tp} ranks")
    return (num_layers, num_blocks, block_size, num_heads // tp, head_dim)
