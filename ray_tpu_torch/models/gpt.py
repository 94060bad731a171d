"""GPT-2-style decoder-only transformer (PyTorch).

The port of the reference package's flax GPT with the same configuration
fields, the same generation variants and the same training forward.
Numerics follow the flax model: LayerNorm epsilon 1e-6 with f32 statistics,
the tanh approximation of GELU, every dense product and the embeddings in
``GPTConfig.dtype``, and a tied LM head whose logits stay in that dtype.

Every parameter is stored in f32 and cast to the compute dtype at each use,
as flax's ``nn.Dense`` / ``nn.Embed`` do with their default f32
``param_dtype``: gradients and optimizer updates land on f32 masters, where
a bf16 weight would round most of a small update away. The one exception
is the reference's own: an MoE block's experts are created in the compute
dtype (``models/moe.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.moe import MoEConfig, MoEMlp
from ray_tpu_torch.ops.flash_attention import attention as attention_op
from ray_tpu_torch.ops.flash_attention import flash_attention_packed
from ray_tpu_torch.ops.paged_flash import paged_attention_impl

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # 50257 padded to a multiple of 128
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    max_seq_len: int = 1024
    dropout_rate: float = 0.0
    dtype: Any = torch.bfloat16
    # "flash" (the CUDA kernels: packed at S <= 2048, blockwise above, and
    # the generation prefill), "reference", or "ring" (not ported yet).
    attention_impl: str = "flash"
    # MoE: num_experts=0 keeps dense MLPs; otherwise every `moe_every`-th
    # block swaps its MLP for a MoEMlp.
    num_experts: int = 0
    moe_every: int = 2
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def gpt2_125m(**overrides) -> "GPTConfig":
    return GPTConfig(**overrides)


def gpt2_350m(**overrides) -> "GPTConfig":
    return GPTConfig(num_layers=24, num_heads=16, embed_dim=1024, **overrides)


def gpt2_760m(**overrides) -> "GPTConfig":
    return GPTConfig(num_layers=24, num_heads=20, embed_dim=1280, **overrides)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(dtype=...): f32 params and statistics, output in
    the compute dtype."""

    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.weight.shape, self.weight, self.bias, LN_EPS
        )
        return y.to(self.dtype)


class Dense(nn.Linear):
    """flax nn.Dense(dtype=...): f32 params; input, kernel and bias cast to
    the compute dtype at each use."""

    def __init__(self, in_features: int, out_features: int, dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    @torch.no_grad()
    def cast_for_inference(self) -> None:
        self.to(self.dtype)


class Embed(nn.Embedding):
    """flax nn.Embed(dtype=...): an f32 table, rows cast to the compute
    dtype (gathering first and casting the rows gives the same values as
    casting the table)."""

    def __init__(self, num: int, dim: int, dtype, device=None):
        super().__init__(num, dim, device=device)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The tied LM head: x @ table^T in the compute dtype."""
        return F.linear(x, self.weight.to(self.dtype))


class Block(nn.Module):
    """One transformer block. With a tensor-parallel `group` (size tp > 1)
    the block holds its rank's heads and MLP columns (Megatron's layout,
    ``parallel.LLM_TP_RULES``): ``attn_qkv`` and ``mlp_in`` column-parallel,
    ``attn_proj`` and ``mlp_out`` row-parallel, each of those two followed
    by one all-reduce; attention runs on the rank's H / tp heads."""

    def __init__(self, config: GPTConfig, use_moe: bool = False, device=None, group=None):
        super().__init__()
        cfg = config
        self.config = cfg
        e, dt = cfg.embed_dim, cfg.dtype
        self.tp = group.size if group is not None else 1
        self.num_heads = cfg.num_heads // self.tp  # this rank's heads
        if self.tp > 1:
            from ray_tpu_torch.parallel.tensor_parallel import (
                ColumnParallelDense,
                RowParallelDense,
            )

            column = lambda i, o: ColumnParallelDense(i, o, dt, device, self.tp)
            row = lambda i, o: RowParallelDense(i, o, dt, device, group)
        else:
            column = row = lambda i, o: Dense(i, o, dt, device)
        # Creation order is the parameter order the seeded init draws in.
        self.ln_1 = LayerNorm(e, dt, device)
        self.attn_qkv = column(e, 3 * e)
        self.attn_proj = row(e, e)
        self.ln_2 = LayerNorm(e, dt, device)
        self.use_moe = use_moe
        if use_moe:
            self.moe_mlp = MoEMlp(
                e, cfg.mlp_ratio * e,
                MoEConfig(
                    num_experts=cfg.num_experts,
                    num_experts_per_tok=cfg.num_experts_per_tok,
                    capacity_factor=cfg.moe_capacity_factor,
                ),
                dtype=dt, device=device, group=group,
            )
        else:
            self.mlp_in = column(e, cfg.mlp_ratio * e)
            self.mlp_out = row(cfg.mlp_ratio * e, e)

    def _heads(self, qkv: torch.Tensor):
        """q, k, v [B, S, H, D] views of the packed projection (this rank's
        heads under tensor parallelism)."""
        b, s, _ = qkv.shape
        d = self.config.head_dim
        return [
            t.view(b, s, self.num_heads, d)
            for t in qkv.split(self.num_heads * d, dim=-1)
        ]

    def forward(
        self,
        x: torch.Tensor,
        *,
        return_kv: bool = False,
        paged_state: Optional[tuple] = None,
        paged_impl: str = "reference",
        return_aux: bool = False,
    ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]], dict]:
        """Returns (x, kv, intermediates): kv is this layer's (k, v)
        [B, S, H, D] for the fed tokens on the generation paths, else None;
        intermediates holds an MoE block's aux losses (``moe_aux``) and
        routing diagnostics (``moe_stats``) when `return_aux` is set."""
        cfg = self.config
        h = self.ln_1(x)
        b, s, _ = h.shape
        qkv = self.attn_qkv(h)
        kv = None
        if return_kv or paged_state is not None:
            # Generation paths: full prefill returns the prompt's K/V for
            # the caller to scatter into the paged cache; decode (s == 1)
            # and partial prefill (s > 1) attend over the cache through the
            # block table — paged over the cached prefix, causal among the
            # fed tokens — and return the new K/V.
            q, k, v = self._heads(qkv)
            if paged_state is not None:
                (k_cache_l, v_cache_l, block_tables, context_lens,
                 k_scale_l, v_scale_l) = paged_state
                # The paged kernel takes dense new-token K/V.
                k, v = k.contiguous(), v.contiguous()
                attn = paged_attention_impl(
                    q, k_cache_l, v_cache_l, block_tables, context_lens,
                    new_k=k, new_v=v, k_scale=k_scale_l, v_scale=v_scale_l,
                    impl=paged_impl,
                )
            else:
                impl = (
                    "reference"
                    if cfg.attention_impl == "ring"
                    else cfg.attention_impl
                )
                attn = attention_op(q, k, v, causal=True, impl=impl)
            kv = (k, v)
        elif cfg.attention_impl == "ring":
            raise NotImplementedError(
                "ring attention is not ported yet (ROADMAP §B: the parallel "
                "layer and ring attention slice)"
            )
        elif cfg.attention_impl == "flash" and s <= 2048:
            # The packed kernels (K6 forward, K7 backward) take the
            # projection output as it is; dqkv comes back packed.
            attn = flash_attention_packed(qkv, self.num_heads, causal=True)
        else:
            # Long context: the blockwise kernels (K2 forward; K4 / K5
            # backward), or the full-matrix reference.
            q, k, v = self._heads(qkv)
            attn = attention_op(q, k, v, causal=True, impl=cfg.attention_impl)
        attn = self.attn_proj(attn.reshape(b, s, self.num_heads * cfg.head_dim))
        x = x + attn
        h = self.ln_2(x)
        inter = {}
        if self.use_moe:
            if return_aux:
                h, aux, stats = self.moe_mlp(h, with_stats=True)
                inter = {"moe_aux": (aux,), "moe_stats": stats}
            else:
                h, _ = self.moe_mlp(h)
        else:
            h = F.gelu(self.mlp_in(h), approximate="tanh")
            h = self.mlp_out(h)
        return x + h, kv, inter


class GPT(nn.Module):
    """GPT-2 decoder. ``device`` defaults to CUDA and raises without it;
    tests pass ``device="cpu"``. Weights are seeded from a torch.Generator
    (normal(0.02) for dense kernels and wte, normal(0.01) for wpe, zeros
    for biases) — deterministic per seed, though not the reference's
    jax.random numbers: parity tests load converted reference weights.

    With a tensor-parallel `group` (a ``parallel.RankGroup`` of size > 1)
    the model is that rank's shard: its blocks hold their slices of the
    split weights. A seeded shard is the seeded full model's slice (drawn
    on the CPU at full size, then sliced), so every tp serves the same
    weights; `init=False` skips that for a caller that loads weights next.
    Only rank 0 computes the final layernorm and the LM head: the other
    ranks' forward returns None for the logits."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0,
                 group=None, init: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        tp = group.size if group is not None else 1
        self.tp_rank = group.rank if tp > 1 else 0
        self.wte = Embed(cfg.vocab_size, cfg.embed_dim, cfg.dtype, device)
        self.wpe = Embed(cfg.max_seq_len, cfg.embed_dim, cfg.dtype, device)
        self.h = nn.ModuleList(
            Block(cfg, use_moe=bool(
                cfg.num_experts and i % cfg.moe_every == cfg.moe_every - 1
            ), device=device, group=group if tp > 1 else None)
            for i in range(cfg.num_layers)
        )
        self.ln_f = LayerNorm(cfg.embed_dim, cfg.dtype, device)
        if tp == 1:
            self.reset_parameters(seed)
        elif init:
            from ray_tpu_torch.parallel.sharding import llm_shard_params

            full = GPT(cfg, device="cpu", seed=seed).state_dict()
            self.load_state_dict(llm_shard_params(full, self.tp_rank, tp))

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if isinstance(self.get_submodule(name.rsplit(".", 1)[0]), LayerNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                std = 0.01 if name.startswith("wpe") else 0.02
                p.copy_(torch.randn(p.shape, generator=gen) * std)

    @torch.no_grad()
    def cast_for_inference(self) -> "GPT":
        """Cast the dense layers and embeddings to the compute dtype once,
        for a model that serves and is never updated: the per-use casts
        become no-ops with the same values. LayerNorm parameters stay f32,
        as its statistics are f32; so does an MoE router (its experts are
        in the compute dtype already). A row-parallel layer keeps f32
        holding the compute dtype's values (``parallel.RowParallelDense``)."""
        for module in self.modules():
            if isinstance(module, Dense):
                module.cast_for_inference()
            elif isinstance(module, Embed):
                module.to(self.config.dtype)
        return self

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        return_kv: bool = False,
        paged_caches: Optional[tuple] = None,
        paged_impl: str = "reference",
        return_aux: bool = False,
    ):
        """Forward pass: tokens [B, S] → bf16 (model dtype) logits [B, S, V].

        Generation variants (same parameters):
          * ``return_kv=True`` also returns each layer's (k, v) [B, S, H, D]
            for the fed tokens: ``(logits, kvs)``.
          * ``paged_caches=(k_cache, v_cache, block_tables, context_lens)``
            or ``(..., k_scale, v_scale)``: k/v_cache are [L, N, bs, H, D]
            paged pools (int8 pools carry [L, N, bs, H] scales); attention
            reads the cached prefix through the block table and runs
            causally over the fed tokens, through the CUDA kernel when
            ``paged_impl`` resolves to it. ``positions`` [B, S] must carry
            each token's absolute position.
          * ``return_aux=True`` also returns the intermediates of the MoE
            blocks, ``{"h_{i}": {"moe_aux": (aux,), "moe_stats": {...}}}``,
            last in the tuple: pass them to :func:`collect_moe_losses`.
        """
        cfg = self.config
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None, :]
        x = self.wte(tokens.long()) + self.wpe(positions.long())
        if paged_caches is not None:
            if len(paged_caches) == 4:  # no scale tensors
                paged_caches = tuple(paged_caches) + (None, None)
            (k_cache, v_cache, block_tables, context_lens,
             k_scale, v_scale) = paged_caches
        kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        intermediates = {}
        for i, block in enumerate(self.h):
            paged_state = None
            if paged_caches is not None:
                paged_state = (
                    k_cache[i], v_cache[i], block_tables, context_lens,
                    None if k_scale is None else k_scale[i],
                    None if v_scale is None else v_scale[i],
                )
            x, kv, inter = block(
                x, return_kv=return_kv, paged_state=paged_state,
                paged_impl=paged_impl, return_aux=return_aux,
            )
            kvs.append(kv)
            if inter:
                intermediates[f"h_{i}"] = inter
        if self.tp_rank > 0:
            logits = None  # only rank 0 samples
        else:
            x = self.ln_f(x)
            # Tied LM head: logits through the embedding matrix in the
            # model dtype (bf16 logits, as in the reference; argmax runs
            # on these).
            logits = self.wte.attend(x)
        out = (logits,) + ((kvs,) if return_kv else ()) + (
            (intermediates,) if return_aux else ())
        return out if len(out) > 1 else logits


def cross_entropy_loss(logits, targets, mask: Optional[torch.Tensor] = None):
    """Token-level LM loss. logits [B,S,V], targets [B,S] int; computed as
    logsumexp(logits) - logits[target] in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def collect_moe_losses(intermediates: Any) -> torch.Tensor:
    """Sum the MoE aux losses in the intermediates that
    ``GPT.forward(..., return_aux=True)`` returns (the reference's sown
    ``intermediates`` collection has the same form). Only ``moe_aux``
    entries are summed: other diagnostics must never leak into the
    training objective."""

    def leaves(node: Any):
        if isinstance(node, dict):
            for sub in node.values():
                yield from leaves(sub)
        elif isinstance(node, (tuple, list)):
            for sub in node:
                yield from leaves(sub)
        else:
            yield node

    def collect(node: Any, total: torch.Tensor) -> torch.Tensor:
        if isinstance(node, dict):
            for key, sub in node.items():
                if key == "moe_aux":
                    for leaf in leaves(sub):
                        total = total + torch.as_tensor(leaf, dtype=torch.float32)
                else:
                    total = collect(sub, total)
        return total

    return collect(intermediates, torch.zeros((), dtype=torch.float32))
