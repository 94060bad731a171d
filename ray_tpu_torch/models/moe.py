"""Mixture-of-Experts feed-forward (PyTorch).

The port of the reference package's ``MoEMlp``: top-k routing with a static
per-expert capacity, choice-major priority, and the Switch auxiliary losses.
The reference expresses dispatch and combine as dense one-hot einsums over
a [T, E, C] tensor. At GPT-2 125M's training shape (T = 8192 tokens, E = 8,
k = 2, capacity C = 2560) each of those tensors is 335 MB in bf16 and each
dispatch einsum costs more than the experts' own products, so the port
computes the same function by index: the kept (token, choice) pairs are
copied into an [E, C, d] buffer, the two expert products run as batched
matmuls, and each token sums its kept pairs' outputs weighted by the gates.
Every shape is static and nothing waits on the host (no ``.item()``, no
``nonzero()``): a dropped pair goes to a discard slot that is never read.

``moe_mlp_dense`` keeps the reference's dense form; the tests hold the
index form against it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    num_experts_per_tok: int = 2  # top-k routing
    capacity_factor: float = 1.25
    router_z_loss_coef: float = 1e-3
    load_balance_loss_coef: float = 1e-2


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Per-expert slots for a call over `n_tokens` tokens (padding
    included), as the reference computes it."""
    k = min(cfg.num_experts_per_tok, cfg.num_experts)
    return max(1, int(cfg.capacity_factor * n_tokens * k / cfg.num_experts))


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k experts, most probable first. jax.lax.top_k returns
    the lower index first among equal values; a stable descending sort
    gives the same order (torch.topk promises none)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]


def _route(tokens: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, dtype):
    """Routing of [T, d] tokens: (logits [T, E] f32, probs, expert_idx
    [T, k], gates [T, k] in `dtype`, position [T, k], kept [T, k], C)."""
    n_tokens = tokens.shape[0]
    E = cfg.num_experts
    k = min(cfg.num_experts_per_tok, E)
    cap = capacity(cfg, n_tokens)
    # The router is f32 and runs on f32 tokens, whatever the model dtype.
    logits = tokens.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    expert_idx = _top_k(probs, k)
    gate_vals = torch.gather(probs, 1, expert_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # Choice-major positions: every token's first choice is placed before
    # any second choice, so under tight capacity a secondary choice never
    # evicts another token's primary. The running count runs along the
    # inner dim of an [E, k*T] one-hot (a scan along the outer dim of
    # [k*T, E] leaves the card nearly idle).
    choice_major = expert_idx.t().reshape(-1)  # [k*T]
    experts = torch.arange(E, device=tokens.device)[:, None]
    counts = torch.cumsum((choice_major[None, :] == experts).to(torch.int32), dim=1)
    position = counts.gather(0, choice_major[None, :]).view(k, n_tokens).t().long() - 1
    kept = position < cap
    return logits, probs, expert_idx, gate_vals.to(dtype), position, kept, cap


def _aux_losses(logits, probs, expert_idx, cfg: MoEConfig) -> Dict[str, torch.Tensor]:
    """Router z-loss and the Switch load-balancing loss, scaled by their
    coefficients."""
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    top1 = F.one_hot(expert_idx[:, 0], cfg.num_experts).float()
    load = top1.mean(0)
    importance = probs.mean(0)
    balance_loss = cfg.num_experts * torch.sum(load * importance)
    return {
        "router_z_loss": cfg.router_z_loss_coef * z_loss,
        "load_balance_loss": cfg.load_balance_loss_coef * balance_loss,
    }


def _experts(expert_in, w_in, w_out, group=None):
    """[E, C, d] → [E, C, d] through each expert's MLP (tanh GELU). With a
    tensor-parallel `group` the weights are this rank's slice of the MLP
    dim (``w_in``'s columns, ``w_out``'s rows): the second product is a
    partial sum, reduced over the ranks in f32 and cast once, as a single
    device's product accumulates and rounds."""
    h = F.gelu(torch.bmm(expert_in, w_in), approximate="tanh")
    if group is None:
        return torch.bmm(h, w_out)
    partial = torch.bmm(h.float(), w_out.float())
    return group.all_reduce(partial).to(expert_in.dtype)


def moe_mlp(x, router, w_in, w_out, cfg: MoEConfig, dtype, with_stats=False, group=None):
    """The MoE MLP by index. x [b, s, d] → (out [b, s, d] in `dtype`, aux)
    and, with `with_stats`, a third dict of diagnostics (the share of
    (token, choice) pairs dropped at capacity) that no loss reads. Under
    tensor parallelism (`group`) every rank routes the same tokens (the
    router is replicated) and runs its slice of every expert."""
    b, s, d = x.shape
    n_tokens = b * s
    E = cfg.num_experts
    tokens = x.reshape(n_tokens, d)
    logits, probs, expert_idx, gates, position, kept, cap = _route(
        tokens, router, cfg, dtype
    )
    k = expert_idx.shape[1]
    # Each kept pair's slot in the flattened [E * C] buffer; every dropped
    # pair shares the discard slot E * C, which is never read. Kept slots
    # are unique, so each copy below is a gather in the backward pass (no
    # atomics, no sort).
    slot = torch.where(kept, expert_idx * cap + position, E * cap).reshape(-1)  # [T * k]
    pairs = tokens.to(dtype)[:, None, :].expand(n_tokens, k, d).reshape(-1, d)
    buf = pairs.new_zeros((E * cap + 1, d)).index_copy(0, slot, pairs)
    expert_out = _experts(buf[: E * cap].view(E, cap, d), w_in, w_out, group).reshape(E * cap, d)
    # Combine: each slot's token (n_tokens, a row dropped at the end, for an
    # empty slot) and gate (0 for an empty slot). A token sums at most k
    # products; the reference's einsum in the model dtype gives the same:
    # products of two `dtype` values are exact in f32, summed there and
    # rounded once.
    token_ids = torch.arange(n_tokens, device=x.device)[:, None].expand(n_tokens, k)
    source = torch.full((E * cap + 1,), n_tokens, dtype=torch.long, device=x.device)
    source = source.index_copy(0, slot, token_ids.reshape(-1))[: E * cap]
    slot_gate = gates.new_zeros(E * cap + 1).index_copy(0, slot, gates.reshape(-1))
    contrib = expert_out.float() * slot_gate[: E * cap, None].float()
    out = contrib.new_zeros((n_tokens + 1, d)).index_add(0, source, contrib)
    out = out[:n_tokens].to(dtype)
    aux = _aux_losses(logits, probs, expert_idx, cfg)
    out = out.reshape(b, s, d)
    if with_stats:
        return out, aux, {"dropped_share": 1.0 - kept.float().mean()}
    return out, aux


def moe_mlp_dense(x, router, w_in, w_out, cfg: MoEConfig, dtype):
    """The reference's dense form: one-hot dispatch and combine tensors
    [T, E, C] in `dtype` and einsums over them. The plain version the tests
    hold `moe_mlp` against; [T, E, C] is too large for the trained shape."""
    b, s, d = x.shape
    n_tokens = b * s
    E = cfg.num_experts
    tokens = x.reshape(n_tokens, d)
    logits, probs, expert_idx, gates, position, kept, cap = _route(
        tokens, router, cfg, dtype
    )
    dispatch = torch.zeros((n_tokens, E, cap), dtype=dtype, device=x.device)
    combine = torch.zeros_like(dispatch)
    for j in range(expert_idx.shape[1]):
        slot = (
            F.one_hot(expert_idx[:, j], E).to(dtype)[..., None]
            * F.one_hot(torch.clamp(position[:, j], max=cap - 1), cap).to(dtype)[:, None, :]
            * kept[:, j, None, None].to(dtype)
        )
        dispatch = dispatch + slot
        combine = combine + slot * gates[:, j, None, None]
    expert_in = torch.einsum("td,tec->ecd", tokens.to(dtype), dispatch)
    expert_out = _experts(expert_in, w_in, w_out)
    out = torch.einsum("ecd,tec->td", expert_out, combine).reshape(b, s, d)
    return out, _aux_losses(logits, probs, expert_idx, cfg)


class MoEMlp(nn.Module):
    """Drop-in replacement for a dense transformer MLP block. Returns
    (output, aux_losses); the caller folds the aux losses into the training
    objective.

    Parameters keep the reference's layouts and dtypes: ``router`` [d, E]
    in f32, ``w_in`` [E, d, m] and ``w_out`` [E, m, d] in the model dtype
    (bf16 experts in a bf16 model, not f32 masters: the reference creates
    them in its compute dtype). Seeded init: normal(0.02) for all three.
    With a tensor-parallel `group` the experts hold this rank's slice of
    `mlp_dim` (``parallel.LLM_TP_RULES``)."""

    def __init__(self, embed_dim: int, mlp_dim: int, moe: MoEConfig = MoEConfig(),
                 dtype=torch.float32, device=None, group=None):
        super().__init__()
        self.moe = moe
        self.dtype = dtype
        self.group = group if group is not None and group.size > 1 else None
        if self.group is not None:
            mlp_dim //= self.group.size
        E = moe.num_experts
        self.router = nn.Parameter(torch.empty(embed_dim, E, device=device))
        self.w_in = nn.Parameter(
            torch.empty(E, embed_dim, mlp_dim, dtype=dtype, device=device))
        self.w_out = nn.Parameter(
            torch.empty(E, mlp_dim, embed_dim, dtype=dtype, device=device))
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in (self.router, self.w_in, self.w_out):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    def forward(self, x: torch.Tensor, with_stats: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return moe_mlp(x, self.router, self.w_in, self.w_out, self.moe,
                       self.dtype, with_stats=with_stats, group=self.group)
