"""V-trace off-policy correction (IMPALA, Espeholt et al. 2018).

Reference: rllib/algorithms/impala/vtrace_torch.py (from_importance_weights).
Time-major [T, B] inputs; the recursion over time is a reverse loop over T
(the JAX package's reversed lax.scan). Neither output carries a gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor  # [T, B] value targets
    pg_advantages: torch.Tensor  # [T, B] policy-gradient advantages


@torch.no_grad()
def from_importance_weights(
    log_rhos: torch.Tensor,  # [T, B] log(pi_target / pi_behavior)
    discounts: torch.Tensor,  # [T, B] gamma * (1 - done)
    rewards: torch.Tensor,  # [T, B]
    values: torch.Tensor,  # [T, B] V(s_t) under the target policy
    bootstrap_value: torch.Tensor,  # [B] V(s_{T})
    clip_rho_threshold: float = 1.0,
    clip_pg_rho_threshold: float = 1.0,
) -> VTraceReturns:
    rhos = torch.exp(log_rhos)
    clipped_rhos = torch.clamp_max(rhos, clip_rho_threshold)
    cs = torch.clamp_max(rhos, 1.0)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)

    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    decay = discounts * cs
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + decay[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = torch.clamp_max(rhos, clip_pg_rho_threshold)
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values
    )
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
