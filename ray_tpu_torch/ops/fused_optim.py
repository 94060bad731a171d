"""AdamW with decoupled weight decay, computed the way the reference's
``fused_adamw`` computes it (its ``init`` / ``update`` / ``apply`` API).

The "pytree" is a mapping of parameter name → tensor, e.g.
``dict(model.named_parameters())``. The moments are f32 from step 0, and
each update is computed in f32 and cast to its parameter's dtype:
    mu' = b1 mu + (1 - b1) g
    nu' = b2 nu + (1 - b2) g²
    p'  = p - lr (mu'/c1 / (sqrt(nu'/c2) + eps) + wd p)
with c1 = 1 - b1^t and c2 = 1 - b2^t in f32. The decay term sits inside the
learning-rate product, which is not ``torch.optim.AdamW``'s order of
operations.

In place for the parameters only: ``apply`` writes the new values into the
given parameter tensors (under ``torch.no_grad()``) and returns them, so a
training step keeps one copy of the weights. The optimizer state is
functional, as in the reference: ``apply`` and ``update`` return new
moments and leave the state passed in as it was, so a step may be retried
from an earlier state. The
pass is plain PyTorch (``torch._foreach_*``), as the reference leaves it to
XLA: the reference has no kernel here.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch

Params = Mapping[str, torch.Tensor]


class FusedAdamWState(NamedTuple):
    count: torch.Tensor  # int32 step counter (a host scalar: no device sync)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class FusedOptimizer(NamedTuple):
    init: Callable
    update: Callable
    apply: Callable


def fused_adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> FusedOptimizer:
    """AdamW with decoupled weight decay, one pass over every parameter."""

    def init(params: Params) -> FusedAdamWState:
        # f32 moments from step 0, whatever the parameters' dtype.
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return FusedAdamWState(
            count=torch.zeros((), dtype=torch.int32),
            mu=zeros,
            nu={k: torch.zeros_like(z) for k, z in zeros.items()},
        )

    @torch.no_grad()
    def apply(grads: Params, state: FusedAdamWState, params: Params):
        count = state.count + 1
        # Bias corrections in f32, as the reference computes them.
        t = count.to(torch.float32)
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        names = list(grads)
        p = [params[k] for k in names]
        g32 = [grads[k].float() for k in names]
        p32 = [x.float() for x in p]
        # New moment tensors: the state passed in stays as it was.
        mu = torch._foreach_mul([state.mu[k] for k in names], b1)
        torch._foreach_add_(mu, g32, alpha=1.0 - b1)
        nu = torch._foreach_mul([state.nu[k] for k in names], b2)
        torch._foreach_addcmul_(nu, g32, g32, value=1.0 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        torch._foreach_add_(step, p32, alpha=weight_decay)
        torch._foreach_mul_(step, -learning_rate)
        new = torch._foreach_add(p32, step)
        for dst, src in zip(p, new):
            dst.copy_(src)  # cast to the parameter's dtype
        return params, FusedAdamWState(
            count=count, mu=dict(zip(names, mu)), nu=dict(zip(names, nu))
        )

    def update(grads: Params, state: FusedAdamWState, params: Optional[Params] = None):
        """(updates, state) with updates = new_params - params; `params`
        and `state` themselves are left as they are."""
        if params is None:
            raise ValueError("fused_adamw.update requires params")
        new, state = apply(grads, state, {k: p.detach().clone() for k, p in params.items()})
        return {k: new[k] - params[k].detach() for k in new}, state

    return FusedOptimizer(init=init, update=update, apply=apply)
