"""Action distributions in torch — categorical and diagonal gaussian.

Reference: rllib/models/distributions.py + torch_distributions.py (new-stack
Distribution API: from_logits / sample / logp / entropy / kl). The formulas
are the JAX package's (`ray_tpu/rllib/core/distributions.py`) term for term,
so the learner's loss and the runner's sampled log-probabilities agree with
it. Sampling takes an explicit `torch.Generator` on the inputs' device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # Gumbel-max, as jax.random.categorical draws.
        u = torch.rand(self.logits.shape, generator=generator,
                       device=self.logits.device, dtype=self.logits.dtype)
        gumbel = -torch.log(-torch.log(u + 1e-20))
        return torch.argmax(self.logits + gumbel, dim=-1)

    def deterministic_sample(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.logits, -1, actions.long().unsqueeze(-1))[..., 0]

    def entropy(self) -> torch.Tensor:
        probs = torch.exp(self.logits)
        return -torch.sum(probs * self.logits, dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        probs = torch.exp(self.logits)
        return torch.sum(probs * (self.logits - other.logits), dim=-1)


class DiagGaussian:
    """dist_inputs = concat([mean, log_std], dim=-1)."""

    def __init__(self, dist_inputs: torch.Tensor):
        self.mean, self.log_std = torch.chunk(dist_inputs, 2, dim=-1)
        self.std = torch.exp(torch.clamp(self.log_std, -20.0, 2.0))

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def deterministic_sample(self) -> torch.Tensor:
        return self.mean

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        z = (actions - self.mean) / self.std
        return torch.sum(
            -0.5 * z**2 - torch.log(self.std) - 0.5 * math.log(2.0 * math.pi), dim=-1
        )

    def entropy(self) -> torch.Tensor:
        return torch.sum(
            torch.log(self.std) + 0.5 * (1.0 + math.log(2.0 * math.pi)), dim=-1
        )

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        return torch.sum(
            other.log_std
            - self.log_std
            + (self.std**2 + (self.mean - other.mean) ** 2) / (2.0 * other.std**2)
            - 0.5,
            dim=-1,
        )


def get_dist_cls(action_space):
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete

    if isinstance(action_space, Discrete):
        return Categorical
    if isinstance(action_space, Box):
        return DiagGaussian
    raise ValueError(f"No distribution for action space {action_space!r}")


def dist_input_dim(action_space) -> int:
    """Width of the model's action-head output for this space."""
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete

    if isinstance(action_space, Discrete):
        return action_space.n
    if isinstance(action_space, Box):
        return 2 * int(np.prod(action_space.shape))
    raise ValueError(f"No distribution for action space {action_space!r}")
