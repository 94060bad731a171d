"""TD3: twin-delayed deterministic policy gradient (Fujimoto et al. 2018).

Reference: rllib/algorithms/td3/td3.py (DDPG family). Shares SAC's
off-policy skeleton — replay buffer, one loss over one parameter tree with
detached copies isolating each objective, Polyak target networks — with
TD3's three tricks:

  * twin critics, target = min(Q1', Q2')  (overestimation control);
  * target-policy smoothing: clipped Gaussian noise on the target action;
  * delayed policy updates: a step counter in the extra state gates the
    actor objective, and after_update reverts the pi subtree on off ticks
    so Adam's momentum cannot drift it (its moments keep moving, as in the
    JAX package) — the actor genuinely moves only every `policy_delay`-th
    update, when the target networks are Polyak-averaged too.

Exploration: additive Gaussian noise from rllib.utils.exploration. The loss
is a pure function of its noise (`TD3Learner.sample_noise`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithms.sac.sac import (
    SAC,
    SACConfig,
    _BoxActionModule,
    _MLP,
    _mlp,
    detached,
    polyak,
)
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.env import Box
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.utils.exploration import GaussianNoise


class TD3Net(nn.Module):
    """Deterministic policy + twin critics in one parameter tree."""

    def __init__(self, in_dim: int, action_dim: int, hiddens: tuple = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_dim = int(action_dim)
        self.pi = _MLP(in_dim, self.action_dim, hiddens, generator)
        self.q1 = _MLP(in_dim + self.action_dim, 1, hiddens, generator)
        self.q2 = _MLP(in_dim + self.action_dim, 1, hiddens, generator)

    def actor(self, params, obs):
        return torch.tanh(_mlp(params, "pi", self.pi.depth, obs))

    def critic(self, params, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return (_mlp(params, "q1", self.q1.depth, x)[..., 0],
                _mlp(params, "q2", self.q2.depth, x)[..., 0])

    def forward(self, obs):
        return self.actor(dict(self.named_parameters()), obs)


class TD3Module(_BoxActionModule):
    def __init__(self, observation_space, action_space, model_config=None,
                 net=None, seed: int = 0, device="cpu"):
        assert isinstance(action_space, Box), "TD3 needs a continuous space"
        model_config = dict(model_config or {})
        if net is None:
            net = TD3Net(
                in_dim=int(np.prod(observation_space.shape)),
                action_dim=int(np.prod(action_space.shape)),
                hiddens=tuple(model_config.get("fcnet_hiddens", (256, 256))),
                generator=torch.Generator().manual_seed(int(seed)),
            )
        super().__init__(observation_space, action_space, model_config, net, seed, device)
        self._bounds(action_space)
        self.exploration = GaussianNoise(
            initial_scale=float(model_config.get("exploration_scale", 0.1)),
            final_scale=float(model_config.get("exploration_final_scale", 0.1)),
            scale_timesteps=int(model_config.get("exploration_timesteps", 1)),
        )

    def exploration_inputs(self, timestep: int) -> dict:
        return self.exploration.inputs(timestep)

    def forward_exploration(self, params, batch, generator=None) -> dict:
        a = self.net.actor(params, batch[SampleBatch.OBS])
        noise = float(batch.get("noise_scale", 0.1)) * torch.randn(
            a.shape, generator=generator, device=a.device, dtype=a.dtype)
        return {SampleBatch.ACTIONS: self._scale(torch.clamp(a + noise, -1, 1))}

    def forward_inference(self, params, batch) -> dict:
        a = self.net.actor(params, batch[SampleBatch.OBS])
        return {SampleBatch.ACTIONS: self._scale(a)}


class TD3Config(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or TD3)
        self.lr = 1e-3
        self.policy_delay = 2
        self.target_noise = 0.2
        self.target_noise_clip = 0.5

    def get_default_learner_class(self):
        return TD3Learner


class TD3Learner(Learner):
    def build(self) -> None:
        super().build()
        self._pi_snapshot = self._pi_subtree(self.module.params)

    def initial_extra_state(self):
        return {
            "target": {k: v.detach().clone() for k, v in self.module.params.items()},
            "step": 0,
        }

    @staticmethod
    def _pi_subtree(params) -> dict:
        """A copy of the actor's tensors, on their device."""
        return {k: v.detach().clone() for k, v in params.items() if k.startswith("pi.")}

    def sample_noise(self, batch) -> dict:
        """The standard normal of the target-policy smoothing."""
        shape = (batch[SampleBatch.OBS].shape[0], self.module.action_dim)
        return {"target": torch.randn(shape, generator=self._rng, device=self.device)}

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        net = self.module.net
        module = self.module
        obs = batch[SampleBatch.OBS]
        next_obs = batch[SampleBatch.NEXT_OBS]
        actions = module.unscale(batch[SampleBatch.ACTIONS])
        rewards = batch[SampleBatch.REWARDS]
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()
        target = extra["target"]

        # Target-policy smoothing: clipped noise on the target action; no
        # gradient.
        with torch.no_grad():
            next_a = net.actor(target, next_obs)
            noise = torch.clamp(
                cfg.target_noise * rng["target"],
                -cfg.target_noise_clip,
                cfg.target_noise_clip,
            )
            next_a = torch.clamp(next_a + noise, -1.0, 1.0)
            tq1, tq2 = net.critic(target, next_obs, next_a)
            target_q = rewards + cfg.gamma * not_done * torch.minimum(tq1, tq2)
        q1, q2 = net.critic(params, obs, actions)
        critic_loss = torch.mean((q1 - target_q) ** 2) + torch.mean(
            (q2 - target_q) ** 2
        )

        # Delayed deterministic policy gradient: critics detached; the step
        # counter masks the actor objective off between delay ticks.
        a_pi = net.actor(params, obs)
        q1_pi, _ = net.critic(detached(params), obs, a_pi)
        actor_gate = 1.0 if extra["step"] % cfg.policy_delay == 0 else 0.0
        actor_loss = -torch.mean(q1_pi) * actor_gate

        total = critic_loss + actor_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "mean_q": torch.mean(q1),
        }

    def after_update(self, batch) -> None:
        step = self.extra_train_state["step"]  # the update just taken
        params = self.module.params
        target = self.extra_train_state["target"]
        if step % self.config.policy_delay != 0:
            # TRUE delayed policy updates: the gated actor gradient is zero,
            # but Adam momentum would still drift pi — revert the subtree so
            # the actor only moves on delay ticks (reference TD3 skips the
            # actor optimizer step; reverting is the single-optimizer form).
            with torch.no_grad():
                keys = list(self._pi_snapshot)
                torch._foreach_copy_([params[k] for k in keys],
                                     [self._pi_snapshot[k] for k in keys])
        else:
            self._pi_snapshot = self._pi_subtree(params)
            # Target polyak on the same delayed tick (reference pairs the
            # target update with the policy update).
            polyak(target, params, self.config.tau)
        self.extra_train_state = {"target": target, "step": step + 1}


class TD3(SAC):
    """Shares SAC's off-policy skeleton (setup/replay/training_step);
    only the module family and the learner differ."""

    config_class = TD3Config
    module_class = TD3Module
