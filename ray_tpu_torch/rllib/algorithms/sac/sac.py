"""SAC — soft actor-critic for continuous control.

Reference: rllib/algorithms/sac/ (SACConfig, sac_torch_policy losses: twin-Q
TD targets with entropy, squashed-gaussian actor, auto-tuned alpha). As in
the JAX package, the three objectives are ONE loss over ONE parameter tree
under one Adam: the actor term evaluates the critics on a detached copy of
the parameters (so the gradient reaches pi only through the sampled
action), alpha is detached in the critic target and the actor term, and the
alpha term takes gradient only through `log_alpha`. Target twin critics
live in the learner's extra state with Polyak averaging after each update.

The nets read their weights from a name -> tensor dict (`SACNet.actor`,
`SACNet.critic`), so the online, detached and target parameters go through
the same code without swapping tensors in and out of the module. The loss
is a pure function of its noise: `SACLearner.sample_noise` draws the two
standard normals first from the learner's device generator.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec, _dense
from ray_tpu_torch.rllib.env.spaces import Box
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class _MLP(nn.Module):
    """fc_0 .. fc_{n-1} (relu) and `out`, flax's `_MLP` layer names, each
    initialised as flax's Dense."""

    def __init__(self, in_dim: int, out_dim: int, hiddens: tuple = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = len(hiddens)
        width = in_dim
        for i, w in enumerate(hiddens):
            self.add_module(f"fc_{i}", _dense(width, w, generator=generator))
            width = w
        self.out = _dense(width, out_dim, generator=generator)


def _mlp(params, prefix: str, depth: int, x: torch.Tensor) -> torch.Tensor:
    """The `_MLP` named `prefix` over the weights in `params`."""
    for i in range(depth):
        x = F.relu(F.linear(x, params[f"{prefix}.fc_{i}.weight"],
                            params[f"{prefix}.fc_{i}.bias"]))
    return F.linear(x, params[f"{prefix}.out.weight"], params[f"{prefix}.out.bias"])


def detached(params) -> dict:
    """The parameter dict with every tensor detached (jax.lax.stop_gradient
    of the whole tree): no copy, no gradient."""
    return {k: v.detach() for k, v in params.items()}


class SACNet(nn.Module):
    """Policy + twin critics + log_alpha in one parameter tree, so detached
    copies can isolate each objective inside a single loss."""

    def __init__(self, in_dim: int, action_dim: int, hiddens: tuple = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_dim = int(action_dim)
        self.pi = _MLP(in_dim, 2 * self.action_dim, hiddens, generator)
        self.q1 = _MLP(in_dim + self.action_dim, 1, hiddens, generator)
        self.q2 = _MLP(in_dim + self.action_dim, 1, hiddens, generator)
        self.log_alpha = nn.Parameter(torch.zeros(()))

    def actor(self, params, obs):
        out = _mlp(params, "pi", self.pi.depth, obs)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def critic(self, params, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return (_mlp(params, "q1", self.q1.depth, x)[..., 0],
                _mlp(params, "q2", self.q2.depth, x)[..., 0])

    def forward(self, obs):
        return self.actor(dict(self.named_parameters()), obs)


def _sample_squashed(mean, log_std, noise):
    """Tanh-squashed gaussian sample + log-prob with the change-of-variables
    correction (SAC appendix C), given the standard normal `noise`."""
    std = torch.exp(log_std)
    raw = mean + std * noise
    action = torch.tanh(raw)
    logp = torch.sum(
        -0.5 * ((raw - mean) / std) ** 2 - log_std - 0.5 * math.log(2 * math.pi),
        dim=-1,
    )
    logp = logp - torch.sum(torch.log(1 - action**2 + 1e-6), dim=-1)
    return action, logp


class _BoxActionModule(RLModule):
    """Shared by SAC's and TD3's modules: tanh actions in [-1, 1] scaled to
    the Box's bounds and back."""

    has_value_head = False

    def _bounds(self, action_space) -> None:
        self.action_dim = int(np.prod(action_space.shape))
        self._low = np.array(action_space.low, np.float32)
        self._high = np.array(action_space.high, np.float32)
        self._low_t = torch.from_numpy(self._low).to(self.device)
        self._high_t = torch.from_numpy(self._high).to(self.device)

    def _scale(self, a):
        low, high = self._low_t.to(a.device), self._high_t.to(a.device)
        return low + (a + 1.0) * 0.5 * (high - low)

    def unscale(self, actions):
        low, high = self._low_t.to(actions.device), self._high_t.to(actions.device)
        return torch.clamp(
            (actions - low) / (high - low + 1e-9) * 2.0 - 1.0, -0.999, 0.999
        )

    def forward_train(self, params, batch) -> dict:
        raise NotImplementedError("the learner drives the nets directly")


class SACModule(_BoxActionModule):
    def __init__(self, observation_space, action_space, model_config=None,
                 net=None, seed: int = 0, device="cpu"):
        assert isinstance(action_space, Box), "SAC needs a continuous space"
        model_config = dict(model_config or {})
        if net is None:
            net = SACNet(
                in_dim=int(np.prod(observation_space.shape)),
                action_dim=int(np.prod(action_space.shape)),
                hiddens=tuple(model_config.get("fcnet_hiddens", (256, 256))),
                generator=torch.Generator().manual_seed(int(seed)),
            )
        super().__init__(observation_space, action_space, model_config, net, seed, device)
        # Action scaling tanh[-1,1] -> env bounds.
        self._bounds(action_space)

    def forward_exploration(self, params, batch, generator=None) -> dict:
        mean, log_std = self.net.actor(params, batch[SampleBatch.OBS])
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
        action, logp = _sample_squashed(mean, log_std, noise)
        return {
            SampleBatch.ACTIONS: self._scale(action),
            SampleBatch.ACTION_LOGP: logp,
        }

    def forward_inference(self, params, batch) -> dict:
        mean, _ = self.net.actor(params, batch[SampleBatch.OBS])
        return {SampleBatch.ACTIONS: self._scale(torch.tanh(mean))}


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SAC)
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005  # polyak coefficient for target critics
        self.train_batch_size = 256
        self.initial_alpha = 1.0
        self.target_entropy: Optional[float] = None  # None -> -action_dim
        self.num_steps_sampled_before_learning_starts = 1000
        self.replay_buffer_config = {"capacity": 100_000}
        self.rollout_fragment_length = 1
        self.training_intensity: Optional[float] = None
        self._compute_gae_on_runner = False

    def get_default_learner_class(self):
        return SACLearner


@torch.no_grad()
def polyak(target: dict, online: dict, tau: float) -> None:
    """target = (1 - tau) * target + tau * online over the whole tree, in
    place, in that order of operations (the JAX package's tree_map)."""
    keys = list(online)
    t = [target[k] for k in keys]
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, torch._foreach_mul([online[k].detach() for k in keys], tau))


class SACLearner(Learner):
    def build(self) -> None:
        super().build()
        self._target_entropy = (
            self.config.target_entropy
            if self.config.target_entropy is not None
            else -float(self.module.action_dim)
        )

    def initial_extra_state(self):
        # Target network = a copy of the whole parameter tree.
        return {"target": {k: v.detach().clone() for k, v in self.module.params.items()}}

    def sample_noise(self, batch) -> dict:
        """Standard normals for the next-state action and the actor's fresh
        action (the JAX package's two keys split from one)."""
        shape = (batch[SampleBatch.OBS].shape[0], self.module.action_dim)
        return {k: torch.randn(shape, generator=self._rng, device=self.device)
                for k in ("next", "pi")}

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        net = self.module.net
        module = self.module
        noise = rng
        obs = batch[SampleBatch.OBS]
        next_obs = batch[SampleBatch.NEXT_OBS]
        actions = module.unscale(batch[SampleBatch.ACTIONS])
        rewards = batch[SampleBatch.REWARDS]
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()

        log_alpha = params["log_alpha"]
        alpha = torch.exp(log_alpha)

        # Critic target: min target-Q of next action, entropy-regularized;
        # no gradient.
        with torch.no_grad():
            next_mean, next_log_std = net.actor(params, next_obs)
            next_a, next_logp = _sample_squashed(next_mean, next_log_std, noise["next"])
            tq1, tq2 = net.critic(extra["target"], next_obs, next_a)
            target_q = rewards + cfg.gamma * not_done * (
                torch.minimum(tq1, tq2) - alpha * next_logp
            )
        q1, q2 = net.critic(params, obs, actions)
        critic_loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)

        # Actor: maximize min-Q of fresh actions, the critics evaluated on
        # detached parameters (the single-loss equivalent of a separate
        # actor optimizer).
        mean, log_std = net.actor(params, obs)
        a_pi, logp_pi = _sample_squashed(mean, log_std, noise["pi"])
        q1_pi, q2_pi = net.critic(detached(params), obs, a_pi)
        actor_loss = torch.mean(
            alpha.detach() * logp_pi - torch.minimum(q1_pi, q2_pi)
        )

        # Alpha: match the entropy target (log-prob detached).
        alpha_loss = -torch.mean(
            log_alpha * (logp_pi + self._target_entropy).detach()
        )

        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "mean_q": torch.mean(q1),
        }

    def after_update(self, batch) -> None:
        polyak(self.extra_train_state["target"], self.module.params, self.config.tau)


class SAC(Algorithm):
    config_class = SACConfig
    # Off-policy skeleton hook: subclasses (TD3) swap the module family
    # while sharing setup/replay/training_step.
    module_class = SACModule

    def setup(self, config: dict) -> None:
        cfg = self.algo_config
        if cfg.rl_module_spec is None:
            from ray_tpu_torch.rllib.env.env import make_env

            probe = make_env(cfg.env, cfg.env_config)
            cfg.rl_module_spec = RLModuleSpec(
                module_class=type(self).module_class,
                observation_space=probe.observation_space,
                action_space=probe.action_space,
                model_config=dict(cfg.model),
                seed=cfg.seed or 0,
            )
            probe.close()
        super().setup(config)
        self.replay_buffer = ReplayBuffer(
            capacity=cfg.replay_buffer_config.get("capacity", 100_000),
            seed=cfg.seed,
        )

    def training_step(self) -> dict:
        cfg = self.algo_config
        rollout = self.env_runner_group.sample(
            max(1, cfg.rollout_fragment_length or 1)
        )
        if self._output_writer is not None:
            self._output_writer.write(rollout)
        self.replay_buffer.add(rollout)
        self._env_steps_total += rollout.count
        results = {"replay_buffer_size": len(self.replay_buffer)}
        if self._env_steps_total >= cfg.num_steps_sampled_before_learning_starts:
            intensity = cfg.training_intensity or (1.0 / rollout.count)
            for _ in range(max(1, int(round(intensity * rollout.count)))):
                train_batch = self.replay_buffer.sample(cfg.train_batch_size)
                results.update(self.learner_group.update(train_batch))
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights(),
                global_vars={"timestep": self._env_steps_total},
            )
        return results
