"""CQL: conservative Q-learning from offline data (Kumar et al. 2020).

Reference: rllib/algorithms/cql/cql.py — SAC's actor/twin-critic machinery
trained purely from a logged dataset, with the conservative regularizer

    alpha_cql * E_s[ logsumexp_a Q(s, a) - Q(s, a_data) ]

pushing Q down on out-of-distribution actions (sampled from the uniform
prior and the current policy) and up on dataset actions. Reuses SACLearner's
entire loss; only the penalty and the offline data source differ. The 2n
action sets go through the twin critics as one batched call over
[2n·B, obs + act] rows (the JAX package vmaps the critic over them).
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.sac.sac import (
    SACConfig,
    SACLearner,
    SACModule,
    _sample_squashed,
)
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or CQL)
        self.cql_alpha = 1.0
        self.num_cql_actions = 4  # OOD samples per source (uniform + policy)
        self.num_steps_sampled_before_learning_starts = 0

    def get_default_learner_class(self):
        return CQLLearner


class CQLLearner(SACLearner):
    def sample_noise(self, batch) -> dict:
        """SAC's two normals, the uniform action sets and the standard
        normals of the policy's action sets, each [n, B, act]."""
        noise = super().sample_noise(batch)
        shape = (self.config.num_cql_actions, batch[SampleBatch.OBS].shape[0],
                 self.module.action_dim)
        noise["uniform"] = torch.empty(shape, device=self.device).uniform_(
            -1.0, 1.0, generator=self._rng)
        noise["policy"] = torch.randn(shape, generator=self._rng, device=self.device)
        return noise

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        total, metrics = super().compute_loss(params, batch, rng, extra)

        net = self.module.net
        module = self.module
        obs = batch[SampleBatch.OBS]
        data_actions = module.unscale(batch[SampleBatch.ACTIONS])
        B = obs.shape[0]

        # OOD action set: uniform over the action cube + fresh policy
        # samples. The penalty trains the CRITICS only: the policy samples
        # come from detached params (reference CQL detaches them), else
        # minimizing logsumexp Q(s, a_pi) would push the actor toward
        # low-Q actions and fight the SAC actor objective.
        with torch.no_grad():
            mean, log_std = net.actor(params, obs)
            policy_acts = _sample_squashed(mean, log_std, rng["policy"])[0]
        ood = torch.cat([rng["uniform"], policy_acts], dim=0)  # [2n, B, A]
        m = ood.shape[0]
        obs_rep = obs.unsqueeze(0).expand((m,) + tuple(obs.shape)).reshape(m * B, -1)
        q1, q2 = net.critic(params, obs_rep, ood.reshape(m * B, -1))
        ood_q = torch.stack([q1.reshape(m, B), q2.reshape(m, B)], dim=1)  # [2n, 2, B]
        data_q = torch.stack(net.critic(params, obs, data_actions))  # [2, B]
        # logsumexp over the action samples, per critic, per state.
        lse = torch.logsumexp(ood_q, dim=0) - math.log(m)
        cql_penalty = torch.mean(lse - data_q)
        total = total + cfg.cql_alpha * cql_penalty
        metrics = dict(metrics)
        metrics["cql_penalty"] = cql_penalty
        return total, metrics


class CQL(Algorithm):
    config_class = CQLConfig

    def setup(self, config: dict) -> None:
        cfg = self.algo_config
        if not cfg.input_:
            raise ValueError(
                "CQL needs offline data: config.offline_data(input_=dir)"
            )
        if cfg.rl_module_spec is None:
            from ray_tpu_torch.rllib.env.env import make_env

            probe = make_env(cfg.env, cfg.env_config)
            cfg.rl_module_spec = RLModuleSpec(
                module_class=SACModule,
                observation_space=probe.observation_space,
                action_space=probe.action_space,
                model_config=dict(cfg.model),
                seed=cfg.seed or 0,
            )
            probe.close()
        super().setup(config)
        self.reader = JsonReader(cfg.input_, seed=cfg.seed)

    def training_step(self) -> dict:
        cfg = self.algo_config
        train_batch = self.reader.sample_rows(cfg.train_batch_size)
        results = dict(self.learner_group.update(train_batch))
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return results
