"""A2C: synchronous advantage actor-critic.

Reference: rllib/algorithms/a2c/a2c.py — the PPO execution skeleton
(parallel rollouts with GAE on the runners, one SGD pass on the learner's
device) with the vanilla policy-gradient loss: no ratio clipping, no KL, a
single pass over each batch.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class A2CConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or A2C)
        self.lr = 1e-3
        self.train_batch_size = 500
        self.num_epochs = 1  # on-policy single pass: the A2C defining trait
        self.minibatch_size = 500
        self.use_kl_loss = False
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5

    def get_default_learner_class(self):
        return A2CLearner


class A2CLearner(Learner):
    """Vanilla PG + value + entropy loss on GAE advantages."""

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        fwd = self.module.forward_train(params, batch)
        dist = self.module.dist_cls(fwd[SampleBatch.ACTION_DIST_INPUTS])
        logp = dist.logp(batch[SampleBatch.ACTIONS])

        # Standardised with the population std, as jnp.std.
        advantages = batch[SampleBatch.ADVANTAGES]
        advantages = (advantages - advantages.mean()) / torch.clamp_min(
            advantages.std(correction=0), 1e-4
        )
        pg_loss = -torch.mean(logp * advantages)
        value = fwd[SampleBatch.VF_PREDS]
        vf_loss = torch.mean((value - batch[SampleBatch.VALUE_TARGETS]) ** 2)
        entropy = torch.mean(dist.entropy())
        total = (
            pg_loss
            + cfg.vf_loss_coeff * vf_loss
            - cfg.entropy_coeff * entropy
        )
        return total, {
            "policy_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
        }


class A2C(PPO):
    config_class = A2CConfig
    # PPO's training_step overlaps sampling with learning, accepting
    # one-iteration-stale fragments because the clipped ratio corrects for
    # them. A2C's vanilla PG has no ratio: keep the base SYNCHRONOUS step
    # so the gradient stays on-policy even with remote runners.
    training_step = Algorithm.training_step
