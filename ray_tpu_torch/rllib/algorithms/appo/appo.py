"""APPO: asynchronous PPO on the IMPALA architecture.

Reference: rllib/algorithms/appo/appo.py (+ appo_learner) — IMPALA's
async sampling/aggregation/learner pipeline, but the policy loss is PPO's
clipped surrogate computed on v-trace-corrected advantages instead of the
plain importance-weighted policy gradient. The surrogate ratio clips
against the BEHAVIOR policy (the rollout's logp), which is what keeps the
update stable when fragments arrive a few weight-versions stale.

Everything but compute_loss is inherited: aggregator tree, learner thread,
bounded feed queue, v-trace, bootstrap handling.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.impala import vtrace
from ray_tpu_torch.rllib.algorithms.impala.impala import (
    IMPALA,
    IMPALAConfig,
    IMPALALearner,
)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or APPO)
        self.clip_param: float = 0.4  # looser than sync PPO (reference default)
        self.use_kl_loss: bool = False
        self.kl_coeff: float = 0.2
        self.kl_target: float = 0.01

    def get_default_learner_class(self):
        return APPOLearner


class APPOLearner(IMPALALearner):
    """Clipped-surrogate loss on v-trace advantages (appo_learner analog)."""

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        T = int(cfg.rollout_fragment_length or 50)
        obs = batch[SampleBatch.OBS]
        N = obs.shape[0] // T

        def tm(x):  # [N*T, ...] -> time-major [T, N, ...]
            return x.reshape((N, T) + tuple(x.shape[1:])).transpose(0, 1)

        fwd = self.module.forward_train(params, batch)
        dist = self.module.dist_cls(fwd[SampleBatch.ACTION_DIST_INPUTS])
        behavior_dist = self.module.dist_cls(
            batch[SampleBatch.ACTION_DIST_INPUTS]
        )
        target_logp = dist.logp(batch[SampleBatch.ACTIONS])
        entropy = dist.entropy()
        values = fwd[SampleBatch.VF_PREDS]

        log_rhos = tm(target_logp - batch[SampleBatch.ACTION_LOGP])
        dones = torch.logical_or(
            batch[SampleBatch.TERMINATEDS], batch[SampleBatch.TRUNCATEDS]
        ).float()
        discounts = tm(cfg.gamma * (1.0 - dones))
        rewards_flat = batch[SampleBatch.REWARDS]
        if SampleBatch.VALUES_BOOTSTRAPPED in batch:
            trunc = batch[SampleBatch.TRUNCATEDS].float()
            rewards_flat = rewards_flat + cfg.gamma * trunc * batch[
                SampleBatch.VALUES_BOOTSTRAPPED
            ]
        rewards = tm(rewards_flat)
        values_tm = tm(values)
        # Bootstrap from V(NEXT_OBS of each fragment's last row), without a
        # gradient.
        next_obs_tm = tm(batch[SampleBatch.NEXT_OBS])
        with torch.no_grad():
            _, bootstrap = self.module.apply(params, next_obs_tm[-1])

        vt = vtrace.from_importance_weights(
            log_rhos=log_rhos,
            discounts=discounts,
            rewards=rewards,
            values=values_tm,
            bootstrap_value=bootstrap,
            clip_rho_threshold=cfg.vtrace_clip_rho_threshold,
            clip_pg_rho_threshold=cfg.vtrace_clip_pg_rho_threshold,
        )

        # PPO clipped surrogate with the ratio against the BEHAVIOR policy
        # and v-trace pg_advantages as the advantage estimate
        # (appo_learner's surrogate; reference appo.py).
        ratio = torch.exp(tm(target_logp) - tm(batch[SampleBatch.ACTION_LOGP]))
        adv = vt.pg_advantages
        surrogate = -torch.mean(
            torch.minimum(
                adv * ratio,
                adv * torch.clamp(
                    ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param
                ),
            )
        )
        vf_loss = 0.5 * torch.mean((values_tm - vt.vs) ** 2)
        entropy_mean = torch.mean(entropy)
        total = (
            surrogate
            + cfg.vf_loss_coeff * vf_loss
            - cfg.entropy_coeff * entropy_mean
        )
        metrics = {
            "policy_loss": surrogate,
            "vf_loss": vf_loss,
            "entropy": entropy_mean,
            "mean_ratio": torch.mean(ratio),
        }
        if cfg.use_kl_loss:
            kl = torch.mean(behavior_dist.kl(dist))
            total = total + cfg.kl_coeff * kl
            metrics["mean_kl"] = kl
        return total, metrics


class APPO(IMPALA):
    config_class = APPOConfig
