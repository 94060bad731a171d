"""Advantage estimation (GAE) on numpy trajectories.

Reference: rllib/evaluation/postprocessing.py:89 compute_advantages, :154
compute_gae_for_sample_batch. Runs on the CPU EnvRunner right after a rollout
(per-episode), so the learner-side jitted loss sees precomputed advantage /
value-target columns with static shapes.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def discount_cumsum(x: np.ndarray, gamma: float) -> np.ndarray:
    out = np.empty_like(x, dtype=np.float32)
    acc = 0.0
    for i in range(len(x) - 1, -1, -1):
        acc = x[i] + gamma * acc
        out[i] = acc
    return out


def compute_advantages(
    rollout: SampleBatch,
    last_r: float,
    gamma: float = 0.99,
    lambda_: float = 1.0,
    use_gae: bool = True,
    use_critic: bool = True,
) -> SampleBatch:
    """Append ADVANTAGES and VALUE_TARGETS to one episode's batch."""
    rewards = np.asarray(rollout[SampleBatch.REWARDS], dtype=np.float32)
    if use_gae:
        assert SampleBatch.VF_PREDS in rollout, "GAE needs value predictions"
        vpred = np.asarray(rollout[SampleBatch.VF_PREDS], dtype=np.float32)
        vpred_t = np.concatenate([vpred, np.array([last_r], dtype=np.float32)])
        delta_t = rewards + gamma * vpred_t[1:] - vpred_t[:-1]
        advantages = discount_cumsum(delta_t, gamma * lambda_)
        rollout[SampleBatch.ADVANTAGES] = advantages
        rollout[SampleBatch.VALUE_TARGETS] = (advantages + vpred).astype(np.float32)
    else:
        rewards_plus_v = np.concatenate(
            [rewards, np.array([last_r], dtype=np.float32)]
        )
        discounted = discount_cumsum(rewards_plus_v, gamma)[:-1]
        if use_critic:
            vpred = np.asarray(rollout[SampleBatch.VF_PREDS], dtype=np.float32)
            rollout[SampleBatch.ADVANTAGES] = discounted - vpred
            rollout[SampleBatch.VALUE_TARGETS] = discounted
        else:
            rollout[SampleBatch.ADVANTAGES] = discounted
            rollout[SampleBatch.VALUE_TARGETS] = np.zeros_like(discounted)
    return rollout


def compute_gae_for_sample_batch(
    batch: SampleBatch,
    gamma: float = 0.99,
    lambda_: float = 1.0,
    use_gae: bool = True,
    use_critic: bool = True,
) -> SampleBatch:
    """Per-episode GAE over a (possibly multi-episode) batch. The bootstrap
    value for a truncated episode must already be in VALUES_BOOTSTRAPPED
    (written by the env runner from the final observation's value estimate);
    terminated episodes bootstrap with 0."""
    episodes = batch.split_by_episode()
    out = []
    for ep in episodes:
        terminated = bool(np.asarray(ep[SampleBatch.TERMINATEDS])[-1])
        if terminated:
            last_r = 0.0
        elif SampleBatch.VALUES_BOOTSTRAPPED in ep:
            last_r = float(np.asarray(ep[SampleBatch.VALUES_BOOTSTRAPPED])[-1])
        else:
            last_r = float(np.asarray(ep[SampleBatch.VF_PREDS])[-1])
        out.append(compute_advantages(ep, last_r, gamma, lambda_, use_gae, use_critic))
    result = SampleBatch.concat_samples(out)
    return result
