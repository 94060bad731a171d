"""Off-policy estimators: evaluate a target policy on logged behavior data.

Reference: rllib/offline/off_policy_estimator.py (+ estimators/
importance_sampling.py, weighted_importance_sampling.py). Logged batches
must carry the behavior policy's action log-probs (SampleBatch.ACTION_LOGP,
recorded by every exploration forward here) and episode ids; the estimator
scores a TARGET policy via `target_logp_fn(obs, actions) -> logp` without
running it in the environment:

  * IS  — per-episode cumulative importance ratios weight the rewards
          (unbiased, high variance);
  * WIS — ratios are normalized by their per-timestep population mean
          (biased, much lower variance; the reference's default).

Both also report V_behavior (the logged returns) so improvement is read
directly from the gap.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class OffPolicyEstimator:
    """Base: accumulate per-episode estimates over logged batches."""

    def __init__(
        self,
        target_logp_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
        gamma: float = 0.99,
        logp_clip: float = 20.0,
    ):
        self.target_logp_fn = target_logp_fn
        self.gamma = gamma
        self.logp_clip = logp_clip
        self._episodes: List[dict] = []

    # -- accumulation -------------------------------------------------------

    def process(self, batch: SampleBatch) -> None:
        if SampleBatch.ACTION_LOGP not in batch:
            raise ValueError(
                "off-policy estimation needs behavior ACTION_LOGP in the "
                "logged batch (record rollouts with exploration forwards)"
            )
        for ep in batch.split_by_episode():
            obs = np.asarray(ep[SampleBatch.OBS])
            actions = np.asarray(ep[SampleBatch.ACTIONS])
            rewards = np.asarray(ep[SampleBatch.REWARDS], dtype=np.float64)
            behavior_logp = np.asarray(
                ep[SampleBatch.ACTION_LOGP], dtype=np.float64
            )
            target_logp = np.asarray(
                self.target_logp_fn(obs, actions), dtype=np.float64
            )
            delta = np.clip(
                target_logp - behavior_logp, -self.logp_clip, self.logp_clip
            )
            # Cumulative importance ratio rho_t = prod_{t'<=t} pi/beta.
            rho = np.exp(np.cumsum(delta))
            discounts = self.gamma ** np.arange(len(rewards))
            self._episodes.append(
                {
                    "rho": rho,
                    "disc_rewards": discounts * rewards,
                    "v_behavior": float(np.sum(discounts * rewards)),
                }
            )

    # -- estimates ----------------------------------------------------------

    def estimate(self) -> Dict[str, float]:
        raise NotImplementedError

    def _check(self) -> None:
        if not self._episodes:
            raise ValueError("no episodes processed")


class ImportanceSampling(OffPolicyEstimator):
    """Per-decision IS: V = E_ep[ sum_t gamma^t rho_t r_t ]."""

    def estimate(self) -> Dict[str, float]:
        self._check()
        v_target = [
            float(np.sum(ep["rho"] * ep["disc_rewards"]))
            for ep in self._episodes
        ]
        v_behavior = [ep["v_behavior"] for ep in self._episodes]
        return {
            "v_behavior": float(np.mean(v_behavior)),
            "v_target": float(np.mean(v_target)),
            "v_gain": float(np.mean(v_target))
            / max(abs(float(np.mean(v_behavior))), 1e-9),
            "v_target_std": float(np.std(v_target)),
            "num_episodes": len(self._episodes),
        }


class WeightedImportanceSampling(OffPolicyEstimator):
    """Per-decision WIS: rho_t is normalized by the mean rho_t across
    episodes still alive at step t (Precup 2000; the reference's
    weighted_importance_sampling.py)."""

    def estimate(self) -> Dict[str, float]:
        self._check()
        max_len = max(len(ep["rho"]) for ep in self._episodes)
        # Per-timestep population mean of rho over episodes that reach t.
        sums = np.zeros(max_len)
        counts = np.zeros(max_len)
        for ep in self._episodes:
            t = len(ep["rho"])
            sums[:t] += ep["rho"]
            counts[:t] += 1.0
        w_mean = sums / np.maximum(counts, 1.0)
        w_mean = np.where(w_mean <= 0.0, 1.0, w_mean)
        v_target = []
        for ep in self._episodes:
            t = len(ep["rho"])
            v_target.append(
                float(np.sum((ep["rho"] / w_mean[:t]) * ep["disc_rewards"]))
            )
        v_behavior = [ep["v_behavior"] for ep in self._episodes]
        return {
            "v_behavior": float(np.mean(v_behavior)),
            "v_target": float(np.mean(v_target)),
            "v_gain": float(np.mean(v_target))
            / max(abs(float(np.mean(v_behavior))), 1e-9),
            "v_target_std": float(np.std(v_target)),
            "num_episodes": len(self._episodes),
        }


def estimate_from_reader(
    estimator: OffPolicyEstimator, reader, num_batches: int = 10
) -> Dict[str, float]:
    """Feed `num_batches` from a JsonReader (or any .next() source) through
    the estimator and return its estimate."""
    for _ in range(num_batches):
        estimator.process(reader.next())
    return estimator.estimate()
