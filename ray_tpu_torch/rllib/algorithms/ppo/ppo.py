"""PPO — clipped-surrogate policy optimization.

Reference: rllib/algorithms/ppo/ppo.py:394 (PPOConfig), :420 (training_step)
and the new-stack loss (ppo/torch/ppo_torch_learner.py compute_loss_for_module).
PPOLearner's loss runs in torch on the learner's device; GAE runs on the env
runners (postprocessing.py) so the learner sees ready advantage columns.
"""

from __future__ import annotations

import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch, concat_samples


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or PPO)
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 30
        self.lambda_ = 0.95
        self.use_gae = True
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.use_kl_loss = True
        self.grad_clip = None
        self._compute_gae_on_runner = True

    def get_default_learner_class(self):
        return PPOLearner


class PPOLearner(Learner):
    def build(self) -> None:
        super().build()
        self._kl_coeff = float(getattr(self.config, "kl_coeff", 0.2))

    def program_constants(self) -> dict:
        # The JAX package bakes the KL coefficient into the update program it
        # caches per update shape and never re-traces it, so the loss keeps
        # the coefficient in force at that shape's first update while
        # `_kl_coeff` goes on adapting (ROADMAP.md §D18, kept for parity).
        return {"kl_coeff": self._kl_coeff}

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        module = self.module
        fwd = module.forward_train(params, batch)
        dist = module.dist_cls(fwd[SampleBatch.ACTION_DIST_INPUTS])
        old_dist = module.dist_cls(batch[SampleBatch.ACTION_DIST_INPUTS])
        logp = dist.logp(batch[SampleBatch.ACTIONS])
        logp_ratio = torch.exp(logp - batch[SampleBatch.ACTION_LOGP])

        # Per-minibatch advantage standardization (reference:
        # rllib/utils/sgd.py standardized() applied in ppo training_step);
        # the population std, as jnp.std.
        advantages = batch[SampleBatch.ADVANTAGES]
        advantages = (advantages - advantages.mean()) / torch.clamp_min(
            advantages.std(correction=0), 1e-4
        )
        surrogate = -torch.minimum(
            advantages * logp_ratio,
            advantages
            * torch.clamp(logp_ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param),
        )

        value_fn_out = fwd[SampleBatch.VF_PREDS]
        vf_err = (value_fn_out - batch[SampleBatch.VALUE_TARGETS]) ** 2
        vf_loss = torch.clamp(vf_err, 0.0, cfg.vf_clip_param)

        entropy = dist.entropy()
        kl = old_dist.kl(dist)

        total = torch.mean(
            surrogate
            + cfg.vf_loss_coeff * vf_loss
            - cfg.entropy_coeff * entropy
        )
        if cfg.use_kl_loss:
            constants = self._constants or {}
            total = total + constants.get("kl_coeff", self._kl_coeff) * torch.mean(kl)
        metrics = {
            "policy_loss": torch.mean(surrogate),
            "vf_loss": torch.mean(vf_loss),
            "entropy": torch.mean(entropy),
            "mean_kl": torch.mean(kl),
        }
        return total, metrics

    def after_update(self, batch) -> None:
        """Adaptive KL coefficient (reference ppo.py update_kl: 1.5x/0.5x
        thresholds around kl_target). As in the JAX package it reads the
        previous update's KL (`update` records it after this hook ran)."""
        cfg = self.config
        if not getattr(cfg, "use_kl_loss", False):
            return
        kl = self._last_mean_kl if hasattr(self, "_last_mean_kl") else None
        if kl is None:
            return
        if kl > 2.0 * cfg.kl_target:
            self._kl_coeff *= 1.5
        elif kl < 0.5 * cfg.kl_target:
            self._kl_coeff *= 0.5

    def update(self, batch) -> dict:
        out = super().update(batch)
        self._last_mean_kl = out.get("mean_kl")
        return out


class PPO(Algorithm):
    """PPO with sampling/learning overlap: remote runners keep producing
    the NEXT iteration's fragments while the learner runs SGD on the
    current batch (reference: ppo.py training_step's
    `AsyncRequestsManager`-era overlap + the IMPALA feed pattern). Actor
    call ordering makes the staleness exactly one iteration — a re-armed
    sample() is queued ahead of the post-update set_weights(), so its
    fragments carry the previous weights' ACTION_LOGP, which is what the
    clipped importance ratio is for."""

    config_class = PPOConfig

    def training_step(self) -> dict:
        cfg = self.algo_config
        group = self.env_runner_group
        runners = group.remote_runners()
        if not runners:
            return super().training_step()  # local-only: nothing to overlap
        frag = cfg.get_rollout_fragment_length()
        inflight: dict = getattr(self, "_inflight_samples", {})
        # Arm every runner without a pending request (first iteration and
        # replacements after failures).
        for idx, runner in runners.items():
            if idx not in inflight:
                inflight[idx] = runner.sample.remote(frag)
        batches: list = []
        count = 0
        while count < cfg.train_batch_size and inflight:
            by_ref = {ref: idx for idx, ref in inflight.items()}
            ready, _ = ray_tpu_torch.wait(
                list(inflight.values()), num_returns=1, timeout=300.0
            )
            if not ready:
                raise RuntimeError("env runners produced no fragments in 300s")
            for ref in ready:
                idx = by_ref[ref]
                del inflight[idx]
                try:
                    batch = ray_tpu_torch.get(ref, timeout=60.0)
                except Exception:
                    group.handle_failures([idx])
                    continue
                batches.append(batch)
                count += batch.count
                # Re-arm immediately: this fragment (for the NEXT iteration)
                # samples while the learner below runs SGD on this one.
                runner = group.remote_runners().get(idx)
                if runner is not None:
                    inflight[idx] = runner.sample.remote(frag)
            # Replacements for failed runners get armed next loop pass.
            for idx, runner in group.remote_runners().items():
                if idx not in inflight:
                    inflight[idx] = runner.sample.remote(frag)
        self._inflight_samples = inflight
        if not batches:
            raise RuntimeError("All env runners failed to sample")
        train_batch = concat_samples(batches)
        self._env_steps_total += train_batch.count
        learner_results = self.learner_group.update(train_batch)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights(),
            global_vars={"timestep": self._env_steps_total},
        )
        return dict(learner_results)
