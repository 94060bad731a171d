"""BC — behavior cloning from offline data.

Reference: rllib/algorithms/bc/ (BCConfig; trains the policy head with
negative log-likelihood on logged actions, no environment interaction). The
simplest member of the offline family and the end-to-end proof of the offline
IO path: JsonReader batches (on the host) → the NLL update on the learner's
device → (optional) evaluation rollouts with the learned policy.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BC)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.bc_logstd_coeff = 0.0
        self._compute_gae_on_runner = False

    def get_default_learner_class(self):
        return BCLearner


class BCLearner(Learner):
    def compute_loss(self, params, batch, rng, extra=None):
        module = self.module
        fwd = module.forward_train(params, batch)
        dist = module.dist_cls(fwd[SampleBatch.ACTION_DIST_INPUTS])
        logp = dist.logp(batch[SampleBatch.ACTIONS])
        loss = -torch.mean(logp)
        return loss, {"bc_nll": loss, "entropy": torch.mean(dist.entropy())}


class BC(Algorithm):
    config_class = BCConfig

    def setup(self, config: dict) -> None:
        cfg = self.algo_config
        if not cfg.input_:
            raise ValueError("BC needs offline data: config.offline_data(input_=dir)")
        super().setup(config)
        self.reader = JsonReader(cfg.input_, seed=cfg.seed)

    def training_step(self) -> dict:
        cfg = self.algo_config
        train_batch = self.reader.sample_rows(cfg.train_batch_size)
        results = self.learner_group.update(train_batch)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return dict(results)
