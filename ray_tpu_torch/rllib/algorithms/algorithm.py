"""Algorithm + AlgorithmConfig — the user-facing training surface.

Reference: rllib/algorithms/algorithm.py:757 (step → training_step) and
algorithm_config.py (fluent AlgorithmConfig). Algorithm is a Tune `Trainable`
(the port's, `ray_tpu_torch.tune.trainable`), so `algo.train()`,
`Tuner(algo_cls, param_space=config)` and checkpointing all come from the
same protocol the reference uses (tune/trainable/trainable.py:350).

Devices: the learner runs on `learners(device=...)`, "cuda" by default; the
env runners sample on `env_runners(sample_device=...)`, "cpu" by default.
Naming CUDA without it raises at build time; nothing falls back to another
device. Multi-agent training and offline IO are not ported yet and raise.
"""

from __future__ import annotations

import copy
from typing import Any, Optional, Type

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.evaluation.worker_set import EnvRunnerGroup
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.tune.trainable import Trainable


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ray_tpu_torch.rllib trains single-agent "
        "PPO and IMPALA from sampled envs (ROADMAP.md §B9)"
    )


class AlgorithmConfig:
    """Fluent config object; `.environment().env_runners().training()` chains
    (reference: algorithm_config.py). Copy-on-build: `build()` freezes a deep
    copy into the Algorithm."""

    algo_class: Optional[type] = None

    def __init__(self, algo_class: Optional[type] = None):
        if algo_class is not None:
            self.algo_class = algo_class
        # environment
        self.env: Any = None
        self.env_config: dict = {}
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.num_cpus_per_env_runner: float = 1
        self.rollout_fragment_length: Optional[int] = None
        self.restart_failed_env_runners: bool = True
        self.observation_filter: Optional[str] = None  # "MeanStdFilter"
        self.sample_device: str = "cpu"
        # training
        self.gamma: float = 0.99
        self.lr: float = 5e-4
        self.train_batch_size: int = 4000
        self.minibatch_size: Optional[int] = None
        self.num_epochs: int = 1
        self.grad_clip: Optional[float] = None
        self.model: dict = {}
        # learners
        self.num_learners: int = 0
        self.num_cpus_per_learner: float = 1
        self.num_gpus_per_learner: float = 0
        self.learner_device: str = "cuda"
        # multi-agent and offline IO (not ported: their setters raise)
        self.policies: Optional[dict] = None
        self.output: Optional[str] = None
        self.input_: Optional[str] = None
        # debugging / reproducibility
        self.seed: Optional[int] = 0
        # internal
        self.rl_module_spec: Optional[RLModuleSpec] = None
        self._compute_gae_on_runner: bool = False

    # -- fluent setters ---------------------------------------------------

    def environment(self, env=None, *, env_config: Optional[dict] = None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(
        self,
        *,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        num_cpus_per_env_runner: Optional[float] = None,
        restart_failed_env_runners: Optional[bool] = None,
        observation_filter: Optional[str] = None,
        sample_device: Optional[str] = None,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_cpus_per_env_runner is not None:
            self.num_cpus_per_env_runner = num_cpus_per_env_runner
        if restart_failed_env_runners is not None:
            self.restart_failed_env_runners = restart_failed_env_runners
        if observation_filter is not None:
            self.observation_filter = observation_filter
        if sample_device is not None:
            self.sample_device = sample_device
        return self

    def offline_data(self, *, input_=None, output=None) -> "AlgorithmConfig":
        raise _not_ported("offline_data() (rllib/offline: JsonWriter, JsonReader)")

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"Unknown training config {k!r}")
            setattr(self, k, v)
        return self

    def multi_agent(
        self,
        *,
        policies: Optional[Any] = None,
        policy_mapping_fn: Optional[Any] = None,
    ) -> "AlgorithmConfig":
        raise _not_ported("multi_agent() (per-policy modules and multi-agent runners)")

    def learners(
        self,
        *,
        num_learners: Optional[int] = None,
        num_cpus_per_learner: Optional[float] = None,
        num_gpus_per_learner: Optional[float] = None,
        device: Optional[str] = None,
    ) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if num_cpus_per_learner is not None:
            self.num_cpus_per_learner = num_cpus_per_learner
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        if device is not None:
            self.learner_device = device
        return self

    def rl_module(self, *, rl_module_spec: Optional[RLModuleSpec] = None) -> "AlgorithmConfig":
        self.rl_module_spec = rl_module_spec
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # -- build ------------------------------------------------------------

    def get_rollout_fragment_length(self) -> int:
        if self.rollout_fragment_length:
            return self.rollout_fragment_length
        runners = max(1, self.num_env_runners)
        return max(1, self.train_batch_size // (runners * self.num_envs_per_env_runner))

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        return {
            k: v for k, v in vars(self).items() if not k.startswith("__")
        }

    def update_from_dict(self, d: dict) -> "AlgorithmConfig":
        for k, v in d.items():
            setattr(self, k, v)
        return self

    def build(self, env=None) -> "Algorithm":
        if env is not None:
            self.env = env
        assert self.algo_class is not None, "config has no algo_class"
        return self.algo_class(config=self.copy())

    # Learner/spec hooks overridden per algorithm --------------------------

    def get_default_learner_class(self) -> Type[Learner]:
        raise NotImplementedError

    def get_learner_slice_unit(self) -> int:
        """Row-group size that must not be split when sharding a train batch
        across remote learners (fragment-structured losses override)."""
        return 1

    def build_learner_group(self, spec: RLModuleSpec) -> LearnerGroup:
        learner_cls = self.get_default_learner_class()
        cfg = self

        def builder():
            return learner_cls(spec, config=cfg)

        return LearnerGroup(
            builder,
            num_learners=self.num_learners,
            num_cpus_per_learner=self.num_cpus_per_learner,
            num_gpus_per_learner=self.num_gpus_per_learner,
            slice_unit=self.get_learner_slice_unit(),
        )


class Algorithm(Trainable):
    """Tune-trainable RL algorithm driving EnvRunnerGroup + LearnerGroup."""

    config_class: Type[AlgorithmConfig] = AlgorithmConfig

    def __init__(self, config: Optional[Any] = None, env=None, **kwargs):
        if isinstance(config, dict):
            cfg = self.config_class()
            cfg.update_from_dict(config)
            config = cfg
        elif config is None:
            config = self.config_class()
        if env is not None:
            config.env = env
        self.algo_config = config
        super().__init__(config=config.to_dict(), **kwargs)

    # -- Trainable protocol -----------------------------------------------

    def setup(self, config: dict) -> None:
        cfg = self.algo_config
        if cfg.policies:
            raise _not_ported("policies (per-policy multi-agent training)")
        if cfg.output or cfg.input_:
            raise _not_ported("offline IO (output=, input_=)")
        # Both devices are checked before any actor starts: a missing one
        # raises here, never after a fallback.
        resolve_device(cfg.learner_device)
        resolve_device(cfg.sample_device)
        # Always keep a local runner — it serves spaces, evaluation and
        # compute_single_action even when sampling is all-remote (reference:
        # WorkerSet always builds a local worker, worker_set.py:80).
        self.env_runner_group = EnvRunnerGroup(cfg, local=True)
        obs_space, act_space = self.env_runner_group.local_runner.spaces()
        spec = cfg.rl_module_spec or RLModuleSpec(
            observation_space=obs_space,
            action_space=act_space,
            model_config=dict(cfg.model),
            seed=cfg.seed or 0,
        )
        cfg.rl_module_spec = spec
        self.learner_group = cfg.build_learner_group(spec)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self._env_steps_total = 0

    def step(self) -> dict:
        results = self.training_step()
        metrics = self.env_runner_group.collect_metrics()
        results.update(metrics)
        results["num_env_steps_sampled_lifetime"] = self._env_steps_total
        return results

    def training_step(self) -> dict:
        """Default on-policy skeleton: sample → update → sync weights
        (reference algorithm.py training_step default)."""
        cfg = self.algo_config
        batches = []
        count = 0
        while count < cfg.train_batch_size:
            batch = self.env_runner_group.sample(cfg.get_rollout_fragment_length())
            batches.append(batch)
            count += batch.count
        train_batch = concat_samples(batches)
        self._env_steps_total += train_batch.count
        learner_results = self.learner_group.update(train_batch)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights(),
            global_vars={"timestep": self._env_steps_total},
        )
        return dict(learner_results)

    # -- checkpointing -----------------------------------------------------

    def save_checkpoint(self) -> Optional[dict]:
        return {
            "learner": self.learner_group.get_state(),
            # Policies trained on normalized observations are garbage without
            # their filter stats; restore must bring them back together.
            "obs_filter": self.env_runner_group.get_filter_state(),
        }

    def load_checkpoint(self, state: Optional[dict]) -> None:
        if state:
            self.learner_group.set_state(state["learner"])
            self.env_runner_group.set_filter_state(state.get("obs_filter"))
            self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def cleanup(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.shutdown()

    # -- convenience -------------------------------------------------------

    def get_module(self, module_id: Optional[str] = None):
        if not self.learner_group.is_local:
            return None
        return self.learner_group.local_learner.module

    def compute_single_action(self, obs, explore: bool = False):
        """Serving-style single-action inference (reference algorithm.py
        compute_single_action) on the local runner; explore=True samples
        with the runner's torch generator."""
        runner = self.env_runner_group.local_runner
        assert runner is not None
        obs = runner.transform_obs(np.asarray(obs, dtype=np.float32)[None])
        if explore:
            out = runner.explore(obs, self._env_steps_total)
        else:
            module = runner.module
            with torch.no_grad():
                out = module.forward_inference(
                    module.params,
                    {SampleBatch.OBS: torch.from_numpy(obs).to(module.device)},
                )
        return out[SampleBatch.ACTIONS].cpu().numpy()[0]
