"""DQN — off-policy Q-learning with replay and a target network.

Reference: rllib/algorithms/dqn/dqn.py (DQNConfig, training_step with
store→sample→train→target-sync loop) and dqn_torch_policy loss (double-Q,
huber TD). The target network rides the Learner's `extra_train_state`: a
copy of the online parameters on the learner's device, and a target sync
copies them there again. Epsilon-greedy exploration enters the runner's
forward as an input computed from a host-side linear schedule.

An update is one step over the sampled batch; its per-sample TD errors
(prioritized replay's new priorities) leave the card with the scalar
metrics in one copy an update, the only wait on the card DQN's loop has.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, to_device_batch
from ray_tpu_torch.rllib.core.rl_module import QNet, RLModule, RLModuleSpec
from ray_tpu_torch.rllib.env.spaces import Discrete
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.utils.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)


class DQNModule(RLModule):
    """Q-network module: greedy inference, epsilon-greedy exploration."""

    has_value_head = False

    def __init__(self, observation_space, action_space, model_config=None,
                 net=None, seed: int = 0, device="cpu"):
        assert isinstance(action_space, Discrete), "DQN needs a Discrete space"
        model_config = dict(model_config or {})
        if net is None:
            net = QNet(
                in_dim=int(np.prod(observation_space.shape)),
                num_actions=action_space.n,
                hiddens=tuple(model_config.get("fcnet_hiddens", (256, 256))),
                dueling=bool(model_config.get("dueling", False)),
                generator=torch.Generator().manual_seed(int(seed)),
            )
        super().__init__(observation_space, action_space, model_config, net, seed, device)
        from ray_tpu_torch.rllib.utils.exploration import EpsilonGreedy

        self.exploration = EpsilonGreedy(
            epsilon_initial=float(model_config.get("epsilon_initial", 1.0)),
            epsilon_final=float(model_config.get("epsilon_final", 0.05)),
            epsilon_timesteps=int(
                model_config.get("epsilon_timesteps", 10_000)
            ),
            schedule=model_config.get("epsilon_schedule", "linear"),
        )

    def exploration_inputs(self, timestep: int) -> dict:
        return self.exploration.inputs(timestep)

    def forward_train(self, params, batch) -> dict:
        return {"q_values": self.apply(params, batch[SampleBatch.OBS])}

    def forward_exploration(self, params, batch, generator=None) -> dict:
        q = self.apply(params, batch[SampleBatch.OBS])
        greedy = torch.argmax(q, dim=-1)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < float(batch["epsilon"])
        random_actions = torch.randint(0, q.shape[-1], greedy.shape,
                                       generator=generator, device=q.device)
        return {SampleBatch.ACTIONS: torch.where(explore, random_actions, greedy)}

    def forward_inference(self, params, batch) -> dict:
        q = self.apply(params, batch[SampleBatch.OBS])
        return {SampleBatch.ACTIONS: torch.argmax(q, dim=-1)}


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.gamma = 0.99
        self.target_network_update_freq = 500  # env steps
        self.num_steps_sampled_before_learning_starts = 1000
        self.replay_buffer_config = {
            "type": "ReplayBuffer",
            "capacity": 50_000,
            "alpha": 0.6,
            "beta": 0.4,
        }
        self.double_q = True
        self.n_step = 1
        self.training_intensity: Optional[float] = None  # updates per env step
        self.epsilon = [1.0, 0.05]
        self.epsilon_timesteps = 10_000
        self.rollout_fragment_length = 4
        self._compute_gae_on_runner = False

    def get_default_learner_class(self):
        return DQNLearner

    def get_rollout_fragment_length(self) -> int:
        return self.rollout_fragment_length or 4


class DQNLearner(Learner):
    def initial_extra_state(self):
        # Target network starts as a copy of the online params.
        return {"target": {k: v.detach().clone() for k, v in self.module.params.items()}}

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        module = self.module
        q_all = module.apply(params, batch[SampleBatch.OBS])
        actions = batch[SampleBatch.ACTIONS].long()
        q_sel = torch.gather(q_all, -1, actions[:, None])[:, 0]

        with torch.no_grad():
            q_next_target = module.apply(extra["target"], batch[SampleBatch.NEXT_OBS])
            if cfg.double_q:
                q_next_online = module.apply(params, batch[SampleBatch.NEXT_OBS])
                # torch.argmax takes the first maximum, as jnp.argmax does.
                best = torch.argmax(q_next_online, dim=-1)
                q_next = torch.gather(q_next_target, -1, best[:, None])[:, 0]
            else:
                q_next = torch.max(q_next_target, dim=-1).values

        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()
        # n-step transitions carry their own per-row discount (windows near
        # episode ends are shorter than n); 1-step batches fall back to gamma.
        discount = batch.get("nstep_discount")
        if discount is None:
            discount = cfg.gamma
        target = batch[SampleBatch.REWARDS] + discount * not_done * q_next
        td_error = q_sel - target
        huber = torch.where(
            torch.abs(td_error) < 1.0,
            0.5 * td_error**2,
            torch.abs(td_error) - 0.5,
        )
        weights = batch.get("weights")
        loss = torch.mean(huber * weights) if weights is not None else torch.mean(huber)
        return loss, {
            "qf_mean": torch.mean(q_sel),
            "td_error_abs": torch.mean(torch.abs(td_error)),
            # Per-sample TD errors for prioritized replay; popped host-side.
            "td_error": td_error,
        }

    def update(self, batch) -> dict:
        """Single-pass update keeping per-sample TD errors (for priority
        updates) out of the scalar metric averaging. The scalars and the TD
        errors come to the host in one copy."""
        assert self._built
        metrics = self._sgd_step(to_device_batch(batch, self.device))
        td = metrics.pop("td_error")
        names = list(metrics)
        host = torch.cat([torch.stack([metrics[k].float() for k in names]),
                          td.float()]).cpu().numpy()
        out = {k: float(v) for k, v in zip(names, host[: len(names)])}
        out["td_error_per_sample"] = host[len(names):]
        return out

    @torch.no_grad()
    def sync_target(self) -> None:
        """Copy the online parameters into the target, on the device."""
        target = self.extra_train_state["target"]
        torch._foreach_copy_([target[k] for k in self.module.params],
                             list(self.module.params.values()))


def n_step_transitions(batch: SampleBatch, n: int, gamma: float) -> SampleBatch:
    """Rewrite 1-step rows into n-step ones: REWARDS become the discounted
    n-step sum, NEXT_OBS/TERMINATEDS come from the window's last step, and
    "nstep_discount" carries gamma^window (windows shrink at episode ends).
    Reference: rllib/utils/replay_buffers/utils.py (n-step adjustment applied
    before adding to the buffer)."""
    if n <= 1:
        return batch
    episodes = []
    for ep in batch.split_by_episode():
        T = ep.count
        rewards = np.asarray(ep[SampleBatch.REWARDS], dtype=np.float32)
        terms = np.asarray(ep[SampleBatch.TERMINATEDS])
        next_obs = np.asarray(ep[SampleBatch.NEXT_OBS])
        new_r = np.empty(T, np.float32)
        new_disc = np.empty(T, np.float32)
        new_next = np.empty_like(next_obs)
        new_term = np.empty(T, bool)
        for t in range(T):
            acc, g = 0.0, 1.0
            end = t
            for k in range(t, min(t + n, T)):
                acc += g * rewards[k]
                g *= gamma
                end = k
                if terms[k]:
                    break
            new_r[t] = acc
            new_disc[t] = g
            new_next[t] = next_obs[end]
            new_term[t] = terms[end]
        ep[SampleBatch.REWARDS] = new_r
        ep[SampleBatch.NEXT_OBS] = new_next
        ep[SampleBatch.TERMINATEDS] = new_term
        ep["nstep_discount"] = new_disc
        episodes.append(ep)
    return SampleBatch.concat_samples(episodes)


class DQN(Algorithm):
    config_class = DQNConfig

    def setup(self, config: dict) -> None:
        cfg = self.algo_config
        # Epsilon schedule flows to runners via the module spec's model config.
        model = dict(cfg.model)
        eps = cfg.epsilon if isinstance(cfg.epsilon, (list, tuple)) else [cfg.epsilon, cfg.epsilon]
        model.setdefault("epsilon_initial", eps[0])
        model.setdefault("epsilon_final", eps[-1])
        model.setdefault("epsilon_timesteps", cfg.epsilon_timesteps)
        cfg.model = model
        if cfg.rl_module_spec is None:
            # Build spaces from a probe env so the spec uses DQNModule.
            from ray_tpu_torch.rllib.env.env import make_env

            probe = make_env(cfg.env, cfg.env_config)
            cfg.rl_module_spec = RLModuleSpec(
                module_class=DQNModule,
                observation_space=probe.observation_space,
                action_space=probe.action_space,
                model_config=model,
                seed=cfg.seed or 0,
            )
            probe.close()
        super().setup(config)
        self.replay_buffer = self._make_replay_buffer()
        self._steps_since_target_sync = 0

    def _make_replay_buffer(self):
        """Local replay construction; Ape-X overrides this to None (its
        replay lives in shard actors, so allocating a full-capacity local
        priorities array here would be pure waste)."""
        cfg = self.algo_config
        buf_cfg = dict(cfg.replay_buffer_config)
        buf_type = buf_cfg.pop("type", "ReplayBuffer")
        if buf_type in ("PrioritizedReplayBuffer", "prioritized"):
            return PrioritizedReplayBuffer(
                capacity=buf_cfg.get("capacity", 50_000),
                alpha=buf_cfg.get("alpha", 0.6),
                beta=buf_cfg.get("beta", 0.4),
                seed=cfg.seed,
            )
        return ReplayBuffer(
            capacity=buf_cfg.get("capacity", 50_000), seed=cfg.seed
        )

    def training_step(self) -> dict:
        cfg = self.algo_config
        rollout = self.env_runner_group.sample(cfg.get_rollout_fragment_length())
        if self._output_writer is not None:
            self._output_writer.write(rollout)
        self.replay_buffer.add(
            n_step_transitions(rollout, cfg.n_step, cfg.gamma)
        )
        self._env_steps_total += rollout.count
        self._steps_since_target_sync += rollout.count

        results = {"replay_buffer_size": len(self.replay_buffer)}
        if self._env_steps_total >= cfg.num_steps_sampled_before_learning_starts:
            # Updates per sampled step; default one update per rollout.
            intensity = cfg.training_intensity or (1.0 / rollout.count)
            num_updates = max(1, int(round(intensity * rollout.count)))
            for _ in range(num_updates):
                train_batch = self.replay_buffer.sample(cfg.train_batch_size)
                metrics = self.learner_group.update(train_batch)
                # Local learners return "td_error_per_sample"; remote-learner
                # mode concatenates the loss's "td_error" array across shards.
                td = metrics.pop("td_error_per_sample", None)
                if td is None:
                    td = metrics.pop("td_error", None)
                if td is not None and isinstance(
                    self.replay_buffer, PrioritizedReplayBuffer
                ):
                    idx = np.asarray(train_batch["batch_indexes"])[: len(td)]
                    self.replay_buffer.update_priorities(idx, td)
                results.update(
                    {k: v for k, v in metrics.items() if np.ndim(v) == 0}
                )
            if self._steps_since_target_sync >= cfg.target_network_update_freq:
                self.learner_group.foreach_learner("sync_target")
                self._steps_since_target_sync = 0
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights(),
                global_vars={"timestep": self._env_steps_total},
            )
        return results
