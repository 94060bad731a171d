"""EnvRunner — the rollout worker of the new stack.

Reference: rllib/evaluation/rollout_worker.py:166 (sample :666) and the
single-agent env-runner loop (evaluation/sampler.py:144 _env_runner,
env_runner_v2.py:199), batched-first: B sub-envs stepped in lockstep, one
forward_exploration call per env step over the [B, obs] stack.

Rollouts run on the host: the numpy environments step there, and for the
stock module the policy's forward is the numpy fast path (the JAX package's
own, so the same weights and seeds give the same SampleBatch). Any other
module runs its torch forward on the runner's `sample_device` ("cpu" by
default; "cuda" puts it on the card) with a `torch.Generator` seeded as the
JAX package seeds its key. A device that is not there raises: the runner
never falls back to another.

Produces SampleBatches with [T*B] rows grouped per sub-env, eps_id marking
episode boundaries, and VALUES_BOOTSTRAPPED carrying V(s_next) at truncation /
fragment cuts so GAE bootstraps correctly (postprocessing.py).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env import make_vector_env
from ray_tpu_torch.rllib.env.spaces import Box
from ray_tpu_torch.rllib.evaluation.postprocessing import compute_gae_for_sample_batch
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class EnvRunner:
    """Plain class; wrapped as an actor by EnvRunnerGroup (so it can also run
    locally inside the Algorithm for `num_env_runners=0`)."""

    def __init__(self, config, worker_index: int = 0):
        self.config = config
        self.worker_index = worker_index
        num_envs = max(1, int(getattr(config, "num_envs_per_env_runner", 1)))
        env_cfg = getattr(config, "env_config", None) or {}
        # Natively-vectorized env when registered (one fused numpy step for
        # all sub-envs), SyncVectorEnv wrapping otherwise.
        self.vector_env = make_vector_env(
            config.env, num_envs, env_cfg, worker_index=worker_index
        )
        self.num_envs = num_envs
        spec = RLModuleSpec(
            observation_space=self.vector_env.observation_space,
            action_space=self.vector_env.action_space,
            model_config=dict(getattr(config, "model", None) or {}),
            seed=(getattr(config, "seed", 0) or 0) + worker_index,
        )
        if getattr(config, "rl_module_spec", None) is not None:
            spec = config.rl_module_spec
        # Rollout inference runs on the host by default: envs are CPU-bound
        # and a device round trip per env step would dominate sampling. The
        # learner alone owns the card. sample_device="cuda" puts the forward
        # there for accelerator-heavy policies; it raises without CUDA.
        device_kind = getattr(config, "sample_device", "cpu") or "cpu"
        self._device = resolve_device(device_kind)
        self.module = spec.build(device=self._device)
        self._has_vf = getattr(self.module, "has_value_head", True)
        seed = (getattr(config, "seed", 0) or 0) * 10007 + worker_index
        self._generator = torch.Generator(device=self._device).manual_seed(seed)
        # Pure-numpy rollout fast path (stock module on a CPU sampling
        # host): no torch dispatch per env step.
        self._np_explore = None
        self._np_value = None
        if self._device.type == "cpu":
            self._np_explore = self.module.np_exploration_fn()
            self._np_value = self.module.np_value_fn()
        self._np_rng = np.random.default_rng(seed ^ 0x5EED)
        self._obs, _ = self.vector_env.reset(seed=seed)
        self._eps_id = np.arange(num_envs, dtype=np.int64) + num_envs * worker_index * 1_000_000
        self._next_eps = self._eps_id.max() + 1
        self._ep_return = np.zeros(num_envs, dtype=np.float64)
        self._ep_len = np.zeros(num_envs, dtype=np.int64)
        self._episode_returns: list[float] = []
        self._episode_lengths: list[int] = []
        self._steps_sampled = 0
        self._global_timestep = 0  # cluster-wide env steps, pushed by the algo
        self._is_continuous = isinstance(self.vector_env.action_space, Box)
        from ray_tpu_torch.rllib.connectors import make_observation_filter

        self.obs_filter = make_observation_filter(
            getattr(config, "observation_filter", None),
            self.vector_env.observation_space.shape,
        )

    # -- the torch forward ---------------------------------------------------

    def explore(self, obs: np.ndarray, timestep: int) -> dict:
        """forward_exploration on the runner's device with its generator;
        outputs stay on that device."""
        fwd_in = {SampleBatch.OBS: torch.from_numpy(obs).to(self._device)}
        # Module-specific exploration knobs (epsilon etc.) enter the forward
        # as inputs; schedules tick on the cluster-wide step count.
        fwd_in.update(self.module.exploration_inputs(timestep))
        with torch.no_grad():
            return self.module.forward_exploration(
                self.module.params, fwd_in, self._generator
            )

    # -- sampling ----------------------------------------------------------

    def sample(self, num_steps: Optional[int] = None) -> SampleBatch:
        """Collect `num_steps` env steps per sub-env (rollout fragment)."""
        T = int(
            num_steps
            or getattr(self.config, "rollout_fragment_length", None)
            or 200
        )
        B = self.num_envs
        cols: dict[str, list] = defaultdict(list)
        # Torch path: per-step forward outputs other than the actions stay
        # on the device during the loop and are copied once per fragment.
        dev_cols: dict[str, list] = defaultdict(list)
        use_np = self._np_explore is not None
        for _ in range(T):
            obs = self._obs.astype(np.float32)
            if self.obs_filter is not None:
                # Rows store FILTERED observations: the learner must see the
                # same inputs the policy acted on.
                obs = self.obs_filter(obs, update=True)
            if use_np:
                fwd = self._np_explore(obs, self._np_rng)
                actions = np.asarray(fwd[SampleBatch.ACTIONS])
            else:
                fwd = self.explore(obs, max(self._global_timestep, self._steps_sampled))
                # The env step needs host actions — this copy is the step
                # boundary itself.
                actions = fwd[SampleBatch.ACTIONS].cpu().numpy()
            env_actions = actions
            if self._is_continuous:
                env_actions = np.clip(
                    actions,
                    self.vector_env.action_space.low,
                    self.vector_env.action_space.high,
                )
            next_obs, rewards, terms, truncs, infos = self.vector_env.step(env_actions)
            cols[SampleBatch.OBS].append(obs)
            cols[SampleBatch.ACTIONS].append(actions)
            cols[SampleBatch.REWARDS].append(rewards)
            cols[SampleBatch.TERMINATEDS].append(terms)
            cols[SampleBatch.TRUNCATEDS].append(truncs)
            for key_, val in fwd.items():
                if key_ == SampleBatch.ACTIONS:
                    continue
                (cols if use_np else dev_cols)[key_].append(val)
            # NEXT_OBS must be the transition's true successor state: at
            # done steps the vector env auto-reset, so substitute the final
            # observation (replay-based TD targets and V-trace bootstraps
            # read this column across truncation boundaries).
            done = terms | truncs
            if done.any():
                next_obs_rec = next_obs.copy()
                for i in np.nonzero(done)[0]:
                    fin = infos[i].get("final_observation")
                    if fin is not None:
                        next_obs_rec[i] = fin
            else:
                next_obs_rec = next_obs
            next_obs_rec = next_obs_rec.astype(np.float32)
            if self.obs_filter is not None:
                next_obs_rec = self.obs_filter(next_obs_rec, update=False)
            cols[SampleBatch.NEXT_OBS].append(next_obs_rec)
            cols[SampleBatch.EPS_ID].append(self._eps_id.copy())
            if self._has_vf:
                # Truncation bootstrap: V(final_observation) where trunc hit.
                boot = np.zeros(B, dtype=np.float32)
                if truncs.any():
                    finals = np.stack(
                        [
                            np.asarray(
                                infos[i].get("final_observation", next_obs[i]),
                                dtype=np.float32,
                            )
                            for i in range(B)
                        ]
                    )
                    if self.obs_filter is not None:
                        finals = self.obs_filter(finals, update=False)
                    boot = np.where(truncs, self._values(finals), 0.0).astype(
                        np.float32
                    )
                cols[SampleBatch.VALUES_BOOTSTRAPPED].append(boot)

            self._ep_return += rewards
            self._ep_len += 1
            for i in np.nonzero(done)[0]:
                self._episode_returns.append(float(self._ep_return[i]))
                self._episode_lengths.append(int(self._ep_len[i]))
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
                self._eps_id[i] = self._next_eps
                self._next_eps += 1
            self._obs = next_obs
        # One stacked device->host copy per forward output for the whole
        # fragment.
        for key_, vals in dev_cols.items():
            cols[key_] = list(torch.stack(vals).cpu().numpy())
        # Fragment cut: running episodes bootstrap from V(current obs).
        running = ~(cols[SampleBatch.TERMINATEDS][-1] | cols[SampleBatch.TRUNCATEDS][-1])
        if self._has_vf and running.any():
            cut_obs = self._obs.astype(np.float32)
            if self.obs_filter is not None:
                cut_obs = self.obs_filter(cut_obs, update=False)
            vals = self._values(cut_obs)
            last = cols[SampleBatch.VALUES_BOOTSTRAPPED][-1]
            cols[SampleBatch.VALUES_BOOTSTRAPPED][-1] = np.where(
                running, vals, last
            ).astype(np.float32)

        compute_gae = getattr(self.config, "_compute_gae_on_runner", True)
        if compute_gae and self._has_vf:
            self._add_gae_columns(cols, B, T)

        # [T, B, ...] -> per-env contiguous [B*T, ...] so eps_id is contiguous.
        batch = SampleBatch(
            {
                k: np.stack(v).swapaxes(0, 1).reshape((B * T,) + np.asarray(v[0]).shape[1:])
                for k, v in cols.items()
            }
        )
        if compute_gae and not self._has_vf:
            # Critic-less modules: the per-episode path (pure discounted
            # returns, use_critic=False) still applies.
            batch = compute_gae_for_sample_batch(
                batch,
                gamma=getattr(self.config, "gamma", 0.99),
                lambda_=getattr(self.config, "lambda_", 0.95),
                use_gae=getattr(self.config, "use_gae", True),
                use_critic=False,
            )
        self._steps_sampled += batch.count
        return batch

    def _add_gae_columns(self, cols: dict, B: int, T: int) -> None:
        """Vectorized GAE over the whole [T, B] fragment in a handful of
        numpy passes (identical math to postprocessing.compute_advantages
        applied per episode).

        next-state values: vpred[t+1] inside an episode; at done steps the
        VALUES_BOOTSTRAPPED column (V(final_obs) for truncations, 0 for
        terminations); at the fragment cut the V(cut obs) the rollout loop
        wrote there."""
        gamma = float(getattr(self.config, "gamma", 0.99))
        lambda_ = float(getattr(self.config, "lambda_", 0.95))
        use_gae = bool(getattr(self.config, "use_gae", True))
        rew = np.stack(cols[SampleBatch.REWARDS]).astype(np.float32)  # [T,B]
        term = np.stack(cols[SampleBatch.TERMINATEDS])
        trunc = np.stack(cols[SampleBatch.TRUNCATEDS])
        done = term | trunc
        vpred = np.stack(cols[SampleBatch.VF_PREDS]).astype(np.float32)
        boot = np.stack(cols[SampleBatch.VALUES_BOOTSTRAPPED]).astype(np.float32)
        next_v = np.empty_like(vpred)
        next_v[:-1] = np.where(done[:-1], boot[:-1], vpred[1:])
        next_v[-1] = boot[-1]  # done or fragment cut — both live in boot
        if use_gae:
            delta = rew + gamma * next_v - vpred
            adv = np.empty_like(delta)
            acc = np.zeros(B, dtype=np.float32)
            cont = (~done).astype(np.float32) * gamma * lambda_
            for t in range(T - 1, -1, -1):
                acc = delta[t] + cont[t] * acc
                adv[t] = acc
            targets = adv + vpred
        else:
            # Discounted returns bootstrapped at episode ends / fragment cut.
            ret = np.empty_like(rew)
            acc = boot[-1]
            for t in range(T - 1, -1, -1):
                nxt = boot[t] if t == T - 1 else np.where(done[t], boot[t], acc)
                acc = rew[t] + gamma * nxt
                ret[t] = acc
            adv = ret - vpred
            targets = ret
        cols[SampleBatch.ADVANTAGES] = list(adv)
        cols[SampleBatch.VALUE_TARGETS] = list(targets.astype(np.float32))

    def _values(self, obs: np.ndarray) -> np.ndarray:
        """V(s) for bootstrap columns — numpy fast path when available."""
        if self._np_value is not None:
            return self._np_value(obs)
        with torch.no_grad():
            _, v = self.module.apply(self.module.params,
                                     torch.from_numpy(obs).to(self._device))
        return v.cpu().numpy()

    # -- weights / metrics -------------------------------------------------

    def set_weights(self, weights: Any, global_vars: Optional[dict] = None) -> None:
        self.module.set_state(weights)
        if global_vars:
            self._global_timestep = int(global_vars.get("timestep", 0))

    def set_global_vars(self, global_vars: dict) -> None:
        self._global_timestep = int(global_vars.get("timestep", 0))

    def get_weights(self) -> Any:
        return self.module.get_state()

    def get_filter_delta(self) -> Optional[dict]:
        if self.obs_filter is None:
            return None
        return self.obs_filter.flush_delta()

    def set_filter_state(self, state: dict) -> None:
        if self.obs_filter is not None:
            self.obs_filter.set_global(state)

    def transform_obs(self, obs: "np.ndarray") -> "np.ndarray":
        """Inference-path normalization (compute_single_action)."""
        if self.obs_filter is None:
            return obs
        return self.obs_filter(obs, update=False)

    def get_metrics(self) -> dict:
        """Drain episode stats (reference: collect_metrics /
        rollout_worker metrics queue)."""
        out = {
            "episode_returns": self._episode_returns,
            "episode_lengths": self._episode_lengths,
            "num_env_steps_sampled": self._steps_sampled,
        }
        self._episode_returns = []
        self._episode_lengths = []
        return out

    def module_device(self) -> str:
        """Where the runner's module and its forward live (its parameters'
        device)."""
        return str(next(iter(self.module.params.values())).device)

    def spaces(self) -> tuple:
        return self.vector_env.observation_space, self.vector_env.action_space

    def stop(self) -> None:
        self.vector_env.close()

    def ping(self) -> str:
        return "pong"


RemoteEnvRunner = ray_tpu_torch.remote(EnvRunner)
