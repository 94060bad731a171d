"""Multi-agent env runner — shared-policy sampling over MultiAgentEnv.

Reference: rllib's multi-agent sampling (evaluation/env_runner_v2.py handling
MultiAgentEnv + policy mapping). This runner implements the most common
configuration — every agent steps the SAME module (parameter sharing) — by
flattening agent transitions into single-agent rows: one forward pass batches
all live agents each step, and each (episode, agent) pair gets its own eps_id
so GAE and the learners treat agent trajectories independently. Any
single-agent algorithm (PPO/IMPALA/DQN/SAC) then trains multi-agent envs
unchanged. `PerPolicyMultiAgentRunner` routes agents to distinct modules by
`policy_mapping_fn` and returns MultiAgentBatches.

The forward is the module's torch `forward_exploration` on the runner's
`sample_device` ("cpu" by default; "cuda" raises without a card, as the
single-agent EnvRunner does — nothing falls back), with a `torch.Generator`
seeded as the JAX package seeds its key. Each forward output comes to the
host once per env step; the per-agent rows then index host arrays.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env import MultiAgentEnv, make_env
from ray_tpu_torch.rllib.env.spaces import Box
from ray_tpu_torch.rllib.evaluation.postprocessing import compute_gae_for_sample_batch
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch


_PROBE_CACHE: dict = {}


def is_multi_agent_env(env_spec, env_config) -> bool:
    """Class-check without instantiation when the spec is a class; registered
    names/callables are probed once and cached (envs may bind simulators or
    sockets — don't pay that per worker-group construction)."""
    if isinstance(env_spec, type):
        return issubclass(env_spec, MultiAgentEnv)
    key = None
    try:
        # str specs key by value; callables by identity (the cache holds the
        # callable, keeping its id stable).
        key = (env_spec, repr(sorted((env_config or {}).items())))
        if key in _PROBE_CACHE:
            return _PROBE_CACHE[key]
    except TypeError:
        key = None  # unhashable spec: probe every time
    probe = make_env(env_spec, env_config)
    result = isinstance(probe, MultiAgentEnv)
    probe.close()
    if key is not None:
        _PROBE_CACHE[key] = result
    return result


def _explore(module, obs: np.ndarray, timestep: int, generator, device) -> dict:
    """One forward_exploration over the [agents, obs] stack, every output
    copied to the host once."""
    fwd_in = {SampleBatch.OBS: torch.from_numpy(obs).to(device)}
    fwd_in.update(module.exploration_inputs(timestep))
    with torch.no_grad():
        fwd = module.forward_exploration(module.params, fwd_in, generator)
    return {k: v.cpu().numpy() for k, v in fwd.items()}


def _values(module, obs: np.ndarray, device) -> np.ndarray:
    """V(s) of the [n, obs] stack, on the host."""
    with torch.no_grad():
        _, v = module.apply(module.params, torch.from_numpy(obs).to(device))
    return v.cpu().numpy()


class MultiAgentEnvRunner:
    """Interface-compatible with EnvRunner (sample/set_weights/metrics)."""

    def __init__(self, config, worker_index: int = 0):
        self.config = config
        self.worker_index = worker_index
        env_cfg = getattr(config, "env_config", None) or {}
        self.env = make_env(config.env, env_cfg, worker_index=worker_index)
        assert isinstance(self.env, MultiAgentEnv)
        spec = getattr(config, "rl_module_spec", None) or RLModuleSpec(
            observation_space=self.env.observation_space,
            action_space=self.env.action_space,
            model_config=dict(getattr(config, "model", None) or {}),
            seed=(getattr(config, "seed", 0) or 0) + worker_index,
        )
        if getattr(config, "observation_filter", None) not in (None, "NoFilter"):
            raise ValueError(
                "observation_filter is not supported for multi-agent envs yet"
            )
        device_kind = getattr(config, "sample_device", "cpu") or "cpu"
        self._device = resolve_device(device_kind)
        self.module = spec.build(device=self._device)
        self._has_vf = getattr(self.module, "has_value_head", True)
        seed = (getattr(config, "seed", 0) or 0) * 7919 + worker_index
        self._generator = torch.Generator(device=self._device).manual_seed(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_counter = worker_index * 1_000_000
        self._agent_eps = {
            aid: self._new_eps_id(aid) for aid in self._obs
        }
        self._ep_return = 0.0
        self._ep_len = 0
        self._episode_returns: list = []
        self._episode_lengths: list = []
        self._steps_sampled = 0
        self._global_timestep = 0
        self._is_continuous = isinstance(self.env.action_space, Box)

    def _new_eps_id(self, agent_id) -> int:
        self._episode_counter += 1
        return self._episode_counter

    def sample(self, num_steps: Optional[int] = None) -> SampleBatch:
        T = int(
            num_steps
            or getattr(self.config, "rollout_fragment_length", None)
            or 200
        )
        rows: dict[Any, dict[str, list]] = defaultdict(lambda: defaultdict(list))
        env_steps = 0
        while env_steps < T:
            agents = sorted(self._obs.keys())
            if not agents:
                self._finish_episode()
                continue
            obs_stack = np.stack(
                [np.asarray(self._obs[a], np.float32) for a in agents]
            )
            # One host fetch per forward output per env step — the step
            # boundary must sync anyway for the env actions.
            fwd_host = _explore(self.module, obs_stack,
                                max(self._global_timestep, self._steps_sampled),
                                self._generator, self._device)
            actions = fwd_host[SampleBatch.ACTIONS]
            env_actions = actions
            if self._is_continuous:
                env_actions = np.clip(
                    actions, self.env.action_space.low, self.env.action_space.high
                )
            action_dict = {a: env_actions[i] for i, a in enumerate(agents)}
            next_obs, rewards, terms, truncs, infos = self.env.step(action_dict)
            # "__all__" ends the episode for every live agent even when the
            # env sets no per-agent flags — rows must reflect it or GAE
            # bootstraps a truncated episode with 0 (and the fragment-cut
            # path could leak the NEXT episode's value across the boundary).
            all_term = bool(terms.get("__all__", False))
            all_trunc = bool(truncs.get("__all__", False))

            for i, agent in enumerate(agents):
                if agent not in rewards:
                    continue  # agent was already done; env ignored the action
                term = bool(terms.get(agent, False)) or all_term
                trunc = (bool(truncs.get(agent, False)) or all_trunc) and not term
                r = rows[agent]
                r[SampleBatch.OBS].append(obs_stack[i])
                r[SampleBatch.ACTIONS].append(actions[i])
                r[SampleBatch.REWARDS].append(np.float32(rewards[agent]))
                r[SampleBatch.TERMINATEDS].append(term)
                r[SampleBatch.TRUNCATEDS].append(trunc)
                # Agents may first appear mid-episode (turn-based/spawning
                # envs): give them an episode id on first sight.
                if agent not in self._agent_eps:
                    self._agent_eps[agent] = self._new_eps_id(agent)
                r[SampleBatch.EPS_ID].append(self._agent_eps[agent])
                for key_, val in fwd_host.items():
                    if key_ != SampleBatch.ACTIONS:
                        r[key_].append(val[i])  # host array, fetched once
                successor = next_obs.get(agent)
                if successor is None:
                    successor = infos.get(agent, {}).get(
                        "final_observation", obs_stack[i]
                    )
                r[SampleBatch.NEXT_OBS].append(np.asarray(successor, np.float32))
                boot = 0.0
                if trunc and self._has_vf:
                    # Only at truncation boundaries (rare), and the value
                    # feeds the row being built this step.
                    boot = float(_values(self.module,
                                         np.asarray(successor, np.float32)[None],
                                         self._device)[0])
                r[SampleBatch.VALUES_BOOTSTRAPPED].append(np.float32(boot))
                self._ep_return += float(rewards[agent])

            env_steps += 1
            self._ep_len += 1
            self._obs = {
                a: o
                for a, o in next_obs.items()
                if not (terms.get(a, False) or truncs.get(a, False))
            }
            if terms.get("__all__", False) or truncs.get("__all__", False) or not self._obs:
                self._finish_episode()

        batches = []
        pending: list[tuple[SampleBatch, int]] = []  # (batch, cut-obs row)
        cut_obs: list[np.ndarray] = []
        for agent, cols in rows.items():
            if not cols[SampleBatch.OBS]:
                continue
            batch = SampleBatch(
                {
                    k: (np.stack(v) if k != SampleBatch.INFOS else v)
                    for k, v in cols.items()
                }
            )
            # Fragment-cut bootstrap for agents still running: collect the
            # cut observations and run ONE batched value call below.
            if (
                self._has_vf
                and not batch[SampleBatch.TERMINATEDS][-1]
                and not batch[SampleBatch.TRUNCATEDS][-1]
                and agent in self._obs
            ):
                pending.append((batch, len(cut_obs)))
                cut_obs.append(np.asarray(self._obs[agent], np.float32))
            batches.append(batch)
        if pending:
            vals = _values(self.module, np.stack(cut_obs), self._device)
            for batch, row in pending:
                vb = np.asarray(batch[SampleBatch.VALUES_BOOTSTRAPPED])
                vb[-1] = float(vals[row])
                batch[SampleBatch.VALUES_BOOTSTRAPPED] = vb
        out = SampleBatch.concat_samples(batches)
        self._steps_sampled += env_steps
        if getattr(self.config, "_compute_gae_on_runner", True) and self._has_vf:
            out = compute_gae_for_sample_batch(
                out,
                gamma=getattr(self.config, "gamma", 0.99),
                lambda_=getattr(self.config, "lambda_", 0.95),
                use_gae=getattr(self.config, "use_gae", True),
            )
        return out

    def _finish_episode(self) -> None:
        self._episode_returns.append(self._ep_return)
        self._episode_lengths.append(self._ep_len)
        self._ep_return = 0.0
        self._ep_len = 0
        self._obs, _ = self.env.reset()
        self._agent_eps = {a: self._new_eps_id(a) for a in self._obs}

    # -- interface parity with EnvRunner ----------------------------------

    def explore(self, obs: np.ndarray, timestep: int) -> dict:
        """compute_single_action's explore path: the module's forward on
        the runner's device with its generator; outputs stay there."""
        fwd_in = {SampleBatch.OBS: torch.from_numpy(obs).to(self._device)}
        fwd_in.update(self.module.exploration_inputs(timestep))
        with torch.no_grad():
            return self.module.forward_exploration(self.module.params, fwd_in,
                                                   self._generator)

    def set_weights(self, weights: Any, global_vars: Optional[dict] = None) -> None:
        self.module.set_state(weights)
        if global_vars:
            self._global_timestep = int(global_vars.get("timestep", 0))

    def get_weights(self) -> Any:
        return self.module.get_state()

    def set_global_vars(self, global_vars: dict) -> None:
        self._global_timestep = int(global_vars.get("timestep", 0))

    def get_filter_delta(self):
        return None  # filters rejected at construction for multi-agent

    def set_filter_state(self, state) -> None:
        pass

    def transform_obs(self, obs):
        return obs

    def get_metrics(self) -> dict:
        out = {
            "episode_returns": self._episode_returns,
            "episode_lengths": self._episode_lengths,
            "num_env_steps_sampled": self._steps_sampled,
        }
        self._episode_returns = []
        self._episode_lengths = []
        return out

    def spaces(self) -> tuple:
        return self.env.observation_space, self.env.action_space

    def stop(self) -> None:
        self.env.close()

    def ping(self) -> str:
        return "pong"


class PerPolicyMultiAgentRunner(MultiAgentEnvRunner):
    """Per-policy multi-agent sampling (reference: env_runner_v2.py policy
    mapping + marl_module.py): agents route to DISTINCT modules via
    config.policy_mapping_fn, one batched forward per policy per step, and
    sample() returns a MultiAgentBatch of per-policy rows so each policy
    trains its own parameters."""

    def __init__(self, config, worker_index: int = 0):
        super().__init__(config, worker_index)
        policies = dict(config.policies or {})
        mapping = config.policy_mapping_fn or (lambda aid, **kw: next(iter(policies)))
        self._mapping_fn = mapping
        base_spec = RLModuleSpec(
            observation_space=self.env.observation_space,
            action_space=self.env.action_space,
            model_config=dict(getattr(config, "model", None) or {}),
            seed=(getattr(config, "seed", 0) or 0) + worker_index,
        )
        self.modules = {}
        for offset, (pid, pspec) in enumerate(sorted(policies.items())):
            spec = pspec or base_spec
            # Distinct init seeds per policy: independently-initialized nets.
            spec = RLModuleSpec(
                observation_space=spec.observation_space,
                action_space=spec.action_space,
                model_config=spec.model_config,
                seed=(spec.seed or 0) + 7727 * (offset + 1),
            )
            self.modules[pid] = spec.build(device=self._device)
        self._agent_policy: dict[Any, str] = {}
        # The base class built a shared module that per-policy mode never
        # weight-syncs; alias the FIRST policy's module so interface users
        # (compute_single_action, weight introspection) see trained params,
        # not random init.
        first = sorted(self.modules)[0]
        self.module = self.modules[first]

    def _policy_for(self, agent_id) -> str:
        pid = self._agent_policy.get(agent_id)
        if pid is None:
            pid = self._mapping_fn(agent_id)
            self._agent_policy[agent_id] = pid
        return pid

    def _has_value(self, pid) -> bool:
        return getattr(self.modules[pid], "has_value_head", True)

    def sample(self, num_steps: Optional[int] = None):
        T = int(
            num_steps
            or getattr(self.config, "rollout_fragment_length", None)
            or 200
        )
        rows: dict[Any, dict[str, list]] = defaultdict(lambda: defaultdict(list))
        env_steps = 0
        while env_steps < T:
            agents = sorted(self._obs.keys())
            if not agents:
                self._finish_episode()
                continue
            by_policy: dict[str, list[Any]] = defaultdict(list)
            for agent in agents:
                by_policy[self._policy_for(agent)].append(agent)
            timestep = max(self._global_timestep, self._steps_sampled)
            fwd_by_agent: dict[Any, dict] = {}
            action_dict: dict[Any, Any] = {}
            for pid, members in by_policy.items():
                obs_stack = np.stack(
                    [np.asarray(self._obs[a], np.float32) for a in members]
                )
                # One host fetch per forward output per policy per step.
                fwd_host = _explore(self.modules[pid], obs_stack, timestep,
                                    self._generator, self._device)
                actions = fwd_host[SampleBatch.ACTIONS]
                env_actions = actions
                if self._is_continuous:
                    env_actions = np.clip(
                        actions,
                        self.env.action_space.low,
                        self.env.action_space.high,
                    )
                for j, agent in enumerate(members):
                    fwd_by_agent[agent] = {
                        k: v[j] for k, v in fwd_host.items()
                    }
                    action_dict[agent] = env_actions[j]
            obs_before = dict(self._obs)
            next_obs, rewards, terms, truncs, infos = self.env.step(action_dict)
            all_term = bool(terms.get("__all__", False))
            all_trunc = bool(truncs.get("__all__", False))
            for agent in agents:
                if agent not in rewards:
                    continue
                term = bool(terms.get(agent, False)) or all_term
                trunc = (bool(truncs.get(agent, False)) or all_trunc) and not term
                fwd = fwd_by_agent[agent]
                r = rows[agent]
                r[SampleBatch.OBS].append(
                    np.asarray(obs_before[agent], np.float32)
                )
                r[SampleBatch.ACTIONS].append(fwd[SampleBatch.ACTIONS])
                r[SampleBatch.REWARDS].append(np.float32(rewards[agent]))
                r[SampleBatch.TERMINATEDS].append(term)
                r[SampleBatch.TRUNCATEDS].append(trunc)
                if agent not in self._agent_eps:
                    self._agent_eps[agent] = self._new_eps_id(agent)
                r[SampleBatch.EPS_ID].append(self._agent_eps[agent])
                for key_, val in fwd.items():
                    if key_ != SampleBatch.ACTIONS:
                        r[key_].append(val)
                successor = next_obs.get(agent)
                if successor is None:
                    successor = infos.get(agent, {}).get(
                        "final_observation", obs_before[agent]
                    )
                r[SampleBatch.NEXT_OBS].append(np.asarray(successor, np.float32))
                pid = self._policy_for(agent)
                boot = 0.0
                if trunc and self._has_value(pid):
                    boot = float(_values(self.modules[pid],
                                         np.asarray(successor, np.float32)[None],
                                         self._device)[0])
                r[SampleBatch.VALUES_BOOTSTRAPPED].append(np.float32(boot))
                self._ep_return += float(rewards[agent])
            env_steps += 1
            self._ep_len += 1
            self._obs = {
                a: o
                for a, o in next_obs.items()
                if not (terms.get(a, False) or truncs.get(a, False))
            }
            if terms.get("__all__", False) or truncs.get("__all__", False) or not self._obs:
                self._finish_episode()

        per_policy: dict[str, list[SampleBatch]] = defaultdict(list)
        for agent, cols in rows.items():
            if not cols[SampleBatch.OBS]:
                continue
            batch = SampleBatch(
                {
                    k: (np.stack(v) if k != SampleBatch.INFOS else v)
                    for k, v in cols.items()
                }
            )
            pid = self._policy_for(agent)
            if (
                self._has_value(pid)
                and not batch[SampleBatch.TERMINATEDS][-1]
                and not batch[SampleBatch.TRUNCATEDS][-1]
                and agent in self._obs
            ):
                val = float(_values(self.modules[pid],
                                    np.asarray(self._obs[agent], np.float32)[None],
                                    self._device)[0])
                vb = np.asarray(batch[SampleBatch.VALUES_BOOTSTRAPPED])
                vb[-1] = val
                batch[SampleBatch.VALUES_BOOTSTRAPPED] = vb
            per_policy[pid].append(batch)
        self._steps_sampled += env_steps
        policy_batches = {}
        for pid, batches in per_policy.items():
            merged = SampleBatch.concat_samples(batches)
            if (
                getattr(self.config, "_compute_gae_on_runner", True)
                and self._has_value(pid)
            ):
                merged = compute_gae_for_sample_batch(
                    merged,
                    gamma=getattr(self.config, "gamma", 0.99),
                    lambda_=getattr(self.config, "lambda_", 0.95),
                    use_gae=getattr(self.config, "use_gae", True),
                )
            policy_batches[pid] = merged
        return MultiAgentBatch(policy_batches, env_steps)

    def set_weights(self, weights: Any, global_vars: Optional[dict] = None) -> None:
        if isinstance(weights, dict) and set(weights) <= set(self.modules):
            for pid, w in weights.items():
                self.modules[pid].set_state(w)
        else:
            super().set_weights(weights)
            return
        if global_vars:
            self._global_timestep = int(global_vars.get("timestep", 0))

    def get_weights(self) -> Any:
        return {pid: m.get_state() for pid, m in self.modules.items()}


RemoteMultiAgentEnvRunner = ray_tpu_torch.remote(MultiAgentEnvRunner)
RemotePerPolicyMultiAgentRunner = ray_tpu_torch.remote(PerPolicyMultiAgentRunner)
