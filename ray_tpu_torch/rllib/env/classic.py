"""Classic-control environments in numpy.

The image ships no gym, so the benchmark/test envs live in-tree. Dynamics
follow the standard OpenAI Gym formulations (CartPole-v1, Pendulum-v1) that
the reference's tuned examples train against (rllib/tuned_examples/ppo/
cartpole-ppo.yaml etc.) so learning-curve expectations transfer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.env.env import (
    Env,
    MultiAgentEnv,
    VectorEnv,
    register_env,
    register_vector_env,
)
from ray_tpu_torch.rllib.env.spaces import Box, Discrete


class CartPole(Env):
    """Pole balancing; episode ends past ±12° / ±2.4m / 500 steps."""

    MAX_STEPS = 500

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.gravity = 9.8
        self.masscart, self.masspole = 1.0, 0.1
        self.length = 0.5  # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        high = np.array(
            [self.x_threshold * 2, np.finfo(np.float32).max,
             self.theta_threshold * 2, np.finfo(np.float32).max],
            dtype=np.float32,
        )
        self.observation_space = Box(-high, high)
        self.action_space = Discrete(2)
        self.max_steps = int(config.get("max_steps", self.MAX_STEPS))
        self._rng = np.random.default_rng()
        self._state = None
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self._steps = 0
        return self._state.copy(), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.force_mag if int(action) == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x += self.tau * x_dot
        x_dot += self.tau * xacc
        theta += self.tau * theta_dot
        theta_dot += self.tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot], dtype=np.float32)
        self._steps += 1
        terminated = bool(
            abs(x) > self.x_threshold or abs(theta) > self.theta_threshold
        )
        truncated = self._steps >= self.max_steps
        return self._state.copy(), 1.0, terminated, truncated, {}


class Pendulum(Env):
    """Swing-up with continuous torque; reward = -(angle² + .1ω² + .001u²)."""

    MAX_STEPS = 200

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.max_speed, self.max_torque = 8.0, 2.0
        self.dt, self.g, self.m, self.l = 0.05, 10.0, 1.0, 1.0
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box(-self.max_torque, self.max_torque, shape=(1,))
        self.max_steps = int(config.get("max_steps", self.MAX_STEPS))
        self._rng = np.random.default_rng()
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta = self._rng.uniform(-np.pi, np.pi)
        self._theta_dot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs(), {}

    def _obs(self):
        return np.array(
            [np.cos(self._theta), np.sin(self._theta), self._theta_dot],
            dtype=np.float32,
        )

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.max_torque, self.max_torque))
        th, thdot = self._theta, self._theta_dot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (
            3 * self.g / (2 * self.l) * np.sin(th) + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        thdot = float(np.clip(thdot, -self.max_speed, self.max_speed))
        self._theta = th + thdot * self.dt
        self._theta_dot = thdot
        self._steps += 1
        return self._obs(), -float(cost), False, self._steps >= self.max_steps, {}


class RandomEnv(Env):
    """Uniform-random rewards/observations; throughput benchmarking env
    (reference: rllib/examples/env/random_env.py, used by sampler perf tests)."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.observation_space = config.get("observation_space") or Box(
            -1.0, 1.0, shape=(int(config.get("obs_dim", 4)),)
        )
        self.action_space = config.get("action_space") or Discrete(2)
        self.episode_len = int(config.get("episode_len", 100))
        self._rng = np.random.default_rng()
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._steps = 0
        return self.observation_space.sample(self._rng), {}

    def step(self, action):
        self._steps += 1
        return (
            self.observation_space.sample(self._rng),
            float(self._rng.random()),
            False,
            self._steps >= self.episode_len,
            {},
        )


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles under one multi-agent env (reference:
    rllib/examples/env/multi_agent.py MultiAgentCartPole)."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.num_agents = int(config.get("num_agents", 2))
        self.agent_ids = [f"agent_{i}" for i in range(self.num_agents)]
        self._envs = {aid: CartPole(config) for aid in self.agent_ids}
        self._done = {aid: False for aid in self.agent_ids}
        first = self._envs[self.agent_ids[0]]
        self.observation_space = first.observation_space
        self.action_space = first.action_space

    def reset(self, *, seed: Optional[int] = None):
        obs, infos = {}, {}
        for i, (aid, env) in enumerate(self._envs.items()):
            o, info = env.reset(seed=None if seed is None else seed + i)
            obs[aid], infos[aid] = o, info
            self._done[aid] = False
        return obs, infos

    def step(self, action_dict):
        obs, rews, terms, truncs, infos = {}, {}, {}, {}, {}
        for aid, action in action_dict.items():
            if self._done[aid]:
                continue
            o, r, term, trunc, info = self._envs[aid].step(action)
            obs[aid], rews[aid] = o, r
            terms[aid], truncs[aid], infos[aid] = term, trunc, info
            if term or trunc:
                self._done[aid] = True
        terms["__all__"] = all(self._done.values())
        truncs["__all__"] = False
        return obs, rews, terms, truncs, infos


class VectorCartPole(VectorEnv):
    """All B cartpoles advanced in one fused numpy pass (state [B,4]).

    Same dynamics/termination as CartPole above; the auto-reset contract
    matches SyncVectorEnv (done rows reset in place, true final obs in
    infos[i]["final_observation"]). ~20x less interpreter overhead per
    env-step than stepping B python envs — the sampler-throughput win the
    reference gets from its remote vector envs, obtained by vectorizing
    the math instead."""

    def __init__(self, num_envs: int, config: Optional[dict] = None):
        config = config or {}
        proto = CartPole(config)
        self.observation_space = proto.observation_space
        self.action_space = proto.action_space
        self.num_envs = int(num_envs)
        self.max_steps = proto.max_steps
        self.theta_threshold = proto.theta_threshold
        self.x_threshold = proto.x_threshold
        self.force_mag = proto.force_mag
        self.tau = proto.tau
        self.gravity = proto.gravity
        self.masscart, self.masspole = proto.masscart, proto.masspole
        self.length = proto.length
        self._rng = np.random.default_rng()
        self._state = np.zeros((self.num_envs, 4), dtype=np.float32)
        self._steps = np.zeros(self.num_envs, dtype=np.int64)

    def _sample_state(self, n: int) -> np.ndarray:
        return self._rng.uniform(-0.05, 0.05, size=(n, 4)).astype(np.float32)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._sample_state(self.num_envs)
        self._steps[:] = 0
        return self._state.copy(), [{} for _ in range(self.num_envs)]

    def step(self, actions):
        s = self._state
        x, x_dot, theta, theta_dot = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        force = np.where(
            np.asarray(actions).astype(np.int64) == 1,
            self.force_mag,
            -self.force_mag,
        ).astype(np.float32)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        state = np.stack([x, x_dot, theta, theta_dot], axis=1).astype(np.float32)
        self._steps += 1
        terminated = (np.abs(x) > self.x_threshold) | (
            np.abs(theta) > self.theta_threshold
        )
        truncated = (~terminated) & (self._steps >= self.max_steps)
        rewards = np.ones(self.num_envs, dtype=np.float32)
        done = terminated | truncated
        infos: list = [{}] * self.num_envs
        if done.any():
            idx = np.nonzero(done)[0]
            infos = [{} for _ in range(self.num_envs)]
            for i in idx:
                infos[i] = {"final_observation": state[i].copy()}
            state[idx] = self._sample_state(len(idx))
            self._steps[idx] = 0
        self._state = state
        return state.copy(), rewards, terminated, truncated, infos


register_env("CartPole-v1", lambda cfg: CartPole(cfg))
register_env("Pendulum-v1", lambda cfg: Pendulum(cfg))
register_env("RandomEnv", lambda cfg: RandomEnv(cfg))
register_env("MultiAgentCartPole", lambda cfg: MultiAgentCartPole(cfg))
register_vector_env(
    "CartPole-v1", lambda n, cfg: VectorCartPole(n, cfg)
)
