"""Exploration schedules and action-noise helpers.

Reference: rllib/utils/exploration/ (EpsilonGreedy, GaussianNoise,
OrnsteinUhlenbeckNoise, schedules in rllib/utils/schedules/), a copy of the
JAX package's: exploration STATE (the schedule position) is host-side and
enters the module's `forward_exploration` as an input through its
`exploration_inputs(timestep)` hook.

Modules compose these instead of hand-rolling schedules (dqn.py's inline
epsilon schedule now delegates here).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class LinearSchedule:
    """value(t): initial -> final over `timesteps`, then flat."""

    initial: float
    final: float
    timesteps: int

    def value(self, t: int) -> float:
        frac = min(1.0, t / max(1, self.timesteps))
        return self.initial + frac * (self.final - self.initial)


@dataclass
class ExponentialSchedule:
    """value(t) = initial * decay_rate^(t / timesteps), floored at final."""

    initial: float
    final: float
    timesteps: int
    decay_rate: float = 0.1

    def value(self, t: int) -> float:
        v = self.initial * self.decay_rate ** (t / max(1, self.timesteps))
        return max(self.final, v)


@dataclass
class EpsilonGreedy:
    """Epsilon schedule for discrete action spaces; the module merges
    {'epsilon': eps(t)} into the exploration batch and mixes random actions
    in its forward (dqn.py's pattern)."""

    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_timesteps: int = 10_000
    schedule: str = "linear"  # or "exponential"

    def epsilon(self, timestep: int) -> float:
        if self.schedule == "exponential":
            return ExponentialSchedule(
                self.epsilon_initial, self.epsilon_final, self.epsilon_timesteps
            ).value(timestep)
        return LinearSchedule(
            self.epsilon_initial, self.epsilon_final, self.epsilon_timesteps
        ).value(timestep)

    def inputs(self, timestep: int) -> dict:
        return {"epsilon": np.float32(self.epsilon(timestep))}


@dataclass
class GaussianNoise:
    """Additive Gaussian action noise for continuous spaces, with an
    annealed scale (reference: exploration/gaussian_noise.py). Use
    `inputs()` for the forward's scale and `apply()` for host-side numpy
    policies."""

    initial_scale: float = 1.0
    final_scale: float = 0.1
    scale_timesteps: int = 10_000
    clip: float | None = None

    def scale(self, timestep: int) -> float:
        return LinearSchedule(
            self.initial_scale, self.final_scale, self.scale_timesteps
        ).value(timestep)

    def inputs(self, timestep: int) -> dict:
        return {"noise_scale": np.float32(self.scale(timestep))}

    def apply(self, actions: np.ndarray, timestep: int,
              rng: np.random.Generator) -> np.ndarray:
        noisy = actions + rng.normal(
            0.0, self.scale(timestep), size=actions.shape
        )
        if self.clip is not None:
            noisy = np.clip(noisy, -self.clip, self.clip)
        return noisy.astype(actions.dtype, copy=False)


@dataclass
class OrnsteinUhlenbeckNoise:
    """Temporally-correlated noise for continuous control (reference:
    exploration/ornstein_uhlenbeck_noise.py). Stateful: call reset() at
    episode boundaries."""

    theta: float = 0.15
    sigma: float = 0.2
    dt: float = 1e-2

    def __post_init__(self):
        self._state: np.ndarray | None = None

    def reset(self) -> None:
        self._state = None

    def apply(self, actions: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self._state is None or self._state.shape != actions.shape:
            self._state = np.zeros_like(actions, dtype=np.float64)
        self._state = (
            self._state
            - self.theta * self._state * self.dt
            + self.sigma * math.sqrt(self.dt)
            * rng.normal(size=actions.shape)
        )
        return (actions + self._state).astype(actions.dtype, copy=False)
