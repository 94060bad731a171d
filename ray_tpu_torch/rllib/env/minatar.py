"""MinAtar-style Breakout: the in-tree Atari-class benchmark environment.

BASELINE config #3 names "PPO + IMPALA on Atari"; the sealed image ships
neither ALE nor MinAtar, so the Atari-class path is carried in-tree as a
re-derivation of MinAtar Breakout's published game rules (10x10 grid,
binary channel planes, diagonal ball, one-cell paddle, three brick rows —
the standard miniaturized-Atari testbed): image-shaped observations
[10, 10, 4], sparse rewards, and a control problem that separates learning
algorithms the way full Atari does, at a scale CPU sampling hosts sustain.
Gymnasium's real ALE plugs in through env.GymnasiumEnv when installed
(reference: rllib/env/wrappers/atari_wrappers.py).

Implemented natively vectorized: all B boards advance in one numpy pass
(state arrays [B, ...]), the same fused-step design as
classic.VectorCartPole. The single-env class wraps the vector one at B=1.

Channels: 0=paddle, 1=ball, 2=ball trail (previous position), 3=bricks.
Actions: 0=noop, 1=left, 2=right. Reward +1 per brick. Episode ends when
the ball passes the paddle (or at max_steps truncation); clearing the wall
respawns it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.env.env import (
    Env,
    VectorEnv,
    register_env,
    register_vector_env,
)
from ray_tpu_torch.rllib.env.spaces import Box, Discrete

GRID = 10
BRICK_ROWS = (1, 2, 3)
MAX_STEPS = 1000


class VectorMinAtarBreakout(VectorEnv):
    def __init__(self, num_envs: int, config: Optional[dict] = None):
        config = config or {}
        self.num_envs = int(num_envs)
        self.max_steps = int(config.get("max_steps", MAX_STEPS))
        # Sticky actions (MinAtar's difficulty knob): with prob p the
        # previous action repeats.
        self.sticky_prob = float(config.get("sticky_action_prob", 0.1))
        self.observation_space = Box(0.0, 1.0, shape=(GRID, GRID, 4))
        self.action_space = Discrete(3)
        self._rng = np.random.default_rng()
        B = self.num_envs
        self._ball = np.zeros((B, 2), dtype=np.int64)  # (y, x)
        self._vel = np.zeros((B, 2), dtype=np.int64)
        self._trail = np.zeros((B, 2), dtype=np.int64)
        self._paddle = np.zeros(B, dtype=np.int64)
        self._bricks = np.zeros((B, len(BRICK_ROWS), GRID), dtype=bool)
        self._steps = np.zeros(B, dtype=np.int64)
        self._last_action = np.zeros(B, dtype=np.int64)

    # -- state helpers ------------------------------------------------------

    def _spawn(self, idx: np.ndarray) -> None:
        n = len(idx)
        self._ball[idx, 0] = 0
        self._ball[idx, 1] = self._rng.integers(0, GRID, size=n)
        self._vel[idx, 0] = 1
        self._vel[idx, 1] = self._rng.choice((-1, 1), size=n)
        self._trail[idx] = self._ball[idx]
        self._paddle[idx] = GRID // 2
        self._bricks[idx] = True
        self._steps[idx] = 0
        self._last_action[idx] = 0

    def _obs(self) -> np.ndarray:
        B = self.num_envs
        obs = np.zeros((B, GRID, GRID, 4), dtype=np.float32)
        rows = np.arange(B)
        obs[rows, GRID - 1, self._paddle, 0] = 1.0
        obs[rows, self._ball[:, 0], self._ball[:, 1], 1] = 1.0
        obs[rows, self._trail[:, 0], self._trail[:, 1], 2] = 1.0
        for ci, row in enumerate(BRICK_ROWS):
            obs[:, row, :, 3] = self._bricks[:, ci]
        return obs

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._spawn(np.arange(self.num_envs))
        return self._obs(), [{} for _ in range(self.num_envs)]

    def step(self, actions):
        B = self.num_envs
        actions = np.asarray(actions).astype(np.int64).reshape(B)
        sticky = self._rng.random(B) < self.sticky_prob
        actions = np.where(sticky, self._last_action, actions)
        self._last_action = actions

        # Paddle move.
        self._paddle = np.clip(
            self._paddle + np.where(actions == 1, -1, 0) + np.where(actions == 2, 1, 0),
            0,
            GRID - 1,
        )

        rewards = np.zeros(B, dtype=np.float32)
        # Ball advance with wall bounces (x), ceiling bounce (y).
        new_x = self._ball[:, 1] + self._vel[:, 1]
        bounce_x = (new_x < 0) | (new_x >= GRID)
        self._vel[:, 1] = np.where(bounce_x, -self._vel[:, 1], self._vel[:, 1])
        new_x = np.clip(new_x, 0, GRID - 1)
        new_y = self._ball[:, 0] + self._vel[:, 0]
        bounce_y = new_y < 0
        self._vel[:, 0] = np.where(bounce_y, -self._vel[:, 0], self._vel[:, 0])
        new_y = np.abs(new_y)

        # Brick hits: remove the brick, score, reflect vertically (the ball
        # does not enter the brick cell this step).
        hit = np.zeros(B, dtype=bool)
        for ci, row in enumerate(BRICK_ROWS):
            at_row = new_y == row
            has_brick = self._bricks[np.arange(B), ci, new_x]
            h = at_row & has_brick
            if h.any():
                self._bricks[np.nonzero(h)[0], ci, new_x[h]] = False
                hit |= h
        rewards += hit.astype(np.float32)
        self._vel[:, 0] = np.where(hit, -self._vel[:, 0], self._vel[:, 0])
        new_y = np.where(hit, self._ball[:, 0], new_y)

        # Bottom row: paddle saves (reflect), otherwise the ball is lost.
        at_bottom = new_y >= GRID - 1
        saved = at_bottom & (new_x == self._paddle)
        terminated = at_bottom & ~saved
        self._vel[:, 0] = np.where(saved, -1, self._vel[:, 0])
        new_y = np.where(saved, GRID - 2, new_y)
        new_y = np.where(terminated, GRID - 1, new_y)

        self._trail = self._ball.copy()
        self._ball = np.stack([new_y, new_x], axis=1)

        # Cleared wall: respawn bricks (play continues — MinAtar behavior).
        cleared = ~self._bricks.any(axis=(1, 2))
        if cleared.any():
            self._bricks[cleared] = True

        self._steps += 1
        truncated = (~terminated) & (self._steps >= self.max_steps)
        obs = self._obs()
        done = terminated | truncated
        infos: list = [{}] * B
        if done.any():
            idx = np.nonzero(done)[0]
            infos = [{} for _ in range(B)]
            for i in idx:
                infos[i] = {"final_observation": obs[i].copy()}
            self._spawn(idx)
            fresh = self._obs()
            obs[idx] = fresh[idx]
        return obs, rewards, terminated, truncated, infos


class MinAtarBreakout(Env):
    """Single-env wrapper over the vectorized implementation (B=1)."""

    def __init__(self, config: Optional[dict] = None):
        self._vec = VectorMinAtarBreakout(1, config)
        self.observation_space = self._vec.observation_space
        self.action_space = self._vec.action_space

    def reset(self, *, seed: Optional[int] = None):
        obs, infos = self._vec.reset(seed=seed)
        return obs[0], infos[0]

    def step(self, action):
        obs, rew, term, trunc, infos = self._vec.step(np.array([action]))
        return obs[0], float(rew[0]), bool(term[0]), bool(trunc[0]), infos[0]


register_env("MinAtar-Breakout", lambda cfg: MinAtarBreakout(cfg))
register_vector_env(
    "MinAtar-Breakout", lambda n, cfg: VectorMinAtarBreakout(n, cfg)
)
