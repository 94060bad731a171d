"""Observation/action spaces.

The image ships no gym/gymnasium, so rllib carries its own minimal space
algebra with the gymnasium calling convention (`sample`, `contains`, `shape`,
`dtype`, `n`). Reference envs type against gym.spaces (rllib/env/*); anything
written for gymnasium's Box/Discrete maps 1:1 onto these.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class Space:
    shape: Tuple[int, ...] = ()
    dtype: np.dtype = np.float32

    def sample(self, rng: Optional[np.random.Generator] = None):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape)

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(low, high, size=self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low) and np.all(x <= self.high)
        )

    def __repr__(self):
        return f"Box{self.shape}"


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int32)

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


def flat_dim(space: Space) -> int:
    """Size of the flattened observation / logits dim for an action space."""
    if isinstance(space, Discrete):
        return space.n
    return int(np.prod(space.shape)) if space.shape else 1


def from_gymnasium(space) -> Space:
    """Translate a gymnasium space into the in-tree algebra (the adapter
    half of env.GymnasiumEnv)."""
    name = type(space).__name__
    if name == "Discrete":
        return Discrete(int(space.n))
    if name == "Box":
        return Box(space.low, space.high, shape=space.shape, dtype=space.dtype)
    raise TypeError(f"Unsupported gymnasium space: {space!r}")
