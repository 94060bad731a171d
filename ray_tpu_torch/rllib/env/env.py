"""Environment API: Env, VectorEnv, MultiAgentEnv.

Gymnasium step convention: `reset(seed) -> (obs, info)`,
`step(a) -> (obs, reward, terminated, truncated, info)`. The reference
vectorizes envs inside the sampler (rllib/env/vector_env.py VectorEnvWrapper);
here `SyncVectorEnv` is the only vectorization layer and auto-resets finished
sub-envs, which is what the batched rollout loop (env_runner.py) consumes —
fixed batch shapes every step, the XLA-friendly property.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.rllib.env.spaces import Space


class Env:
    """Single-agent environment base (reference: gym.Env as used throughout
    rllib/env/)."""

    observation_space: Space
    action_space: Space

    def reset(self, *, seed: Optional[int] = None) -> tuple:
        raise NotImplementedError

    def step(self, action) -> tuple:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MultiAgentEnv(Env):
    """Dict-keyed multi-agent env (reference: rllib/env/multi_agent_env.py).

    reset -> ({agent: obs}, {agent: info}); step({agent: action}) ->
    (obs_dict, rew_dict, terminated_dict, truncated_dict, info_dict) with the
    special "__all__" key in terminated/truncated.
    """

    agent_ids: list = []

    def observation_space_for(self, agent_id) -> Space:
        return self.observation_space

    def action_space_for(self, agent_id) -> Space:
        return self.action_space


class VectorEnv:
    """Natively-batched environment: all B sub-envs advance in ONE call.

    Reference: rllib/env/vector_env.py VectorEnv (the `vector_step` API).
    The python-loop SyncVectorEnv below costs ~10us of interpreter per
    sub-env per step; a numpy-vectorized implementation (classic.py
    VectorCartPole, minatar.py) steps hundreds of envs in one fused pass —
    on one sampling core that is the difference between 40k and 100k+
    env-steps/s. Must implement the same auto-reset contract as
    SyncVectorEnv: done sub-envs reset in place and surface the true final
    observation via infos[i]["final_observation"].
    """

    observation_space: Space
    action_space: Space
    num_envs: int

    def reset(self, *, seed: Optional[int] = None) -> tuple:
        raise NotImplementedError

    def step(self, actions) -> tuple:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyncVectorEnv(VectorEnv):
    """N sub-envs stepped in lockstep with auto-reset.

    Reference: rllib/env/vector_env.py:_VectorizedGymEnv (vector_env.py, auto
    reset in VectorEnvWrapper). Terminal observations are replaced by the
    reset observation; the true final obs is surfaced in infos as
    "final_observation" (gymnasium convention) for bootstrap-value computation.
    """

    def __init__(self, env_fns: list):
        assert env_fns, "need at least one env"
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self, *, seed: Optional[int] = None):
        obs, infos = [], []
        for i, env in enumerate(self.envs):
            o, info = env.reset(seed=None if seed is None else seed + i)
            obs.append(o)
            infos.append(info)
        return np.stack(obs), infos

    def step(self, actions):
        obs, rews, terms, truncs, infos = [], [], [], [], []
        for env, action in zip(self.envs, actions):
            o, r, term, trunc, info = env.step(action)
            if term or trunc:
                info = dict(info)
                info["final_observation"] = o
                o, _ = env.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
            infos.append(info)
        return (
            np.stack(obs),
            np.asarray(rews, dtype=np.float32),
            np.asarray(terms, dtype=bool),
            np.asarray(truncs, dtype=bool),
            infos,
        )

    def close(self):
        for env in self.envs:
            env.close()


class EnvContext(dict):
    """Env config dict + worker/vector indices (reference:
    rllib/env/env_context.py)."""

    def __init__(self, config: dict, worker_index: int = 0, vector_index: int = 0):
        super().__init__(config or {})
        self.worker_index = worker_index
        self.vector_index = vector_index


_ENV_REGISTRY: dict[str, Callable[[EnvContext], Env]] = {}
_VECTOR_ENV_REGISTRY: dict[str, Callable[[int, EnvContext], "VectorEnv"]] = {}


def register_env(name: str, creator: Callable[[Any], Env]) -> None:
    """Reference: ray/tune/registry.py register_env as used by rllib."""
    _ENV_REGISTRY[name] = creator


def register_vector_env(
    name: str, creator: Callable[[int, EnvContext], "VectorEnv"]
) -> None:
    """Register a natively-batched implementation for an env name; the
    env runner prefers it over per-env SyncVectorEnv wrapping.
    creator(num_envs, ctx) -> VectorEnv."""
    _VECTOR_ENV_REGISTRY[name] = creator


class GymnasiumEnv(Env):
    """Adapter for gymnasium environments (reference:
    rllib/env/wrappers/atari_wrappers.py + the gym.make interop throughout
    rllib/env/utils.py): translates gymnasium spaces to ray_tpu spaces and
    passes the 5-tuple step convention through unchanged."""

    def __init__(self, gym_env):
        from ray_tpu_torch.rllib.env.spaces import from_gymnasium

        self._env = gym_env
        self.observation_space = from_gymnasium(gym_env.observation_space)
        self.action_space = from_gymnasium(gym_env.action_space)

    def reset(self, *, seed: Optional[int] = None):
        return self._env.reset(seed=seed)

    def step(self, action):
        return self._env.step(action)

    def close(self) -> None:
        self._env.close()


def _ensure_builtins() -> None:
    from ray_tpu_torch.rllib.env import classic, minatar  # noqa: F401 — register


def make_env(spec, config: Optional[dict] = None, worker_index: int = 0) -> Env:
    """Resolve an env spec: registered name, Env subclass, callable, or any
    gymnasium id (e.g. "LunarLander-v3") as a fallback."""
    ctx = EnvContext(config or {}, worker_index=worker_index)
    if isinstance(spec, str):
        if spec not in _ENV_REGISTRY:
            _ensure_builtins()
        if spec in _ENV_REGISTRY:
            return _ENV_REGISTRY[spec](ctx)
        try:
            import gymnasium

            return GymnasiumEnv(gymnasium.make(spec, **ctx))
        except Exception:
            raise KeyError(
                f"Unknown env {spec!r}; registered: {sorted(_ENV_REGISTRY)} "
                "(and not resolvable as a gymnasium id)"
            ) from None
    if isinstance(spec, type) and issubclass(spec, Env):
        try:
            return spec(ctx)
        except TypeError:
            return spec()
    if callable(spec):
        return spec(ctx)
    raise TypeError(f"Bad env spec: {spec!r}")


def make_vector_env(
    spec,
    num_envs: int,
    config: Optional[dict] = None,
    worker_index: int = 0,
) -> "VectorEnv":
    """Vectorize an env spec: a registered native VectorEnv when one exists
    (one fused numpy step for all sub-envs), else SyncVectorEnv around
    per-env instances."""
    if isinstance(spec, str):
        if spec not in _VECTOR_ENV_REGISTRY and spec not in _ENV_REGISTRY:
            _ensure_builtins()
        creator = _VECTOR_ENV_REGISTRY.get(spec)
        if creator is not None:
            ctx = EnvContext(config or {}, worker_index=worker_index)
            return creator(num_envs, ctx)
    return SyncVectorEnv(
        [
            (lambda i=i: make_env(spec, config, worker_index=worker_index))
            for i in range(num_envs)
        ]
    )
