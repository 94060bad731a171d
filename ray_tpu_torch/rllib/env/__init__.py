from ray_tpu_torch.rllib.env.env import (
    Env,
    EnvContext,
    GymnasiumEnv,
    MultiAgentEnv,
    SyncVectorEnv,
    VectorEnv,
    make_env,
    make_vector_env,
    register_env,
    register_vector_env,
)
from ray_tpu_torch.rllib.env.spaces import Box, Discrete, Space, flat_dim

__all__ = [
    "Box",
    "Discrete",
    "Env",
    "EnvContext",
    "GymnasiumEnv",
    "MultiAgentEnv",
    "Space",
    "SyncVectorEnv",
    "VectorEnv",
    "flat_dim",
    "make_env",
    "make_vector_env",
    "register_env",
    "register_vector_env",
]
