from ray_tpu_torch.rllib.algorithms.apex_dqn.apex_dqn import (
    ApexDQN,
    ApexDQNConfig,
    ReplayShard,
)

__all__ = ["ApexDQN", "ApexDQNConfig", "ReplayShard"]
