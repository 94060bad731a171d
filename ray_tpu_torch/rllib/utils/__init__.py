from ray_tpu_torch.rllib.utils.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)

__all__ = ["PrioritizedReplayBuffer", "ReplayBuffer"]
