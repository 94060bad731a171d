from ray_tpu_torch.rllib.algorithms.sac.sac import (
    SAC,
    SACConfig,
    SACLearner,
    SACModule,
)

__all__ = ["SAC", "SACConfig", "SACLearner", "SACModule"]
