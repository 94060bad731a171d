from ray_tpu_torch.rllib.core.distributions import Categorical, DiagGaussian, get_dist_cls
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (
    MultiAgentRLModule,
    PiVfNet,
    QNet,
    RLModule,
    RLModuleSpec,
    params_from_flax,
)

__all__ = [
    "Categorical",
    "DiagGaussian",
    "Learner",
    "LearnerGroup",
    "MultiAgentRLModule",
    "PiVfNet",
    "QNet",
    "RLModule",
    "RLModuleSpec",
    "get_dist_cls",
    "params_from_flax",
]
