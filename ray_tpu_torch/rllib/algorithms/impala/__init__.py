from ray_tpu_torch.rllib.algorithms.impala.impala import (
    IMPALA,
    IMPALAConfig,
    IMPALALearner,
)
from ray_tpu_torch.rllib.algorithms.impala import vtrace

__all__ = ["IMPALA", "IMPALAConfig", "IMPALALearner", "vtrace"]
