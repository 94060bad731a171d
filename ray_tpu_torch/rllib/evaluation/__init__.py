from ray_tpu_torch.rllib.evaluation.env_runner import EnvRunner, RemoteEnvRunner
from ray_tpu_torch.rllib.evaluation.postprocessing import (
    compute_advantages,
    compute_gae_for_sample_batch,
)
from ray_tpu_torch.rllib.evaluation.worker_set import EnvRunnerGroup

__all__ = [
    "EnvRunner",
    "EnvRunnerGroup",
    "RemoteEnvRunner",
    "compute_advantages",
    "compute_gae_for_sample_batch",
]
