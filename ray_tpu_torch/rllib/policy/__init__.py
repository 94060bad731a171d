from ray_tpu_torch.rllib.policy.sample_batch import (
    MultiAgentBatch,
    SampleBatch,
    concat_samples,
)

__all__ = ["MultiAgentBatch", "SampleBatch", "concat_samples"]
