from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    cross_entropy_loss,
    gpt2_125m,
    gpt2_350m,
    gpt2_760m,
)

__all__ = [
    "GPT",
    "GPTConfig",
    "cross_entropy_loss",
    "gpt2_125m",
    "gpt2_350m",
    "gpt2_760m",
    "params_from_flax",
]
