from ray_tpu_torch.models.convert import params_from_flax, resnet_params_from_flax
from ray_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    collect_moe_losses,
    cross_entropy_loss,
    gpt2_125m,
    gpt2_350m,
    gpt2_760m,
)
from ray_tpu_torch.models.moe import MoEConfig, MoEMlp
from ray_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)

__all__ = [
    "GPT",
    "GPTConfig",
    "MoEConfig",
    "MoEMlp",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "collect_moe_losses",
    "cross_entropy_loss",
    "gpt2_125m",
    "gpt2_350m",
    "gpt2_760m",
    "params_from_flax",
    "resnet_params_from_flax",
]
