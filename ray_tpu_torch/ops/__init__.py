from ray_tpu_torch.ops.attention import (
    dequantize_kv,
    mha_reference,
    paged_attention,
)
from ray_tpu_torch.ops.flash_attention import (
    attention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_fused,
    flash_attention_bwd_fused_reference,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_packed_bwd,
    flash_attention_packed_bwd_reference,
    flash_attention_packed_fwd,
    flash_attention_packed_reference,
    flash_attention_reference,
)
from ray_tpu_torch.ops.fused_optim import FusedAdamWState, fused_adamw
from ray_tpu_torch.ops.paged_flash import (
    paged_attention_impl,
    paged_flash_attention,
    quantize_kv,
)

__all__ = [
    "FusedAdamWState",
    "attention",
    "dequantize_kv",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_fused",
    "flash_attention_bwd_fused_reference",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_packed_bwd",
    "flash_attention_packed_bwd_reference",
    "flash_attention_packed_fwd",
    "flash_attention_packed_reference",
    "flash_attention_reference",
    "fused_adamw",
    "mha_reference",
    "paged_attention",
    "paged_attention_impl",
    "paged_flash_attention",
    "quantize_kv",
]
