from ray_tpu_torch.ops.attention import (
    dequantize_kv,
    mha_reference,
    paged_attention,
)
from ray_tpu_torch.ops.flash_attention import (
    attention,
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
)
from ray_tpu_torch.ops.paged_flash import (
    paged_attention_impl,
    paged_flash_attention,
    quantize_kv,
)

__all__ = [
    "attention",
    "dequantize_kv",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_reference",
    "mha_reference",
    "paged_attention",
    "paged_attention_impl",
    "paged_flash_attention",
    "quantize_kv",
]
