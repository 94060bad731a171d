"""The port's device rule, shared by every entry point."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Entry points run on the card unless the caller asks otherwise:
    ``device=None`` means CUDA, and raises when CUDA is absent instead of
    carrying on on the CPU. Pass ``device="cpu"`` to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given: "
                "ray_tpu_torch entry points default to device='cuda'; pass "
                "device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
