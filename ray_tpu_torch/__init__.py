"""ray_tpu_torch — the PyTorch / CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` (the JAX reference, which it never imports):
the GPT model and its training step (``fused_adamw``), its hand-written
CUDA attention kernels (``ops/csrc``, forward and backward), and the
continuous-batching serving engine. Entry points take ``device=`` and
default to ``"cuda"``; without CUDA they raise unless the caller passes
``device="cpu"``. The kernels build with ``nvcc`` at first use on the card;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
