"""ray_tpu_torch — the PyTorch / CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` (the JAX reference, which it never imports):
the in-process task/actor/object runtime (``init``, ``remote``, ``get``, ...)
and the Train library built on it (``ray_tpu_torch.train.TorchTrainer``),
the GPT model and its training step (``fused_adamw``), its hand-written
CUDA attention kernels (``ops/csrc``, forward and backward), and the
continuous-batching serving engine. Entry points take ``device=`` and
default to ``"cuda"``; without CUDA they raise unless the caller passes
``device="cpu"``. The kernels build with ``nvcc`` at first use on the card;
on the CPU every kernel wrapper runs its plain PyTorch version. Importing
the package creates no CUDA context.
"""

import os as _os

# pyarrow's bundled jemalloc pool can corrupt itself under heavy thread churn
# (runtime shutdown's pool-thread exits followed by an arrow call segfault);
# the system allocator does not. It must be set before pyarrow's first
# import, which ray_tpu_torch.data defers to blocks or files of its formats.
_os.environ.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")

from ray_tpu_torch import exceptions
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_gpu_ids,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.streaming import ObjectRefGenerator
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "ObjectRefGenerator",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "get",
    "get_actor",
    "get_gpu_ids",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "timeline",
    "wait",
]
