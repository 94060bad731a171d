"""Training backends — per-framework worker-group setup.

Reference: the Backend plugin protocol (train/_internal/backend_executor.py
drives Backend.on_start/on_shutdown; torch impl at train/torch/config.py:155).
The JAX reference forms a device mesh and a host collective group on every
worker; the port's TorchBackend gives each worker its torch.device and the
same host collective group. Gradient sync across workers over NCCL waits for
the parallel layer (ROADMAP.md §B7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks called by the BackendExecutor around the worker group."""

    def on_start(self, worker_group, backend_config: "BackendConfig") -> None:
        pass

    def on_training_start(self, worker_group, backend_config: "BackendConfig") -> None:
        pass

    def on_shutdown(self, worker_group, backend_config: "BackendConfig") -> None:
        pass


# ---------------------------------------------------------------------------
# Torch backend
# ---------------------------------------------------------------------------


@dataclass
class TorchBackendConfig(BackendConfig):
    """Device-choosing backend config (the JaxBackendConfig counterpart).

    device: where each worker's loop runs. "cuda" (the default) gives rank
        r's worker `cuda:<local_rank>` and raises without CUDA; pass "cpu"
        to train on the host.
    collective_group: name of the host collective group every worker joins
        (`util.collective`, numpy over a named actor).
    mesh_spec / mesh_strategy / multihost: the reference's mesh options,
        kept so that asking for anything but the defaults is refused.
    """

    device: str = "cuda"
    collective_group: str = "train"
    mesh_spec: Optional[Any] = None
    mesh_strategy: str = "dp"
    multihost: bool = False

    def __post_init__(self):
        from ray_tpu_torch._private.device import resolve_device

        resolve_device(self.device)  # raises for CUDA without CUDA
        if self.mesh_spec is not None or self.mesh_strategy != "dp":
            raise NotImplementedError(
                "TorchBackendConfig: device meshes (mesh_spec, mesh_strategy) "
                "wait for the parallel layer (ROADMAP.md §B7)"
            )
        if self.multihost:
            raise NotImplementedError(
                "TorchBackendConfig(multihost=True): multi-host training over "
                "NCCL waits for the parallel layer (ROADMAP.md §B7)"
            )

    @property
    def backend_cls(self):
        return TorchBackend


def _set_up_worker(context, config: TorchBackendConfig, num_workers: int) -> str:
    """Runs ON each worker: choose its device and join the host collective
    group. Membership is stashed on the worker context: the train loop runs
    on a different thread (the runner), which resolves groups via its
    session."""
    import torch

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.util import collective

    device = resolve_device(config.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", context.local_rank)
    context.device = device
    state = collective.create_group_state(
        world_size=num_workers,
        rank=context.world_rank,
        group_name=config.collective_group,
    )
    context.extras.setdefault("collective_groups", {})[config.collective_group] = state
    return str(device)


class TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchBackendConfig) -> None:
        worker_group.execute(
            _set_up_worker, backend_config, worker_group.num_workers
        )

    def on_shutdown(self, worker_group, backend_config: TorchBackendConfig) -> None:
        def _leave(context):
            import ray_tpu_torch

            state = context.extras.get("collective_groups", {}).pop(
                backend_config.collective_group, None
            )
            # Rank 0 kills the rendezvous actor so the next trainer can form a
            # group of a different size under the same name.
            if state is not None and context.world_rank == 0:
                try:
                    ray_tpu_torch.kill(state.handle)
                except Exception:
                    pass

        try:
            worker_group.execute(_leave)
        except Exception:
            pass
