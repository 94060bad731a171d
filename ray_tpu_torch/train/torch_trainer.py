"""TorchTrainer + in-loop helpers — the port's Train path.

The counterpart of the reference's `jax_trainer.py`: `TorchTrainer` is a
`DataParallelTrainer` whose backend (`TorchBackendConfig`) gives every worker
its torch.device and host collective group before the user loop starts.

In-loop helpers (the reference's `prepare_params`/`prepare_batch`/
`prepare_step`, train/torch/train_loop_utils.py:245,329 in Ray):
`prepare_params` moves a parameter dict or module to the worker's device,
`prepare_batch` copies a batch there, and `prepare_step` times the step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.air import session
from ray_tpu_torch.train.backend import TorchBackendConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer


class TorchTrainer(DataParallelTrainer):
    """Runs `train_loop_per_worker` on `scaling_config.num_workers` worker
    actors. The default backend puts each worker on CUDA and raises without
    it; pass `backend_config=TorchBackendConfig(device="cpu")` for the CPU."""

    def __init__(self, train_loop_per_worker: Callable, **kwargs):
        if kwargs.get("backend_config") is None:
            kwargs["backend_config"] = TorchBackendConfig()
        super().__init__(train_loop_per_worker, **kwargs)


# -- in-loop helpers ---------------------------------------------------------


def _to_device(tree: Any, device: torch.device, non_blocking: bool) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=non_blocking)
    if isinstance(tree, dict):
        return {k: _to_device(v, device, non_blocking) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, non_blocking) for v in tree)
    return tree


def prepare_params(params: Any) -> Any:
    """Move a parameter dict (any tree of tensors, e.g. a checkpoint's) or an
    `nn.Module` to the session's device. Values are unchanged, bit for bit."""
    device = session.get_device()
    if isinstance(params, torch.nn.Module):
        return params.to(device)
    return _to_device(params, device, non_blocking=False)


def prepare_batch(batch: Any) -> Any:
    """Copy a batch (a tensor or a tree of them) to the session's device,
    non-blocking. Under an instrumented session the copy counts as
    `data_wait` (it is the step's wait-for-input tail), and batches feed the
    samples/sec clock."""
    from ray_tpu_torch.train.observability import batch_rows, current_profiler

    device = session.get_device()
    profiler = current_profiler()
    if profiler is None:
        return _to_device(batch, device, non_blocking=True)
    with profiler.phase("data_wait"):
        out = _to_device(batch, device, non_blocking=True)
    profiler.add_samples(batch_rows(batch))
    return out


def prepare_step(step_fn: Callable) -> Callable:
    """Under an instrumented session each call is timed into the `compute`
    phase and bounded by `torch.cuda.synchronize(device)` (the reference's
    block_until_ready) — otherwise asynchronous launches would bill device
    time to whatever host code touches the result next. Uninstrumented (or
    driver-side) callers get `step_fn` itself."""
    from ray_tpu_torch.train.observability import current_profiler

    # The session's profiler is fixed for the loop's lifetime: decide once.
    profiler = current_profiler()
    if profiler is None:
        return step_fn
    device = session.get_device()
    sync = torch.cuda.synchronize if device.type == "cuda" else None

    def instrumented_step(*args, **kwargs):
        with profiler.phase("compute"):
            out = step_fn(*args, **kwargs)
            if sync is not None:
                sync(device)
        return out

    return instrumented_step


def report_from_rank0(metrics: dict, checkpoint=None) -> None:
    """report() with identical metrics from every rank; checkpoint only from
    rank 0 (the reference persists the master rank's checkpoint)."""
    if session.get_world_rank() == 0:
        session.report(metrics, checkpoint=checkpoint)
    else:
        session.report(metrics)
