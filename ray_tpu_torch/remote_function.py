"""@remote functions (reference: python/ray/remote_function.py, _remote :245)."""

from __future__ import annotations

import functools
from typing import Any, Callable

from ray_tpu_torch._private import options as option_utils
from ray_tpu_torch._private.runtime import get_runtime


class RemoteFunction:
    def __init__(self, func: Callable, task_options: dict[str, Any]):
        self._function = func
        self._options = option_utils.validate_task_options(task_options)
        functools.update_wrapper(self, func)

    def options(self, **task_options) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(task_options)
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        opts = self._options
        runtime = get_runtime()
        resources = option_utils.to_resource_request(
            opts.get("num_cpus"),
            opts.get("num_gpus"),
            opts.get("resources"),
            default_num_cpus=1.0,  # tasks default to 1 CPU (ray_option_utils.py)
        )
        num_returns = opts.get("num_returns", 1)
        refs = runtime.submit_task(
            self._function,
            args,
            kwargs,
            name=opts.get("name") or self._function.__qualname__,
            num_returns=num_returns,
            resources=resources,
            scheduling_strategy=opts.get("scheduling_strategy"),
            max_retries=opts.get("max_retries", option_utils.DEFAULT_MAX_RETRIES),
            retry_exceptions=opts.get("retry_exceptions", False),
            runtime_env=opts.get("runtime_env"),
        )
        if num_returns == 0:
            return None
        if num_returns == 1 or num_returns == "streaming":
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function.__qualname__!r} cannot be called "
            "directly. Use .remote() instead."
        )

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node instead of submitting (reference:
        dag/function_node.py)."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs, {})
