"""Public core API (reference: python/ray/_private/worker.py — init :1186,
remote :3016, get :2506, put :2621, wait :2684, kill :2840, cancel :2870,
get_actor :2805)."""

from __future__ import annotations

import os
from typing import Any, Iterable, Optional, Sequence, Union

from ray_tpu_torch._private import runtime as runtime_mod
from ray_tpu_torch._private.engine import CONTEXT
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime import Runtime, get_runtime
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.remote_function import RemoteFunction


def _detect_num_gpus() -> int:
    """CUDA devices visible to this process, counted without creating a
    CUDA context (``torch.cuda.device_count`` reads NVML or the driver)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def init(
    *,
    address: Optional[str] = None,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[dict[str, float]] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    client_server_port: Optional[int] = None,
    _system_config: Optional[dict] = None,
) -> Runtime:
    """Start the runtime with one (head) node, or connect to a remote one.

    The control plane lives in this process, and the workers too, as
    threads, unless ``_system_config={"isolation": "process"}`` makes them
    OS processes; ``GPU`` counts the visible CUDA devices unless
    ``num_gpus`` says otherwise. ``client_server_port=`` also listens on
    TCP for node daemons (``python -m ray_tpu_torch._private.node_daemon``)
    and remote drivers, and prints the connect string.

    ``address="host:port?token=..."`` connects this process as a remote
    driver to such a head (the ray-client analog, reference:
    python/ray/util/client/): the returned proxy serves the full
    task/actor/object API over the wire protocol, and the process runs no
    runtime of its own.
    """
    if runtime_mod._RUNTIME is not None:
        if ignore_reinit_error:
            return runtime_mod._RUNTIME
        raise RuntimeError(
            "ray_tpu_torch.init() called twice; pass ignore_reinit_error=True"
        )
    if address is not None:
        ignored = {
            "num_cpus": num_cpus,
            "num_gpus": num_gpus,
            "resources": resources,
            "client_server_port": client_server_port,
            "_system_config": _system_config,
        }
        bad = [k for k, v in ignored.items() if v is not None]
        if bad:
            raise ValueError(
                f"init(address=...) connects to an existing head; {bad} "
                "only apply when starting a local runtime"
            )
        from ray_tpu_torch._private.client import connect

        proxy = connect(address, namespace=namespace)
        runtime_mod._RUNTIME = proxy
        return proxy
    node_resources = dict(resources or {})
    node_resources["CPU"] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
    gpus = float(num_gpus if num_gpus is not None else _detect_num_gpus())
    if gpus:
        node_resources["GPU"] = gpus
    runtime = Runtime(
        resources=node_resources, system_config=_system_config, namespace=namespace
    )
    if client_server_port is not None:
        connect_address = runtime.serve_clients(port=client_server_port)
        # Surface the credentialed connect string — the auto-generated auth
        # token lives only in this address (or RAY_TPU_TORCH_CLIENT_TOKEN on
        # both sides), so remote drivers have no other way to obtain it.
        print(f"ray_tpu_torch client server listening; connect with "
              f'ray_tpu_torch.init(address="{connect_address}")')
    return runtime


def is_initialized() -> bool:
    return runtime_mod._RUNTIME is not None


def shutdown() -> None:
    if runtime_mod._RUNTIME is not None:
        runtime_mod._RUNTIME.shutdown()


def remote(*args, **kwargs):
    """@remote decorator for functions and classes (worker.py:3016)."""

    def make(target, options):
        if isinstance(target, type):
            return ActorClass(target, options)
        if callable(target):
            return RemoteFunction(target, options)
        raise TypeError(f"@remote target must be a function or class, got {target!r}")

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return make(args[0], {})
    if args:
        raise TypeError("@remote only takes keyword options, e.g. @remote(num_cpus=2)")

    def decorator(target):
        return make(target, kwargs)

    return decorator


def put(value: Any) -> ObjectRef:
    return get_runtime().put(value)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
):
    runtime = get_runtime()
    if isinstance(refs, ObjectRef):
        return runtime.get([refs], timeout)[0]
    if isinstance(refs, (list, tuple)):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(f"get() expects ObjectRefs, got {type(bad[0]).__name__}")
        return runtime.get(list(refs), timeout)
    raise TypeError(f"get() expects an ObjectRef or list, got {type(refs).__name__}")


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> tuple[list[ObjectRef], list[ObjectRef]]:
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns cannot exceed the number of refs")
    return get_runtime().wait(refs, num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle; use cancel() for tasks")
    get_runtime().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    get_runtime().cancel(ref, force=force, recursive=recursive)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    runtime = get_runtime()
    actor_id = runtime.controller.get_named_actor(name, namespace or runtime.namespace)
    if actor_id is None:
        raise ValueError(f"Failed to look up actor with name {name!r}")
    record = runtime.controller.get_actor_record(actor_id)
    return ActorHandle(actor_id, record.class_name if record else "Actor")


class RuntimeContext:
    """reference: ray.runtime_context.RuntimeContext."""

    def __init__(self, runtime: Runtime):
        self._runtime = runtime

    def get_job_id(self) -> str:
        return self._runtime.job_id.hex()

    def get_task_id(self) -> Optional[str]:
        task_id = CONTEXT.task_id
        return task_id.hex() if task_id else None

    def get_actor_id(self) -> Optional[str]:
        actor_id = CONTEXT.actor_id
        return actor_id.hex() if actor_id else None

    def get_node_id(self) -> Optional[str]:
        node_id = CONTEXT.node_id or self._runtime.controller.head_node_id
        return node_id.hex() if node_id else None

    def get_assigned_resources(self) -> dict[str, float]:
        return dict(CONTEXT.resource_grant)


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(get_runtime())


def get_gpu_ids() -> list[int]:
    """GPU indices granted to the current task/actor (reference:
    ray.get_gpu_ids, _private/worker.py:916)."""
    grant = CONTEXT.resource_grant
    return list(range(int(grant.get("GPU", 0)) if grant else 0))


def nodes() -> list[dict]:
    runtime = get_runtime()
    return [
        {
            "NodeID": n.node_id.hex(),
            "Alive": n.alive,
            "Resources": dict(n.total),
            "Available": dict(n.available),
            "Labels": dict(n.labels),
        }
        for n in runtime.controller.alive_nodes()
    ]


def cluster_resources() -> dict[str, float]:
    totals: dict[str, float] = {}
    for node in get_runtime().controller.alive_nodes():
        for name, amount in node.total.items():
            totals[name] = totals.get(name, 0.0) + amount
    return totals


def available_resources() -> dict[str, float]:
    totals: dict[str, float] = {}
    for node in get_runtime().controller.alive_nodes():
        for name, amount in node.available.items():
            totals[name] = totals.get(name, 0.0) + amount
    return totals


def timeline(
    filename: Optional[str] = None, trace_id: Optional[str] = None
):
    """Chrome-trace timeline of task executions and buffered tracing spans
    (reference: ray.timeline, _private/state.py:831), written as JSON when
    `filename` is given — load in chrome://tracing or Perfetto.

    With `trace_id`, exports ONE request's connected timeline instead:
    a Perfetto trace object with per-actor process rows (handle →
    router → ingress → engine) and flow events stitching the
    cross-actor span ids (observability.perfetto)."""
    runtime = get_runtime()
    if trace_id is not None:
        from ray_tpu_torch.observability.perfetto import (
            perfetto_trace,
            write_perfetto_trace,
        )

        if filename:
            return write_perfetto_trace(
                filename, trace_id=trace_id, runtime=runtime
            )
        return perfetto_trace(trace_id=trace_id, runtime=runtime)
    from ray_tpu_torch.util import tracing

    events = runtime.task_events.chrome_trace() + tracing.chrome_spans(runtime)
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(events, f)
    return events
