"""Public Serve API: @serve.deployment, .bind(), serve.run, status, shutdown.

Reference: serve/api.py:413 (serve.run), serve/deployment.py (@serve.deployment
→ Deployment → .bind() → Application), serve/_private/client.py:257
(deploy_application). Applications are lazy graphs: bound deployments appearing
in another deployment's init args are replaced with DeploymentHandles at
deploy time (reference: deployment graph build,
serve/_private/deployment_graph_build.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Union

import cloudpickle

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.handle import DeploymentHandle


@dataclass
class Application:
    """A bound deployment (+ its transitively bound dependencies)."""

    deployment: "Deployment"
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)

    def _collect(self, out: dict) -> None:
        name = self.deployment.name
        if name in out:
            return
        out[name] = self
        for a in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(a, Application):
                a._collect(out)


class Deployment:
    def __init__(
        self,
        callable_def: Union[type, Callable],
        name: str,
        config: DeploymentConfig,
    ):
        self._callable_def = callable_def
        self.name = name
        self._config = config

    def options(
        self,
        name: Optional[str] = None,
        num_replicas: Optional[int] = None,
        max_concurrent_queries: Optional[int] = None,
        autoscaling_config: Optional[Union[AutoscalingConfig, dict]] = None,
        user_config: Any = None,
        ray_actor_options: Optional[dict] = None,
        health_check_period_s: Optional[float] = None,
        graceful_shutdown_timeout_s: Optional[float] = None,
        request_retry_budget: Optional[int] = None,
        request_backoff_initial_s: Optional[float] = None,
        request_backoff_jitter_seed: Optional[int] = None,
        stream_resume_fn: Optional[Callable] = None,
        affinity_key_fn: Optional[Callable] = None,
    ) -> "Deployment":
        cfg = replace(self._config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_concurrent_queries is not None:
            cfg.max_concurrent_queries = max_concurrent_queries
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if request_retry_budget is not None:
            cfg.request_retry_budget = request_retry_budget
        if request_backoff_initial_s is not None:
            cfg.request_backoff_initial_s = request_backoff_initial_s
        if request_backoff_jitter_seed is not None:
            cfg.request_backoff_jitter_seed = request_backoff_jitter_seed
        if stream_resume_fn is not None:
            cfg.stream_resume_fn = stream_resume_fn
        if affinity_key_fn is not None:
            cfg.affinity_key_fn = affinity_key_fn
        return Deployment(self._callable_def, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def _code_version(self) -> str:
        try:
            payload = cloudpickle.dumps(self._callable_def)
        except Exception:
            payload = repr(self._callable_def).encode()
        return hashlib.sha1(payload).hexdigest()[:16]


def deployment(
    _callable: Optional[Union[type, Callable]] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_concurrent_queries: int = 100,
    autoscaling_config: Optional[Union[AutoscalingConfig, dict]] = None,
    user_config: Any = None,
    ray_actor_options: Optional[dict] = None,
):
    """Decorator: mark a class or function as a Serve deployment."""

    def wrap(target):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            ray_actor_options=ray_actor_options or {},
        )
        if autoscaling_config is not None:
            ac = autoscaling_config
            if isinstance(ac, dict):
                ac = AutoscalingConfig(**ac)
            cfg.autoscaling_config = ac
        return Deployment(target, name or target.__name__, cfg)

    if _callable is not None:
        return wrap(_callable)
    return wrap


# ---------------- run / shutdown / status ----------------

_DEFAULT_APP = "default"


def run(
    app: Application,
    name: str = _DEFAULT_APP,
    _blocking_timeout_s: float = 60.0,
) -> DeploymentHandle:
    """Deploy an application and block until healthy, returning a handle to
    the ingress deployment (reference: serve/api.py:413)."""
    from ray_tpu_torch import api as ray
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    if not ray.is_initialized():
        ray.init()
    bound: dict[str, Application] = {}
    app._collect(bound)

    def materialize_arg(a):
        if isinstance(a, Application):
            d = a.deployment
            return DeploymentHandle(
                name,
                d.name,
                d._config.max_concurrent_queries,
                retry_budget=d._config.request_retry_budget,
                backoff_initial_s=d._config.request_backoff_initial_s,
                backoff_jitter_seed=d._config.request_backoff_jitter_seed,
            )
        return a

    deployments = []
    for dep_name, bound_app in bound.items():
        d = bound_app.deployment
        deployments.append(
            {
                "name": dep_name,
                "callable_def": d._callable_def,
                "init_args": tuple(
                    materialize_arg(a) for a in bound_app.init_args
                ),
                "init_kwargs": {
                    k: materialize_arg(v)
                    for k, v in bound_app.init_kwargs.items()
                },
                "config": d._config,
                "code_version": d._code_version(),
            }
        )
    controller = get_or_create_controller()
    ray.get(controller.deploy_application.remote(name, deployments))
    _wait_healthy(controller, name, _blocking_timeout_s)
    ingress = app.deployment
    return DeploymentHandle(
        name,
        ingress.name,
        ingress._config.max_concurrent_queries,
        retry_budget=ingress._config.request_retry_budget,
        backoff_initial_s=ingress._config.request_backoff_initial_s,
        backoff_jitter_seed=ingress._config.request_backoff_jitter_seed,
        stream_resume_fn=ingress._config.stream_resume_fn,
        affinity_key_fn=ingress._config.affinity_key_fn,
    )


def _wait_healthy(controller, app_name: str, timeout_s: float) -> None:
    import time

    from ray_tpu_torch import api as ray

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = ray.get(controller.get_status.remote())
        app = st.get(app_name, {})
        if app and all(d["status"] == "HEALTHY" for d in app.values()):
            return
        if any(d["status"] == "DEPLOY_FAILED" for d in app.values()):
            bad = {k: v for k, v in app.items() if v["status"] == "DEPLOY_FAILED"}
            raise RuntimeError(f"Deployment failed: {bad}")
        time.sleep(0.05)
    raise TimeoutError(f"Application {app_name!r} not healthy in {timeout_s}s")


def scale_deployment(
    deployment_name: str, num_replicas: int, app_name: str = _DEFAULT_APP
) -> None:
    """Imperatively retarget a deployment's replica count (ops / chaos
    hook — the loadgen drain cell fires this mid-run). Scale-down goes
    through the controller's graceful drain protocol: the shrunk routing
    set publishes first, in-flight requests get up to
    graceful_shutdown_timeout_s to finish, and interrupted streams
    resume on surviving replicas. A deployment with an autoscaling
    policy keeps autoscaling — the policy overrides this target on the
    next reconcile pass."""
    from ray_tpu_torch import api as ray
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    ok = ray.get(
        get_or_create_controller().set_target_replicas.remote(
            app_name, deployment_name, int(num_replicas)
        )
    )
    if not ok:
        raise ValueError(
            f"No deployment {deployment_name!r} in app {app_name!r}"
        )


def get_deployment_handle(
    deployment_name: str, app_name: str = _DEFAULT_APP
) -> DeploymentHandle:
    return _handle_with_configured_knobs(app_name, deployment_name)


def get_app_handle(app_name: str = _DEFAULT_APP) -> DeploymentHandle:
    from ray_tpu_torch import api as ray
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    st = ray.get(get_or_create_controller().get_status.remote())
    app = st.get(app_name)
    if not app:
        raise ValueError(f"No application named {app_name!r}")
    # The ingress is the first deployment deployed for the app.
    return _handle_with_configured_knobs(app_name, next(iter(app)))


def _handle_with_configured_knobs(
    app_name: str, deployment_name: str
) -> DeploymentHandle:
    """Build a handle that honors the deployment's configured failover/
    concurrency knobs (same as the handle serve.run returns); falls back
    to defaults when the deployment isn't known to the controller yet."""
    from ray_tpu_torch import api as ray
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    try:
        cfg = ray.get(
            get_or_create_controller().get_deployment_config.remote(
                app_name, deployment_name
            ),
            timeout=10.0,
        )
    except Exception:
        cfg = None
    if cfg is None:
        return DeploymentHandle(app_name, deployment_name)
    return DeploymentHandle(
        app_name,
        deployment_name,
        cfg.max_concurrent_queries,
        retry_budget=cfg.request_retry_budget,
        backoff_initial_s=cfg.request_backoff_initial_s,
        backoff_jitter_seed=getattr(
            cfg, "request_backoff_jitter_seed", None
        ),
        # The deployment-declared mid-stream failover policy rides every
        # configured handle — including the HTTP proxy's — so streams
        # migrate off dying/draining replicas for HTTP clients too; the
        # declared affinity policy rides along the same way.
        stream_resume_fn=getattr(cfg, "stream_resume_fn", None),
        affinity_key_fn=getattr(cfg, "affinity_key_fn", None),
    )


class _NodeProxyActor:
    """Actor shell hosting an HTTPProxyActor on whatever node it lands on
    (reference: one HTTPProxyActor per node, serve/_private/proxy.py).
    Binds all interfaces and advertises the machine's outward-facing
    address so off-node clients can reach it."""

    def __init__(self, port: int, request_timeout_s: float,
                 probe_host: Optional[str] = None):
        from ray_tpu_torch.serve._private.http_proxy import HTTPProxyActor

        self._probe_host = probe_host
        self._proxy = HTTPProxyActor("0.0.0.0", port, request_timeout_s)

    def address(self) -> tuple:
        import socket as _socket

        _, port = self._proxy.address()
        # The interface used to reach the head is the address peers can
        # reach US at (node_daemon._advertise_host's trick); hostname
        # resolution is the single-machine fallback.
        if self._probe_host:
            try:
                probe = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
                probe.connect((self._probe_host, 1))
                host = probe.getsockname()[0]
                probe.close()
                return (host, port)
            except OSError:
                pass
        try:
            return (_socket.gethostbyname(_socket.gethostname()), port)
        except OSError:
            return ("127.0.0.1", port)

    def ready(self) -> bool:
        return True

    def shutdown(self) -> None:
        self._proxy.shutdown()


_node_proxies: list = []


def start(
    proxy_location: str = "HeadOnly",
    http_host: str = "127.0.0.1",
    http_port: int = 0,
    request_timeout_s: float = 60.0,
) -> list:
    """Start HTTP ingress proxies (reference: serve.start + per-node
    HTTPProxyActor placement). "HeadOnly" runs one in-process proxy;
    "EveryNode" additionally pins one proxy ACTOR to every alive node (port
    0 = ephemeral per node). Returns [(host, port), ...]."""
    from ray_tpu_torch import api as ray
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.serve._private.http_proxy import start_proxy
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    addresses = [start_proxy(http_host, http_port, request_timeout_s)]
    if proxy_location == "EveryNode":
        if _node_proxies:
            # Idempotent: the node fleet is already up; report it.
            return addresses + [addr for _, addr in _node_proxies]
        runtime = get_runtime()
        head = getattr(runtime, "_head_server", None)
        probe_host = head.host if head else None
        proxy_cls = ray.remote(_NodeProxyActor)
        for node in runtime.controller.alive_nodes():
            actor = proxy_cls.options(
                num_cpus=0,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node.node_id.hex(), soft=False
                ),
            ).remote(0, request_timeout_s, probe_host)
            addr = tuple(ray.get(actor.address.remote()))
            addresses.append(addr)
            _node_proxies.append((actor, addr))
    return addresses


def status() -> dict:
    from ray_tpu_torch import api as ray
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    return ray.get(get_or_create_controller().get_status.remote())


def shutdown() -> None:
    from ray_tpu_torch import api as ray
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.serve._private.controller import (
        CONTROLLER_NAME,
        get_or_create_controller,
    )
    from ray_tpu_torch.serve._private.http_proxy import stop_proxy

    if not ray.is_initialized():
        return
    stop_proxy()
    global _node_proxies
    proxies, _node_proxies = _node_proxies, []
    for actor, _addr in proxies:
        try:
            ray.get(actor.shutdown.remote(), timeout=10.0)
        except Exception:
            pass
        finally:
            try:
                ray.kill(actor)  # force-kill even if graceful stop hung
            except Exception:
                pass
    runtime = get_runtime()
    existing = runtime.controller.get_named_actor(
        CONTROLLER_NAME, runtime.namespace
    )
    if existing is None:
        return
    controller = get_or_create_controller()
    try:
        ray.get(controller.graceful_shutdown.remote(), timeout=30.0)
    finally:
        from ray_tpu_torch.actor import ActorHandle

        ray.kill(ActorHandle(existing, "ServeControllerActor"))
