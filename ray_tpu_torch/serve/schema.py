"""Declarative Serve config — GitOps-style application deployment.

Reference: serve/schema.py (ServeDeploySchema / ServeApplicationSchema) +
serve/controller.py:483 deploy_apps: a config document (usually YAML) lists
applications by import path with per-deployment overrides; applying it
reconciles the running cluster to the document. `serve run`-style ad-hoc code
and config-driven deploys share the same controller path.

Config shape:

    applications:
      - name: text-app
        import_path: my_module:app          # a bound Application or Deployment
        args: {}                            # kwargs for a builder function
        deployments:                        # per-deployment overrides
          - name: LM
            num_replicas: 2
            user_config: {temperature: 0.7}
            max_concurrent_queries: 16
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.api import Application, Deployment, run as serve_run


def _validate(config: dict) -> List[dict]:
    if not isinstance(config, dict):
        raise TypeError("serve config must be a dict")
    apps = config.get("applications")
    if not isinstance(apps, list) or not apps:
        raise ValueError("serve config needs a non-empty 'applications' list")
    seen_names: set = set()
    for app in apps:
        if not isinstance(app, dict):
            raise ValueError(
                f"each applications entry must be a dict, got {app!r}"
            )
        if "import_path" not in app:
            raise ValueError(f"application {app.get('name')!r} needs import_path")
        if ":" not in app["import_path"]:
            raise ValueError(
                f"import_path {app['import_path']!r} must be 'module:attribute'"
            )
        name = app.get("name") or "default"
        if name in seen_names:
            raise ValueError(
                f"Duplicate application name {name!r}: the second deploy "
                "would silently reconcile away the first"
            )
        seen_names.add(name)
        for dep in app.get("deployments", []) or []:
            if "name" not in dep:
                raise ValueError("deployment overrides need a 'name'")
    return apps


def _clone_app(app: Application) -> Application:
    """Copy the Application tree so overrides never touch the module-level
    objects (the module cache would leak one apply's overrides into the
    next, or into sibling apps sharing an import path)."""
    new_args = tuple(
        _clone_app(a) if isinstance(a, Application) else a for a in app.init_args
    )
    new_kwargs = {
        k: _clone_app(v) if isinstance(v, Application) else v
        for k, v in app.init_kwargs.items()
    }
    return Application(
        deployment=app.deployment, init_args=new_args, init_kwargs=new_kwargs
    )


def _load_target(import_path: str, args: Optional[dict]) -> Application:
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    target = getattr(module, attr)
    if isinstance(target, (Application, Deployment)):
        if args:
            raise ValueError(
                f"{import_path} is already bound; 'args' only applies to "
                "builder functions (the config's args would be silently "
                "ignored otherwise)"
            )
        app = target if isinstance(target, Application) else target.bind()
        return _clone_app(app)
    if callable(target):  # builder function -> Application
        built = target(**(args or {}))
        if isinstance(built, Deployment):
            built = built.bind()
        if not isinstance(built, Application):
            raise TypeError(
                f"{import_path} returned {type(built).__name__}, expected an "
                "Application (a .bind() result)"
            )
        return _clone_app(built)
    raise TypeError(f"{import_path} is not an Application/Deployment/builder")


_OVERRIDABLE = {
    "num_replicas",
    "max_concurrent_queries",
    "autoscaling_config",
    "user_config",
    "ray_actor_options",
    "health_check_period_s",
    "graceful_shutdown_timeout_s",
}


def _apply_overrides(app: Application, overrides: List[dict]) -> None:
    by_name: dict = {}
    app._collect(by_name)  # deployment name -> Application node
    for dep_override in overrides or []:
        name = dep_override["name"]
        node = by_name.get(name)
        if node is None:
            raise ValueError(
                f"Config overrides unknown deployment {name!r}; "
                f"app has {sorted(by_name)}"
            )
        fields = {k: v for k, v in dep_override.items() if k != "name"}
        unknown = set(fields) - _OVERRIDABLE
        if unknown:
            raise ValueError(
                f"Unknown deployment override(s) {sorted(unknown)} for {name!r}"
            )
        # The Application tree is already a clone (_clone_app); options()
        # clones the Deployment itself, so module-level objects stay pristine.
        node.deployment = node.deployment.options(**fields)


def apply(config: dict) -> Dict[str, Any]:
    """Deploy every application in the config; returns {app_name: handle}.
    Idempotent: re-applying reconciles (the controller diffs target state)."""
    handles = {}
    for app_config in _validate(config):
        name = app_config.get("name") or "default"
        application = _load_target(
            app_config["import_path"], app_config.get("args")
        )
        _apply_overrides(application, app_config.get("deployments"))
        handles[name] = serve_run(application, name=name)
    return handles


def apply_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return apply(yaml.safe_load(f))
