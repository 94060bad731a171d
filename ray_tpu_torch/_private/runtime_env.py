"""Runtime environments — per-task/actor execution environments.

Reference: _private/runtime_env/ (validation.py, working_dir.py, plugin.py
URI-cached envs built by the per-node agent) and A.8 in SURVEY.md. Supported
fields here: `env_vars`, `working_dir` (staged into a content-addressed cache
dir, prepended to sys.path), `py_modules` (each staged + importable). pip and
conda are rejected explicitly — the image is sealed (no installs), matching
the zero-egress deployment this framework targets.

The in-process engine applies an env as a scoped context around task
execution: env_vars patch os.environ under a global lock (process-wide state
— the fidelity cost of threads-as-workers; job submission subprocesses get
true isolation), sys.path gains the staged dirs for the duration.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
import tempfile
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional

_SUPPORTED = {"env_vars", "working_dir", "py_modules"}
_REJECTED = {"pip", "conda", "container"}

_ENV_LOCK = threading.RLock()


def validate_runtime_env(spec: Optional[dict]) -> Optional[dict]:
    if not spec:
        return None
    if not isinstance(spec, dict):
        raise TypeError(f"runtime_env must be a dict, got {type(spec)}")
    for key in spec:
        if key in _REJECTED:
            raise ValueError(
                f"runtime_env[{key!r}] is not supported: the image is "
                "sealed (no package installs at runtime)"
            )
        if key not in _SUPPORTED:
            raise ValueError(
                f"Unknown runtime_env key {key!r}; supported: {sorted(_SUPPORTED)}"
            )
    env_vars = spec.get("env_vars")
    if env_vars is not None:
        if not isinstance(env_vars, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()
        ):
            raise TypeError("runtime_env['env_vars'] must be dict[str, str]")
    for key in ("working_dir",):
        if spec.get(key) is not None and not isinstance(spec[key], str):
            raise TypeError(f"runtime_env[{key!r}] must be a path string")
    if spec.get("py_modules") is not None and not isinstance(
        spec["py_modules"], (list, tuple)
    ):
        raise TypeError("runtime_env['py_modules'] must be a list of paths")
    return dict(spec)


class RuntimeEnvContext:
    """A built environment: resolved env vars + sys.path additions.

    Activation is refcounted: overlapping tasks sharing the same env (threaded
    actors, the node thread pool) apply the os.environ/sys.path patch on the
    first entry and restore the pre-patch state on the last exit, so one
    task's exit never yanks the env out from under a concurrent task."""

    def __init__(self, env_vars: Dict[str, str], sys_paths: list):
        self.env_vars = env_vars
        self.sys_paths = sys_paths
        self._active = 0
        self._saved_env: Dict[str, Optional[str]] = {}
        self._added_paths: list = []


class RuntimeEnvManager:
    """Builds and caches environments by spec hash.

    Envs are snapshotted ONCE per process: editing a working_dir source after
    the first task used it does NOT restage (use a new path or a fresh
    runtime). Staging goes to a temp dir and lands with an atomic rename, so
    an interrupted copy can never be mistaken for a complete one; the build
    lock is per-env, not global, so one large copy doesn't serialize every
    other env."""

    def __init__(self, cache_root: Optional[str] = None):
        self._root = cache_root or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_runtime_env_{os.getpid()}"
        )
        self._cache: Dict[str, RuntimeEnvContext] = {}
        self._lock = threading.Lock()
        self._building: Dict[str, threading.Event] = {}

    @staticmethod
    def _hash(spec: dict) -> str:
        import json

        return hashlib.sha1(
            json.dumps(spec, sort_keys=True).encode()
        ).hexdigest()[:16]

    @staticmethod
    def _stage(src: str, dest: str) -> None:
        """Copy src → dest atomically (temp + rename); no-op if dest exists."""
        if os.path.exists(dest):
            return
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        tmp = tempfile.mkdtemp(dir=os.path.dirname(dest))
        try:
            staged = os.path.join(tmp, "staged")
            if os.path.isdir(src):
                shutil.copytree(src, staged)
            else:
                shutil.copy2(src, staged)
            try:
                os.rename(staged, dest)
            except OSError:
                pass  # concurrent stager won the rename
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def get_or_create(self, spec: Optional[dict]) -> Optional[RuntimeEnvContext]:
        spec = validate_runtime_env(spec)
        if not spec:
            return None
        key = self._hash(spec)
        while True:
            with self._lock:
                ctx = self._cache.get(key)
                if ctx is not None:
                    return ctx
                event = self._building.get(key)
                if event is None:
                    event = threading.Event()
                    self._building[key] = event
                    break  # we build
            event.wait(timeout=300.0)
        try:
            ctx = self._build(spec, key)
            with self._lock:
                self._cache[key] = ctx
            return ctx
        finally:
            with self._lock:
                self._building.pop(key, None)
            event.set()

    def _build(self, spec: dict, key: str) -> RuntimeEnvContext:
        env_dir = os.path.join(self._root, key)
        sys_paths = []
        working_dir = spec.get("working_dir")
        if working_dir:
            if not os.path.isdir(working_dir):
                raise FileNotFoundError(
                    f"runtime_env working_dir {working_dir!r} does not exist"
                )
            dest = os.path.join(env_dir, "working_dir")
            self._stage(working_dir, dest)
            sys_paths.append(dest)
        for module_path in spec.get("py_modules") or []:
            if not os.path.exists(module_path):
                raise FileNotFoundError(
                    f"runtime_env py_module {module_path!r} does not exist"
                )
            base = os.path.basename(module_path.rstrip("/"))
            dest = os.path.join(env_dir, "py_modules", base)
            self._stage(module_path, dest)
            # A module dir is importable from its parent.
            sys_paths.append(os.path.dirname(dest))
        return RuntimeEnvContext(dict(spec.get("env_vars") or {}), sys_paths)

    @contextmanager
    def activate(self, ctx: Optional[RuntimeEnvContext]):
        """Scoped application around one task execution (refcounted)."""
        if ctx is None:
            yield
            return
        with _ENV_LOCK:
            ctx._active += 1
            if ctx._active == 1:
                ctx._saved_env = {k: os.environ.get(k) for k in ctx.env_vars}
                os.environ.update(ctx.env_vars)
                ctx._added_paths = [p for p in ctx.sys_paths if p not in sys.path]
                for p in reversed(ctx._added_paths):
                    sys.path.insert(0, p)
        try:
            yield
        finally:
            with _ENV_LOCK:
                ctx._active -= 1
                if ctx._active == 0:
                    for k, old in ctx._saved_env.items():
                        if old is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = old
                    for p in ctx._added_paths:
                        try:
                            sys.path.remove(p)
                        except ValueError:
                            pass
                    ctx._saved_env = {}
                    ctx._added_paths = []

    def cleanup(self) -> None:
        # Clear BEFORE removing the tree, both under the lock: a
        # concurrent get_or_create must either see the cached env (and a
        # live dir) or miss and rebuild from scratch, never a cache hit
        # pointing at the tree rmtree just removed (found by lint
        # RTL201).
        with self._lock:
            self._cache.clear()
            shutil.rmtree(self._root, ignore_errors=True)
