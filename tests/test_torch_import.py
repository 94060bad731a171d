"""The port stands alone: no module of ray_tpu_torch, and not chip_smoke.py,
imports jax, jaxlib, flax, optax, or anything of the ray_tpu package.

Checked twice. In a fresh interpreter with an import hook that refuses
those names (exact, or as a dotted prefix — `ray_tpu_torch` itself must
pass), which sees what importing every module pulls in. And by a static
scan of every source file's syntax tree, which also sees the imports that
run only when a function is called (inside functions, methods and `try`
blocks), as Serve's code does for the runtime. The gated interpreter also
loads the native store's library: the port's build from inside the
package, never the reference's src/build/libtpustore.so.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def blocked_imports(path: str) -> list:
    """(line, module) of every import of a blocked name anywhere in the
    file: module level, functions, methods, classes, `try` blocks."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _blocked(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _blocked(node.module):
                found.append((node.lineno, node.module))
    return found


def _port_sources() -> list:
    """Every source of the package and chip_smoke.py; not the git-ignored
    build directory (ops/_build), which may hold copies of other trees."""
    files = glob.glob(os.path.join(REPO, "ray_tpu_torch", "**", "*.py"), recursive=True)
    files = [f for f in files if "_build" not in os.path.relpath(f, REPO).split(os.sep)]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]

_GATE = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "ray_tpu")

    class Gate(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Gate())
    import ray_tpu_torch

    names = ["ray_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            ray_tpu_torch.__path__, prefix="ray_tpu_torch."
        )
    ]
    for name in names:
        importlib.import_module(name)
    for name in ("store", "affinity", "disagg"):
        assert f"ray_tpu_torch.llm.kvfabric.{name}" in names, name
    for name in ("gcs_storage", "object_plane", "head_server", "remote_node",
                 "node_daemon", "client"):
        assert f"ray_tpu_torch._private.{name}" in names, name
    for name in ("dashboard.head", "autoscaler.autoscaler", "autoscaler.monitor",
                 "autoscaler.load_metrics", "autoscaler.node_provider",
                 "autoscaler.resource_demand_scheduler", "util.state.api",
                 "scripts.cli", "cluster_utils", "job_submission"):
        assert f"ray_tpu_torch.{name}" in names, name
    for name in ("core", "baseline", "project", "cli", "shapes", "rules_async",
                 "rules_locks", "rules_trace", "rules_resources", "rules_actors",
                 "rules_shapes"):
        assert f"ray_tpu_torch.tools.lint.{name}" in names, name
    importlib.import_module("chip_smoke")
    # The native store's library is the port's own build, from inside the
    # package, and the reference's libtpustore is never mapped.
    import os
    from ray_tpu_torch._private import native_store
    lib = native_store.load_library()
    pkg = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
    assert os.path.commonpath([os.path.abspath(lib._name), pkg]) == pkg, lib._name
    assert "libtpustore" not in open("/proc/self/maps").read()
    leaked = sorted(
        m for m in sys.modules
        if any(m == b or m.startswith(b + ".") for b in BLOCKED)
    )
    assert not leaked, leaked
    print(len(names))
    """
)


def test_port_imports_nothing_of_jax_or_ray_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RAY_TPU_TORCH_FAULT_INJECTION", None)
    env.pop("RAY_TPU_TORCH_STORE_LIB", None)
    proc = subprocess.run(
        [sys.executable, "-c", _GATE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # Every subpackage and module was walked (ops, models, llm, util, ...).
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


_LINT_ALONE = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    import ray_tpu_torch.tools.lint as lint

    names = [m.name for m in pkgutil.walk_packages(
        lint.__path__, prefix="ray_tpu_torch.tools.lint.")]
    for name in names:
        importlib.import_module(name)
    from ray_tpu_torch.tools.lint.cli import main
    assert main(["--list-rules"]) == 0
    heavy = sorted(m for m in sys.modules if m.split(".")[0] in (
        "torch", "numpy", "jax", "jaxlib", "flax", "optax", "ray_tpu"))
    assert not heavy, heavy
    print(len(names))
    """
)


def test_lint_tool_imports_no_torch_and_nothing_of_the_reference():
    """The analyzer is a pure `ast` pass: importing every module of
    ray_tpu_torch.tools.lint and listing its rules pulls in neither torch
    (nor numpy) nor JAX nor the reference's package."""
    proc = subprocess.run(
        [sys.executable, "-c", _GATE.split("import ray_tpu_torch")[0] + _LINT_ALONE],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 12


def test_gate_refuses_the_reference_package():
    """The hook itself works: importing ray_tpu under it fails."""
    code = _GATE.split("import ray_tpu_torch")[0] + "import ray_tpu\n"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "blocked import of ray_tpu" in proc.stderr


def test_entry_points_default_to_cuda():
    """Without CUDA and without device=, every entry point raises instead
    of carrying on on the CPU."""
    import pytest
    import torch

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.llm import EngineConfig, GPTRunner, KVFabricConfig, LLMServer
    from ray_tpu_torch.llm.kvfabric import DisaggregatedLLM
    from ray_tpu_torch.models import GPT, GPTConfig

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    cfg = GPTConfig(vocab_size=128, num_layers=1, num_heads=2, embed_dim=32,
                    max_seq_len=64)
    ecfg = EngineConfig(block_size=8, num_blocks=8, max_blocks_per_seq=4)
    fabric = EngineConfig(block_size=8, num_blocks=8, max_blocks_per_seq=4,
                          kv_fabric=KVFabricConfig())
    for make in (lambda: GPT(cfg), lambda: GPTRunner(cfg, ecfg),
                 lambda: LLMServer(cfg, ecfg),
                 lambda: DisaggregatedLLM(cfg, fabric)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_no_import_of_jax_or_ray_tpu_at_any_depth():
    """The static scan over every source of the port and chip_smoke.py."""
    files = _port_sources()
    assert len(files) >= 60
    assert any(f.endswith(os.path.join("serve", "handle.py")) for f in files)
    assert any(f.endswith(os.path.join("kvfabric", "disagg.py")) for f in files)
    assert any(f.endswith(os.path.join("tools", "lint", "shapes.py")) for f in files)
    found = {
        os.path.relpath(f, REPO): hits
        for f in files
        if (hits := blocked_imports(f))
    }
    assert not found, found


@pytest.mark.parametrize(
    "source, want",
    [
        ("def f():\n    from ray_tpu import api as ray\n    return ray\n",
         [(2, "ray_tpu")]),
        ("class A:\n    def m(self):\n        from ray_tpu.serve._private"
         ".controller import get_or_create_controller\n",
         [(3, "ray_tpu.serve._private.controller")]),
        ("try:\n    import jax.numpy as jnp\nexcept ImportError:\n    pass\n",
         [(2, "jax.numpy")]),
        ("def f():\n    if True:\n        import os, flax.linen as nn\n",
         [(3, "flax.linen")]),
        ("import ray_tpu_torch\nfrom ray_tpu_torch import serve\n"
         "from . import x\nimport jaxtyping\n", []),
    ],
    ids=["function", "method", "try_block", "nested_block", "allowed_names"],
)
def test_static_scan_sees_function_local_imports(tmp_path, source, want):
    """The scan finds imports the import-time gate cannot see (a
    function-local `from ray_tpu import api`), and passes the port's own
    names and relative imports."""
    path = tmp_path / "mod.py"
    path.write_text(source)
    assert blocked_imports(str(path)) == want


# Every process the port starts sees this hook first (sitecustomize on
# PYTHONPATH, which worker processes and node daemons inherit): an import of
# a blocked name anywhere fails that process.
_SITE_GATE = textwrap.dedent(
    """
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "ray_tpu")

    class Gate(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Gate())
    """
)

_CLIENT = textwrap.dedent(
    """
    import sys
    import ray_tpu_torch

    ray_tpu_torch.init(address=sys.argv[1])
    f = ray_tpu_torch.remote(lambda: 7)
    assert ray_tpu_torch.get(f.options(resources={"gated": 1}).remote(), timeout=60) == 7
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ray_tpu"))
    assert not bad, bad
    ray_tpu_torch.shutdown()
    print("CLIENT_CLEAN")
    """
)

# A job's entrypoint: a remote driver of the head that submitted it.
_JOB = textwrap.dedent(
    """
    import sys
    import ray_tpu_torch

    ray_tpu_torch.init(address=sys.argv[1])
    f = ray_tpu_torch.remote(lambda: 8)
    assert ray_tpu_torch.get(f.options(resources={"gated": 1}).remote(), timeout=60) == 8
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ray_tpu"))
    assert not bad, bad
    ray_tpu_torch.shutdown()
    print("JOB_CLEAN")
    """
)

_CLUSTER = textwrap.dedent(
    """
    import os, subprocess, sys, time
    import ray_tpu_torch

    def leaked():
        import sys
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ray_tpu"))

    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "isolation": "process", "worker_device": "cpu"})
    address = rt.serve_clients(port=0)
    daemon = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
                               "--address", address, "--num-cpus", "1",
                               "--resources", '{"gated": 1}',
                               "--object-store-memory", str(64 << 20)])
    try:
        deadline = time.monotonic() + 60
        while len(rt.controller.alive_nodes()) < 2:
            assert time.monotonic() < deadline and daemon.poll() is None
            time.sleep(0.05)
        task = ray_tpu_torch.remote(lambda: (os.getppid(), leaked()))
        ppid, names = ray_tpu_torch.get(
            task.options(resources={"gated": 1}).remote(), timeout=60)
        assert ppid == daemon.pid and names == [], (ppid, names)
        out = subprocess.run([sys.executable, "-c", sys.argv[1], address],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "CLIENT_CLEAN" in out.stdout, out.stderr
        # The CLI's process submits a job whose entrypoint, started by the
        # supervisor in a head worker, connects back as a remote driver.
        out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", "job",
                              "submit", "--address", address, "--", sys.executable,
                              "-c", sys.argv[2], address],
                             capture_output=True, text=True, timeout=180)
        assert out.returncode == 0 and "JOB_CLEAN" in out.stdout, out.stdout + out.stderr
        assert leaked() == []
    finally:
        ray_tpu_torch.shutdown()
        daemon.wait(timeout=30)
    print("CLUSTER_CLEAN")
    """
)


def test_daemon_and_client_processes_import_no_jax_or_ray_tpu(tmp_path):
    """A head, a node daemon, a task in the daemon's worker, a remote
    driver client, the CLI's process and a job's entrypoint it submits,
    every process under the import hook: none imports jax or anything of
    ray_tpu, and neither the worker, the client nor the job has such a
    module in sys.modules."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_GATE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((str(site), REPO)))
    env.pop("RAY_TPU_TORCH_STORE_LIB", None)
    proc = subprocess.run([sys.executable, "-c", _CLUSTER, _CLIENT, _JOB],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=360)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "CLUSTER_CLEAN" in proc.stdout
