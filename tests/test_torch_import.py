"""The port stands alone: no module of ray_tpu_torch, and not chip_smoke.py,
imports jax, jaxlib, flax, optax, or anything of the ray_tpu package.

Checked twice. In a fresh interpreter with an import hook that refuses
those names (exact, or as a dotted prefix — `ray_tpu_torch` itself must
pass), which sees what importing every module pulls in. And by a static
scan of every source file's syntax tree, which also sees the imports that
run only when a function is called (inside functions, methods and `try`
blocks), as Serve's code does for the runtime.
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
    importlib.import_module("chip_smoke")
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
    proc = subprocess.run(
        [sys.executable, "-c", _GATE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # Every subpackage and module was walked (ops, models, llm, util, ...).
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


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
