"""The port stands alone: no module of ray_tpu_torch, and not chip_smoke.py,
imports jax, jaxlib, flax, optax, or anything of the ray_tpu package.

Checked in a fresh interpreter with an import hook that refuses those
names (exact, or as a dotted prefix — `ray_tpu_torch` itself must pass).
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    from ray_tpu_torch.llm import EngineConfig, GPTRunner, LLMServer
    from ray_tpu_torch.models import GPT, GPTConfig

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    cfg = GPTConfig(vocab_size=128, num_layers=1, num_heads=2, embed_dim=32,
                    max_seq_len=64)
    ecfg = EngineConfig(block_size=8, num_blocks=8, max_blocks_per_seq=4)
    for make in (lambda: GPT(cfg), lambda: GPTRunner(cfg, ecfg),
                 lambda: LLMServer(cfg, ecfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu").type == "cpu"
