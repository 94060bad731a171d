"""The profiling kernels' plain versions (K8-K10) and entry points against
the reference's profiling scripts, on the CPU.

`benchmarks/profile_attn_{dissect,variants,subtile}.py` run their
benchmarks when imported, so no test imports them. `_script` parses one
with `ast`, keeps its imports and the named kernel-building functions, and
executes those with the module constants (B, S, H, D, BH) set small. Its
`pl` is replaced, in that namespace only, by a shim whose `pallas_call`
passes `interpret=True`, as the reference's own tests run Pallas on the
CPU. The scripts and the `jax` module stay as they are.

The same seeded numpy inputs (distinct q, k, v) go through the script's
Pallas kernel and the port's wrapper on CPU tensors (its plain version).
Every case asserts a share of bf16 outputs bit-identical to JAX's, a
relative L2 error of O within 4e-3, and lse within 2e-6 + 1e-6 |lse|.
"""

import ast
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attn_profile as ap
from ray_tpu_torch.profiling import attn_dissect, attn_subtile, attn_variants

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


class _InterpretPallas:
    """`pl` of a loaded script: every attribute is Pallas's own, but
    `pallas_call` runs in interpret mode."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


def _script(name: str, functions, **constants) -> dict:
    """The imports, `_LANES` and `functions` of benchmarks/<name>.py,
    executed with `constants` as the module constants; nothing else of the
    script runs."""
    path = REPO / "benchmarks" / f"{name}.py"
    keep = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in functions:
            keep.append(node)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_LANES" for t in node.targets):
            keep.append(node)
    ns = dict(constants, __name__=f"_script_{name}")
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    ns["pl"] = _InterpretPallas(ns["pl"])
    return ns


def _inputs(seed, bh, s, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, s, d).astype(np.float32) for _ in range(3)]


def _both(arrays):
    """bf16 copies for JAX and for the port."""
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


def _hold(got: torch.Tensor, want, share: float) -> None:
    """Bit-identical share of the bf16 output, and relative L2 <= 4e-3."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, np.float32).astype(np.float64)
    assert g.shape == w.shape
    same = float((g == w).mean())
    rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    assert same >= share, same
    assert rel <= 4e-3, rel


def _hold_lse(got: torch.Tensor, want) -> None:
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=2e-6)


# B1 H2 at S128 D32: BH = 2 (make2h takes the heads in pairs).
SMALL = dict(B=1, S=128, H=2, D=32, BH=2)


@pytest.mark.parametrize("level,two_heads", [
    (0, False), (1, False), (2, False), (3, False), (4, False), (3, True),
])
def test_dissect_plain_matches_the_script(level, two_heads):
    """K8's plain version against `make(level)` / `make2h(3)` at S128 H2
    D32. Measured: bit-identical share 1.0 at levels 1-4 and for make2h(3),
    0.9996 at level 0 (relative L2 3.0e-6: |O| reaches 276 there, so f32
    summation order flips a bf16 rounding here and there). Levels 1-2 carry
    the -1e30 mask into O (|O| up to 3.7e31 here), which both sides compute
    alike."""
    ns = _script("profile_attn_dissect", {"make", "make2h"}, **SMALL)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(10 + level + 5 * two_heads, 2, 128, 32))
    want = (ns["make2h"] if two_heads else ns["make"])(level)(jq, jk, jv)
    got = ap.attn_dissect(tq, tk, tv, level, two_heads=two_heads)
    assert got.dtype == torch.bfloat16
    _hold(got, want, 0.99)


@pytest.mark.parametrize("T", [2, 4, 8])
def test_subtile_plain_matches_the_script(T):
    """K10's plain version against `make_subtiled(T)` at S128 H2 D32: O and
    lse. Measured: bit-identical share 1.0 at T = 2 and 4, 0.9999 at T = 8
    (relative L2 1.4e-5); lse within 1.9e-6."""
    ns = _script("profile_attn_subtile", {"make_subtiled"}, **SMALL)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(20 + T, 2, 128, 32))
    want_o, want_lse = ns["make_subtiled"](T)(jq, jk, jv)
    got_o, got_lse = ap.attn_subtile(tq, tk, tv, T)
    _hold(got_o, want_o, 0.99)
    _hold_lse(got_lse, np.asarray(want_lse)[:, 0, :])


@pytest.mark.parametrize("block", [64, 128])
def test_slim_plain_matches_the_script(block):
    """K9's plain version against `slim_fwd` with block_q = block_k = block
    at S256 H2 D32, causal: q prescaled and rounded to bf16 on both sides,
    P rounded against the running max of the same key tiles. Measured:
    bit-identical share 0.99994 (64) and 0.9996 (128), lse within 4.8e-7;
    with the other tile's block_k on the port's side the share falls to
    0.88 and 0.87, so the tile edges are what is held."""
    ns = _script("profile_attn_variants", {"_fwd_kernel_slim", "slim_fwd"},
                 **dict(SMALL, S=256))
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(30 + block, 2, 256, 32))
    sm = 1.0 / math.sqrt(32)
    want_o, want_lse = ns["slim_fwd"](jq, jk, jv, sm, True, block, block)
    got_o, got_lse = ap.flash_fwd_slim(tq, tk, tv, sm_scale=sm, block_q=block,
                                       block_k=block)
    _hold(got_o, want_o, 0.99)
    _hold_lse(got_lse, np.asarray(want_lse)[:, 0, :])


def test_slim_attention_gradient_is_the_flash_gradient():
    """`slim_attention` (K9 forward, K4 + K5 backward) against
    `flash_attention` at B1 S256 H2 D32 in f32 on the CPU (the plain
    versions): the same forward at any key tile in f32, and the same
    backward, so O and every gradient agree to f32 summation order."""
    from ray_tpu_torch.ops import flash_attention

    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 256, 2, 32).astype(np.float32))
                  for _ in range(4))
    outs = []
    for fn in (lambda a, b, c: ap.slim_attention(a, b, c, block_q=64, block_k=128),
               lambda a, b, c: flash_attention(a, b, c, causal=True, block_q=128,
                                               block_k=128)):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*x)
        o.backward(g)
        outs.append([o.detach()] + [t.grad for t in x])
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


TINY = ["--device", "cpu", "--batch", "1", "--seq", "128", "--heads", "2",
        "--dim", "32"]


@pytest.mark.parametrize("module,n_rows", [
    (attn_dissect, 7), (attn_variants, 5), (attn_subtile, 4),
])
def test_entry_points_run_on_the_cpu(module, n_rows, capsys):
    """Each entry point's main at a tiny size on the CPU: one row per
    variant, in its script's order ("current" included), finite outputs,
    and no device time (a CPU run is not a device measurement)."""
    argv = TINY + (["--layers", "2"] if module is attn_variants else [])
    rows = module.main(argv)
    assert len(rows) == n_rows
    assert all(r["ms"] is None and r["finite"] for r in rows)
    assert "not measured" in capsys.readouterr().out


@pytest.mark.parametrize("module", [attn_dissect, attn_variants, attn_subtile])
def test_entry_points_default_to_the_card(module):
    """Without CUDA the default --device cuda raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--seq", "128"])


@pytest.mark.parametrize("call", ["dissect", "slim", "subtile"])
def test_wrappers_forced_to_the_kernel_raise(monkeypatch, call):
    """With the device resolution forced to the kernel (there is no card
    here), each wrapper takes its kernel path and refuses the CPU tensors
    there, instead of falling back to its plain version; launch counts do
    not move."""
    monkeypatch.setattr(sys.modules["ray_tpu_torch.ops.attn_profile"], "_on_cpu",
                        lambda t: False)
    q, k, v = (torch.zeros(2, 128, 32, dtype=torch.bfloat16) for _ in range(3))
    fn = {"dissect": lambda: ap.attn_dissect(q, k, v, 4),
          "slim": lambda: ap.flash_fwd_slim(q, k, v),
          "subtile": lambda: ap.attn_subtile(q, k, v, 2)}[call]
    before = (ap.attn_dissect.launches, ap.flash_fwd_slim.launches,
              ap.attn_subtile.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn()
    assert (ap.attn_dissect.launches, ap.flash_fwd_slim.launches,
            ap.attn_subtile.launches) == before


def test_wrappers_refuse_what_no_version_takes():
    """Arguments no version takes raise on the CPU too: a level outside
    0-4, the two-head variant at another level than 3, K9 tiles outside
    {64, 128}, a T that does not divide S, and inputs that require grad."""
    q, k, v = (torch.zeros(2, 128, 32, dtype=torch.bfloat16) for _ in range(3))
    with pytest.raises(ValueError, match="level"):
        ap.attn_dissect(q, k, v, 5)
    with pytest.raises(ValueError, match="make2h"):
        ap.attn_dissect(q, k, v, 4, two_heads=True)
    with pytest.raises(ValueError, match="tiles"):
        ap.flash_fwd_slim(q, k, v, block_q=256)
    with pytest.raises(ValueError, match="divide"):
        ap.attn_subtile(q, k, v, 3)
    with pytest.raises(RuntimeError, match="autograd"):
        ap.attn_subtile(q.requires_grad_(), k, v, 2)
