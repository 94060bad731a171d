"""ray-tpu-torch lint: codebase-aware static analyzer for ray_tpu_torch.

A pure `ast` pass: it never imports the modules it scans (nor torch).
Five rule families read the port as the reference analyzer reads its own
package; the first four are per-module, the fifth rides the
PROJECT-LEVEL pass (`project.py`): a cross-module symbol table
(import-alias chains, `__init__.py` re-exports), a call graph, and an
actor index over `@ray_tpu_torch.remote` classes. The sixth runs a small
abstract evaluator (`shapes.py`) over torch pool constructors:

  * async (RTL1xx)     — blocking calls in `async def`, await while
                         holding a threading lock, unawaited coroutines
  * locks (RTL2xx)     — per-class lock-coverage inference: state mutated
                         under `self._lock` accessed bare elsewhere (the
                         port's hand-off lock counts as a lock)
  * trace (RTL302)     — wall-clock duration/deadline arithmetic
  * resources (RTL4xx) — dropped ObjectRefs, rollback markers cleared
                         before commit, allocate/free exception safety
  * actors (RTL7xx)    — blocking get on a same-actor task, synchronous
                         cross-actor call cycles (graph SCCs)
  * shapes (RTL804)    — int8 K/V pool and scale pool pairing: geometry,
                         dtype, and writes that skip the scales

The reference analyzer's rules that read JAX programs have nothing to
read in the port; `NOT_PORTED` names each with its reason, and
`--list-rules` prints them. Registry plus `NOT_PORTED` equals the
reference's registry, id for id.

Entry points: `ray-tpu-torch lint`, `ray-tpu-torch-lint`, `python -m
ray_tpu_torch.tools.lint`, or `lint_source()` / `lint_sources()` /
`lint_paths()` from Python. The baseline is `LINT_BASELINE_TORCH.json`
at the repo root.
"""

from ray_tpu_torch.tools.lint.core import (  # noqa: F401
    Finding,
    LintResult,
    all_rules,
    find_repo_root,
    lint_paths,
    lint_source,
    lint_sources,
)

_JIT_BODIES = (
    "reads the bodies of functions handed to jax.jit/pjit/shard_map/"
    "pallas_call; the port traces nothing (its kernels are CUDA sources)"
)
_NO_DONATION = (
    "torch has no buffer donation and no per-signature compile"
)
_NO_MESH = (
    "the port has no mesh until ROADMAP §B7; its counterpart over "
    "DeviceMesh dim names and DTensor placements comes with it"
)
_NO_BUCKETS = (
    "judges jitted programs and their compile buckets; the port compiles "
    "nothing per shape"
)

# id -> (name, why the port drops it)
NOT_PORTED = {
    "RTL301": ("jit-impure-call", _JIT_BODIES),
    "RTL303": ("jit-closure-mutation", _JIT_BODIES),
    "RTL501": ("use-after-donate", _NO_DONATION),
    "RTL502": ("unstable-jit-signature", _NO_DONATION),
    "RTL503": (
        "host-sync-in-step-loop",
        "keys on a jitted call's result; in eager PyTorch no static mark "
        "tells a device tensor from a host value",
    ),
    "RTL601": ("spec-axis-not-in-mesh", _NO_MESH),
    "RTL602": ("collective-axis-unbound", _NO_MESH),
    "RTL801": ("jit-call-shape-mismatch", _NO_BUCKETS),
    "RTL802": ("donation-alias-mismatch", _NO_DONATION),
    "RTL803": ("sharding-nondivisible", _NO_MESH),
    "RTL805": ("bucket-coverage-drift", _NO_BUCKETS),
}


def not_ported(rule_id: str):
    """(id, name, reason) of a dropped rule named by id or name, else None."""
    for rid, (name, reason) in NOT_PORTED.items():
        if rule_id in (rid, name):
            return rid, name, reason
    return None
