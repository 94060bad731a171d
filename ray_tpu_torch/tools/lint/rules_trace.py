"""Family 3 — clock discipline.

RTL302: durations or deadlines computed from `time.time()`. Wall clock
steps under NTP/suspend, so `deadline = time.time() + t` can hang or
fire early; `time.time() - t0` durations jitter. Use
`time.monotonic()`/`perf_counter()` unless wall-clock *identity* is
required (timestamps that are compared across processes, e.g. trace
spans).

The reference analyzer's other two rules of this family, RTL301 and
RTL303, read the bodies of functions handed to `jax.jit`/`pjit`/
`shard_map`/`pallas_call`; the port traces nothing (its kernels are CUDA
sources), so they are not ported (see `NOT_PORTED` in `__init__.py`).
"""

from __future__ import annotations

import ast
from typing import List, Set

from ray_tpu_torch.tools.lint.core import Finding, ModuleInfo, Rule


class WallClockDurationRule(Rule):
    id = "RTL302"
    name = "wallclock-duration"
    family = "trace"
    description = (
        "duration/deadline arithmetic on time.time(); use "
        "time.monotonic()/perf_counter() unless wall-clock identity is "
        "required"
    )
    rationale = (
        "wall clock steps under NTP/suspend: `deadline = time.time() + "
        "t` can park a poller forever after a backward step, and "
        "`time.time() - t0` durations jitter. Monotonic clocks exist "
        "for exactly this; keep time.time() only where wall-clock "
        "IDENTITY matters (timestamps compared across processes)."
    )
    bad_example = """
        import time

        def wait_for(pred, timeout):
            deadline = time.time() + timeout
            while time.time() < deadline:
                if pred():
                    return True
            return False
    """
    good_example = """
        import time

        def wait_for(pred, timeout):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if pred():
                    return True
            return False
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        class_attrs = self._wallclock_self_attrs(module)
        for scope in module.scopes:
            if isinstance(scope, ast.Lambda):
                continue
            out.extend(self._check_scope(module, scope, class_attrs))
        return out

    def _wallclock_self_attrs(self, module) -> Set[str]:
        attrs = set()
        for node in module.nodes(ast.Assign):
            if self._is_time_call(module, node.value):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        attrs.add(t.attr)
        return attrs

    def _is_time_call(self, module, expr) -> bool:
        return (
            isinstance(expr, ast.Call)
            and module.call_target(expr) == "time.time"
        )

    def _check_scope(self, module, scope, class_attrs) -> List[Finding]:
        # Wall-clock-tainted names in this scope (transitive over simple
        # assignments), excluding nested function bodies.
        own_nodes = module.own_nodes(scope)
        tainted: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for node in own_nodes:
                if not isinstance(node, ast.Assign):
                    continue
                if self._expr_tainted(module, node.value, tainted):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id not in tainted:
                            tainted.add(t.id)
                            changed = True
        findings = []
        for node in own_nodes:
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                if self._side_tainted(module, node.left, tainted,
                                      class_attrs) and self._side_tainted(
                                          module, node.right, tainted,
                                          class_attrs):
                    findings.append(self._flag(module, node))
            elif isinstance(node, ast.Compare) and len(node.ops) == 1:
                if isinstance(node.ops[0], (ast.Lt, ast.LtE, ast.Gt,
                                            ast.GtE)):
                    sides = [node.left, node.comparators[0]]
                    if any(self._is_time_call(module, s) for s in sides) and (
                        all(
                            self._side_tainted(module, s, tainted,
                                               class_attrs)
                            for s in sides
                        )
                    ):
                        findings.append(self._flag(module, node))
        return findings

    def _flag(self, module, node) -> Finding:
        return self.finding(
            module,
            node,
            "duration/deadline computed from time.time(); wall clock "
            "steps under NTP — use time.monotonic()/perf_counter() "
            "unless wall-clock identity is required",
        )

    def _side_tainted(self, module, expr, tainted, class_attrs) -> bool:
        if self._is_time_call(module, expr):
            return True
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return expr.attr in class_attrs
        return False

    def _expr_tainted(self, module, expr, tainted) -> bool:
        for node in ast.walk(expr):
            if self._is_time_call(module, node):
                return True
            if isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Load
            ) and node.id in tainted:
                return True
        return False


RULES = [WallClockDurationRule]
