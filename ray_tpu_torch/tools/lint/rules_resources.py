"""Family 4 — resource-hygiene rules.

RTL401: a bare `x.remote(...)` expression statement drops the ObjectRef.
In this runtime the reference counter collects an out-of-scope reply
object — a dropped ref means the result (and any error in it!) is
unobservable, and the reply may be deleted mid-flight. Keep the ref,
or suppress with a reason when fire-and-forget is genuinely intended.

RTL402: calling a local `async def` without `await` builds a coroutine
object and silently never runs it.

RTL403 (cleared-before-commit): a cleanup/rollback marker (`x.attr =
None`) cleared BEFORE the operation that consumes the saved value has
completed — an exception in between skips the rollback path and leaks
the resource. This is the shape of the CoW copy-source refcount leak
this rule was written against.

RTL404 (leaky-acquire): `allocate()`/`touch()` whose references a later
`free()` in the same function is supposed to release, with the acquire
outside any try — a raise in between leaks the acquired references.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.lint.core import Finding, ModuleInfo, Rule


class DroppedObjectRefRule(Rule):
    id = "RTL401"
    name = "dropped-object-ref"
    family = "resources"
    description = (
        "bare .remote(...) statement discards the ObjectRef: the result "
        "and any error become unobservable"
    )
    rationale = (
        "a dropped ObjectRef means the task's failure is silently "
        "swallowed and its result is immediately eligible for "
        "reclamation. Bind the ref (even to collect later) so errors "
        "surface and lifetimes are explicit."
    )
    bad_example = """
        def fire(handle):
            handle.ping.remote()
    """
    good_example = """
        def keep(handle):
            ref = handle.ping.remote()
            return ref
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for node in module.nodes(ast.Expr):
            call = node.value
            if (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "remote"
            ):
                out.append(
                    self.finding(
                        module,
                        call,
                        "ObjectRef from .remote(...) is dropped; bind it "
                        "(or suppress with a reason if fire-and-forget "
                        "is intended)",
                    )
                )
        return out


class UnawaitedCoroutineRule(Rule):
    id = "RTL402"
    name = "unawaited-coroutine"
    family = "async"
    description = (
        "calling a local async def without await creates a coroutine "
        "that never runs"
    )
    rationale = (
        "the call builds a coroutine object and throws it away — the "
        "body never executes, and Python only murmurs a 'never awaited' "
        "warning at GC time, far from the bug."
    )
    bad_example = """
        class A:
            async def _push(self):
                pass

            def kick(self):
                self._push()
    """
    good_example = """
        class A:
            async def _push(self):
                pass

            async def kick(self):
                await self._push()
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        module_async: Set[str] = set()
        class_async: Dict[str, Set[str]] = {}
        for node in module.nodes(ast.AsyncFunctionDef):
            parent = module.parent(node)
            if isinstance(parent, ast.Module):
                module_async.add(node.name)
            elif isinstance(parent, ast.ClassDef):
                class_async.setdefault(parent.name, set()).add(node.name)
        if not module_async and not class_async:
            return []
        out: List[Finding] = []
        for node in module.nodes(ast.Expr):
            call = node.value
            if not isinstance(call, ast.Call):
                continue
            func = call.func
            name = None
            if isinstance(func, ast.Name) and func.id in module_async:
                name = func.id
            elif (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
            ):
                cls = self._enclosing_class(module, node)
                if cls and func.attr in class_async.get(cls.name, ()):
                    name = f"self.{func.attr}"
            if name is not None:
                out.append(
                    self.finding(
                        module,
                        call,
                        f"{name}(...) is an async def; the coroutine is "
                        "created but never awaited (it will never run)",
                    )
                )
        return out

    def _enclosing_class(self, module, node):
        cur = module.parent(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = module.parent(cur)
        return None


class ClearedBeforeCommitRule(Rule):
    id = "RTL403"
    name = "cleared-before-commit"
    family = "resources"
    description = (
        "rollback marker set to None before the operation consuming it "
        "completed; an exception in between leaks the resource"
    )
    rationale = (
        "clearing the marker first removes the only record a failure "
        "handler could roll back with: if the consuming operation "
        "raises, the resource (a KV block, a pinned ref) leaks forever. "
        "Commit first, clear after."
    )
    bad_example = """
        class Engine:
            def bad(self, seq):
                src, dst = seq.pending_copy
                seq.pending_copy = None
                self.runner.copy_block(src, dst)
                self.allocator.free([src])
    """
    good_example = """
        class Engine:
            def good(self, seq):
                src, dst = seq.pending_copy
                self.runner.copy_block(src, dst)
                self.allocator.free([src])
                seq.pending_copy = None
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for fn in module.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            out.extend(self._check_fn(module, fn))
        return out

    def _check_fn(self, module, fn) -> List[Finding]:
        # 1. names bound from `<obj>.<attr>` loads:  src, dst = x.attr
        bound_from: Dict[str, Set[str]] = {}  # attr -> names
        bind_line: Dict[str, int] = {}
        clears: List[Tuple[ast.AST, str]] = []  # (assign-target, attr)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target, value = node.targets[0], node.value
            if (
                isinstance(target, ast.Attribute)
                and isinstance(value, ast.Constant)
                and value.value is None
            ):
                clears.append((target, target.attr))
            elif isinstance(value, ast.Attribute):
                names = self._target_names(target)
                if names:
                    bound_from.setdefault(value.attr, set()).update(names)
                    bind_line.setdefault(value.attr, node.lineno)
        if not clears or not bound_from:
            return []
        findings = []
        for target, attr in clears:
            names = bound_from.get(attr)
            if not names:
                continue
            if bind_line.get(attr, 10**9) > target.lineno:
                continue  # bound after the clear: unrelated
            # 2. a call AFTER the clear that consumes a bound name means
            # the risky operation had not finished when the marker died.
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and node.lineno > target.lineno
                    and any(
                        isinstance(a, ast.Name) and a.id in names
                        for a in ast.walk(node)
                        if isinstance(a, ast.Name)
                    )
                ):
                    findings.append(
                        self.finding(
                            module,
                            target,
                            f"{attr} cleared before the operation using "
                            f"{'/'.join(sorted(names))} completed — an "
                            "exception in between skips the rollback path "
                            "that checks it (move the clear after)",
                        )
                    )
                    break
        return findings

    @staticmethod
    def _target_names(target) -> Set[str]:
        if isinstance(target, ast.Name):
            return {target.id}
        if isinstance(target, (ast.Tuple, ast.List)):
            return {
                el.id for el in target.elts if isinstance(el, ast.Name)
            }
        return set()


class LeakyAcquireRule(Rule):
    id = "RTL404"
    name = "leaky-acquire"
    family = "resources"
    description = (
        "allocate()/touch() outside try with a later free() in the same "
        "function: a raise in between leaks the acquired references"
    )
    rationale = (
        "the function clearly owns the resource (it frees it later), "
        "but any exception between acquire and free skips the release — "
        "refcounts drift up and the pool shrinks permanently. Wrap the "
        "consuming work in try/finally."
    )
    bad_example = """
        class S:
            def bad(self, n):
                blocks = self.allocator.allocate(n)
                self.compute(blocks)
                self.allocator.free(blocks)
    """
    good_example = """
        class S:
            def good(self, n):
                blocks = self.allocator.allocate(n)
                try:
                    self.compute(blocks)
                finally:
                    self.allocator.free(blocks)
    """

    ACQUIRERS = {"allocate", "touch"}
    RELEASERS = {"free", "release"}

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for fn in module.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            out.extend(self._check_fn(module, fn))
        return out

    def _check_fn(self, module, fn) -> List[Finding]:
        acquires: List[ast.Call] = []
        release_lines: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr in self.ACQUIRERS:
                    acquires.append(node)
                elif node.func.attr in self.RELEASERS:
                    release_lines.append(node.lineno)
        if not acquires or not release_lines:
            return []
        last_release = max(release_lines)
        # try/finally (or try/except) blocks whose cleanup section calls a
        # releaser: an acquire immediately above one is the CORRECT
        # pattern — the raise path releases.
        guarded_try_lines = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            cleanup = list(node.finalbody)
            for handler in node.handlers:
                cleanup.extend(handler.body)
            for stmt in cleanup:
                for sub in ast.walk(stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in self.RELEASERS
                    ):
                        guarded_try_lines.append(node.lineno)
        findings = []
        for call in acquires:
            if call.lineno >= last_release:
                continue
            if self._inside_try(module, call, fn):
                continue
            if any(line >= call.lineno for line in guarded_try_lines):
                continue
            findings.append(
                self.finding(
                    module,
                    call,
                    f".{call.func.attr}(...) takes references that a "
                    "later free() releases, but is not inside a try — a "
                    "raise in between leaks them",
                )
            )
        return findings

    def _inside_try(self, module, node, fn) -> bool:
        cur = module.parent(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.Try):
                return True
            cur = module.parent(cur)
        return False


RULES = [
    DroppedObjectRefRule,
    UnawaitedCoroutineRule,
    ClearedBeforeCommitRule,
    LeakyAcquireRule,
]
