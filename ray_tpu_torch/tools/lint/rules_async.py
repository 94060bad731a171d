"""Family 1 — actor/async deadlock rules.

RTL101: blocking calls inside `async def`. A coroutine runs on the actor's
single event loop; one blocking `ray_tpu_torch.get()` / `Future.result()` /
`time.sleep()` stalls EVERY in-flight request on that actor, and when the
awaited result depends on another task of the same actor it deadlocks
outright. Calls shipped off-loop (`run_in_executor`, `asyncio.to_thread`,
thread/executor submission) are exempt, as is anything directly awaited.

RTL102: `await` while holding a `threading.Lock`/`RLock`/`Condition`. The
suspended coroutine keeps the OS lock; any thread (or any coroutine on
this loop that needs the same lock before the holder resumes) blocks the
whole loop — the classic async-deadlock.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from ray_tpu_torch.tools.lint.core import Finding, ModuleInfo, Rule
from ray_tpu_torch.tools.lint.rules_locks import class_lock_attrs, is_lock_ctor

# Dotted call targets that block the calling thread.
BLOCKING_CALLS = {
    "time.sleep",
    "ray_tpu_torch.get",
    "ray_tpu_torch.wait",
    "ray_tpu_torch.api.get",
    "ray_tpu_torch.api.wait",
}

# Ship-it-off-loop wrappers: a blocking call lexically inside one of
# these is the sanctioned pattern, not a finding.
OFFLOAD_CALLS = {"run_in_executor", "to_thread", "submit", "start"}

BLOCKING_METHODS = {"result"}  # concurrent.futures.Future.result()


def _enclosing_async_def(module: ModuleInfo, node: ast.AST):
    cur = module.parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.Lambda)):
            return None  # nested sync def: runs wherever it's called
        if isinstance(cur, ast.AsyncFunctionDef):
            return cur
        cur = module.parent(cur)
    return None


def _is_offloaded(module: ModuleInfo, node: ast.AST, stop: ast.AST) -> bool:
    cur = module.parent(node)
    while cur is not None and cur is not stop:
        if isinstance(cur, ast.Call):
            func = cur.func
            if isinstance(func, ast.Attribute) and func.attr in OFFLOAD_CALLS:
                return True
        cur = module.parent(cur)
    return False


class AsyncBlockingCallRule(Rule):
    id = "RTL101"
    name = "async-blocking-call"
    family = "async"
    description = (
        "blocking call (ray_tpu_torch.get / Future.result / time.sleep / "
        "lock.acquire / Event.wait) inside async def stalls the event loop"
    )
    rationale = (
        "a coroutine runs on the actor's single event loop; one blocking "
        "call stalls EVERY in-flight request on that actor, and when the "
        "awaited result depends on another task of the same actor it "
        "deadlocks outright. Ship blocking work off-loop with "
        "run_in_executor/to_thread, or use the async variant."
    )
    bad_example = """
        import ray_tpu_torch

        async def handler(ref):
            return ray_tpu_torch.get(ref)
    """
    good_example = """
        import asyncio

        async def handler(loop, ref):
            return await loop.run_in_executor(None, fetch, ref)
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for node in module.nodes(ast.Call):
            owner = _enclosing_async_def(module, node)
            if owner is None:
                continue
            if isinstance(module.parent(node), ast.Await):
                continue
            label = self._blocking_label(module, node)
            if label is None:
                continue
            if _is_offloaded(module, node, owner):
                continue
            out.append(
                self.finding(
                    module,
                    node,
                    f"blocking {label} inside `async def {owner.name}` "
                    "stalls the actor's event loop (use the async variant "
                    "or run_in_executor)",
                )
            )
        return out

    def _blocking_label(self, module: ModuleInfo, call: ast.Call):
        target = module.call_target(call)
        if target in BLOCKING_CALLS:
            return f"{target}()"
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr in BLOCKING_METHODS and len(call.args) <= 1:
                return f".{func.attr}()"
            if func.attr == "wait" and self._receiver_is_threading_sync(
                module, func.value
            ):
                return ".wait() on a threading primitive"
            if func.attr == "acquire" and self._receiver_is_threading_sync(
                module, func.value
            ):
                return ".acquire() on a threading lock"
        return None

    def _receiver_is_threading_sync(self, module, recv: ast.AST) -> bool:
        """True when the receiver is provably a threading Event/Lock:
        a self-attr or local assigned from threading.Event()/Lock()/...
        or from one of the port's lock classes (rules_locks.LOCK_CTORS)."""
        ctors = {
            "threading.Event", "threading.Lock", "threading.RLock",
            "threading.Condition", "threading.Semaphore",
            "threading.Barrier",
        }
        names = module.memo.get("threading_sync_names")
        if names is None:
            names = {}
            for node in module.nodes(ast.Assign):
                if isinstance(node.value, ast.Call) and (
                    module.call_target(node.value) in ctors
                    or is_lock_ctor(module, node.value)
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            names[("local", t.id)] = True
                        elif (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            names[("attr", t.attr)] = True
            module.memo["threading_sync_names"] = names
        if isinstance(recv, ast.Name):
            return names.get(("local", recv.id), False)
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
        ):
            return names.get(("attr", recv.attr), False)
        return False


class AwaitHoldingLockRule(Rule):
    id = "RTL102"
    name = "await-holding-lock"
    family = "async"
    description = (
        "await while holding a threading lock parks the lock across a "
        "suspension point — any contender deadlocks the loop"
    )
    rationale = (
        "the suspended coroutine keeps the OS lock; any thread — or any "
        "coroutine on this loop that needs the same lock before the "
        "holder resumes — blocks the whole event loop. Use an asyncio "
        "lock, or release before awaiting."
    )
    bad_example = """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            async def bad(self, coro):
                with self._lock:
                    await coro
    """
    good_example = """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            async def good(self, coro):
                with self._lock:
                    pass
                await coro
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for node in module.nodes(ast.AsyncFunctionDef):
            out.extend(self._check_async_fn(module, node))
        return out

    def _check_async_fn(self, module, fn: ast.AsyncFunctionDef):
        cls = self._enclosing_class(module, fn)
        lock_attrs = class_lock_attrs(module, cls) if cls else {}
        local_locks = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and is_lock_ctor(
                module, node.value
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        local_locks.add(t.id)

        findings: List[Finding] = []

        def lockish(expr: ast.AST) -> str:
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in lock_attrs
            ):
                return f"self.{expr.attr}"
            if isinstance(expr, ast.Name) and expr.id in local_locks:
                return expr.id
            return ""

        def visit(node, held: str):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.With):
                inner = held
                for item in node.items:
                    name = lockish(item.context_expr)
                    if name:
                        inner = name
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.Await) and held:
                findings.append(
                    self.finding(
                        module,
                        node,
                        f"await while holding threading lock {held} in "
                        f"`async def {fn.name}` — the lock stays held "
                        "across the suspension (deadlock hazard); use an "
                        "asyncio lock or release before awaiting",
                    )
                )
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, "")
        return findings

    def _enclosing_class(self, module, fn):
        cur = module.parent(fn)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = module.parent(cur)
        return None


RULES = [AsyncBlockingCallRule, AwaitHoldingLockRule]
