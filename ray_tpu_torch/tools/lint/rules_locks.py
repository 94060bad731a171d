"""Family 2 — lock-coverage race detection.

RTL201 infers, per class, which `self.<attr>` state a lock protects: an
attribute MUTATED while holding `self._lock` (or an alias — a
`threading.Condition(self._lock)` acquires the same lock) is treated as
lock-guarded, and every access to it outside the lock, in any other
method, is a finding. Codebase-aware exemptions:

  * `__init__`/`__new__`/`__del__` run before/after concurrent access and
    are never flagged (and contribute no guard evidence).
  * Methods named `*_locked` or whose docstring says the caller must hold
    the lock (e.g. "Caller must hold self._lock.") are treated as holding
    every class lock — the repo's existing private-helper convention.

A lock is what one of LOCK_CTORS builds: the threading primitives and
the port's own lock classes (the server's hand-off lock), the latter
resolved through the project model like any other call target, so
`self._lock = _HandoffLock()` in the defining module counts as well as an
imported or aliased use.

RTL202 flags bare `lock.acquire()` calls — a raise between acquire and
release leaks the lock; use `with`.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.lint.core import (
    Finding,
    ModuleInfo,
    Rule,
    module_name_for,
)

LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    # LLMServer's lock: hands itself to the oldest waiter on release.
    "ray_tpu_torch.llm.engine._HandoffLock",
}

MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "clear", "update", "pop", "popleft", "popitem",
    "setdefault", "put", "put_nowait", "move_to_end", "sort", "reverse",
}

_HOLDS_DOC_RE = re.compile(r"caller(s)?\s+(must\s+)?hold", re.IGNORECASE)

_SKIP_METHODS = {"__init__", "__new__", "__del__", "__post_init__"}


def lock_ctor_name(module: ModuleInfo, call: ast.Call) -> Optional[str]:
    """The absolute dotted name of what `call` constructs: the import-
    resolved target, or — for a class the project model can find (defined
    in this module, or imported through any alias/re-export chain) — its
    defining module's name plus the class name."""
    target = module.call_target(call)
    if target in LOCK_CTORS or target is None or module.project is None:
        return target
    sym = module.project.resolve_expr(module, call.func)
    if sym is None or not isinstance(sym.node, ast.ClassDef):
        return target
    return f"{module_name_for(sym.module.relpath)}.{sym.node.name}"


def is_lock_ctor(module: ModuleInfo, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    return lock_ctor_name(module, node) in LOCK_CTORS


def class_lock_attrs(module: ModuleInfo, cls: ast.ClassDef) -> Dict[str, str]:
    """{attr -> canonical lock attr}: `self._work =
    threading.Condition(self._lock)` maps _work to _lock, so holding
    either counts as holding the one underlying lock. Memoized per class."""
    memo = module.memo.setdefault("class_lock_attrs", {})
    cached = memo.get(id(cls))
    if cached is not None:
        return cached
    locks: Dict[str, str] = {}
    pending_alias: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            continue
        if not is_lock_ctor(module, node.value):
            continue
        call = node.value
        alias_of: Optional[str] = None
        if (
            module.call_target(call) == "threading.Condition"
            and call.args
            and isinstance(call.args[0], ast.Attribute)
            and isinstance(call.args[0].value, ast.Name)
            and call.args[0].value.id == "self"
        ):
            alias_of = call.args[0].attr
        if alias_of is not None:
            pending_alias[target.attr] = alias_of
        else:
            locks[target.attr] = target.attr
    for attr, alias_of in pending_alias.items():
        locks[attr] = locks.get(alias_of, alias_of)
    memo[id(cls)] = locks
    return locks


def _method_assumes_held(fn: ast.AST) -> bool:
    if fn.name.endswith("_locked"):
        return True
    doc = ast.get_docstring(fn) or ""
    return bool(_HOLDS_DOC_RE.search(doc))


class _Access:
    __slots__ = ("attr", "node", "held", "mutation", "method")

    def __init__(self, attr, node, held, mutation, method):
        self.attr = attr
        self.node = node
        self.held = held
        self.mutation = mutation
        self.method = method


class LockCoverageRule(Rule):
    id = "RTL201"
    name = "unlocked-attribute"
    family = "locks"
    description = (
        "attribute mutated under a lock in one method must not be "
        "read or written without it in another"
    )
    rationale = (
        "the class's own locking discipline defines which attributes are "
        "shared state: anything mutated under self._lock is contended, so "
        "a bare access elsewhere races the locked writers — torn reads, "
        "lost updates, check-then-act bugs. __init__, *_locked helpers "
        "and 'Caller must hold' docstrings are exempt."
    )
    bad_example = """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def peek(self):
                return len(self._items)
    """
    good_example = """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def peek(self):
                with self._lock:
                    return len(self._items)
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for node in module.nodes(ast.ClassDef):
            out.extend(self._check_class(module, node))
        return out

    def _check_class(
        self, module: ModuleInfo, cls: ast.ClassDef
    ) -> List[Finding]:
        locks = class_lock_attrs(module, cls)
        if not locks:
            return []
        all_locks = frozenset(locks.values())
        accesses: List[_Access] = []
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in _SKIP_METHODS:
                continue
            if self._constructs_lock(module, stmt, locks):
                # A method that CREATES the class's locks (setup()-style
                # late init) is initialization: nothing can contend for a
                # lock that does not exist yet.
                continue
            base_held = all_locks if _method_assumes_held(stmt) else frozenset()
            self._collect(module, stmt, stmt.name, locks, base_held, accesses)

        # Guard evidence: locks held across at least one MUTATION of the
        # attribute (plain loads under a lock prove nothing — snapshot
        # reads of unguarded state are idiomatic).
        guarded: Dict[str, Set[str]] = {}
        witness: Dict[str, str] = {}
        for acc in accesses:
            if acc.mutation and acc.held:
                guarded.setdefault(acc.attr, set()).update(acc.held)
                witness.setdefault(acc.attr, acc.method)

        findings = []
        for acc in accesses:
            guards = guarded.get(acc.attr)
            if not guards:
                continue
            if acc.held & guards:
                continue
            lock_names = "/".join(sorted(f"self.{g}" for g in guards))
            findings.append(
                self.finding(
                    module,
                    acc.node,
                    f"self.{acc.attr} is mutated under {lock_names} "
                    f"(e.g. in {cls.name}.{witness[acc.attr]}) but "
                    f"accessed here without it",
                )
            )
        return findings

    @staticmethod
    def _constructs_lock(module, method, locks) -> bool:
        for node in ast.walk(method):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "self"
                and node.targets[0].attr in locks
                and is_lock_ctor(module, node.value)
            ):
                return True
        return False

    # -- per-method walk ----------------------------------------------------

    def _collect(
        self,
        module: ModuleInfo,
        method: ast.AST,
        method_name: str,
        locks: Dict[str, str],
        held: frozenset,
        accesses: List[_Access],
    ) -> None:
        self._visit_body(module, method.body, method_name, locks, held,
                         accesses)

    def _held_after_with(
        self, module: ModuleInfo, node: ast.With, locks: Dict[str, str],
        held: frozenset,
    ) -> frozenset:
        extra = set()
        for item in node.items:
            expr = item.context_expr
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in locks
            ):
                extra.add(locks[expr.attr])
        return held | extra if extra else held

    def _visit_body(self, module, body, method_name, locks, held, accesses):
        for stmt in body:
            self._visit_stmt(module, stmt, method_name, locks, held, accesses)

    def _visit_stmt(self, module, stmt, method_name, locks, held, accesses):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            # Nested defs (callbacks, worker closures) run on arbitrary
            # threads at arbitrary times — the lexical lock state is
            # meaningless there, so they neither prove guarding nor flag.
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = self._held_after_with(module, stmt, locks, held)
            for item in stmt.items:
                self._visit_expr(module, item.context_expr, method_name,
                                 locks, held, accesses)
            self._visit_body(module, stmt.body, method_name, locks, inner,
                             accesses)
            return
        if isinstance(stmt, ast.Assign):
            self._visit_expr(module, stmt.value, method_name, locks, held,
                             accesses)
            for target in stmt.targets:
                self._visit_target(module, target, method_name, locks, held,
                                   accesses)
            return
        if isinstance(stmt, ast.AugAssign):
            self._visit_expr(module, stmt.value, method_name, locks, held,
                             accesses)
            self._visit_target(module, stmt.target, method_name, locks, held,
                               accesses)
            return
        if isinstance(stmt, (ast.Delete,)):
            for target in stmt.targets:
                self._visit_target(module, target, method_name, locks, held,
                                   accesses)
            return
        # Generic statement: recurse into child statements with the same
        # held set, and scan its expressions.
        for field in ast.iter_child_nodes(stmt):
            if isinstance(field, ast.stmt):
                self._visit_stmt(module, field, method_name, locks, held,
                                 accesses)
            elif isinstance(field, ast.expr):
                self._visit_expr(module, field, method_name, locks, held,
                                 accesses)
            elif isinstance(field, (ast.excepthandler,)):
                self._visit_body(module, field.body, method_name, locks,
                                 held, accesses)

    def _visit_target(self, module, target, method_name, locks, held,
                      accesses):
        """Assignment target: `self.X = ...`, `self.X[k] = ...` and
        `self.X.y = ...` all mutate X."""
        attr = self._root_self_attr(target)
        if attr is not None and attr not in locks:
            accesses.append(
                _Access(attr, target, held, True, method_name)
            )
        # Subscript indices / nested tuples may contain loads.
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._visit_target(module, el, method_name, locks, held,
                                   accesses)
        elif isinstance(target, ast.Subscript):
            self._visit_expr(module, target.slice, method_name, locks, held,
                             accesses)

    def _visit_expr(self, module, expr, method_name, locks, held, accesses):
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # ast.walk descends into nested defs; skip their contents
                # by pruning here (walk is BFS — prune via containment
                # check below instead).
                continue
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ) and node.value.id == "self":
                if node.attr in locks:
                    continue
                if self._inside_nested_def(module, node, expr):
                    continue
                mutation = self._is_mutating_use(module, node)
                accesses.append(
                    _Access(node.attr, node, held, mutation, method_name)
                )

    @staticmethod
    def _root_self_attr(target: ast.AST) -> Optional[str]:
        node = target
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            parent = node.value
            if (
                isinstance(node, ast.Attribute)
                and isinstance(parent, ast.Name)
                and parent.id == "self"
            ):
                return node.attr
            node = parent
        return None

    def _inside_nested_def(self, module, node, stop) -> bool:
        if node is stop:
            # A bare `self.X` that IS the visited expression (e.g.
            # `return self.X`, an `if self.X:` test) — walking up from
            # its parent would run past `stop` to the enclosing method
            # and misclassify it as nested.
            return False
        cur = module.parent(node)
        while cur is not None and cur is not stop:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return True
            cur = module.parent(cur)
        return False

    def _is_mutating_use(self, module, node: ast.Attribute) -> bool:
        """`self.X.append(...)` / `self.X |= ...`-style mutations that
        appear as loads in the AST."""
        parent = module.parent(node)
        if (
            isinstance(parent, ast.Attribute)
            and parent.attr in MUTATOR_METHODS
        ):
            gp = module.parent(parent)
            if isinstance(gp, ast.Call) and gp.func is parent:
                return True
        return False


class ManualAcquireRule(Rule):
    id = "RTL202"
    name = "manual-lock-acquire"
    family = "locks"
    description = (
        "lock.acquire() outside a with-statement leaks the lock if "
        "anything between acquire and release raises"
    )
    rationale = (
        "an exception between acquire() and release() leaves the lock "
        "held forever — every later contender hangs. The with-statement "
        "releases on every exit path."
    )
    bad_example = """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self):
                self._lock.acquire()
                do_something()
                self._lock.release()
    """
    good_example = """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def good(self):
                with self._lock:
                    do_something()
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        known_attrs = set()
        for cls in module.nodes(ast.ClassDef):
            known_attrs.update(class_lock_attrs(module, cls))
        for node in module.nodes(ast.Call):
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"):
                continue
            recv = node.func.value
            is_lock = False
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and recv.attr in known_attrs
            ):
                is_lock = True
            elif isinstance(recv, ast.Name) and "lock" in recv.id.lower():
                is_lock = True
            if not is_lock:
                continue
            parent = module.parent(node)
            if isinstance(parent, ast.Await):
                continue  # asyncio primitive
            out.append(
                self.finding(
                    module,
                    node,
                    "bare lock.acquire(); use `with` so a raise between "
                    "acquire and release cannot leak the lock",
                )
            )
        return out


RULES = [LockCoverageRule, ManualAcquireRule]
