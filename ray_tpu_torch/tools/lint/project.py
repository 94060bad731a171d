"""Project-level model for `ray-tpu-torch lint`: the cross-module layer.

A rule sees one `ModuleInfo` at a time. This module adds the
cross-module structure the lock (RTL201's lock classes), actor (RTL7xx)
and pool (RTL804) rules need, computed ONCE per scan and shared through
`project.memo`:

  * a **symbol table** (`resolve`): dotted name -> defining module + AST
    node, following `import x as y` chains, `from x import y as z`, and
    re-exports through `__init__.py` (each hop resolves in the module
    that wrote the alias, so multi-file chains terminate correctly);
  * a **constant resolver** (`resolve_constant`): small literal values
    (strings, numbers, tuples of them) pulled through names and across
    modules — e.g. a block-size tuple defined in one package and used
    to size a pool two packages away;
  * a **call graph** (`call_graph`): function/method qualkey -> resolved
    callee qualkeys, built from the same `_resolve_function` binding
    semantics rules already use, now crossing files;
  * an **actor index** (`actor_index`): classes decorated
    `@ray_tpu_torch.remote` or registered via `ray_tpu_torch.remote(Cls)` (including
    `Handle = ray_tpu_torch.remote(Cls)` aliases and classes imported under
    another name), plus which names each module knows them by — the
    reachability base for the RTL7xx deadlock rules.

Every resolver is conservative: unresolvable means "no answer", never a
guess — cross-module rules only fire on facts the table can prove.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.lint.core import (
    ModuleInfo,
    _resolve_function,
    _scope_level_nodes,
    module_name_for,
    qualname_of,
    resolve_name_binding,
)

# Dotted targets that register an actor class. `ray_tpu_torch.api.remote` is the
# implementation home `ray_tpu_torch.remote` re-exports.
REMOTE_TARGETS = ("ray_tpu_torch.remote", "ray_tpu_torch.api.remote")

_MAX_HOPS = 8  # alias/re-export chains (a cycle would otherwise loop)

# A local def shadowing one of these would be missed by the call graph —
# an acceptable (edge-dropping, never edge-inventing) trade for skipping
# the binding walk on the majority of all bare-name calls.
import builtins as _builtins

_BUILTIN_NAMES = frozenset(dir(_builtins))


@dataclasses.dataclass
class Symbol:
    """A project-resolved top-level (or class-level) definition."""

    module: ModuleInfo
    node: Optional[ast.AST]  # FunctionDef/ClassDef/Assign; None = module
    name: str
    qualname: str  # "ray_tpu_torch.llm.engine.LLMServer"


def qualkey(module: ModuleInfo, node: ast.AST) -> Tuple[str, str]:
    """Stable identity of a function/method across the project."""
    return (module.relpath, qualname_of(module, node) or getattr(
        node, "name", "<module>"
    ))


class ProjectInfo:
    """All scanned modules plus lazily-built cross-module structure."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules = list(modules)
        self.by_relpath: Dict[str, ModuleInfo] = {
            m.relpath: m for m in modules
        }
        self.by_name: Dict[str, ModuleInfo] = {}
        for m in modules:
            self.by_name[module_name_for(m.relpath)] = m
        self.memo: Dict[str, object] = {}
        self._top_level: Dict[int, Dict[str, ast.AST]] = {}
        for m in modules:
            m.project = self

    # -- symbol table -------------------------------------------------------

    def top_level(self, module: ModuleInfo) -> Dict[str, ast.AST]:
        """name -> defining node at module scope (defs, classes, and the
        LAST module-level assignment of each name)."""
        cached = self._top_level.get(id(module))
        if cached is not None:
            return cached
        out: Dict[str, ast.AST] = {}
        for node in module.tree.body:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                out[node.name] = node
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = node
            elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name
            ) and node.value is not None:
                out[node.target.id] = node
        self._top_level[id(module)] = out
        return out

    def resolve(self, dotted: str, _depth: int = 0) -> Optional[Symbol]:
        """Map an absolute dotted name (already passed through the using
        module's import aliases) to the defining module + node, following
        re-export chains. None for externals and dynamic values."""
        if not dotted or _depth > _MAX_HOPS:
            return None
        parts = dotted.split(".")
        # Longest module prefix wins: "ray_tpu_torch.llm.engine.LLMServer"
        # resolves in ray_tpu_torch/llm/engine.py, not as an attr chain on
        # ray_tpu_torch/__init__.py.
        for cut in range(len(parts), 0, -1):
            mod = self.by_name.get(".".join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            if not rest:
                return Symbol(mod, None, "", dotted)
            return self._resolve_in_module(mod, rest, dotted, _depth)
        return None

    def _resolve_in_module(
        self, mod: ModuleInfo, rest: List[str], dotted: str, _depth: int
    ) -> Optional[Symbol]:
        name = rest[0]
        defs = self.top_level(mod)
        node = defs.get(name)
        if node is not None:
            if len(rest) == 1:
                return Symbol(mod, node, name, dotted)
            if isinstance(node, ast.ClassDef):
                for member in node.body:
                    if isinstance(
                        member, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ) and member.name == rest[1] and len(rest) == 2:
                        return Symbol(mod, member, rest[1], dotted)
            return None
        alias = mod.aliases.get(name)
        if alias is not None:
            # Re-export: resolve the alias target in ITS module, keeping
            # any remaining attr path.
            return self.resolve(
                ".".join([alias, *rest[1:]]), _depth + 1
            )
        return None

    def resolve_expr(
        self, module: ModuleInfo, expr: ast.AST
    ) -> Optional[Symbol]:
        dotted = module.dotted_name(expr)
        if dotted is None:
            return None
        sym = self.resolve(dotted)
        if sym is not None:
            return sym
        # A name with no module prefix may simply be defined at the top
        # level of the USING module (aliases were already folded in by
        # dotted_name, so anything left is local or unresolvable).
        parts = dotted.split(".")
        if parts[0] in self.top_level(module):
            return self._resolve_in_module(module, parts, dotted, 0)
        return None

    # -- constants ----------------------------------------------------------

    def resolve_constant(
        self, module: ModuleInfo, expr: ast.AST,
        at: Optional[ast.AST] = None, _depth: int = 0
    ):
        """Evaluate small static values: literals, tuples/lists of them,
        and names bound to them (locally via the binding walk when `at`
        is given, else module-level — crossing modules through the symbol
        table). None when not statically known."""
        if expr is None or _depth > _MAX_HOPS:
            return None
        if isinstance(expr, ast.Constant):
            return expr.value
        if isinstance(expr, (ast.Tuple, ast.List)):
            out = []
            for el in expr.elts:
                v = self.resolve_constant(module, el, at, _depth + 1)
                if v is None:
                    return None
                out.append(v)
            return tuple(out)
        if isinstance(expr, ast.Name) and at is not None:
            bind = resolve_name_binding(module, expr.id, at)
            if isinstance(bind, ast.Assign):
                return self.resolve_constant(
                    module, bind.value, bind, _depth + 1
                )
            if isinstance(bind, ast.AnnAssign) and bind.value is not None:
                return self.resolve_constant(
                    module, bind.value, bind, _depth + 1
                )
            return None
        if isinstance(expr, (ast.Name, ast.Attribute)):
            sym = self.resolve_expr(module, expr)
            if sym is None or sym.node is None:
                return None
            if isinstance(sym.node, ast.Assign):
                return self.resolve_constant(
                    sym.module, sym.node.value, sym.node, _depth + 1
                )
            if isinstance(
                sym.node, ast.AnnAssign
            ) and sym.node.value is not None:
                return self.resolve_constant(
                    sym.module, sym.node.value, sym.node, _depth + 1
                )
        return None

    # -- call graph ---------------------------------------------------------

    def call_graph(self) -> Dict[Tuple[str, str], Set[Tuple[str, str]]]:
        """caller qualkey -> set of resolved callee qualkeys. Callees
        resolve through local bindings (`_resolve_function` semantics),
        `self._method`, and the cross-module symbol table; dynamic
        receivers simply contribute no edge."""
        cached = self.memo.get("call_graph")
        if cached is not None:
            return cached
        graph: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        for module in self.modules:
            for call in module.nodes(ast.Call):
                target = self._resolve_callee(module, call)
                if target is None:
                    continue
                scope = self._enclosing_function(module, call)
                caller = (
                    qualkey(module, scope)
                    if scope is not None
                    else (module.relpath, "<module>")
                )
                graph.setdefault(caller, set()).add(target)
        self.memo["call_graph"] = graph
        return graph

    def function_index(
        self,
    ) -> Dict[Tuple[str, str], Tuple[ModuleInfo, ast.AST]]:
        """qualkey -> (module, FunctionDef) for every function/method in
        the project — the lookup side of call_graph()."""
        cached = self.memo.get("function_index")
        if cached is not None:
            return cached
        out: Dict[Tuple[str, str], Tuple[ModuleInfo, ast.AST]] = {}
        for module in self.modules:
            for fn in module.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
                out[qualkey(module, fn)] = (module, fn)
        self.memo["function_index"] = out
        return out

    def _enclosing_function(self, module: ModuleInfo, node: ast.AST):
        cur = module.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = module.parent(cur)
        return None

    def _resolve_callee(
        self, module: ModuleInfo, call: ast.Call
    ) -> Optional[Tuple[str, str]]:
        func = call.func
        # Builtins can never be project edges; skipping them avoids the
        # binding walk on the bulk of all bare-name calls (the full-tree
        # scan budget lives or dies on this).
        if isinstance(func, ast.Name) and func.id in _BUILTIN_NAMES:
            return None
        # self.method() -> method of the enclosing class.
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            fn = _resolve_function(module, func, call)
            if fn is not None:
                return qualkey(module, fn)
            return None
        if isinstance(func, ast.Attribute):
            # Dotted receivers resolve through the symbol table only —
            # the binding walk can't see into attribute chains anyway.
            sym = self.resolve_expr(module, func)
            if sym is not None and isinstance(
                sym.node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                return qualkey(sym.module, sym.node)
            return None
        fn = _resolve_function(module, func, call)
        if fn is not None:
            return qualkey(module, fn)
        sym = self.resolve_expr(module, func)
        if sym is not None and isinstance(
            sym.node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
        ):
            return qualkey(sym.module, sym.node)
        return None

    # -- import graph (ray-tpu-torch lint --changed) ------------------------------

    def _import_targets(self, module: ModuleInfo) -> Set[str]:
        """Every absolute dotted name `module` imports, raw: alias
        targets, bare `import pkg.mod` names (the alias map stores only
        "pkg" for those), and `from X import *` bases (which bind no
        alias at all)."""
        cached = module.memo.get("import_targets")
        if cached is not None:
            return cached
        targets: Set[str] = set(module.aliases.values())
        for node in module.nodes(ast.Import):
            for a in node.names:
                targets.add(a.name)
        for node in module.nodes(ast.ImportFrom):
            base = module._import_base(node)
            if base is not None:
                targets.add(base)
        module.memo["import_targets"] = targets
        return targets

    def import_deps(self) -> Dict[str, Set[str]]:
        """relpath -> relpaths of scanned modules it imports (through
        any alias: `import x`, `from x import y [as z]`, bare dotted
        imports, `import *`; re-export chains are NOT followed here — a
        changed re-exporting __init__ is itself an import of its
        sources, so the transitive closure covers them)."""
        cached = self.memo.get("import_deps")
        if cached is not None:
            return cached
        out: Dict[str, Set[str]] = {}
        for module in self.modules:
            deps: Set[str] = set()
            for alias in self._import_targets(module):
                parts = alias.split(".")
                # Longest module prefix wins, mirroring resolve():
                # "pkg.mod.Symbol" depends on pkg/mod.py, and plain
                # "pkg.mod" on the module itself (or its __init__).
                for cut in range(len(parts), 0, -1):
                    dep = self.by_name.get(".".join(parts[:cut]))
                    if dep is not None:
                        deps.add(dep.relpath)
                        break
            deps.discard(module.relpath)
            out[module.relpath] = deps
        self.memo["import_deps"] = out
        return out

    def reverse_import_closure(self, relpaths) -> Set[str]:
        """The given modules plus every scanned module that imports any
        of them, transitively — the set a diff-scoped lint run must
        re-check (cross-module rules can change their verdict in any
        importer of a changed file). A changed path with NO module in
        the scan (deleted or renamed) still seeds the closure with its
        former importers, matched by module name against each module's
        raw import targets — a pure deletion must re-check everything
        that resolved symbols through the deleted file."""
        deps = self.import_deps()
        importers: Dict[str, Set[str]] = {}
        for src, targets in deps.items():
            for t in targets:
                importers.setdefault(t, set()).add(src)
        stack = [p for p in relpaths if p in self.by_relpath]
        missing_names = [
            module_name_for(p)
            for p in relpaths
            if p not in self.by_relpath and p.endswith(".py")
        ]
        if missing_names:
            for module in self.modules:
                targets = self._import_targets(module)
                if any(
                    t == name or t.startswith(name + ".")
                    for name in missing_names
                    for t in targets
                ):
                    stack.append(module.relpath)
        out: Set[str] = set()
        while stack:
            p = stack.pop()
            if p in out:
                continue
            out.add(p)
            stack.extend(importers.get(p, ()))
        return out

    # -- actor index --------------------------------------------------------

    def actor_index(self) -> "ActorIndex":
        cached = self.memo.get("actor_index")
        if cached is not None:
            return cached
        index = ActorIndex(self)
        self.memo["actor_index"] = index
        return index


class ActorIndex:
    """Which classes run as actors, and the names each module knows their
    handles/classes by.

    classes:    class qualkey -> (module, ClassDef)
    registered: (module relpath, bound name) -> actor class qualkey, for
                `Handle = ray_tpu_torch.remote(Cls)`-style registrations (the
                bound name constructs handles of Cls).
    """

    def __init__(self, project: ProjectInfo):
        self.project = project
        self.classes: Dict[Tuple[str, str], Tuple[ModuleInfo, ast.ClassDef]] = {}
        self.registered: Dict[Tuple[str, str], Tuple[str, str]] = {}
        for module in project.modules:
            self._scan(module)

    def _is_remote_target(self, module: ModuleInfo, expr: ast.AST) -> bool:
        dotted = module.dotted_name(expr)
        return dotted in REMOTE_TARGETS

    def _scan(self, module: ModuleInfo) -> None:
        for node in module.nodes(ast.ClassDef):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if self._is_remote_target(module, target):
                    self.classes[qualkey(module, node)] = (module, node)
                    break
        # MODULE-scope registrations only: a function-local
        # `h = ray_tpu_torch.remote(Cls)` must not leak into a module-wide map
        # where an unrelated local `h` elsewhere would resolve to it.
        for node in module.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            key = self._registration_target(module, node.value)
            if key is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.registered[(module.relpath, t.id)] = key

    def _registration_target(
        self, module: ModuleInfo, expr: ast.AST
    ) -> Optional[Tuple[str, str]]:
        """`ray_tpu_torch.remote(Cls)` (optionally `.options(...)`) -> Cls's
        qualkey; the class may live in another module or be imported
        under an alias."""
        # Unwrap .options(...) / other fluent chains.
        while isinstance(expr, ast.Call) and isinstance(
            expr.func, ast.Attribute
        ) and expr.func.attr == "options":
            expr = expr.func.value
        if not (
            isinstance(expr, ast.Call)
            and self._is_remote_target(module, expr.func)
            and expr.args
        ):
            return None
        cls = self.resolve_class(module, expr.args[0], expr)
        if cls is None:
            return None
        clsmod, clsnode = cls
        key = qualkey(clsmod, clsnode)
        self.classes.setdefault(key, (clsmod, clsnode))
        return key

    def resolve_class(
        self, module: ModuleInfo, expr: ast.AST, at: ast.AST
    ) -> Optional[Tuple[ModuleInfo, ast.ClassDef]]:
        """Resolve an expression naming a class — locally, through the
        symbol table, or through an import alias."""
        if isinstance(expr, ast.Name):
            bind = resolve_name_binding(module, expr.id, at)
            if isinstance(bind, ast.ClassDef):
                return (module, bind)
        sym = self.project.resolve_expr(module, expr)
        if sym is not None and isinstance(sym.node, ast.ClassDef):
            return (sym.module, sym.node)
        return None

    def handle_class(
        self, module: ModuleInfo, expr: ast.AST, at: ast.AST
    ) -> Optional[Tuple[str, str]]:
        """Actor class behind a handle-constructing expression:
        `ActorCls.remote(...)`, `ActorCls.options(...).remote(...)`,
        `ray_tpu_torch.remote(Cls)[.options(...)].remote(...)`, or a registered
        handle name (`RemoteX = ray_tpu_torch.remote(X)`) — local or imported."""
        if not (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "remote"
        ):
            return None
        base = expr.func.value  # the thing .remote() was called on
        while isinstance(base, ast.Call) and isinstance(
            base.func, ast.Attribute
        ) and base.func.attr == "options":
            base = base.func.value
        # ray_tpu_torch.remote(Cls)....remote()
        if isinstance(base, ast.Call):
            return self._registration_target(module, base)
        # A decorated actor class used directly, or a registered name.
        cls = self.resolve_class(module, base, at)
        if cls is not None:
            key = qualkey(cls[0], cls[1])
            if key in self.classes:
                return key
            return None
        dotted = module.dotted_name(base)
        if dotted is None:
            return None
        # Registered handle name, local ("RemoteX") or imported
        # ("pkg.mod.RemoteX" via the alias map).
        if "." not in dotted:
            return self.registered.get((module.relpath, dotted))
        sym = self.project.resolve(dotted)
        if sym is not None and isinstance(sym.node, ast.Assign):
            return self._registration_target(sym.module, sym.node.value)
        return None

    def methods(self, key: Tuple[str, str]) -> Dict[str, ast.AST]:
        module, node = self.classes[key]
        return {
            m.name: m
            for m in node.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
