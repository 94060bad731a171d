"""Core of `ray-tpu-torch lint`: findings, module model, rule registry, runner.

A rule is a class with an `id` (stable, e.g. "RTL201"), a short `name`,
a `family` (async / locks / trace / resources) and a `check(module)`
returning findings. Rules work on a `ModuleInfo` — one parsed file plus
the derived maps every rule needs (import aliases, AST parent links,
inline suppressions) so each rule stays a focused AST pass.

Suppression idiom (reason is REQUIRED — an unexplained ignore is itself
reported as RTL002):

    do_risky_thing()  # ray-tpu: lint-ignore[RTL201] probe reads a stale
                      # bool at worst; the lock would serialize the loop

The marker keeps the reference analyzer's spelling (`ray-tpu:`), so one
comment reads the same to both tools. A standalone suppression comment
applies to the next code line. Findings
neither fixed nor suppressible inline live in the checked-in baseline
(see baseline.py) with a written reason per entry.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# `_build` beyond the reference's set: the port's kernel and store builds
# land in git-ignored `ops/_build/` and `_private/_build/`, and a source
# tree unpacked there for a rehearsal would double every module.
SKIP_DIRS = {
    "__pycache__", ".git", ".eggs", "build", "_build", "dist", "node_modules",
}
SKIP_FILE_SUFFIXES = ("_pb2.py", "_pb2_grpc.py")

_SUPPRESS_RE = re.compile(
    r"#\s*ray-tpu:\s*lint-ignore\[([^\]]*)\]\s*(.*)$"
)


@dataclasses.dataclass
class Finding:
    rule: str
    name: str
    family: str
    path: str  # repo-relative posix path
    line: int
    col: int
    context: str  # dotted qualname of the enclosing scope
    message: str
    fingerprint: str = ""

    def key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fingerprint(rule: str, path: str, context: str, line_text: str,
                 occurrence: int) -> str:
    # Line NUMBERS drift with every edit; the fingerprint hashes the rule,
    # file, enclosing scope and the normalized source text instead, so a
    # baseline survives unrelated churn above the finding.
    normalized = "".join(line_text.split())
    payload = f"{rule}|{path}|{context}|{normalized}|{occurrence}"
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


class Suppression:
    __slots__ = ("line", "ids", "reason", "used")

    def __init__(self, line: int, ids: set, reason: str):
        self.line = line
        self.ids = ids
        self.reason = reason
        self.used = False

    def matches(self, finding: Finding) -> bool:
        return "*" in self.ids or finding.rule in self.ids or (
            finding.name in self.ids
        )


def _matching_suppression(
    sups: Optional[List[Suppression]], finding: Finding
) -> Optional[Suppression]:
    """First suppression on the finding's line that names its rule AND
    carries a reason. RTL002 (reasonless ignore) is never suppressible."""
    if not sups or finding.rule == "RTL002":
        return None
    for sup in sups:
        if sup.reason and sup.matches(finding):
            return sup
    return None


_SCOPE_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def module_name_for(relpath: str) -> str:
    """Dotted module name of a repo-relative path:
    "ray_tpu_torch/llm/engine.py" -> "ray_tpu_torch.llm.engine",
    "ray_tpu_torch/llm/__init__.py" -> "ray_tpu_torch.llm"."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = [part for part in p.split("/") if part]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ModuleInfo:
    """One parsed source file plus the shared derived structure.

    Everything rules repeatedly need is computed in ONE traversal:
    parent links, a by-type node index, and scope ownership (each node
    mapped to its nearest enclosing function/lambda/module), so rules
    never re-walk the whole tree. A per-module memo dict lets rules
    share expensive derived maps (lock attrs, pool evaluations)."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        # Backref set by ProjectInfo when this module is part of a
        # project-level scan; None for standalone snippets.
        self.project = None
        self.parents: Dict[int, ast.AST] = {}
        self.by_type: Dict[type, List[ast.AST]] = {}
        # scope node (Module/FunctionDef/AsyncFunctionDef/Lambda) id ->
        # nodes owned directly by that scope (not by a nested scope).
        self.scope_nodes: Dict[int, List[ast.AST]] = {id(self.tree): []}
        self.scopes: List[ast.AST] = [self.tree]
        self.memo: Dict[str, object] = {}
        stack = [(self.tree, self.tree)]
        while stack:
            node, scope = stack.pop()
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
                self.by_type.setdefault(type(child), []).append(child)
                child_scope = scope
                if isinstance(child, _SCOPE_TYPES):
                    self.scopes.append(child)
                    self.scope_nodes[id(child)] = []
                    child_scope = child
                else:
                    self.scope_nodes[id(scope)].append(child)
                stack.append((child, child_scope))
        # name -> dotted module ("np" -> "numpy"); from-imports map the
        # bound name to "module.attr" ("zeros" -> "torch.zeros"). Relative
        # imports resolve against this file's package so a project-level
        # scan can follow `from .engine import X` across files.
        self.aliases: Dict[str, str] = {}
        for node in self.nodes(ast.Import):
            for a in node.names:
                self.aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        for node in self.nodes(ast.ImportFrom):
            base = self._import_base(node)
            if base is None:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                self.aliases[a.asname or a.name] = f"{base}.{a.name}"
        self.suppressions = self._parse_suppressions()
        self._expand_suppressions()

    def _import_base(self, node: ast.ImportFrom) -> Optional[str]:
        """Absolute dotted base of an ImportFrom. `from a.b import c` ->
        "a.b"; `from .sib import c` in pkg/mod.py -> "pkg.sib"; a relative
        import that climbs above the scan root resolves to None."""
        if not node.level:
            return node.module
        pkg_parts = module_name_for(self.relpath).split(".")
        if not self.relpath.endswith("__init__.py"):
            pkg_parts = pkg_parts[:-1]  # plain module: package is the dir
        drop = node.level - 1
        if drop > len(pkg_parts):
            return None
        base_parts = pkg_parts[: len(pkg_parts) - drop]
        if node.module:
            base_parts.append(node.module)
        return ".".join(base_parts) or None

    def nodes(self, *types: type) -> List[ast.AST]:
        if len(types) == 1:
            return self.by_type.get(types[0], [])
        out: List[ast.AST] = []
        for t in types:
            out.extend(self.by_type.get(t, []))
        return out

    def own_nodes(self, scope: ast.AST) -> List[ast.AST]:
        """Nodes owned directly by `scope`, excluding nested functions."""
        return self.scope_nodes.get(id(scope), [])

    # -- suppressions -------------------------------------------------------

    def _parse_suppressions(self) -> Dict[int, List[Suppression]]:
        # A list per line: several standalone lint-ignore comments stacked
        # above one statement all resolve to that statement's line, and
        # each must keep its own ids + reason.
        # Lines inside multi-line string literals are string CONTENT, not
        # comments — a docstring showing the idiom must not register.
        in_string: set = set()
        for node in self.nodes(ast.Constant):
            if (
                isinstance(node.value, str)
                and getattr(node, "end_lineno", node.lineno) > node.lineno
            ):
                in_string.update(range(node.lineno, node.end_lineno + 1))
        out: Dict[int, List[Suppression]] = {}
        for i, text in enumerate(self.lines, start=1):
            if i in in_string:
                continue
            m = _SUPPRESS_RE.search(text)
            if m is None:
                continue
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            reason = m.group(2).strip()
            line = i
            if text.lstrip().startswith("#"):
                # Standalone comment: applies to the next code line.
                j = i + 1
                while j <= len(self.lines) and (
                    not self.lines[j - 1].strip()
                    or self.lines[j - 1].lstrip().startswith("#")
                ):
                    j += 1
                line = j
            out.setdefault(line, []).append(Suppression(line, ids, reason))
        return out

    def _expand_suppressions(self) -> None:
        """Extend each suppression across the statement it anchors to, so
        an ignore above a black-wrapped expression reaches findings whose
        AST node sits on a continuation line. Compound statements extend
        over their HEADER only (`with`/`if`/`def` lines up to the first
        body statement) — an ignore must never blanket a whole block."""
        if not self.suppressions:
            return
        spans: Dict[int, int] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt):
                continue
            body = getattr(node, "body", None)
            if isinstance(body, list) and body and hasattr(body[0], "lineno"):
                end = max(node.lineno, body[0].lineno - 1)
            else:
                end = getattr(node, "end_lineno", None) or node.lineno
            prev = spans.get(node.lineno)
            spans[node.lineno] = end if prev is None else max(prev, end)
        for line, sups in list(self.suppressions.items()):
            for extra in range(line + 1, spans.get(line, line) + 1):
                self.suppressions.setdefault(extra, []).extend(sups)

    def suppression_findings(self) -> List[Finding]:
        """RTL002: a lint-ignore with no written reason is not a valid
        suppression (and does not suppress anything)."""
        out = []
        # Expansion aliases one Suppression onto several lines — report
        # each object once, at its anchor.
        unique = {
            id(s): s for sups in self.suppressions.values() for s in sups
        }
        for sup in unique.values():
            if not sup.reason:
                out.append(
                    Finding(
                        rule="RTL002",
                        name="suppression-missing-reason",
                        family="meta",
                        path=self.relpath,
                        line=sup.line,
                        col=0,
                        context="<module>",
                        message=(
                            "lint-ignore without a reason; write why the "
                            "finding is a false positive after the bracket"
                        ),
                    )
                )
        return out

    # -- resolution helpers -------------------------------------------------

    def dotted_name(self, node: ast.AST) -> Optional[str]:
        """`a.b.c` for an Attribute/Name chain, with the root mapped
        through the module's import aliases. None for dynamic receivers."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def call_target(self, call: ast.Call) -> Optional[str]:
        return self.dotted_name(call.func)

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(id(node))

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


def qualname_of(module: ModuleInfo, node: ast.AST) -> str:
    """Dotted path of the scopes enclosing `node` (classes + functions)."""
    parts: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            parts.append(cur.name)
        cur = module.parent(cur)
    return ".".join(reversed(parts)) or "<module>"


# -- name/function binding resolution (shared by rule families) -------------


def call_kwargs(call: ast.Call) -> Dict[str, ast.AST]:
    """Named keyword arguments of a call (a `**splat` contributes none)."""
    return {kw.arg: kw.value for kw in call.keywords if kw.arg}


def _target_binds(target: ast.AST, name: str) -> bool:
    """Does an assignment-like target bind `name`? Sees through tuple /
    list unpacking and starred elements."""
    if isinstance(target, ast.Name):
        return target.id == name
    if isinstance(target, (ast.Tuple, ast.List)):
        return any(_target_binds(el, name) for el in target.elts)
    if isinstance(target, ast.Starred):
        return _target_binds(target.value, name)
    return False


def _param_names(fn: ast.AST) -> set:
    a = fn.args
    names = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    if a.vararg is not None:
        names.add(a.vararg.arg)
    if a.kwarg is not None:
        names.add(a.kwarg.arg)
    return names


def _scope_level_nodes(scope: ast.AST):
    """Nodes lexically inside `scope` without descending into nested
    scopes — a function/class body introduces its own namespace, so its
    bindings are not visible where `scope`'s are."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef),
        ):
            stack.extend(ast.iter_child_nodes(node))


def _binding_of(node: ast.AST, name: str) -> Optional[ast.AST]:
    """The node, when it is a statement binding `name` (def, assignment,
    for/with target); else None."""
    if isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    ) and node.name == name:
        return node
    if isinstance(node, ast.Assign) and any(
        _target_binds(t, name) for t in node.targets
    ):
        return node
    if isinstance(
        node, (ast.AnnAssign, ast.NamedExpr)
    ) and _target_binds(node.target, name):
        return node
    if isinstance(node, (ast.For, ast.AsyncFor)) and _target_binds(
        node.target, name
    ):
        return node
    if isinstance(node, (ast.With, ast.AsyncWith)) and any(
        item.optional_vars is not None
        and _target_binds(item.optional_vars, name)
        for item in node.items
    ):
        return node
    return None


def _bound_names(node: ast.AST) -> List[str]:
    """Names an assignment-like statement binds (see _binding_of)."""
    if isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    ):
        return [node.name]
    out: List[str] = []

    def collect(target: ast.AST) -> None:
        for sub in ast.walk(target):
            if isinstance(sub, ast.Name) and isinstance(
                sub.ctx, ast.Store
            ):
                out.append(sub.id)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            collect(t)
    elif isinstance(node, (ast.AnnAssign, ast.NamedExpr)):
        collect(node.target)
    elif isinstance(node, (ast.For, ast.AsyncFor)):
        collect(node.target)
    elif isinstance(node, (ast.With, ast.AsyncWith)):
        for item in node.items:
            if item.optional_vars is not None:
                collect(item.optional_vars)
    return out


def _module_scope_bindings(module: ModuleInfo) -> Dict[str, ast.AST]:
    """name -> LAST module-level binding. The module scope is scanned by
    every name lookup that escapes a function (the call graph does many
    thousands per scan), so it is memoized once per module; the latest
    binding wins, matching the non-sequential walk."""
    cached = module.memo.get("module_scope_bindings")
    if cached is not None:
        return cached
    out: Dict[str, ast.AST] = {}
    for node in _scope_level_nodes(module.tree):
        for name in _bound_names(node):
            prev = out.get(name)
            if prev is None or node.lineno > prev.lineno:
                out[name] = node
    module.memo["module_scope_bindings"] = out
    return out


def _scope_binding_index(
    module: ModuleInfo, scope: ast.AST
) -> Dict[str, List[ast.AST]]:
    """name -> binding statements at `scope` level, memoized per scope.
    `resolve_name_binding` is on the hot path of the call graph AND the
    RTL804 pool evaluator; re-walking a scope's statements per
    lookup was the dominant cost of a full scan."""
    memo = module.memo.setdefault("scope_binding_index", {})
    cached = memo.get(id(scope))
    if cached is not None:
        return cached
    index: Dict[str, List[ast.AST]] = {}
    for node in _scope_level_nodes(scope):
        # _bound_names answers exactly the names _binding_of binds
        # (its docstring points back at the predicate).
        for name in _bound_names(node):
            index.setdefault(name, []).append(node)
    memo[id(scope)] = index
    return index


def resolve_name_binding(
    module: ModuleInfo, name: str, at: ast.AST
) -> Optional[ast.AST]:
    """Latest live binding of a bare name visible at `at`, with the same
    scoping semantics as `_resolve_function` (innermost scope first,
    latest binding not past the use site wins inside the function holding
    `at`, class scope skipped from inside methods, opaque local bindings
    stop the walk). Returns the binding statement (def / Assign / For /
    With), or None."""
    scope = module.parent(at)
    chain = []
    while scope is not None:
        chain.append(scope)
        scope = module.parent(scope)
    if not chain or chain[-1] is not module.tree:
        chain.append(module.tree)
    sequential = True
    crossed_function = False
    for scope in chain:
        if isinstance(scope, ast.ClassDef) and crossed_function:
            continue
        if scope is module.tree and not sequential:
            # Hot path: every lookup that escapes a function lands here —
            # use the memoized module-level map instead of rescanning.
            # (module.tree is always the last scope in the chain, so a
            # miss here is the walk's final None.)
            return _module_scope_bindings(module).get(name)
        best = None
        for node in _scope_binding_index(module, scope).get(name, ()):
            if sequential and (
                node.lineno > getattr(at, "lineno", node.lineno)
            ):
                continue
            if best is None or node.lineno > best.lineno:
                best = node
        if isinstance(
            scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            sequential = False
            crossed_function = True
            if best is None and name in _param_names(scope):
                return None  # bound by a parameter: opaque
        if best is not None:
            return best
    return None


def _resolve_function(
    module: ModuleInfo, expr: ast.AST, at: ast.AST, _depth: int = 0
):
    """Map a function expression to a FunctionDef/Lambda defined in this
    module: a bare name (module function or sibling nested def), a
    `self._method`, or an inline lambda. Sees through
    `functools.partial(fn, ...)` — inline, or bound to a local name first
    (`cb = functools.partial(fn, ...)`), the two ways a callable is
    commonly handed on. None when not resolvable."""
    if _depth > 8:  # self-referential bindings (f = partial(f, ...))
        return None
    if isinstance(expr, ast.Lambda):
        return expr
    if isinstance(expr, ast.Call):
        dotted = module.dotted_name(expr.func)
        if (
            dotted is not None
            and dotted.rsplit(".", 1)[-1] == "partial"
            and expr.args
        ):
            return _resolve_function(module, expr.args[0], at, _depth + 1)
        return None
    if isinstance(expr, ast.Name):
        best = resolve_name_binding(module, expr.id, at)
        if best is None:
            return None
        if isinstance(best, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return best
        # Some assignment-like form binds the name: resolve its value
        # where one maps to the name directly, else give up — walking
        # outward would analyze a shadowed, never-traced binding (tuple
        # unpacking, for/with targets, bare annotations are all opaque).
        if isinstance(best, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == expr.id
            for t in best.targets
        ):
            return _resolve_function(module, best.value, at, _depth + 1)
        if (
            isinstance(best, (ast.AnnAssign, ast.NamedExpr))
            and best.value is not None
        ):
            return _resolve_function(module, best.value, at, _depth + 1)
        return None
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        cls = module.parent(at)
        while cls is not None and not isinstance(cls, ast.ClassDef):
            cls = module.parent(cls)
        if cls is not None:
            for node in cls.body:
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and node.name == expr.attr:
                    return node
    return None


def resolve_function_ex(
    module: ModuleInfo, expr: ast.AST, at: ast.AST, _depth: int = 0
) -> Optional[Tuple[ModuleInfo, ast.AST]]:
    """`_resolve_function` extended across module boundaries: when the
    expression names an import (directly, through `as`-alias chains, or
    re-exported by an `__init__.py`), the project symbol table maps it to
    the defining module's FunctionDef. Returns (defining_module, fn)."""
    fn = _resolve_function(module, expr, at)
    if fn is not None:
        return (module, fn)
    project = module.project
    if project is None or _depth > 8:
        return None
    if isinstance(expr, ast.Call):
        dotted = module.dotted_name(expr.func)
        if (
            dotted is not None
            and dotted.rsplit(".", 1)[-1] == "partial"
            and expr.args
        ):
            return resolve_function_ex(module, expr.args[0], at, _depth + 1)
        return None
    dotted = module.dotted_name(expr)
    if dotted is None:
        return None
    sym = project.resolve(dotted)
    if sym is not None and isinstance(
        sym.node, (ast.FunctionDef, ast.AsyncFunctionDef)
    ):
        return (sym.module, sym.node)
    return None


class Rule:
    id = "RTL000"
    name = "abstract"
    family = "meta"
    description = ""
    # `--explain` material: why the rule exists plus a minimal firing /
    # exempt snippet pair. The same snippets double as fixture tests
    # (tests/test_torch_lint.py parametrizes over them), so the CLI's examples
    # can never drift from what the rule actually flags.
    rationale = ""
    bad_example = ""
    good_example = ""

    def check(self, module: ModuleInfo) -> List[Finding]:
        raise NotImplementedError

    def finding(
        self, module: ModuleInfo, node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule=self.id,
            name=self.name,
            family=self.family,
            path=module.relpath,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            context=qualname_of(module, node),
            message=message,
        )


def all_rules() -> List[Rule]:
    from ray_tpu_torch.tools.lint import (  # noqa: PLC0415 — avoid import cycle
        rules_actors,
        rules_async,
        rules_locks,
        rules_resources,
        rules_shapes,
        rules_trace,
    )

    rules: List[Rule] = []
    for mod in (
        rules_async,
        rules_locks,
        rules_trace,
        rules_resources,
        rules_actors,
        rules_shapes,
    ):
        rules.extend(r() for r in mod.RULES)
    return rules


def iter_python_files(paths: Sequence[Path]) -> Iterable[Path]:
    # Overlapping scan paths (`lint ray_tpu_torch ray_tpu_torch/_private`) must not
    # yield a file twice: duplicate findings get occurrence-shifted
    # fingerprints that no longer match the baseline.
    seen = set()
    for path in paths:
        if path.is_file():
            if path.suffix == ".py" and path.resolve() not in seen:
                seen.add(path.resolve())
                yield path
            continue
        for sub in sorted(path.rglob("*.py")):
            # Only components BELOW the scan root count: a checkout that
            # happens to live under ~/.cache or a dir named `build` must
            # not make the whole scan vacuously clean.
            if any(part in SKIP_DIRS or part.startswith(".")
                   for part in sub.relative_to(path).parts):
                continue
            if sub.name.endswith(SKIP_FILE_SUFFIXES):
                continue
            resolved = sub.resolve()
            if resolved in seen:
                continue
            seen.add(resolved)
            yield sub


def find_repo_root(start: Path) -> Path:
    """Directory the baseline lives in: nearest ancestor (of the first
    scanned path) holding a pyproject.toml, else the CWD."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for candidate in (cur, *cur.parents):
        if (candidate / "pyproject.toml").exists():
            return candidate
    return Path.cwd()


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]  # active (not suppressed, not baselined)
    suppressed: List[Tuple[Finding, str]]  # (finding, reason)
    baselined: List[Tuple[Finding, str]]
    parse_errors: List[Finding]
    files_scanned: int
    duration_s: float
    stale_baseline: List[str] = dataclasses.field(default_factory=list)
    # Relpaths rules actually ran on. Equals every parsed file on a full
    # scan; a --changed scan parses everything (the project model needs
    # the whole tree) but checks only the diff closure — and baseline
    # bookkeeping (stale detection, --write-baseline drops) must scope
    # to THIS set, never to everything parsed.
    checked_relpaths: set = dataclasses.field(default_factory=set)


def _unused_suppression_findings(
    suppressions: Dict[int, List[Suppression]], relpath: str
) -> List[Finding]:
    """RTL003: a reasoned lint-ignore whose finding no longer fires is
    rot — the hazard was fixed (delete the comment) or the comment
    drifted off the flagged statement (it no longer protects anything).
    Only meaningful when the FULL rule registry ran: under --rule the
    other rules' suppressions legitimately match nothing."""
    out = []
    unique = {id(s): s for sups in suppressions.values() for s in sups}
    for sup in unique.values():
        if sup.reason and not sup.used:
            out.append(
                Finding(
                    rule="RTL003",
                    name="unused-suppression",
                    family="meta",
                    path=relpath,
                    line=sup.line,
                    col=0,
                    context="<module>",
                    message=(
                        "lint-ignore["
                        + ",".join(sorted(sup.ids))
                        + "] suppresses nothing; delete it or re-anchor "
                        "it to the flagged statement"
                    ),
                )
            )
    return out


def lint_paths(
    paths: Sequence[Path],
    rules: Optional[Sequence[Rule]] = None,
    rule_ids: Optional[Sequence[str]] = None,
    baseline: Optional[dict] = None,
    root: Optional[Path] = None,
    changed_only: Optional[Sequence[str]] = None,
) -> LintResult:
    """Scan `paths`. With `changed_only` (repo-relative posix paths of
    changed files), EVERYTHING is still parsed — the cross-module
    symbol table and call graph must see the whole scan — but rules run
    only on the changed files plus their reverse import dependents from
    the project model (`ray-tpu-torch lint --changed`)."""
    t0 = time.perf_counter()
    full_run = rules is None and not rule_ids
    rules = list(rules) if rules is not None else all_rules()
    if rule_ids:
        wanted = set(rule_ids)
        rules = [r for r in rules if r.id in wanted or r.name in wanted]
    root = root or find_repo_root(Path(paths[0]))
    baseline = baseline or {}

    raw: List[Finding] = []
    parse_errors: List[Finding] = []
    suppressions_by_file: Dict[str, Dict[int, List[Suppression]]] = {}
    lines_by_file: Dict[str, List[str]] = {}
    n_files = 0
    # Two phases: parse EVERYTHING first so the cross-module symbol table
    # / call graph sees the whole scan, then run rules per module (the
    # per-module memoization from the single-pass design still holds; the
    # project adds its own memo for cross-module derived structure).
    modules: List[ModuleInfo] = []
    for file in iter_python_files([Path(p) for p in paths]):
        n_files += 1
        try:
            relpath = file.resolve().relative_to(root).as_posix()
        except ValueError:
            relpath = file.as_posix()
        try:
            module = ModuleInfo(file, relpath, file.read_text())
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            parse_errors.append(
                Finding(
                    rule="RTL001",
                    name="parse-error",
                    family="meta",
                    path=relpath,
                    line=getattr(exc, "lineno", 0) or 0,
                    col=0,
                    context="<module>",
                    message=f"could not parse: {exc}",
                )
            )
            continue
        modules.append(module)

    from ray_tpu_torch.tools.lint.project import ProjectInfo  # noqa: PLC0415

    project = ProjectInfo(modules)
    if changed_only is None:
        checked = {m.relpath for m in modules}
    else:
        checked = project.reverse_import_closure(set(changed_only))
    for module in modules:
        lines_by_file[module.relpath] = module.lines
        # Suppressions classify by the FINDING's path, and a checked
        # module's cross-module rule may attribute a finding to an
        # unchecked defining module — so every parsed module's
        # suppressions stay available, while rules (and the meta
        # suppression findings) run only on the checked set.
        suppressions_by_file[module.relpath] = module.suppressions
        if module.relpath not in checked:
            continue
        raw.extend(module.suppression_findings())
        for rule in rules:
            raw.extend(rule.check(module))

    raw.sort(key=Finding.key)
    # Occurrence-stable fingerprints for findings that normalize to the
    # same source text within one scope.
    seen: Dict[tuple, int] = {}
    for f in raw:
        lines = lines_by_file.get(f.path, [])
        line_text = lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
        base = (f.rule, f.path, f.context, "".join(line_text.split()))
        occ = seen.get(base, 0)
        seen[base] = occ + 1
        f.fingerprint = _fingerprint(f.rule, f.path, f.context, line_text, occ)

    active: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    baselined: List[Tuple[Finding, str]] = []
    produced = set()
    for f in raw:
        produced.add(f.fingerprint)
        sup = _matching_suppression(
            suppressions_by_file.get(f.path, {}).get(f.line), f
        )
        if sup is not None:
            sup.used = True
            suppressed.append((f, sup.reason))
            continue
        if f.fingerprint in baseline:
            baselined.append((f, baseline[f.fingerprint].get("reason", "")))
            continue
        active.append(f)

    if full_run:
        # Orphaned suppressions are only knowable after every rule had
        # its chance to match them, so they classify here (baseline
        # honored; inline self-suppression would be circular, skipped).
        orphans: List[Finding] = []
        for relpath, sups in suppressions_by_file.items():
            if relpath not in checked:
                # An unchecked module's suppressions matched nothing
                # because its rules never ran, not because they rotted.
                continue
            orphans.extend(_unused_suppression_findings(sups, relpath))
        orphans.sort(key=Finding.key)
        for f in orphans:
            lines = lines_by_file.get(f.path, [])
            line_text = (
                lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
            )
            base = (f.rule, f.path, f.context, "".join(line_text.split()))
            occ = seen.get(base, 0)
            seen[base] = occ + 1
            f.fingerprint = _fingerprint(
                f.rule, f.path, f.context, line_text, occ
            )
            produced.add(f.fingerprint)
            if f.fingerprint in baseline:
                baselined.append(
                    (f, baseline[f.fingerprint].get("reason", ""))
                )
            else:
                active.append(f)
        active.sort(key=Finding.key)

    # Stale = the scan COULD have re-produced the entry (its file was
    # CHECKED with its rule active) and did not. A path-, rule- or
    # diff-scoped run must not report the rest of the baseline as
    # stale. The meta findings are producible too: RTL002 on every run,
    # RTL003 only when the full registry ran.
    scanned_rule_ids = {r.id for r in rules} | {"RTL002"}
    if full_run:
        scanned_rule_ids.add("RTL003")
    stale = [
        fp for fp, entry in baseline.items()
        if fp not in produced
        and entry.get("rule") in scanned_rule_ids
        and entry.get("path") in checked
    ]
    return LintResult(
        findings=active,
        suppressed=suppressed,
        baselined=baselined,
        parse_errors=parse_errors,
        files_scanned=n_files,
        duration_s=time.perf_counter() - t0,
        stale_baseline=stale,
        checked_relpaths=checked,
    )


def lint_source(
    source: str,
    rules: Optional[Sequence[Rule]] = None,
    relpath: str = "snippet.py",
) -> List[Finding]:
    """Run rules on an in-memory snippet (test harness entry point);
    returns ALL findings, honoring inline suppressions but no baseline."""
    return lint_sources({relpath: source}, rules=rules)


def lint_sources(
    sources: Dict[str, str],
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Run rules on a dict of in-memory modules {relpath: source} — the
    multi-file test harness for cross-module rules. All modules join one
    ProjectInfo (symbol table / call graph / actor index span the dict);
    findings from every module come back in one sorted list."""
    from ray_tpu_torch.tools.lint.project import ProjectInfo  # noqa: PLC0415

    modules = [
        ModuleInfo(Path(relpath), relpath, source)
        for relpath, source in sources.items()
    ]
    ProjectInfo(modules)
    full_run = rules is None
    rules = list(rules) if rules is not None else all_rules()
    raw: List[Finding] = []
    for module in modules:
        raw.extend(module.suppression_findings())
        for rule in rules:
            raw.extend(rule.check(module))
    raw.sort(key=Finding.key)
    # A cross-module rule can attribute a finding to the DEFINING module
    # while checking the importing one — classify suppressions by the
    # finding's own path, exactly as lint_paths does.
    sups_by_path = {m.relpath: m.suppressions for m in modules}
    out: List[Finding] = []
    for f in raw:
        sup = _matching_suppression(
            sups_by_path.get(f.path, {}).get(f.line), f
        )
        if sup is not None:
            sup.used = True
            continue
        out.append(f)
    if full_run:
        for module in modules:
            out.extend(
                _unused_suppression_findings(
                    module.suppressions, module.relpath
                )
            )
        out.sort(key=Finding.key)
    return out
