"""Family 7 — actor call-graph deadlock rules.

Actors in this runtime execute one task at a time unless deployed with
`max_concurrency`/async methods. A method that BLOCKS on the result of a
task that can only run on an actor that is (transitively) waiting on the
caller never completes — the classic distributed deadlock. Because the
layering rule keeps all distribution in actors + collectives (PAPER.md
§1), the hazard is a static property of the actor call graph, which the
project-level pass can build:

RTL701: a blocking `ray_tpu_torch.get` inside an actor method on a ref whose
producing task targets the SAME actor class — the self-cycle. The
producing task queues behind the very method that is waiting for it.

RTL702: synchronous cross-actor call cycles (A.m gets B.n, B.n gets
A.p). Detected as strongly-connected components of the blocking-call
graph between actor classes; every blocking edge inside a cycle is
flagged. Handles resolve through class-wide `self._x = Cls.remote()`
assignments, method-local bindings, `ray_tpu_torch.remote(Cls)` registrations
(aliased imports included), and `functools.partial`-bound remote
methods; an unresolvable handle contributes no edge (conservative).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.lint.core import (
    Finding,
    ModuleInfo,
    Rule,
    _scope_level_nodes,
    resolve_name_binding,
)
from ray_tpu_torch.tools.lint.project import qualkey

GET_TARGETS = ("ray_tpu_torch.get", "ray_tpu_torch.api.get")


@dataclasses.dataclass
class Edge:
    src: Tuple[str, str]  # actor class qualkey
    dst: Tuple[str, str]
    module: ModuleInfo  # module holding the get call
    node: ast.AST  # the blocking get
    src_method: str
    dst_method: str


def _is_remote_task_call(expr: ast.AST) -> bool:
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "remote"
    )


def _blocking_gets(
    index, module: ModuleInfo, attr_handles, fn: ast.AST
):
    """(get_call, resolved (dst_key, dst_method)) pairs in one function."""
    for call in _scope_level_nodes(fn):
        if not isinstance(call, ast.Call):
            continue
        if module.dotted_name(call.func) not in GET_TARGETS:
            continue
        if not call.args:
            continue
        for target in _ref_targets(
            index, module, attr_handles, call.args[0], call
        ):
            yield call, target


def _actor_edges(project) -> List[Edge]:
    """All blocking-get edges between actor classes, project-wide.

    Edges come from two places: blocking gets written directly in an
    actor's (sync) methods, and blocking gets in plain functions those
    methods REACH through the project call graph — the actor-method
    reachability index. A helper that resolves a task to an actor class
    contributes the edge to every actor whose methods can reach it."""
    cached = project.memo.get("actor_edges")
    if cached is not None:
        return cached
    index = project.actor_index()
    if not index.classes:
        # No actor classes anywhere in the scan: no edges, and the
        # (expensive) project call graph need not be built at all —
        # this keeps diff-scoped runs over actor-free modules fast.
        project.memo["actor_edges"] = []
        return []
    graph = project.call_graph()
    fn_index = project.function_index()
    method_owner = {}  # method qualkey -> actor class key
    for key, (module, cls) in index.classes.items():
        for m in cls.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                method_owner[qualkey(module, m)] = key
    edges: List[Edge] = []
    for key, (module, cls) in index.classes.items():
        attr_handles = _class_attr_handles(index, module, cls)
        reached: List[Tuple[Tuple[str, str], str]] = []
        seen = set()
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef):
                continue  # async methods don't hard-block the actor loop
            for call, target in _blocking_gets(
                index, module, attr_handles, method
            ):
                dst_key, dst_method = target
                edges.append(
                    Edge(
                        src=key, dst=dst_key, module=module, node=call,
                        src_method=method.name, dst_method=dst_method,
                    )
                )
            mk = qualkey(module, method)
            seen.add(mk)
            reached.append((mk, method.name))
        # BFS over the call graph: helpers this actor's methods reach run
        # ON the actor, so their blocking gets block the actor loop too.
        frontier = list(reached)
        while frontier:
            k, via = frontier.pop()
            for callee in sorted(graph.get(k, ())):
                if callee in seen:
                    continue
                seen.add(callee)
                if callee in method_owner:
                    continue  # another actor's method: scanned there
                entry = fn_index.get(callee)
                if entry is None:
                    continue
                hmod, hfn = entry
                if isinstance(hfn, ast.AsyncFunctionDef):
                    continue
                # Handle inference inside a free helper sees its own
                # local bindings + module registrations, never this
                # actor's self attrs (the helper has no self).
                for call, target in _blocking_gets(index, hmod, {}, hfn):
                    dst_key, dst_method = target
                    edges.append(
                        Edge(
                            src=key, dst=dst_key, module=hmod, node=call,
                            src_method=f"{via} (via {callee[1]})",
                            dst_method=dst_method,
                        )
                    )
                frontier.append((callee, via))
    project.memo["actor_edges"] = edges
    return edges


def _class_attr_handles(
    index, module: ModuleInfo, cls: ast.ClassDef
) -> Dict[str, Tuple[str, str]]:
    """self attrs holding a handle whose actor class is provable."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        key = None
        if _is_remote_task_call(node.value) or isinstance(
            node.value, ast.Call
        ):
            key = index.handle_class(module, node.value, node)
        if key is None:
            continue
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                out[t.attr] = key
    return out


def _ref_targets(
    index,
    module: ModuleInfo,
    attr_handles: Dict[str, Tuple[str, str]],
    expr: ast.AST,
    at: ast.AST,
) -> List[Tuple[Tuple[str, str], str]]:
    """(actor class, method name) for every resolvable actor-task ref in
    a get argument (single ref, list of refs, name bound earlier,
    partial-bound remote method)."""
    out: List[Tuple[Tuple[str, str], str]] = []
    for node in ast.walk(expr):
        resolved = _resolve_ref_value(
            index, module, attr_handles, node, at
        )
        if resolved is not None:
            out.append(resolved)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            bind = resolve_name_binding(module, node.id, at)
            if isinstance(bind, ast.Assign):
                resolved = _resolve_ref_value(
                    index, module, attr_handles, bind.value, bind
                )
                if resolved is not None:
                    out.append(resolved)
    return out


def _resolve_ref_value(
    index,
    module: ModuleInfo,
    attr_handles: Dict[str, Tuple[str, str]],
    value: ast.AST,
    at: ast.AST,
    _depth: int = 0,
) -> Optional[Tuple[Tuple[str, str], str]]:
    """A ref-producing expression: a direct `<handle>.<m>.remote(...)`,
    a call of a name bound to one, or a call of a `functools.partial`-
    bound remote method (`fire = partial(h.m.remote, x); fire()`)."""
    if _depth > 4:
        return None
    resolved = _task_target(index, module, attr_handles, value, at)
    if resolved is not None:
        return resolved
    if not isinstance(value, ast.Call):
        return None
    dotted = module.dotted_name(value.func) or ""
    if dotted.rsplit(".", 1)[-1] == "partial" and value.args:
        return _resolve_ref_value(
            index,
            module,
            attr_handles,
            ast.Call(func=value.args[0], args=[], keywords=[]),
            at,
            _depth + 1,
        )
    if isinstance(value.func, ast.Name):
        bind = resolve_name_binding(module, value.func.id, at)
        if isinstance(bind, ast.Assign):
            # Calling a name bound to a partial invokes the partial's
            # underlying remote method.
            return _resolve_ref_value(
                index, module, attr_handles, bind.value, bind, _depth + 1
            )
    return None


def _task_target(
    index,
    module: ModuleInfo,
    attr_handles: Dict[str, Tuple[str, str]],
    node: ast.AST,
    at: ast.AST,
) -> Optional[Tuple[Tuple[str, str], str]]:
    """`<handle>.<method>.remote(...)` -> (actor class, method)."""
    if not _is_remote_task_call(node):
        return None
    base = node.func.value
    if isinstance(node.func, ast.Attribute) and isinstance(
        base, ast.Attribute
    ):
        method_name = base.attr
        handle = base.value
        key = None
        if (
            isinstance(handle, ast.Attribute)
            and isinstance(handle.value, ast.Name)
            and handle.value.id == "self"
        ):
            key = attr_handles.get(handle.attr)
        elif isinstance(handle, ast.Name):
            bind = resolve_name_binding(module, handle.id, at)
            if isinstance(bind, ast.Assign):
                key = index.handle_class(module, bind.value, bind)
            elif bind is None:
                # Only an UNBOUND name may fall back to the registration
                # map; a local binding we couldn't resolve shadows any
                # module-level registration of the same name.
                key = index.registered.get((module.relpath, handle.id))
        if key is not None:
            return (key, method_name)
    return None


def _sccs(graph: Dict[Tuple, Set[Tuple]]) -> List[Set[Tuple]]:
    """Tarjan strongly-connected components (iterative)."""
    idx: Dict[Tuple, int] = {}
    low: Dict[Tuple, int] = {}
    on_stack: Set[Tuple] = set()
    stack: List[Tuple] = []
    out: List[Set[Tuple]] = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(graph.get(v, ()))))]
        idx[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == idx[node]:
                comp = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)

    nodes = set(graph) | {w for vs in graph.values() for w in vs}
    for v in sorted(nodes):
        if v not in idx:
            strongconnect(v)
    return out


class SameActorBlockingGetRule(Rule):
    id = "RTL701"
    name = "same-actor-blocking-get"
    family = "actors"
    description = (
        "blocking ray_tpu_torch.get inside an actor method on a task of the "
        "same actor — the producing task queues behind the waiter"
    )
    rationale = (
        "an actor executes one task at a time: a method that blocks on "
        "ray_tpu_torch.get of a task targeting its own actor waits for work "
        "that can only start after the method returns. The get never "
        "completes (or burns the full timeout). Make the method async "
        "and await the ref, return the ref to the caller, or route the "
        "work through a different actor."
    )
    bad_example = """
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class Coordinator:
            def __init__(self):
                self._self_handle = None

            def register(self, handle):
                self._self_handle = Coordinator.remote()

            def run(self, x):
                ref = self._self_handle.helper.remote(x)
                return ray_tpu_torch.get(ref)  # queues behind run() itself

            def helper(self, x):
                return x + 1
    """
    good_example = """
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class Coordinator:
            def helper(self, x):
                return x + 1

            def run(self, x):
                return self.helper(x)  # plain call, same process
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        if module.project is None:
            return []
        out: List[Finding] = []
        seen_nodes: set = set()  # a shared helper flags once, not per actor
        for edge in _actor_edges(module.project):
            if edge.module is not module or edge.src != edge.dst:
                continue
            if id(edge.node) in seen_nodes:
                continue
            seen_nodes.add(id(edge.node))
            out.append(
                self.finding(
                    module,
                    edge.node,
                    f"blocking ray_tpu_torch.get on `{edge.dst_method}` of the "
                    f"same actor class {edge.src[1]} — the task queues "
                    f"behind `{edge.src_method}` and the get never "
                    "returns; await it, return the ref, or call the "
                    "method directly",
                )
            )
        return out


class CrossActorCallCycleRule(Rule):
    id = "RTL702"
    name = "cross-actor-call-cycle"
    family = "actors"
    description = (
        "synchronous cross-actor call cycle (A blocks on B while B "
        "blocks on A) — distributed deadlock"
    )
    rationale = (
        "two single-threaded actors that synchronously ray_tpu_torch.get each "
        "other's tasks deadlock the moment the calls overlap: each actor "
        "is busy waiting, so neither can serve the other's request. The "
        "cycle is detected on the blocking-call graph between actor "
        "classes (strongly-connected components); break it by making one "
        "leg async, returning refs instead of resolving them, or "
        "restructuring so dependencies flow one way."
    )
    bad_example = """
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class Alpha:
            def __init__(self, beta):
                self._beta = Beta.remote()

            def ping(self, x):
                return ray_tpu_torch.get(self._beta.pong.remote(x))

            def poke(self, x):
                return x

        @ray_tpu_torch.remote
        class Beta:
            def __init__(self):
                self._alpha = Alpha.remote(None)

            def pong(self, x):
                return ray_tpu_torch.get(self._alpha.poke.remote(x))
    """
    good_example = """
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class Alpha:
            def __init__(self):
                self._beta = Beta.remote()

            def ping(self, x):
                return ray_tpu_torch.get(self._beta.pong.remote(x))

        @ray_tpu_torch.remote
        class Beta:
            def pong(self, x):
                return x + 1  # leaf actor: dependencies flow one way
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        if module.project is None:
            return []
        edges = _actor_edges(module.project)
        graph: Dict[Tuple, Set[Tuple]] = {}
        for e in edges:
            if e.src != e.dst:  # self-cycles are RTL701's
                graph.setdefault(e.src, set()).add(e.dst)
        comp_of: Dict[Tuple, int] = {}
        for i, comp in enumerate(_sccs(graph)):
            if len(comp) > 1:
                for node in comp:
                    comp_of[node] = i
        out: List[Finding] = []
        seen_nodes: set = set()  # a shared helper flags once, not per actor
        for e in edges:
            if e.module is not module or e.src == e.dst:
                continue
            if id(e.node) in seen_nodes:
                continue
            if e.src in comp_of and comp_of.get(e.dst) == comp_of[e.src]:
                seen_nodes.add(id(e.node))
                out.append(
                    self.finding(
                        module,
                        e.node,
                        f"synchronous call cycle between actor classes "
                        f"{e.src[1]} and {e.dst[1]}: `{e.src_method}` "
                        f"blocks on `{e.dst_method}` while the reverse "
                        "leg blocks back — overlapping calls deadlock "
                        "both actors; make one leg async or return the "
                        "ref",
                    )
                )
        return out


RULES = [SameActorBlockingGetRule, CrossActorCallCycleRule]
