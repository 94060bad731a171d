"""A small abstract evaluator for RTL804 (paired int8 pools) on torch.

It models exactly what the pool/scale pairing needs and nothing else:

  * tuples and lists of dims, their slices (`cache_shape[:-1]`) and
    indexing; an int literal is a known dim, any other element a symbol
    named by its source text (equal only to itself);
  * dtypes spelled `torch.<dtype>` (`torch.int8`, `torch.bfloat16`, ...);
  * module constants and their cross-module imports (`KV_SCALE_DTYPE`
    defined in one module, imported into another), through the project
    symbol table;
  * `torch.zeros | empty | ones | full(shape, dtype=...)`, giving an
    `AbstractArray(shape, dtype)`;
  * a lambda bound in the same scope whose body is one such call
    (`zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, ...)`),
    evaluated at its call with the call's arguments.

Anything else is TOP: unknown, never a fact. A branch that binds a name
two different ways joins it to TOP. The rule built on it fires only on a
contradiction between two known facts, so an unmodelled form keeps it
silent — the same contract as the reference analyzer's interpreter,
which models JAX programs instead.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.tools.lint.core import ModuleInfo, _module_scope_bindings


class _Top:
    """The unknown value (one instance, TOP)."""

    def __repr__(self) -> str:
        return "TOP"


TOP = _Top()


@dataclasses.dataclass(frozen=True)
class Sym:
    """A dim whose value is unknown, named by its source text."""

    text: str

    def __repr__(self) -> str:
        return self.text


@dataclasses.dataclass(frozen=True)
class AbstractArray:
    shape: object  # tuple of int | Sym, or TOP
    dtype: object  # dtype name, or TOP


@dataclasses.dataclass(eq=False)
class FuncVal:
    """A lambda with the environment it closes over (equal only to
    itself, so a name bound to two lambdas joins to TOP)."""

    node: ast.Lambda
    env: Dict[str, object]


DTYPE_NAMES = {
    "int8": "int8", "uint8": "uint8", "int16": "int16", "short": "int16",
    "int32": "int32", "int": "int32", "int64": "int64", "long": "int64",
    "bool": "bool", "float16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "float32": "float32", "float": "float32",
    "float64": "float64", "double": "float64",
    "float8_e4m3fn": "float8_e4m3fn", "float8_e5m2": "float8_e5m2",
}
FLOAT_DTYPES = {
    "float16", "bfloat16", "float32", "float64", "float8_e4m3fn",
    "float8_e5m2",
}
ARRAY_CTORS = {"torch.zeros", "torch.empty", "torch.ones", "torch.full"}

_MAX_DEPTH = 8


def dims_equal(a, b) -> Optional[bool]:
    """True / False when provable, None when unknown. Only two int dims
    can differ provably; a symbol equals only itself."""
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    if a == b:
        return True
    return None


def join(a, b):
    return a if a == b else TOP


def join_envs(a: Dict[str, object], b: Dict[str, object]) -> Dict[str, object]:
    return {k: join(a.get(k, TOP), b.get(k, TOP)) for k in set(a) | set(b)}


def _as_shape(value):
    if isinstance(value, tuple):
        return value
    if isinstance(value, int) and not isinstance(value, bool):
        return (value,)
    return TOP


def _dim_of(value, node: ast.AST):
    if isinstance(value, (int, Sym)) and not isinstance(value, bool):
        return value
    return Sym(ast.unparse(node))


def target_key(t: ast.AST) -> Optional[str]:
    """Env key of an assignment target: `x` or `self.x`."""
    if isinstance(t, ast.Name):
        return t.id
    if (
        isinstance(t, ast.Attribute)
        and isinstance(t.value, ast.Name)
        and t.value.id == "self"
    ):
        return f"self.{t.attr}"
    return None


class Evaluator:
    """Evaluates one function body in order. `on_assign(stmt, key,
    value)` sees every binding of a name or `self.` attribute as it is
    made (before any branch join)."""

    def __init__(
        self,
        module: ModuleInfo,
        on_assign: Optional[Callable[[ast.AST, str, object], None]] = None,
    ):
        self.module = module
        self.on_assign = on_assign

    # -- expressions --------------------------------------------------------

    def eval(self, expr: ast.AST, env: Dict[str, object], module=None,
             depth: int = 0):
        module = module or self.module
        if depth > _MAX_DEPTH or expr is None:
            return TOP
        if isinstance(expr, ast.Constant):
            v = expr.value
            if isinstance(v, int) and not isinstance(v, bool):
                return v
            return TOP
        if isinstance(expr, ast.UnaryOp) and isinstance(
            expr.op, ast.USub
        ) and isinstance(expr.operand, ast.Constant):
            v = expr.operand.value
            if isinstance(v, int) and not isinstance(v, bool):
                return -v
            return TOP
        if isinstance(expr, (ast.Tuple, ast.List)):
            if any(isinstance(el, ast.Starred) for el in expr.elts):
                return TOP
            return tuple(
                _dim_of(self.eval(el, env, module, depth + 1), el)
                for el in expr.elts
            )
        if isinstance(expr, ast.Name):
            if expr.id in env:
                return env[expr.id]
            return self._global(module, expr, depth)
        if isinstance(expr, ast.Attribute):
            key = target_key(expr)
            if key is not None and key in env:
                return env[key]
            dotted = module.dotted_name(expr)
            if dotted and dotted.startswith("torch."):
                return DTYPE_NAMES.get(dotted[len("torch."):], TOP)
            return self._global(module, expr, depth)
        if isinstance(expr, ast.Subscript):
            return self._subscript(expr, env, module, depth)
        if isinstance(expr, ast.IfExp):
            return join(
                self.eval(expr.body, env, module, depth + 1),
                self.eval(expr.orelse, env, module, depth + 1),
            )
        if isinstance(expr, ast.Lambda):
            return FuncVal(expr, dict(env))
        if isinstance(expr, ast.Call):
            return self._call(expr, env, module, depth)
        return TOP

    def _global(self, module: ModuleInfo, expr: ast.AST, depth: int):
        """A module-level constant of this module, or one reached through
        an import (alias chains and re-exports via the project)."""
        if isinstance(expr, ast.Name):
            bind = _module_scope_bindings(module).get(expr.id)
            if isinstance(bind, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == expr.id
                for t in bind.targets
            ):
                return self.eval(bind.value, {}, module, depth + 1)
            if bind is not None:
                return TOP
        project = module.project
        if project is None:
            return TOP
        dotted = module.dotted_name(expr)
        sym = project.resolve(dotted) if dotted else None
        if sym is not None and isinstance(sym.node, ast.Assign):
            return self.eval(sym.node.value, {}, sym.module, depth + 1)
        return TOP

    def _subscript(self, expr: ast.Subscript, env, module, depth):
        base = self.eval(expr.value, env, module, depth + 1)
        if not isinstance(base, tuple):
            return TOP
        sl = expr.slice
        if isinstance(sl, ast.Slice):
            parts = []
            for bound in (sl.lower, sl.upper, sl.step):
                if bound is None:
                    parts.append(None)
                    continue
                v = self.eval(bound, env, module, depth + 1)
                if not isinstance(v, int):
                    return TOP
                parts.append(v)
            return base[slice(*parts)]
        v = self.eval(sl, env, module, depth + 1)
        if isinstance(v, int) and -len(base) <= v < len(base):
            return base[v]
        return TOP

    def _call(self, call: ast.Call, env, module, depth):
        dotted = module.dotted_name(call.func)
        if dotted in ARRAY_CTORS:
            return self._array_ctor(dotted, call, env, module, depth)
        if isinstance(call.func, ast.Name):
            fn = env.get(call.func.id)
            if isinstance(fn, FuncVal):
                return self._apply(fn, call, env, module, depth)
        return TOP

    def _array_ctor(self, dotted, call, env, module, depth):
        kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}
        if any(kw.arg is None for kw in call.keywords):
            return TOP
        args = list(call.args)
        if any(isinstance(a, ast.Starred) for a in args):
            return TOP
        if dotted == "torch.full":
            shape = self.eval(args[0], env, module, depth + 1) if args else (
                self.eval(kwargs["size"], env, module, depth + 1)
                if "size" in kwargs else TOP
            )
        elif len(args) == 1:
            shape = self.eval(args[0], env, module, depth + 1)
        elif args:
            shape = tuple(
                _dim_of(self.eval(a, env, module, depth + 1), a) for a in args
            )
        elif "size" in kwargs:
            shape = self.eval(kwargs["size"], env, module, depth + 1)
        else:
            shape = TOP
        dtype = (
            self.eval(kwargs["dtype"], env, module, depth + 1)
            if "dtype" in kwargs else TOP
        )
        if not isinstance(dtype, str):
            dtype = TOP
        return AbstractArray(_as_shape(shape), dtype)

    def _apply(self, fn: FuncVal, call: ast.Call, env, module, depth):
        a = fn.node.args
        if a.vararg or a.kwarg or a.kwonlyargs or a.posonlyargs or a.defaults:
            return TOP
        params = [p.arg for p in a.args]
        if len(call.args) > len(params) or any(
            isinstance(x, ast.Starred) for x in call.args
        ):
            return TOP
        inner = dict(fn.env)
        bound = {}
        for name, arg in zip(params, call.args):
            bound[name] = self.eval(arg, env, module, depth + 1)
        for kw in call.keywords:
            if kw.arg is None or kw.arg not in params or kw.arg in bound:
                return TOP
            bound[kw.arg] = self.eval(kw.value, env, module, depth + 1)
        if set(bound) != set(params):
            return TOP
        inner.update(bound)
        return self.eval(fn.node.body, inner, module, depth + 1)

    # -- statements ---------------------------------------------------------

    def run(self, fn: ast.AST) -> Dict[str, object]:
        """Evaluate `fn`'s body from an environment where every parameter
        is unknown; returns the environment at its end."""
        env: Dict[str, object] = {}
        args = fn.args
        for p in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            env[p.arg] = TOP
        for p in (args.vararg, args.kwarg):
            if p is not None:
                env[p.arg] = TOP
        self._block(fn.body, env)
        return env

    def _bind(self, stmt, target: ast.AST, value, env) -> None:
        key = target_key(target)
        if key is not None:
            env[key] = value
            if self.on_assign is not None:
                self.on_assign(stmt, key, value)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, tuple) and len(value) == len(target.elts) \
                    and not any(isinstance(e, ast.Starred) for e in target.elts):
                for el, v in zip(target.elts, value):
                    self._bind(stmt, el, v, env)
                return
            for el in target.elts:
                self._bind(stmt, el.value if isinstance(el, ast.Starred) else el,
                           TOP, env)

    def _block(self, body: List[ast.stmt], env: Dict[str, object]) -> None:
        for stmt in body:
            self._stmt(stmt, env)

    def _replace(self, env, new) -> None:
        env.clear()
        env.update(new)

    def _stmt(self, stmt: ast.stmt, env: Dict[str, object]) -> None:
        # A walrus in the statement's own expressions binds in this scope.
        for _, field in ast.iter_fields(stmt):
            for expr in field if isinstance(field, list) else [field]:
                if isinstance(expr, ast.expr):
                    for node in ast.walk(expr):
                        if isinstance(node, ast.NamedExpr):
                            env[node.target.id] = TOP
        if isinstance(stmt, ast.Assign):
            value = self.eval(stmt.value, env)
            for t in stmt.targets:
                self._bind(stmt, t, value, env)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt, stmt.target, self.eval(stmt.value, env), env)
        elif isinstance(stmt, ast.AugAssign):
            key = target_key(stmt.target)
            if key is not None:
                env[key] = TOP
        elif isinstance(stmt, ast.If):
            a, b = dict(env), dict(env)
            self._block(stmt.body, a)
            self._block(stmt.orelse, b)
            self._replace(env, join_envs(a, b))
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            loop = dict(env)
            if not isinstance(stmt, ast.While):
                self._bind(stmt, stmt.target, TOP, loop)
            self._block(stmt.body, loop)
            merged = join_envs(env, loop)
            self._block(stmt.orelse, merged)
            self._replace(env, merged)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    self._bind(stmt, item.optional_vars, TOP, env)
            self._block(stmt.body, env)
        elif isinstance(stmt, ast.Try) or type(stmt).__name__ == "TryStar":
            body = dict(env)
            self._block(stmt.body, body)
            self._block(stmt.orelse, body)
            merged = join_envs(env, body)
            for handler in stmt.handlers:
                h = dict(merged)
                if handler.name:
                    h[handler.name] = TOP
                self._block(handler.body, h)
                merged = join_envs(merged, h)
            merged = join_envs(merged, body)
            self._block(stmt.finalbody, merged)
            self._replace(env, merged)
        elif isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            env[stmt.name] = TOP
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for a in stmt.names:
                env[a.asname or a.name.split(".")[0]] = TOP
        else:
            # Anything else that binds (del, match, walrus inside an
            # expression statement) makes those names unknown.
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    env[node.id] = TOP
                elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    key = target_key(node)
                    if key is not None:
                        env[key] = TOP
