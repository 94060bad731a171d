"""Family 8 — paired int8 pools (RTL804), on torch.

RTL804 paired-pool-geometry — an int8 K/V pool stores per-token
per-head scales in a mirror pool, paired by name (`X_cache` / `X_pool`
with `X_scale`, locals or `self.` attributes alike). Three checks:

  * geometry: the scale pool's shape is the pool's `shape[:-1]` (it
    drops exactly the trailing head_dim axis);
  * dtype: the scale pool is a float dtype (an int dtype truncates every
    scale);
  * flow: a function that owns both names — parameters, its own
    bindings, or (in a method) attributes its class assigns — and writes
    the pool but never the scales. Writes are `X[...] = ...`,
    `X.index_put_`, `X.index_copy_`, `X.copy_` and the same three on
    `X[...]`. A value written without its scale reads back at the wrong
    magnitude.

The first two run the shapes.py evaluator over every top-level function
and method that binds a `*_scale` name; its TOP keeps them silent on
anything it does not model. The reference analyzer's other rules of the
family judge jitted programs (RTL801, RTL802, RTL805) and meshes
(RTL803); they are not ported (see `NOT_PORTED` in `__init__.py`).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.lint.core import Finding, ModuleInfo, Rule
from ray_tpu_torch.tools.lint.shapes import (
    TOP,
    AbstractArray,
    Evaluator,
    FLOAT_DTYPES,
    dims_equal,
)

_POOL_SUFFIXES = ("_cache", "_pool")
_WRITE_METHODS = ("index_put_", "index_copy_", "copy_")


def _name_of(t: ast.AST) -> Optional[str]:
    """`X` for a Name or a `self.X` attribute."""
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute) and isinstance(
        t.value, ast.Name
    ) and t.value.id == "self":
        return t.attr
    return None


def _root_name(expr: ast.AST) -> Optional[str]:
    """`X` for `X`, `self.X`, or any subscript of them (`X[i][j]`)."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    return _name_of(expr)


def _top_level_functions(module: ModuleInfo):
    """Functions and methods not nested in another function: a nested
    def's free names belong to a scope the evaluator does not run."""
    for fn in module.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
        cur = module.parent(fn)
        while isinstance(cur, ast.ClassDef):
            cur = module.parent(cur)
        if isinstance(cur, ast.Module):
            yield fn


def _enclosing_class(module: ModuleInfo, fn) -> Optional[ast.ClassDef]:
    parent = module.parent(fn)
    return parent if isinstance(parent, ast.ClassDef) else None


def _class_attrs(module: ModuleInfo, cls: ast.ClassDef) -> Set[str]:
    """Attributes any method of `cls` assigns (`self.X = ...`)."""
    memo = module.memo.setdefault("rtl804_class_attrs", {})
    cached = memo.get(id(cls))
    if cached is not None:
        return cached
    out: Set[str] = set()
    for node in ast.walk(cls):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Attribute) and isinstance(
                    sub.ctx, ast.Store
                ):
                    name = _name_of(sub)
                    if name is not None:
                        out.add(name)
    memo[id(cls)] = out
    return out


def _binds_scale(fn) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for sub in ast.walk(t):
                    name = _name_of(sub)
                    if name is not None and name.endswith("_scale"):
                        return True
    return False


def _unambiguous(records: List[Tuple[ast.AST, object]]):
    """The one array a name is bound to, when its array bindings agree
    (a branch binding None beside it, the bf16 arm, is no ambiguity);
    with the statement that bound it."""
    arrays = [(stmt, v) for stmt, v in records if isinstance(v, AbstractArray)]
    if len({v for _, v in arrays}) == 1:
        return arrays[0]
    return None


def _check_pairs(module: ModuleInfo, fn, out: List) -> None:
    records: Dict[str, List[Tuple[ast.AST, object]]] = {}

    def on_assign(stmt, key, value):
        name = key[len("self."):] if key.startswith("self.") else key
        if name.endswith(("_scale",) + _POOL_SUFFIXES):
            records.setdefault(name, []).append((stmt, value))

    Evaluator(module, on_assign).run(fn)
    for sname in sorted(records):
        if not sname.endswith("_scale"):
            continue
        scale = _unambiguous(records[sname])
        if scale is None:
            continue
        node, sval = scale
        base = sname[: -len("_scale")]
        for suffix in _POOL_SUFFIXES:
            pname = base + suffix
            pool = _unambiguous(records.get(pname, []))
            if pool is None:
                continue
            pval = pool[1]
            if (
                sval.dtype is not TOP
                and sval.dtype not in FLOAT_DTYPES
                and pval.dtype not in FLOAT_DTYPES
            ):
                out.append((
                    node,
                    f"pool {pname} pairs with scale pool {sname} of dtype "
                    f"{sval.dtype}; dequant scales must be a float dtype",
                ))
            if not (isinstance(pval.shape, tuple)
                    and isinstance(sval.shape, tuple)):
                continue
            if len(sval.shape) != len(pval.shape) - 1:
                out.append((
                    node,
                    f"scale pool {sname} is rank {len(sval.shape)} but the "
                    f"paired pool {pname} is rank {len(pval.shape)}: "
                    "per-token scales must drop exactly the trailing "
                    "(head_dim) axis — pool.shape[:-1]",
                ))
                continue
            for i, (a, b) in enumerate(zip(sval.shape, pval.shape[:-1])):
                if dims_equal(a, b) is False:
                    out.append((
                        node,
                        f"scale pool {sname} dim {i} is {a!r} but the "
                        f"paired pool {pname} has {b!r} there; scales "
                        "must mirror pool.shape[:-1] exactly",
                    ))


def _write_of(node: ast.AST) -> Optional[str]:
    """The pool name a statement-level node writes in place, if any."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                return _root_name(t)
        return None
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _WRITE_METHODS
    ):
        return _root_name(node.func.value)
    return None


def _check_writes(module: ModuleInfo, fn, out: List) -> None:
    a = fn.args
    owned = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    cls = _enclosing_class(module, fn)
    if cls is not None:
        owned |= _class_attrs(module, cls)
    writes: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                name = _name_of(t)
                if name is not None:
                    owned.add(name)
        name = _write_of(node)
        if name is not None:
            writes.setdefault(name, node)
    for sname in sorted(owned):
        if not sname.endswith("_scale"):
            continue
        base = sname[: -len("_scale")]
        for suffix in _POOL_SUFFIXES:
            pname = base + suffix
            if pname in owned and pname in writes and sname not in writes:
                out.append((
                    writes[pname],
                    f"{pname} is written here but its paired scale pool "
                    f"{sname} is never updated in {fn.name} — a value "
                    "written without its scale is read back at the wrong "
                    "magnitude (block copies must move scales with values)",
                ))


def _mentions_scale(module: ModuleInfo) -> bool:
    """Whether any name, attribute or parameter of the module ends in
    `_scale`: without one there is no pair to check."""
    return any(
        n.id.endswith("_scale") for n in module.nodes(ast.Name)
    ) or any(
        n.attr.endswith("_scale") for n in module.nodes(ast.Attribute)
    ) or any(n.arg.endswith("_scale") for n in module.nodes(ast.arg))


def pool_findings(module: ModuleInfo) -> List[Tuple[ast.AST, str]]:
    cached = module.memo.get("rtl804")
    if cached is not None:
        return cached
    out: List[Tuple[ast.AST, str]] = []
    if not _mentions_scale(module):
        module.memo["rtl804"] = out
        return out
    for fn in _top_level_functions(module):
        if _binds_scale(fn):
            _check_pairs(module, fn, out)
        _check_writes(module, fn, out)
    module.memo["rtl804"] = out
    return out


class PairedPoolGeometryRule(Rule):
    id = "RTL804"
    name = "paired-pool-geometry"
    family = "shapes"
    description = (
        "int8 K/V pool whose scale pool breaks the pool.shape[:-1] law, "
        "is not float, or is skipped on a pool write"
    )
    rationale = (
        "int8 pools store per-token per-head scales in a mirror pool of "
        "shape pool.shape[:-1] ([L, N, bs, H] against [L, N, bs, H, "
        "D]). A scale pool with the wrong geometry scatters garbage "
        "scales; an int dtype truncates them; and a block write or "
        "copy (copy-on-write copy_block, index_put_ scatters) that "
        "moves values without scales reads back at the wrong magnitude "
        "— all silent numeric corruption, not crashes. The pairing is by "
        "name (X_cache/X_pool with X_scale), the same convention the "
        "runner uses."
    )
    bad_example = """
        import torch

        def build_pools(num_blocks, block_size, heads, head_dim):
            shape = (4, num_blocks, block_size, heads, head_dim)
            k_cache = torch.zeros(shape, dtype=torch.int8)
            k_scale = torch.zeros(shape[:2], dtype=torch.bfloat16)
            return k_cache, k_scale
    """
    good_example = """
        import torch

        def build_pools(num_blocks, block_size, heads, head_dim):
            shape = (4, num_blocks, block_size, heads, head_dim)
            k_cache = torch.zeros(shape, dtype=torch.int8)
            k_scale = torch.zeros(shape[:-1], dtype=torch.bfloat16)
            return k_cache, k_scale
    """

    def check(self, module: ModuleInfo) -> List[Finding]:
        return [
            self.finding(module, node, message)
            for node, message in pool_findings(module)
        ]


RULES = [PairedPoolGeometryRule]
