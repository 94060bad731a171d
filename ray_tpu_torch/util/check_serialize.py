"""Serializability inspection — find what makes an object unpicklable.

Reference: python/ray/util/check_serialize.py (inspect_serializability):
walk closures/attributes of a failing object and report the specific
offending members, instead of cloudpickle's opaque top-level error.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, List, Tuple

import cloudpickle


@dataclass
class FailureTuple:
    obj: Any
    name: str
    parent: Any

    def __repr__(self):
        return f"FailTuple({self.name} [obj={self.obj!r}, parent={self.parent!r}])"


def _try_pickle(obj: Any) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:
        return False


def _members(obj: Any) -> List[Tuple[str, Any]]:
    """Pickling-relevant members: closure vars for functions, __dict__ attrs
    for instances."""
    out: List[Tuple[str, Any]] = []
    if inspect.isfunction(obj):
        try:
            closure = inspect.getclosurevars(obj)
        except (TypeError, ValueError):
            return out
        out.extend(closure.nonlocals.items())
        out.extend(closure.globals.items())
    attrs = getattr(obj, "__dict__", None)
    if isinstance(attrs, dict) and not inspect.isfunction(obj):
        out.extend(attrs.items())
    return out


def inspect_serializability(
    obj: Any, name: str = "", depth: int = 3
) -> Tuple[bool, List[FailureTuple]]:
    """Returns (serializable, failures): the deepest unserializable members
    reachable within `depth` levels, or the object itself if opaque."""
    name = name or getattr(obj, "__qualname__", None) or repr(obj)
    if _try_pickle(obj):
        return True, []
    failures: List[FailureTuple] = []
    seen: set = set()

    def walk(node: Any, node_name: str, parent_name, level: int) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        deeper_found = False
        if level < depth:
            for member_name, member in _members(node):
                if not _try_pickle(member):
                    deeper_found = True
                    walk(member, member_name, node_name, level + 1)
        if not deeper_found:
            if not any(f.obj is node for f in failures):
                failures.append(FailureTuple(node, node_name, parent_name))

    walk(obj, name, None, 0)
    return False, failures
