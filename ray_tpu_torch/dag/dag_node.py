"""DAG node types.

Reference: python/ray/dag/dag_node.py (DAGNode: bound args + traversal),
function_node.py, class_node.py, input_node.py. A DAG is built by `.bind()`
on remote functions/classes and executed by `.execute(input)`: nodes submit
as regular tasks / actor creations / actor method calls, with parent outputs
passed as ObjectRefs (the runtime resolves dependencies, so execution is
fully parallel where the graph allows).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional


class DAGNode:
    """A node in a lazy call graph."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._stable_uuid = uuid.uuid4().hex

    # -- traversal -----------------------------------------------------

    def _children(self) -> List["DAGNode"]:
        out: List[DAGNode] = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            _scan_nodes(a, out)
        return out

    def topological_order(self) -> List["DAGNode"]:
        seen: Dict[str, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if node._stable_uuid in seen:
                return
            seen[node._stable_uuid] = node
            for child in node._children():
                visit(child)
            order.append(node)

        visit(self)
        return order

    # -- execution -----------------------------------------------------

    def execute(self, *input_args, **input_kwargs) -> Any:
        """Execute the DAG rooted at this node; returns the root's result
        handle (ObjectRef for task nodes, ActorHandle for ClassNode roots)."""
        cache: Dict[str, Any] = {}
        input_value = _InputValue(input_args, input_kwargs)
        for node in self.topological_order():
            cache[node._stable_uuid] = node._execute_node(cache, input_value)
        return cache[self._stable_uuid]

    def _resolve(self, value: Any, cache: Dict[str, Any], input_value) -> Any:
        """Swap DAGNodes for their results, scanning into list/tuple/dict
        containers (reference dag_node.py uses a scanner for exactly this:
        nested nodes in collection args must execute, not pass through raw)."""
        if isinstance(value, DAGNode):
            return cache[value._stable_uuid]
        if isinstance(value, list):
            return [self._resolve(v, cache, input_value) for v in value]
        if isinstance(value, tuple):
            return tuple(self._resolve(v, cache, input_value) for v in value)
        if isinstance(value, dict):
            return {k: self._resolve(v, cache, input_value) for k, v in value.items()}
        return value

    def _resolved_args(self, cache, input_value):
        args = tuple(self._resolve(a, cache, input_value) for a in self._bound_args)
        kwargs = {
            k: self._resolve(v, cache, input_value)
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    def _execute_node(self, cache, input_value) -> Any:
        raise NotImplementedError


def _scan_nodes(value: Any, out: List["DAGNode"]) -> None:
    if isinstance(value, DAGNode):
        out.append(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _scan_nodes(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _scan_nodes(v, out)


class _InputValue:
    __slots__ = ("args", "kwargs")

    def __init__(self, args: tuple, kwargs: dict):
        self.args = args
        self.kwargs = kwargs


class InputNode(DAGNode):
    """Placeholder for runtime input (reference: dag/input_node.py). Supports
    attribute/index access via InputAttributeNode."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_node(self, cache, input_value: _InputValue):
        if input_value.kwargs:
            return _InputProxy(input_value)
        if len(input_value.args) == 1:
            return input_value.args[0]
        return input_value.args

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return InputAttributeNode(self, item, "attr")

    def __getitem__(self, item):
        return InputAttributeNode(self, item, "item")


class _InputProxy:
    def __init__(self, input_value: _InputValue):
        self._iv = input_value

    def __getattr__(self, item):
        return self._iv.kwargs[item]

    def __getitem__(self, item):
        if isinstance(item, int):
            return self._iv.args[item]
        return self._iv.kwargs[item]


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key, kind: str):
        super().__init__((parent,), {})
        self._key = key
        self._kind = kind

    def _execute_node(self, cache, input_value: _InputValue):
        if self._kind == "item" and isinstance(self._key, int):
            return input_value.args[self._key]
        return input_value.kwargs[self._key]


class FunctionNode(DAGNode):
    """`fn.bind(...)` over a remote function (reference: function_node.py)."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict, options: dict):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = options

    def _execute_node(self, cache, input_value):
        args, kwargs = self._resolved_args(cache, input_value)
        fn = self._remote_fn
        if self._options:
            fn = fn.options(**self._options)
        return fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """`Actor.bind(...)`: actor creation as a DAG node."""

    def __init__(self, actor_cls, args: tuple, kwargs: dict, options: dict):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._options = options

    def _execute_node(self, cache, input_value):
        args, kwargs = self._resolved_args(cache, input_value)
        cls = self._actor_cls
        if self._options:
            cls = cls.options(**self._options)
        return cls.remote(*args, **kwargs)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _BoundMethodFactory(self, item)


class _BoundMethodFactory:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    """Actor method call bound into a DAG."""

    def __init__(self, parent: ClassNode, method_name: str, args, kwargs):
        super().__init__((parent,) + tuple(args), kwargs)
        self._method_name = method_name

    def _execute_node(self, cache, input_value):
        resolved = [
            self._resolve(a, cache, input_value) for a in self._bound_args
        ]
        handle, args = resolved[0], resolved[1:]
        kwargs = {
            k: self._resolve(v, cache, input_value)
            for k, v in self._bound_kwargs.items()
        }
        return getattr(handle, self._method_name).remote(*args, **kwargs)
