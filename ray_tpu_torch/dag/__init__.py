"""Lazy task/actor call graphs (reference: python/ray/dag/ — dag_node.py,
input_node.py). `.bind()` builds the DAG; `.execute()` submits it as normal
tasks/actor calls. Base layer for Serve graphs and Workflow."""

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
)

__all__ = [
    "ClassMethodNode",
    "ClassNode",
    "DAGNode",
    "FunctionNode",
    "InputNode",
]
