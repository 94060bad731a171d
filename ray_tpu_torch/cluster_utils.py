"""In-process multi-node cluster fixture.

The keystone test asset (SURVEY.md §4): the reference's `cluster_utils.Cluster`
(python/ray/cluster_utils.py:99, add_node :165, remove_node :238) runs real
raylet+GCS process trees with fabricated resources; here nodes are logical
entries in the shared control plane with their own execution engine, which is
what the scheduling/spillback/PG/failure tests need. A node's `GPU` is a
resource count, as `num_gpus` is everywhere in the port; there is no TPU
resource (the node daemon has no `--num-tpus` either).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.runtime import Runtime


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[dict] = None,
    ):
        self._runtime: Optional[Runtime] = None
        self.head_node: Optional[NodeID] = None
        if initialize_head:
            args = head_node_args or {"num_cpus": 1}
            self._runtime = Runtime(resources=None)
            self.head_node = self.add_node(**args)

    @property
    def runtime(self) -> Runtime:
        assert self._runtime is not None
        return self._runtime

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: float = 0,
        resources: Optional[dict] = None,
        labels: Optional[dict] = None,
    ) -> NodeID:
        node_resources = dict(resources or {})
        if num_cpus:
            node_resources["CPU"] = float(num_cpus)
        if num_gpus:
            node_resources["GPU"] = float(num_gpus)
        is_head = self.head_node is None
        node_id = self.runtime.add_node(node_resources, labels, is_head=is_head)
        if is_head:
            self.head_node = node_id
        return node_id

    def remove_node(self, node_id: NodeID) -> None:
        self.runtime.remove_node(node_id)

    def shutdown(self) -> None:
        if self._runtime is not None:
            self._runtime.shutdown()
            self._runtime = None
