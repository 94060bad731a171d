from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics, LoadSnapshot
from ray_tpu_torch.autoscaler.monitor import Monitor
from ray_tpu_torch.autoscaler.node_provider import (
    FakeNodeProvider,
    NodeProvider,
    SSHNodeProvider,
    SubprocessNodeProvider,
    TAG_NODE_TYPE,
    TAG_SLICE_ID,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import ResourceDemandScheduler

__all__ = [
    "FakeNodeProvider",
    "LoadMetrics",
    "LoadSnapshot",
    "Monitor",
    "NodeProvider",
    "SSHNodeProvider",
    "SubprocessNodeProvider",
    "ResourceDemandScheduler",
    "StandardAutoscaler",
    "TAG_NODE_TYPE",
    "TAG_SLICE_ID",
]
