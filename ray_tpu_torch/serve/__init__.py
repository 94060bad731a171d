"""ray_tpu_torch.serve — online model serving.

Re-design of the reference Serve library (python/ray/serve/): a central
ServeController actor reconciles declarative deployment target state
(serve/controller.py:79, _private/deployment_state.py:1115), replicas are
plain actors, DeploymentHandles route requests to replicas client-side
(_private/router.py:338,370), config changes fan out via a long-poll host
(_private/long_poll.py:68,186), and replica counts autoscale on queue metrics
(_private/autoscaling_policy.py:9,53).

A copy of the reference package's Serve library on the port's runtime,
with the same departures from Ray's:
  * @serve.batch can pad batches to bucketed sizes so a model sees a
    small, fixed set of batch shapes (one launch shape, or one CUDA graph,
    per bucket instead of per batch size).
  * Replicas warm their model on init (the LLM engine builds its kernels
    and runs every bucket once before the deployment reports healthy).
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    deployment,
    get_app_handle,
    get_deployment_handle,
    run,
    scale_deployment,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import (
    AutoscalingConfig,
    DeploymentConfig,
    LLMAutoscalingPolicy,
)
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve import schema

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "LLMAutoscalingPolicy",
    "batch",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "run",
    "scale_deployment",
    "schema",
    "shutdown",
    "start",
    "status",
]
