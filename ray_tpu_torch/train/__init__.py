from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TrainConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air.session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_device,
    get_world_rank,
    get_world_size,
    report,
)
from ray_tpu_torch.train.backend import (
    Backend,
    BackendConfig,
    TorchBackend,
    TorchBackendConfig,
)
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingWorkerError
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch_trainer import (
    TorchTrainer,
    prepare_batch,
    prepare_params,
    prepare_step,
    report_from_rank0,
)
from ray_tpu_torch.train.worker_group import WorkerGroup
from ray_tpu_torch.train.observability import (
    StepProfiler,
    TrainRunRecord,
    list_runs,
)

__all__ = [
    "Backend",
    "BackendConfig",
    "BackendExecutor",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "StepProfiler",
    "TorchBackend",
    "TorchBackendConfig",
    "TorchTrainer",
    "TrainConfig",
    "TrainRunRecord",
    "TrainingWorkerError",
    "WorkerGroup",
    "list_runs",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "get_device",
    "get_world_rank",
    "get_world_size",
    "prepare_batch",
    "prepare_params",
    "prepare_step",
    "report",
    "report_from_rank0",
]
