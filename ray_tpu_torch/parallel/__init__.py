"""ray_tpu_torch.parallel — tensor parallelism for the serving engine.

The reference lets GSPMD insert the collectives of a `tp` mesh; here they
are written by hand over a ``torch.distributed`` process group of one
process per device (NCCL on the card, gloo on the CPU):

  * ``mesh`` — ``tensor_parallel_group``, the counterpart of
    ``tensor_parallel_mesh``: rank 0 is the caller's process, ranks
    1..tp-1 are spawned processes that run ``llm.tp_worker``'s loop;
  * ``sharding`` — ``LLM_TP_RULES`` and ``llm_shard_params``: which GPT
    weight is column-parallel, row-parallel or replicated, and rank r's
    slice of a full state dict; the per-rank KV pool shape;
  * ``tensor_parallel`` — ``ColumnParallelDense`` / ``RowParallelDense``,
    the dense layers with the all-reduce GSPMD inserts after a
    row-parallel product.
"""

from ray_tpu_torch.parallel.mesh import (
    TP_TIMEOUT_S,
    RankGroup,
    TensorParallelError,
    TensorParallelGroup,
    check_tp_devices,
    tensor_parallel_group,
)
from ray_tpu_torch.parallel.sharding import (
    LLM_POOL_SPEC,
    LLM_TP_RULES,
    llm_pool_shape,
    llm_shard_params,
    param_rule,
)
from ray_tpu_torch.parallel.tensor_parallel import ColumnParallelDense, RowParallelDense

__all__ = [
    "ColumnParallelDense",
    "LLM_POOL_SPEC",
    "LLM_TP_RULES",
    "RankGroup",
    "RowParallelDense",
    "TP_TIMEOUT_S",
    "TensorParallelError",
    "TensorParallelGroup",
    "check_tp_devices",
    "llm_pool_shape",
    "llm_shard_params",
    "param_rule",
    "tensor_parallel_group",
]
