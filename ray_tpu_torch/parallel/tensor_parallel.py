"""Megatron's two dense layers over a tensor-parallel group.

The reference has no module of this kind: under its ``tp`` mesh GSPMD
reads the weights' shardings (``ray_tpu/parallel/sharding.py:159-212``,
``LLM_TP_RULES``) and inserts the collectives itself — an all-reduce after
each row-parallel product (``attn_proj`` and ``mlp_out`` of
``ray_tpu/models/gpt.py:164,188``), nothing after a column-parallel one.
These two classes are what it inserts, written by hand:

  * ``ColumnParallelDense`` holds its rank's output columns (weight and
    bias rows); its output stays split, and no collective runs.
  * ``RowParallelDense`` holds the input rows that match the previous
    layer's columns. Each rank's product is a partial sum over its rows:
    the partials are summed by one all-reduce, in f32, and the bias is
    added once, after it, before the cast to the compute dtype. With a
    bf16 model a single-device product accumulates in f32 and rounds
    once; summing bf16 partials would round twice. The weight is kept as
    f32 holding the compute dtype's values (``cast_for_inference``), so
    every product is exact in f32 and only the order of the sum differs
    from one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.gpt import Dense


class ColumnParallelDense(Dense):
    """Dense(in_features, out_features / tp): this rank's output columns."""

    def __init__(self, in_features: int, out_features: int, dtype, device=None, tp: int = 1):
        if out_features % tp:
            raise ValueError(f"out_features {out_features} does not split over {tp} ranks")
        super().__init__(in_features, out_features // tp, dtype, device)


class RowParallelDense(Dense):
    """Dense(in_features / tp, out_features) whose outputs are summed over
    `group` (a RankGroup) before the bias; the bias is replicated."""

    def __init__(self, in_features: int, out_features: int, dtype, device=None, group=None):
        tp = group.size if group is not None else 1
        if in_features % tp:
            raise ValueError(f"in_features {in_features} does not split over {tp} ranks")
        super().__init__(in_features // tp, out_features, dtype, device)
        self.group = group
        self._rounded = False

    @torch.no_grad()
    def cast_for_inference(self) -> None:
        # The compute dtype's values, stored in f32 (see the module doc);
        # the bias is added in f32 after the all-reduce.
        self.weight.data = self.weight.to(self.dtype).float()
        self.bias.data = self.bias.to(self.dtype).float()
        self._rounded = True

    def _f32(self, p: torch.Tensor) -> torch.Tensor:
        return p if self._rounded else p.to(self.dtype).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        partial = F.linear(x.to(self.dtype).float(), self._f32(self.weight))
        self.group.all_reduce(partial)
        return (partial + self._f32(self.bias)).to(self.dtype)
