"""LearnerGroup — local learner or N learner actors with gradient averaging.

Reference: rllib/core/learner/learner_group.py:61. Two modes mirroring the
reference's `num_learners == 0` (local) vs `>= 1` (remote actors):

* local: one Learner in-process, on its device (the card by default);
* remote: N learner actors, each building the same Learner; a train batch is
  sharded across them, each computes gradients, the group averages the
  host copies of the gradients and applies the average everywhere, so every
  learner holds the same weights. Actors on one card take fractional
  `num_gpus_per_learner` (the JAX package's `num_tpus_per_learner`).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


@ray_tpu_torch.remote
class _LearnerActor:
    def __init__(self, learner_builder):
        self.learner = learner_builder()
        self.learner.build()

    def update(self, batch):
        return self.learner.update(batch)

    def compute_gradients(self, batch):
        return self.learner.compute_gradients(batch)

    def apply_gradients(self, grads):
        self.learner.apply_gradients(grads)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state):
        self.learner.set_state(state)

    def call(self, method: str, *args):
        """Generic dispatch for learner-subclass methods (target syncs etc.)."""
        return getattr(self.learner, method)(*args)


def _average_grads(grad_list):
    """Element-wise mean of host gradients (name -> tensor), in numpy as the
    JAX package averages them."""
    return {
        k: torch.from_numpy(np.mean(np.stack([np.asarray(g[k]) for g in grad_list]), axis=0))
        for k in grad_list[0]
    }


class LearnerGroup:
    def __init__(
        self,
        learner_builder: Callable,
        num_learners: int = 0,
        num_cpus_per_learner: float = 1,
        num_gpus_per_learner: float = 0,
        slice_unit: int = 1,
    ):
        self._num_learners = num_learners
        # Batch rows come in groups of `slice_unit` that must not be split
        # across learners (IMPALA fragments of rollout_fragment_length rows).
        self._slice_unit = max(1, int(slice_unit))
        self._workers = []
        self._local = None
        if num_learners == 0:
            self._local = learner_builder()
            self._local.build()
        else:
            opts = {"num_cpus": num_cpus_per_learner}
            if num_gpus_per_learner:
                opts["num_gpus"] = num_gpus_per_learner
            self._workers = [
                _LearnerActor.options(**opts).remote(learner_builder)
                for _ in range(num_learners)
            ]

    @property
    def is_local(self) -> bool:
        return self._local is not None

    @property
    def local_learner(self):
        return self._local

    def update(self, batch: SampleBatch) -> dict:
        if self.is_local:
            return self._local.update(batch)
        # Shard the batch across learners on slice_unit boundaries;
        # grad-average; apply everywhere. Units distribute round-robin so no
        # learner ever receives an empty shard (empty batches mean NaN
        # means that would poison the gradient average).
        n = len(self._workers)
        unit = self._slice_unit
        num_units = batch.count // unit
        if num_units == 0:
            shards = [batch]  # smaller than one unit: single learner
        else:
            shards = []
            start = 0
            for i in range(min(n, num_units)):
                take = num_units // n + (1 if i < num_units % n else 0)
                end = start + take * unit
                # Partial-unit tail rows (count % unit) are dropped — they
                # would break the fragment reshape in order-dependent losses.
                shards.append(batch.slice(start, end))
                start = end
        workers = self._workers[: len(shards)]
        results = ray_tpu_torch.get(
            [w.compute_gradients.remote(s) for w, s in zip(workers, shards)]
        )
        grads = _average_grads([g for g, _ in results])
        ray_tpu_torch.get([w.apply_gradients.remote(grads) for w in self._workers])
        metric_dicts = [m for _, m in results]
        out = {}
        for k in metric_dicts[0]:
            vals = [m[k] for m in metric_dicts]
            if np.ndim(vals[0]) == 0:
                out[k] = float(np.mean(vals))
            else:
                # Per-sample diagnostics (td errors) concatenate in shard
                # order, which matches the batch's row order.
                out[k] = np.concatenate([np.asarray(v) for v in vals])
        return out

    def foreach_learner(self, method: str, *args) -> list:
        """Call a learner-subclass method on every learner (public dispatch;
        algorithms must not reach into _local/_workers)."""
        if self.is_local:
            return [getattr(self._local, method)(*args)]
        return ray_tpu_torch.get([w.call.remote(method, *args) for w in self._workers])

    def get_weights(self) -> Any:
        if self.is_local:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._workers[0].get_weights.remote())

    def set_weights(self, weights: Any) -> None:
        if self.is_local:
            self._local.set_weights(weights)
        else:
            ray_tpu_torch.get([w.set_weights.remote(weights) for w in self._workers])

    def get_state(self) -> dict:
        if self.is_local:
            return self._local.get_state()
        return ray_tpu_torch.get(self._workers[0].get_state.remote())

    def set_state(self, state: Any) -> None:
        if self.is_local:
            self._local.set_state(state)
        else:
            ray_tpu_torch.get([w.set_state.remote(state) for w in self._workers])

    def shutdown(self) -> None:
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = []
        self._local = None
