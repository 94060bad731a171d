"""SampleBatch / MultiAgentBatch — dict-of-arrays rollout containers.

Reference: rllib/policy/sample_batch.py:95 (SampleBatch), :1220
(MultiAgentBatch), concat_samples. Kept numpy-first: EnvRunners produce numpy
batches on CPU hosts; the Learner converts once to device arrays at update
time (single host→HBM transfer per train batch — the HBM-bandwidth-conscious
path, SURVEY.md "minimise host↔device transfers").
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional, Sequence

import numpy as np


class SampleBatch(dict):
    # Standard column names (reference sample_batch.py: class attrs).
    OBS = "obs"
    NEXT_OBS = "new_obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    INFOS = "infos"
    EPS_ID = "eps_id"
    ACTION_LOGP = "action_logp"
    ACTION_DIST_INPUTS = "action_dist_inputs"
    VF_PREDS = "vf_preds"
    VALUES_BOOTSTRAPPED = "values_bootstrapped"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, (list, tuple)) and k != self.INFOS:
                self[k] = np.asarray(v)

    def __len__(self) -> int:
        return self.count

    @property
    def count(self) -> int:
        for k, v in self.items():
            if k != self.INFOS and hasattr(v, "__len__"):
                return len(v)
        return 0

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch(
            {
                k: (v[start:end] if hasattr(v, "__getitem__") else v)
                for k, v in self.items()
            }
        )

    def shuffle(self, rng: Optional[np.random.Generator] = None) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(self.count)
        return SampleBatch(
            {
                k: (v[perm] if isinstance(v, np.ndarray) else v)
                for k, v in self.items()
            }
        )

    def minibatches(
        self, minibatch_size: int, num_epochs: int = 1, shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Iterator["SampleBatch"]:
        """SGD minibatch iterator (reference: rllib/utils/sgd.py
        minibatches / do_minibatch_sgd)."""
        for _ in range(num_epochs):
            batch = self.shuffle(rng) if shuffle else self
            for start in range(0, batch.count - minibatch_size + 1, minibatch_size):
                yield batch.slice(start, start + minibatch_size)

    def split_by_episode(self) -> list:
        """Split on EPS_ID boundaries (reference sample_batch.py:
        split_by_episode)."""
        if self.EPS_ID not in self:
            return [self]
        eps = np.asarray(self[self.EPS_ID])
        boundaries = [0] + (np.nonzero(eps[1:] != eps[:-1])[0] + 1).tolist() + [len(eps)]
        return [self.slice(a, b) for a, b in zip(boundaries[:-1], boundaries[1:])]

    @staticmethod
    def concat_samples(batches: Sequence["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b is not None and b.count > 0]
        if not batches:
            return SampleBatch()
        keys = set(batches[0].keys())
        for b in batches[1:]:
            keys &= set(b.keys())
        out = {}
        for k in keys:
            if k == SampleBatch.INFOS:
                merged: list = []
                for b in batches:
                    merged.extend(b[k])
                out[k] = merged
            else:
                out[k] = np.concatenate([np.asarray(b[k]) for b in batches], axis=0)
        return SampleBatch(out)


def concat_samples(batches: Sequence) -> "SampleBatch":
    if batches and isinstance(batches[0], MultiAgentBatch):
        return MultiAgentBatch.concat_samples(batches)
    return SampleBatch.concat_samples(batches)


class MultiAgentBatch(dict):
    """{module_id/agent_id: SampleBatch} with a global env-step count
    (reference sample_batch.py:1220)."""

    def __init__(self, policy_batches: Mapping[str, SampleBatch], env_steps: int = 0):
        super().__init__(policy_batches)
        self._env_steps = int(env_steps)

    def env_steps(self) -> int:
        return self._env_steps

    def agent_steps(self) -> int:
        return sum(b.count for b in self.values())

    @property
    def count(self) -> int:
        """Env-step count (the reference counts multi-agent batches by env
        steps, not agent rows, for train_batch_size accounting)."""
        return self._env_steps or self.agent_steps()

    @staticmethod
    def concat_samples(batches: Sequence["MultiAgentBatch"]) -> "MultiAgentBatch":
        merged: dict[str, list] = {}
        steps = 0
        for mb in batches:
            steps += mb.env_steps()
            for k, b in mb.items():
                merged.setdefault(k, []).append(b)
        return MultiAgentBatch(
            {k: SampleBatch.concat_samples(v) for k, v in merged.items()}, steps
        )
