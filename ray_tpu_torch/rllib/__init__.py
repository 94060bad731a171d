"""ray_tpu_torch.rllib — RL on the port: the learner on the card.

A port of `ray_tpu.rllib`'s new stack, single-agent path: RLModule (an
`nn.Module` and its parameters) / Learner (minibatch SGD in torch on the
learner's device, the card by default) / LearnerGroup (learner actors,
fractional GPUs on one card) / EnvRunner actor pool stepping the numpy
environments on the host, as the reference does. PPO and IMPALA (V-trace)
are ported; the other algorithms, multi-agent sampling and offline IO are
not yet (ROADMAP.md §B9), and their entry points raise naming it.

Layering rule preserved from the reference: rllib uses only the public
task/actor/object API (ray_tpu_torch.remote / actors / ObjectRefs) — no
runtime internals.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "MultiAgentBatch",
    "SampleBatch",
]
