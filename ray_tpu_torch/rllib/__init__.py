"""ray_tpu_torch.rllib — RL on the port: the learner on the card.

A port of `ray_tpu.rllib`'s new stack: RLModule (an `nn.Module` and its
parameters) / Learner (minibatch SGD in torch on the learner's device, the
card by default) / LearnerGroup (learner actors, fractional GPUs on one
card) / EnvRunner actor pool stepping the numpy environments on the host, as
the reference does. Every algorithm of the reference is ported: PPO, IMPALA
(V-trace), APPO, A2C, DQN, Ape-X DQN (replay-shard actors), SAC, TD3, and
the offline BC and CQL; multi-agent envs sample through the shared-policy
and per-policy runners, and offline IO (JsonWriter / JsonReader, the
reference's file format) with its IS / WIS estimators runs on the host.

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
