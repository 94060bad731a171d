"""Ape-X DQN — distributed prioritized experience replay (Horgan et al. 2018).

Reference: rllib/algorithms/apex_dqn/apex_dqn.py. Ape-X's distinctive
distributed pattern — absent from every other algorithm family here — is
REPLAY SHARD ACTORS sitting between the samplers and the learner:

  * rollouts push to shards round-robin (fire-and-forget with bounded
    in-flight backpressure), so ingest never serializes behind the
    learner's sample requests on one buffer's ordered actor queue;
  * the learner PREFETCHES: while the current batch trains, the next
    batch is already being sampled on a different shard;
  * priority updates flow back asynchronously to the shard that served
    the batch (each shard owns its indices).

The losses, target-network handling, n-step rewrite, and epsilon
scheduling are DQN's own (dqn.py) — Ape-X changes the dataflow, not the
math. The learner's update on the card is DQN's; sharded replay keeps the
host side feeding it without a global buffer lock. The shards are actors of
the port's runtime (`num_cpus=0`); `stop()` kills them and drops every
pending push, prefetch and priority update.
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.dqn.dqn import (
    DQN,
    DQNConfig,
    n_step_transitions,
)


class ReplayShard:
    """One prioritized replay shard, hosted in its own actor. Indices are
    shard-local: priority updates must return to the serving shard."""

    def __init__(self, capacity: int, alpha: float, beta: float, seed):
        from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer

        self.buffer = PrioritizedReplayBuffer(
            capacity=capacity, alpha=alpha, beta=beta, seed=seed
        )

    def add(self, batch) -> int:
        self.buffer.add(batch)
        return len(self.buffer)

    def sample(self, num_items: int):
        if len(self.buffer) < num_items:
            return None
        return self.buffer.sample(num_items)

    def update_priorities(self, idx, td) -> bool:
        self.buffer.update_priorities(
            np.asarray(idx, dtype=np.int64), np.abs(np.asarray(td)) + 1e-6
        )
        return True

    def size(self) -> int:
        return len(self.buffer)


class ApexDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ApexDQN)
        self.num_replay_shards = 2
        self.replay_buffer_config = {
            "type": "prioritized",
            "capacity": 50_000,
            "alpha": 0.6,
            "beta": 0.4,
        }
        # Bound on un-acked shard pushes before sampling blocks on them
        # (ingest backpressure; the reference bounds this with its
        # max_requests_in_flight_per_replay_worker).
        self.max_inflight_pushes = 8


class ApexDQN(DQN):
    config_class = ApexDQNConfig

    def _make_replay_buffer(self):
        return None  # replay lives in the shard actors

    def setup(self, config: dict) -> None:
        super().setup(config)
        cfg = self.algo_config
        buf_cfg = dict(cfg.replay_buffer_config)
        shard_capacity = max(
            1, buf_cfg.get("capacity", 50_000) // cfg.num_replay_shards
        )
        actor_cls = ray_tpu_torch.remote(ReplayShard)
        self.replay_shards = [
            actor_cls.options(num_cpus=0).remote(
                shard_capacity,
                buf_cfg.get("alpha", 0.6),
                buf_cfg.get("beta", 0.4),
                None if cfg.seed is None else cfg.seed + i,
            )
            for i in range(cfg.num_replay_shards)
        ]
        self._push_rr = 0
        self._sample_rr = 0
        self._inflight_pushes: list = []
        self._inflight_prio: list = []
        self._shard_sizes = [0] * cfg.num_replay_shards
        # Prefetched (shard_index, batch_ref) pair, requested one step early.
        self._prefetched = None

    # -- dataflow ----------------------------------------------------------

    def _push_rollout(self, batch) -> None:
        cfg = self.algo_config
        shard_idx = self._push_rr % len(self.replay_shards)
        self._push_rr += 1
        self._inflight_pushes.append(
            (shard_idx, self.replay_shards[shard_idx].add.remote(batch))
        )
        # Reap acked pushes NON-blocking (size bookkeeping rides the ack).
        refs = [ref for _, ref in self._inflight_pushes]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        ready_set = set(ready)
        still = []
        for idx, ref in self._inflight_pushes:
            if ref in ready_set:
                try:
                    self._shard_sizes[idx] = ray_tpu_torch.get(ref)
                except Exception:
                    pass
            else:
                still.append((idx, ref))
        self._inflight_pushes = still
        # Ingest backpressure: bound the un-acked window.
        while len(self._inflight_pushes) > cfg.max_inflight_pushes:
            idx, ref = self._inflight_pushes.pop(0)
            try:
                self._shard_sizes[idx] = ray_tpu_torch.get(ref, timeout=60)
            except Exception:
                pass

    def _request_sample(self):
        """Ask the next shard for a batch (round-robin over shards that have
        enough data)."""
        cfg = self.algo_config
        shard_idx = self._sample_rr % len(self.replay_shards)
        self._sample_rr += 1
        shard = self.replay_shards[shard_idx]
        return (shard_idx, shard.sample.remote(cfg.train_batch_size))

    def training_step(self) -> dict:
        cfg = self.algo_config
        rollout = self.env_runner_group.sample(cfg.get_rollout_fragment_length())
        if self._output_writer is not None:
            self._output_writer.write(rollout)
        self._push_rollout(n_step_transitions(rollout, cfg.n_step, cfg.gamma))
        self._env_steps_total += rollout.count
        self._steps_since_target_sync += rollout.count

        results = {
            "replay_shards": len(self.replay_shards),
            "replay_buffer_size": sum(self._shard_sizes),
        }
        if self._env_steps_total < cfg.num_steps_sampled_before_learning_starts:
            return results

        # Prefetch pipeline: resolve the batch requested LAST step (it was
        # sampling while the previous update ran), immediately request the
        # next one, then train.
        if self._prefetched is None:
            self._prefetched = self._request_sample()
        shard_idx, batch_ref = self._prefetched
        try:
            train_batch = ray_tpu_torch.get(batch_ref, timeout=120)
        except Exception:
            train_batch = None
        self._prefetched = self._request_sample()
        if train_batch is None:
            return results  # shard not warm yet

        metrics = self.learner_group.update(train_batch)
        td = metrics.pop("td_error_per_sample", None)
        if td is None:
            td = metrics.pop("td_error", None)
        if td is not None:
            idx = np.asarray(train_batch["batch_indexes"])[: len(td)]
            shard = self.replay_shards[shard_idx]
            self._inflight_prio.append(
                shard.update_priorities.remote(idx, np.asarray(td))
            )
            if len(self._inflight_prio) > 2 * len(self.replay_shards):
                ready, rest = ray_tpu_torch.wait(
                    self._inflight_prio,
                    num_returns=len(self._inflight_prio) - len(self.replay_shards),
                    timeout=30,
                )
                self._inflight_prio = list(rest)
        results.update({k: v for k, v in metrics.items() if np.ndim(v) == 0})

        if self._steps_since_target_sync >= cfg.target_network_update_freq:
            self.learner_group.foreach_learner("sync_target")
            self._steps_since_target_sync = 0
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights(),
            global_vars={"timestep": self._env_steps_total},
        )
        return results

    def stop(self) -> None:
        for shard in getattr(self, "replay_shards", ()):
            try:
                ray_tpu_torch.kill(shard)
            except Exception:
                pass
        self.replay_shards = []
        self._inflight_pushes = []
        self._inflight_prio = []
        self._prefetched = None
        super().stop()
