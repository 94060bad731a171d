"""IMPALA — asynchronous sampling with V-trace off-policy correction.

Reference: rllib/algorithms/impala/impala.py (:554 config, :687 training_step:
async sample ObjectRefs -> aggregator-actor tree -> learner queue; :697
aggregation workers; rllib/execution/learner_thread.py). The architecture that
makes IMPALA IMPALA, in actor space:

  * every remote runner always has one sample() in flight (never idles);
  * ready fragment REFS route to aggregator actors that concat them into
    train batches off the driver thread (the aggregator tree — fragments
    deserialize+concat in parallel, the driver only moves refs);
  * a dedicated LEARNER THREAD consumes aggregated batches from a bounded
    queue, overlapping SGD with sampling (the device-feed queue); the queue
    bound is the backpressure that caps policy lag;
  * fresh weights broadcast to just-drained runners (V-trace absorbs the
    one-ish-version staleness — exactly IMPALA's off-policy regime).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Optional

import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.impala import vtrace
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch, concat_samples


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or IMPALA)
        self.lr = 5e-4
        self.train_batch_size = 500
        self.rollout_fragment_length = 50
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_pg_rho_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self.num_epochs = 1
        self.minibatch_size = None  # one pass over the whole train batch
        self._compute_gae_on_runner = False  # V-trace runs in the loss
        # Aggregator-actor tree (reference impala.py:697): 0 = auto (one per
        # 4 runners); fragments concat into train batches off-driver.
        self.num_aggregation_workers: int = 0
        # Bounded device-feed queue between sampling and the learner thread;
        # the bound caps how far sampling can run ahead (policy lag).
        self.learner_queue_size: int = 4

    def get_default_learner_class(self):
        return IMPALALearner

    def get_learner_slice_unit(self) -> int:
        return int(self.rollout_fragment_length or 50)


@ray_tpu_torch.remote
class _AggregatorActor:
    """Concats rollout fragments into train batches (impala.py:697 tree leaf):
    the driver passes fragment refs; values deserialize HERE, so N aggregators
    parallelize the gather that would otherwise serialize on the driver."""

    def __init__(self, train_batch_size: int):
        self._target = int(train_batch_size)
        self._buffer: list = []
        self._count = 0

    def add(self, fragment) -> Optional[SampleBatch]:
        self._buffer.append(fragment)
        self._count += fragment.count
        if self._count >= self._target:
            out = concat_samples(self._buffer)
            self._buffer = []
            self._count = 0
            return out
        return None


class IMPALALearner(Learner):
    """V-trace actor-critic loss over time-major reshaped fragments."""

    # Rows are fragment-ordered; shuffling would scramble trajectories.
    shuffle_minibatches = False

    def compute_loss(self, params, batch, rng, extra=None):
        cfg = self.config
        T = int(cfg.rollout_fragment_length or 50)
        obs = batch[SampleBatch.OBS]
        N = obs.shape[0] // T  # fragments (each a contiguous per-env slice)

        def tm(x):  # [N*T, ...] -> time-major [T, N, ...]
            return x.reshape((N, T) + tuple(x.shape[1:])).transpose(0, 1)

        fwd = self.module.forward_train(params, batch)
        dist = self.module.dist_cls(fwd[SampleBatch.ACTION_DIST_INPUTS])
        target_logp = dist.logp(batch[SampleBatch.ACTIONS])
        entropy = dist.entropy()
        values = fwd[SampleBatch.VF_PREDS]

        log_rhos = tm(target_logp - batch[SampleBatch.ACTION_LOGP])
        dones = torch.logical_or(
            batch[SampleBatch.TERMINATEDS], batch[SampleBatch.TRUNCATEDS]
        ).float()
        discounts = tm(cfg.gamma * (1.0 - dones))
        # Truncations are not true terminals: fold the runner's bootstrap
        # value V(final_observation) (VALUES_BOOTSTRAPPED, stale by one
        # weight version) into the reward at the truncated step, so cutting
        # the recursion there (discount 0) still credits the episode tail.
        rewards_flat = batch[SampleBatch.REWARDS]
        if SampleBatch.VALUES_BOOTSTRAPPED in batch:
            trunc = batch[SampleBatch.TRUNCATEDS].float()
            rewards_flat = rewards_flat + cfg.gamma * trunc * batch[
                SampleBatch.VALUES_BOOTSTRAPPED
            ]
        rewards = tm(rewards_flat)
        values_tm = tm(values)
        # Bootstrap from V(next_obs of each fragment's last step), without
        # a gradient.
        next_obs_tm = tm(batch[SampleBatch.NEXT_OBS])
        with torch.no_grad():
            _, bootstrap = self.module.apply(params, next_obs_tm[-1])

        vt = vtrace.from_importance_weights(
            log_rhos=log_rhos,
            discounts=discounts,
            rewards=rewards,
            values=values_tm,
            bootstrap_value=bootstrap,
            clip_rho_threshold=cfg.vtrace_clip_rho_threshold,
            clip_pg_rho_threshold=cfg.vtrace_clip_pg_rho_threshold,
        )
        pg_loss = -torch.mean(tm(target_logp) * vt.pg_advantages)
        vf_loss = 0.5 * torch.mean((values_tm - vt.vs) ** 2)
        entropy_mean = torch.mean(entropy)
        total = pg_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy_mean
        return total, {
            "policy_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy_mean,
            "mean_rho": torch.mean(torch.exp(log_rhos)),
        }


class IMPALA(Algorithm):
    config_class = IMPALAConfig

    def setup(self, config: dict) -> None:
        super().setup(config)
        cfg = self.algo_config
        self._in_flight: dict[int, object] = {}
        self._agg_in_flight: list = []  # pending aggregator add() refs
        self._aggregators: list = []
        self._agg_cursor = 0
        n_runners = len(self.env_runner_group.remote_runners())
        if n_runners:
            n_agg = int(cfg.num_aggregation_workers) or max(1, n_runners // 4)
            self._aggregators = [
                _AggregatorActor.remote(cfg.train_batch_size)
                for _ in range(n_agg)
            ]
        # Learner thread: consumes aggregated batches, overlapping SGD with
        # sampling (rllib/execution/learner_thread.py).
        self._queue: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(1, int(cfg.learner_queue_size))
        )
        self._learner_lock = threading.Lock()
        self._learner_metrics: dict = {}
        self._learner_updates = 0
        self._learner_errors = 0
        self._fresh_weights = self.learner_group.get_weights()
        self._stopping = False
        self._learner_thread = threading.Thread(
            target=self._learner_loop, name="impala-learner", daemon=True
        )
        self._learner_thread.start()

    def _learner_loop(self) -> None:
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            try:
                results = self.learner_group.update(batch)
                weights = self.learner_group.get_weights()
            except Exception as exc:  # keep the thread alive; surface below
                with self._learner_lock:
                    self._learner_metrics = {"learner_error": repr(exc)}
                    self._learner_errors += 1
                continue
            with self._learner_lock:
                self._learner_metrics = dict(results)
                self._learner_updates += 1
                self._fresh_weights = weights

    def _latest_metrics(self) -> dict:
        with self._learner_lock:
            out = dict(self._learner_metrics)
            out["num_learner_updates"] = self._learner_updates
            out["learner_queue_size"] = self._queue.qsize()
        return out

    def training_step(self) -> dict:
        cfg = self.algo_config
        group = self.env_runner_group
        frag = int(cfg.rollout_fragment_length or 50)

        if not group.remote_runners():
            # Synchronous fallback (num_env_runners=0): still V-trace, just
            # on-policy — the reference's local-mode IMPALA does the same.
            batches = []
            count = 0
            while count < cfg.train_batch_size:
                b = group.local_runner.sample(frag)
                batches.append(b)
                count += b.count
            train_batch = concat_samples(batches)
            if self._output_writer is not None:
                self._output_writer.write(train_batch)
            self._env_steps_total += train_batch.count
            results = self.learner_group.update(train_batch)
            group.sync_weights(
                self.learner_group.get_weights(),
                global_vars={"timestep": self._env_steps_total},
            )
            return dict(results)

        # Loop sampling rounds until the learner thread publishes an update
        # newer than this step's entry (metrics freshness for the Trainable
        # contract) — sampling and aggregation CONTINUE during the wait, so
        # the learner never starves and SGD overlaps collection.
        with self._learner_lock:
            updates_at_entry = self._learner_updates
            errors_at_entry = self._learner_errors
        deadline = time.monotonic() + 120.0
        enqueued = 0
        while True:
            enqueued += self._sampling_round(group, frag)
            with self._learner_lock:
                advanced = self._learner_updates > updates_at_entry
                errored = self._learner_errors > errors_at_entry
            if advanced or errored or time.monotonic() > deadline:
                break
        out = self._latest_metrics()
        if errored and not advanced:
            # A reproducibly failing learner must not silently spin train()
            # to the deadline forever — propagate to the caller.
            raise RuntimeError(
                f"IMPALA learner update failed: {out.get('learner_error')}"
            )
        out["num_batches_enqueued"] = enqueued
        return out

    def _sampling_round(self, group, frag: int) -> int:
        """Drain ready fragments, route refs through the aggregator tree,
        enqueue completed train batches; returns batches enqueued."""
        # Keep one sample() in flight per runner (runners never idle).
        # Each in-flight ref carries the runner HANDLE it was issued to, so a
        # failure later surfacing from that ref is attributed to the issuing
        # runner only — never to a healthy replacement at the same index.
        for idx, runner in group.remote_runners().items():
            if idx not in self._in_flight:
                self._in_flight[idx] = (runner.sample.remote(frag), runner)

        drained: list[int] = []
        enqueued = 0
        refs = {ref: (idx, rn) for idx, (ref, rn) in self._in_flight.items()}
        ready, _ = ray_tpu_torch.wait(
            list(refs.keys()), num_returns=1, timeout=5.0
        )
        for ref in ready:
            idx, source = refs[ref]
            del self._in_flight[idx]
            runner = group.remote_runners().get(idx)
            # Route the fragment REF to an aggregator; a dead runner's
            # errored ref surfaces when the aggregator add FAILS (arg
            # resolution cascades the sample error), so the add ref is
            # tracked with its source runner for failure attribution below.
            agg = self._aggregators[self._agg_cursor % len(self._aggregators)]
            self._agg_cursor += 1
            self._agg_in_flight.append((agg.add.remote(ref), idx, source))
            drained.append(idx)
            if runner is not None:
                self._in_flight[idx] = (runner.sample.remote(frag), runner)
        # Collect aggregator outputs that completed a batch.
        if self._agg_in_flight:
            by_ref = {ref: (idx, rn) for ref, idx, rn in self._agg_in_flight}
            done, pending = ray_tpu_torch.wait(
                list(by_ref.keys()),
                num_returns=len(by_ref),
                timeout=0.05,
            )
            self._agg_in_flight = [
                (r, by_ref[r][0], by_ref[r][1]) for r in pending
            ]
            for ref in done:
                try:
                    train_batch = ray_tpu_torch.get(ref)
                except Exception:
                    # The fragment was an error (runner died mid-sample).
                    # Kill/replace the source runner only if it is still the
                    # live runner at that index; stale refs from an already-
                    # replaced runner drain out without touching the
                    # replacement (otherwise one death churns every
                    # successor at this index forever).
                    idx, source = by_ref[ref]
                    current = group.remote_runners().get(idx)
                    if current is not None and current is source:
                        # Drop the sample ref re-armed on the dead runner so
                        # the replacement gets a fresh sample() next round.
                        pending_entry = self._in_flight.get(idx)
                        if pending_entry is not None and pending_entry[1] is source:
                            del self._in_flight[idx]
                        group.handle_failures([idx])
                    drained = [i for i in drained if i != idx]
                    continue
                if train_batch is None:
                    continue
                self._env_steps_total += train_batch.count
                if self._output_writer is not None:
                    self._output_writer.write(train_batch)
                # Bounded queue = backpressure: sampling throttles when the
                # learner falls behind, capping policy lag.
                self._queue.put(train_batch)
                enqueued += 1
        # Broadcast-on-consume: just-drained runners get the newest weights
        # the learner thread has published.
        if drained:
            with self._learner_lock:
                weights = self._fresh_weights
            group.sync_weights(
                weights,
                global_vars={"timestep": self._env_steps_total},
                to=sorted(set(drained)),
            )
        return enqueued

    def cleanup(self) -> None:
        self._stopping = True
        try:
            self._queue.put(None, timeout=1.0)
        except Exception:
            # Queue full: make room for the poison pill.
            try:
                self._queue.get_nowait()
                self._queue.put_nowait(None)
            except Exception:
                pass
        if getattr(self, "_learner_thread", None) is not None:
            self._learner_thread.join(timeout=5.0)
        for agg in self._aggregators:
            try:
                ray_tpu_torch.kill(agg)
            except Exception:
                pass
        self._aggregators = []
        self._in_flight = {}
        super().cleanup()
