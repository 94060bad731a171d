"""EnvRunnerGroup — the WorkerSet of env-runner actors, fault-tolerant.

Reference: rllib/evaluation/worker_set.py:80 (WorkerSet; sync_weights :356;
fault-tolerant foreach_worker* :648-748) + rllib/utils/actor_manager.py:189
(FaultTolerantActorManager). Failed runners are dropped from the active set
and asynchronously recreated (restored from the latest weights), preserving
the reference's "ignore_env_runner_failures / recreate_failed_env_runners"
semantics.
"""

from __future__ import annotations

from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch.rllib.evaluation.env_runner import EnvRunner, RemoteEnvRunner
from ray_tpu_torch.rllib.env.env import MultiAgentEnv, make_env
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch, concat_samples


_PROBE_CACHE: dict = {}


def is_multi_agent_env(env_spec, env_config) -> bool:
    """Class-check without instantiation when the spec is a class; registered
    names/callables are probed once and cached (envs may bind simulators or
    sockets — don't pay that per worker-group construction). A copy of the
    JAX package's (evaluation/multi_agent_runner.py), whose runners are not
    ported."""
    if isinstance(env_spec, type):
        return issubclass(env_spec, MultiAgentEnv)
    key = None
    try:
        # str specs key by value; callables by identity (the cache holds the
        # callable, keeping its id stable).
        key = (env_spec, repr(sorted((env_config or {}).items())))
        if key in _PROBE_CACHE:
            return _PROBE_CACHE[key]
    except TypeError:
        key = None  # unhashable spec: probe every time
    probe = make_env(env_spec, env_config)
    result = isinstance(probe, MultiAgentEnv)
    probe.close()
    if key is not None:
        _PROBE_CACHE[key] = result
    return result


class EnvRunnerGroup:
    def __init__(self, config, local: bool = True):
        self.config = config
        self.num_workers = int(getattr(config, "num_env_runners", 0) or 0)
        self.local_runner: Optional[EnvRunner] = None
        self._remote: dict[int, Any] = {}
        self._weights: Any = None
        self._global_filter_stat = None
        # Multi-agent sampling (the shared-policy and per-policy runners) is
        # not ported yet.
        if getattr(config, "policies", None) or is_multi_agent_env(
            config.env, getattr(config, "env_config", None) or {}
        ):
            raise NotImplementedError(
                "multi-agent envs and policies are not ported yet: "
                "ray_tpu_torch.rllib samples single-agent envs only (ROADMAP.md §B9)"
            )
        self._runner_cls = EnvRunner
        self._remote_runner_cls = RemoteEnvRunner
        if local or self.num_workers == 0:
            self.local_runner = self._runner_cls(config, worker_index=0)
        for i in range(1, self.num_workers + 1):
            self._remote[i] = self._make_remote(i)

    def _make_remote(self, index: int):
        opts = {"num_cpus": getattr(self.config, "num_cpus_per_env_runner", 1)}
        return self._remote_runner_cls.options(
            max_restarts=0, **opts
        ).remote(self.config, index)

    # -- sampling ---------------------------------------------------------

    def sample(self, num_steps: Optional[int] = None) -> SampleBatch:
        """Synchronous parallel sample across all runners (reference:
        rllib/execution/rollout_ops.py:21 synchronous_parallel_sample)."""
        if not self._remote:
            return self.local_runner.sample(num_steps)
        refs = {
            idx: runner.sample.remote(num_steps)
            for idx, runner in self._remote.items()
        }
        batches, failed = [], []
        for idx, ref in refs.items():
            try:
                batches.append(ray_tpu_torch.get(ref, timeout=300.0))
            except Exception:
                failed.append(idx)
        self._handle_failures(failed)
        if not batches:
            raise RuntimeError("All env runners failed to sample")
        return concat_samples(batches)

    def sample_async(self, num_steps: Optional[int] = None) -> dict:
        """Kick off sampling on every remote runner; {index: ObjectRef}."""
        return {
            idx: runner.sample.remote(num_steps)
            for idx, runner in self._remote.items()
        }

    def _handle_failures(self, failed: list) -> None:
        restore = getattr(self.config, "restart_failed_env_runners", True)
        if not failed:
            return
        for idx in failed:
            try:
                ray_tpu_torch.kill(self._remote[idx])
            except Exception:
                pass
            del self._remote[idx]
            if restore:
                runner = self._make_remote(idx)
                if self._weights is not None:
                    # ray-tpu: lint-ignore[RTL401] fire-and-forget weight
                    # seed for the replacement runner; a failed push just
                    # means stale weights until the next sync_weights
                    runner.set_weights.remote(self._weights)
                self._remote[idx] = runner

    # -- weights ----------------------------------------------------------

    def sync_weights(
        self,
        weights: Any,
        global_vars: Optional[dict] = None,
        to: Optional[list] = None,
    ) -> None:
        """Broadcast learner weights (and global vars like the cluster-wide
        timestep) to runners. The weights ref is put once and shared
        (reference worker_set.py:356). `to` restricts the push to specific
        remote runner indices (IMPALA's broadcast-on-consume)."""
        self._weights = weights
        if self.local_runner is not None:
            self.local_runner.set_weights(weights, global_vars)
        targets = self._remote if to is None else {
            i: self._remote[i] for i in to if i in self._remote
        }
        if targets:
            ref = ray_tpu_torch.put(weights)
            for runner in targets.values():
                # ray-tpu: lint-ignore[RTL401] broadcast is deliberately
                # fire-and-forget (reference WorkerSet does the same);
                # runner failures surface on the next sample() poll
                runner.set_weights.remote(ref, global_vars)
        self._sync_obs_filters(to)

    def _sync_obs_filters(self, to: Optional[list] = None) -> None:
        """Merge per-runner observation-filter deltas into the global stat
        and broadcast it (reference: WorkerSet filter synchronization via
        utils/filter.py apply_changes). Restricted to `to` when given —
        querying a runner with a sample() in flight would serialize async
        pipelines behind the slowest fragment."""
        if getattr(self.config, "observation_filter", None) in (None, "NoFilter"):
            return
        from ray_tpu_torch.rllib.connectors import RunningStat

        targets = self._remote if to is None else {
            i: self._remote[i] for i in to if i in self._remote
        }
        deltas = []
        if self.local_runner is not None:
            deltas.append(self.local_runner.get_filter_delta())
        failed = []
        refs = [(idx, r.get_filter_delta.remote()) for idx, r in targets.items()]
        for idx, ref in refs:
            try:
                deltas.append(ray_tpu_torch.get(ref, timeout=120.0))
            except Exception:
                failed.append(idx)
        self._handle_failures(failed)
        deltas = [d for d in deltas if d]
        if not deltas:
            return
        if self._global_filter_stat is None:
            self._global_filter_stat = RunningStat(deltas[0]["shape"])
        for delta in deltas:
            self._global_filter_stat.merge(RunningStat.from_state(delta))
        state = self._global_filter_stat.to_state()
        if self.local_runner is not None:
            self.local_runner.set_filter_state(state)
        for runner in targets.values():
            # ray-tpu: lint-ignore[RTL401] filter-state broadcast is
            # fire-and-forget; stats re-merge on the next delta sweep
            runner.set_filter_state.remote(state)

    def get_filter_state(self) -> Optional[dict]:
        """Authoritative filter stat for checkpointing (deltas flushed)."""
        self._sync_obs_filters()
        if self._global_filter_stat is None:
            return None
        return self._global_filter_stat.to_state()

    def set_filter_state(self, state: Optional[dict]) -> None:
        if state is None:
            return
        from ray_tpu_torch.rllib.connectors import RunningStat

        self._global_filter_stat = RunningStat.from_state(state)
        if self.local_runner is not None:
            self.local_runner.set_filter_state(state)
        for runner in self._remote.values():
            # ray-tpu: lint-ignore[RTL401] checkpoint-restore broadcast is
            # fire-and-forget; stats re-merge on the next delta sweep
            runner.set_filter_state.remote(state)

    def remote_runners(self) -> dict:
        """Live remote runners keyed by worker index (read-only view)."""
        return dict(self._remote)

    def handle_failures(self, failed: list) -> None:
        self._handle_failures(failed)

    # -- metrics / map ----------------------------------------------------

    def foreach_worker(self, fn_name: str, *args, local: bool = True) -> list:
        out = []
        if local and self.local_runner is not None:
            out.append(getattr(self.local_runner, fn_name)(*args))
        refs, failed = [], []
        for idx, runner in self._remote.items():
            refs.append((idx, getattr(runner, fn_name).remote(*args)))
        for idx, ref in refs:
            try:
                out.append(ray_tpu_torch.get(ref, timeout=120.0))
            except Exception:
                failed.append(idx)
        self._handle_failures(failed)
        return out

    def collect_metrics(self) -> dict:
        """Aggregate drained episode stats across runners."""
        import numpy as np

        metrics = self.foreach_worker("get_metrics")
        returns = [r for m in metrics for r in m["episode_returns"]]
        lengths = [l for m in metrics for l in m["episode_lengths"]]
        steps = sum(m["num_env_steps_sampled"] for m in metrics)
        out = {
            "num_env_steps_sampled_total": steps,
            "episodes_this_iter": len(returns),
        }
        if returns:
            out["episode_return_mean"] = float(np.mean(returns))
            out["episode_return_max"] = float(np.max(returns))
            out["episode_return_min"] = float(np.min(returns))
            out["episode_len_mean"] = float(np.mean(lengths))
        return out

    def num_healthy_workers(self) -> int:
        return len(self._remote) + (1 if self.local_runner else 0)

    def stop(self) -> None:
        if self.local_runner is not None:
            self.local_runner.stop()
        for runner in self._remote.values():
            try:
                ray_tpu_torch.kill(runner)
            except Exception:
                pass
        self._remote = {}
