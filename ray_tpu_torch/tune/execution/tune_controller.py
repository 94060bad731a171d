"""TuneController: the experiment event loop.

Reference: tune/execution/tune_controller.py (:49 TuneController, step :267) —
an event loop that (1) asks the searcher for new configs and starts trial
actors while resources allow, (2) consumes trial results as they arrive,
(3) routes them through the scheduler (CONTINUE/STOP/PAUSE), (4) applies PBT
exploit/explore via save/restore on the trial actors, (5) snapshots experiment
state for resume (tune/execution/experiment_state.py).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search.searcher import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trainable import DONE, Trainable


class _TrialRunner:
    """Actor hosting one Trainable instance (reference: the trial actor —
    Trainable IS the actor class upstream; we wrap so user classes need no
    actor decoration)."""

    def __init__(self, trainable_cls: type, config: dict, trial_id: str):
        # Set trial_id on the instance BEFORE __init__ (setup() reads it);
        # a class attribute would race across concurrently-built trials in
        # the in-process runtime.
        trainable = trainable_cls.__new__(trainable_cls)
        trainable.trial_id = trial_id
        trainable.__init__(config)
        self._trainable: Trainable = trainable

    def train(self) -> dict:
        return self._trainable.train()

    def save(self) -> dict:
        return self._trainable.save()

    def restore(self, state: dict) -> None:
        self._trainable.restore(state)

    def reset(self, config: dict) -> bool:
        return self._trainable.reset(config)

    def stop(self) -> None:
        self._trainable.stop()


class TuneController:
    def __init__(
        self,
        trainable_cls: type,
        *,
        param_space: Optional[dict] = None,
        searcher: Optional[Searcher] = None,
        scheduler: Optional[TrialScheduler] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        num_samples: int = 1,
        stop: Optional[dict] = None,
        max_concurrent_trials: Optional[int] = None,
        resources_per_trial: Optional[dict] = None,
        max_failures: int = 0,
        checkpoint_at_end: bool = False,
        experiment_dir: str = "",
        seed: Optional[int] = None,
        reuse_actors: bool = False,
        callbacks: Optional[list] = None,
        checkpoint_frequency: int = 0,
        seed_trials: Optional[list] = None,
    ):
        self._trainable_cls = trainable_cls
        # With a user searcher, num_samples caps the number of suggestions
        # (reference: tune.run num_samples semantics); the default
        # grid/random generator bakes num_samples into the variant stream.
        self._suggest_cap = num_samples if searcher is not None else None
        self._searcher = searcher or BasicVariantGenerator(
            param_space or {}, num_samples=num_samples, seed=seed
        )
        self._searcher.set_search_properties(metric, mode, param_space or {})
        self._scheduler = scheduler or FIFOScheduler(metric, mode)
        self._scheduler.set_search_properties(metric, mode)
        if hasattr(self._scheduler, "set_controller"):
            # ResourceChangingScheduler's allocation function inspects the
            # controller (live trials, cluster headroom).
            self._scheduler.set_controller(self)
        self.metric = metric
        self.mode = mode
        self._stop_criteria = stop or {}
        self._max_concurrent = max_concurrent_trials or 0
        self._resources = resources_per_trial or {"CPU": 1.0}
        self._max_failures = max_failures
        self._checkpoint_at_end = checkpoint_at_end
        self._experiment_dir = experiment_dir or os.path.join(
            os.path.expanduser("~/ray_tpu_torch_results"), f"exp_{int(time.time())}"
        )
        os.makedirs(self._experiment_dir, exist_ok=True)
        self._reuse_actors = reuse_actors
        self._callbacks = callbacks or []
        self._checkpoint_frequency = checkpoint_frequency

        self.trials: List[Trial] = []
        self._live: Dict[str, Trial] = {}  # trial_id -> trial with future
        self._idle_actors: list = []  # for reuse_actors
        self._exhausted = False
        # trial_id -> the Checkpoint last pickled into its trial directory.
        self._pickled: Dict[str, Checkpoint] = {}
        # Restored experiments seed unfinished trials: (config, ckpt_dict|None).
        for config, ckpt in seed_trials or []:
            trial = Trial(
                trainable_cls.__name__,
                config,
                trial_id=f"t{len(self.trials):05d}",
                experiment_dir=self._experiment_dir,
                resources=dict(self._resources),
                max_failures=max_failures,
            )
            if ckpt is not None:
                trial.checkpoint = Checkpoint.from_dict(ckpt)
            self.trials.append(trial)
            self._scheduler.on_trial_add(trial)

    # -- lifecycle -------------------------------------------------------

    def _next_trial(self) -> Optional[Trial]:
        if self._exhausted:
            return None
        if self._suggest_cap is not None and len(self.trials) >= self._suggest_cap:
            self._exhausted = True
            return None
        if hasattr(self._searcher, "is_saturated") and self._searcher.is_saturated():
            return None
        trial_id = f"t{len(self.trials):05d}"
        config = self._searcher.suggest(trial_id)
        if config is None:
            # None while not saturated means the space is exhausted.
            saturated = getattr(self._searcher, "is_saturated", lambda: False)()
            self._exhausted = not saturated
            return None
        trial = Trial(
            self._trainable_cls.__name__,
            config,
            trial_id=trial_id,
            experiment_dir=self._experiment_dir,
            resources=dict(self._resources),
            max_failures=self._max_failures,
        )
        self.trials.append(trial)
        self._scheduler.on_trial_add(trial)
        for cb in self._callbacks:
            cb.on_trial_start(trial) if hasattr(cb, "on_trial_start") else None
        return trial

    def _has_resources(self, trial: Trial) -> bool:
        avail = ray_tpu_torch.available_resources()
        return all(avail.get(k, 0.0) >= v for k, v in trial.resources.items())

    def _actor_options(self, trial: Trial) -> dict:
        return {
            "num_cpus": trial.resources.get("CPU", 0.0),
            "num_gpus": trial.resources.get("GPU", 0.0),
            "resources": {
                k: v for k, v in trial.resources.items() if k not in ("CPU", "GPU")
            },
        }

    def _create_actor(self, trial: Trial):
        actor_cls = ray_tpu_torch.remote(_TrialRunner).options(**self._actor_options(trial))
        return actor_cls.remote(self._trainable_cls, trial.config, trial.trial_id)

    def _start_trial(self, trial: Trial) -> None:
        # A resized trial (ResourceChangingScheduler, applied in step()'s
        # admission path) must get a FRESH actor at the new size.
        resized = getattr(trial, "_no_actor_reuse", False)
        trial._no_actor_reuse = False
        if not resized and self._reuse_actors and self._idle_actors:
            actor = self._idle_actors.pop()
            ok = ray_tpu_torch.get(actor.reset.remote(trial.config))
            if ok:
                trial.actor = actor
                trial.set_status(Trial.RUNNING)
                trial.future = actor.train.remote()
                self._live[trial.trial_id] = trial
                return
            ray_tpu_torch.kill(actor)
        trial.actor = self._create_actor(trial)
        # PAUSED and restored-from-disk trials resume from their checkpoint.
        if trial.checkpoint is not None:
            ray_tpu_torch.get(trial.actor.restore.remote(trial.checkpoint.to_dict()))
        trial.set_status(Trial.RUNNING)
        trial.future = trial.actor.train.remote()
        self._live[trial.trial_id] = trial

    def _stop_trial(self, trial: Trial, status: str, save_final: bool = False) -> None:
        if trial.actor is not None:
            try:
                if save_final and self._checkpoint_at_end:
                    trial.checkpoint = Checkpoint.from_dict(
                        ray_tpu_torch.get(trial.actor.save.remote())
                    )
                ray_tpu_torch.get(trial.actor.stop.remote())
            except Exception:
                pass
            if self._reuse_actors and status == Trial.TERMINATED:
                self._idle_actors.append(trial.actor)
            else:
                try:
                    ray_tpu_torch.kill(trial.actor)
                except Exception:
                    pass
            trial.actor = None
        trial.future = None
        trial.set_status(status)
        self._live.pop(trial.trial_id, None)
        self._scheduler.on_trial_remove(trial)

    # -- stop criteria ---------------------------------------------------

    def _should_stop(self, result: dict) -> bool:
        if result.get(DONE):
            return True
        # Reference semantics (tune/stopper.py dict stopper): stop when
        # result[key] >= threshold, independent of the optimization mode.
        for key, threshold in self._stop_criteria.items():
            if key in result and result[key] >= threshold:
                return True
        return False

    # -- PBT exploit -----------------------------------------------------

    def _apply_exploits(self) -> None:
        pending = getattr(self._scheduler, "pending_exploits", None)
        if not pending:
            return
        for target_id, (src, new_config) in list(pending.items()):
            pending.pop(target_id)
            target = next(
                (t for t in self.trials if t.trial_id == target_id), None
            )
            if target is None or src.actor is None or target.actor is None:
                continue
            # Rendezvous: both actors are between train() calls for the target;
            # src may be mid-train — save() queues behind it (ordered actor queue).
            state = ray_tpu_torch.get(src.actor.save.remote())
            target.config = new_config
            reset_ok = ray_tpu_torch.get(target.actor.reset.remote(new_config))
            if not reset_ok:
                # Restart the actor with the new config, then restore weights.
                # The pending train() future on the old actor dies with it —
                # resubmit on the new actor so the controller never consumes a
                # stale ref (that would read as a spurious trial failure).
                # The old actor's loop is stopped before the kill (after its
                # pending train() returns): killed alone, its runner thread
                # and a trainer-backed trial's fit would run on unseen.
                try:
                    ray_tpu_torch.get(target.actor.stop.remote())
                except Exception:
                    pass
                ray_tpu_torch.kill(target.actor)
                target.actor = self._create_actor(target)
                ray_tpu_torch.get(target.actor.restore.remote(state))
                if target.trial_id in self._live:
                    target.future = target.actor.train.remote()
            else:
                ray_tpu_torch.get(target.actor.restore.remote(state))

    # -- main loop -------------------------------------------------------

    def step(self, timeout: float = 10.0) -> bool:
        """One controller tick. Returns False when the experiment is over."""
        # 1. Launch new trials while capacity allows.
        while True:
            if self._max_concurrent and len(self._live) >= self._max_concurrent:
                break
            candidate = next(
                (
                    t
                    for t in self.trials
                    if t.status == Trial.PENDING
                    or (
                        t.status == Trial.PAUSED
                        # Synchronous schedulers (HyperBand) hold paused
                        # trials at a rung until the cohort decision lands.
                        and self._scheduler.may_resume(t)
                    )
                ),
                None,
            )
            if candidate is None:
                candidate = self._next_trial()
            if candidate is None:
                break
            # Apply a pending ResourceChangingScheduler resize BEFORE the
            # admission check: admitting against the stale size could start
            # an actor the cluster can't place and block the event loop on
            # its restore.
            pending_resources = getattr(
                self._scheduler, "pending_resources", None
            )
            if pending_resources and candidate.trial_id in pending_resources:
                candidate.resources = dict(
                    pending_resources.pop(candidate.trial_id)
                )
                candidate._no_actor_reuse = True
            if not self._has_resources(candidate) and self._live:
                break  # wait for a slot; if nothing live, start anyway (queue)
            self._start_trial(candidate)

        if not self._live:
            return False

        # 2. Wait for any trial result, then harvest everything already ready —
        # processing only the first ready future would starve later trials
        # (their 1-deep report queues park the runner threads).
        futures = {t.future: t for t in self._live.values() if t.future is not None}
        ready, rest = ray_tpu_torch.wait(
            list(futures.keys()), num_returns=1, timeout=timeout
        )
        if ready and rest:
            more, _ = ray_tpu_torch.wait(rest, num_returns=len(rest), timeout=0)
            ready = ready + more
        for ref in ready:
            trial = futures[ref]
            try:
                result = ray_tpu_torch.get(ref)
            except Exception as e:
                trial.num_failures += 1
                trial.error_msg = repr(e)
                if trial.should_recover():
                    self._restart_trial(trial)
                else:
                    self._stop_trial(trial, Trial.ERROR)
                    self._searcher.on_trial_complete(trial.trial_id, error=True)
                    self._scheduler.on_trial_complete(trial, None)
                continue

            trial.error_msg = None  # recovered if previously failed
            trial.last_result = result
            trial.results.append(result)
            trial.iteration = result.get("training_iteration", trial.iteration + 1)
            self._searcher.on_trial_result(trial.trial_id, result)
            for cb in self._callbacks:
                if hasattr(cb, "on_trial_result"):
                    cb.on_trial_result(trial, result)

            if self._should_stop(result):
                self._stop_trial(trial, Trial.TERMINATED, save_final=True)
                self._searcher.on_trial_complete(trial.trial_id, result)
                self._scheduler.on_trial_complete(trial, result)
                continue

            # Periodic checkpointing (CheckpointConfig.checkpoint_frequency).
            if (
                self._checkpoint_frequency
                and trial.iteration % self._checkpoint_frequency == 0
            ):
                trial.checkpoint = Checkpoint.from_dict(
                    ray_tpu_torch.get(trial.actor.save.remote())
                )

            decision = self._scheduler.on_trial_result(trial, result)
            if decision == TrialScheduler.STOP:
                self._stop_trial(trial, Trial.TERMINATED, save_final=True)
                self._searcher.on_trial_complete(trial.trial_id, result)
                self._scheduler.on_trial_complete(trial, result)
            elif decision == TrialScheduler.PAUSE:
                state = ray_tpu_torch.get(trial.actor.save.remote())
                trial.checkpoint = Checkpoint.from_dict(state)
                self._stop_trial(trial, Trial.PAUSED)
            else:
                trial.future = trial.actor.train.remote()

        # 3. PBT exploits after the batch of results.
        self._apply_exploits()

        # 4. Periodic experiment-state snapshot.
        self._save_experiment_state()
        return True

    def _restart_trial(self, trial: Trial) -> None:
        try:
            if trial.actor is not None:
                ray_tpu_torch.kill(trial.actor)
        except Exception:
            pass
        state = trial.checkpoint.to_dict() if trial.checkpoint else None
        trial.actor = self._create_actor(trial)
        if state is not None:
            ray_tpu_torch.get(trial.actor.restore.remote(state))
        trial.future = trial.actor.train.remote()
        trial.set_status(Trial.RUNNING)
        self._live[trial.trial_id] = trial

    def run(self) -> List[Trial]:
        while self.step():
            pass
        self._save_experiment_state()
        return self.trials

    def train_run_reports(self, rounds_limit: int = 8) -> Dict[str, list]:
        """Per-trial training telemetry. Trainer-backed trials
        (DataParallelTrainer.as_trainable) register their fit's round
        records under the trial id, so trial rounds reuse the SAME records
        the train profiler produced — one telemetry plane for standalone
        fits and tuned ones. Trials may fit more than once (failure
        retries, PBT exploits), hence a list per trial."""
        from ray_tpu_torch.train.observability import list_runs

        trial_ids = {t.trial_id for t in self.trials}
        out: Dict[str, list] = {}
        for run in list_runs(limit=len(trial_ids) * 4 + 8, rounds_limit=rounds_limit):
            if run["name"] in trial_ids:
                out.setdefault(run["name"], []).append(run)
        return out

    # -- experiment state ------------------------------------------------

    def _save_experiment_state(self) -> None:
        path = os.path.join(self._experiment_dir, "experiment_state.json")
        # A temporary name of this writer's own: two controllers that share
        # a directory (two runs started within one second on the default
        # root) never replace each other's half-written file.
        tmp = f"{path}.{os.getpid()}.{id(self):x}.tmp"
        with open(tmp, "w") as f:
            json.dump({"trials": [t.metadata() for t in self.trials]}, f)
        os.replace(tmp, path)
        # Checkpoints for resumable trials (pickle: configs may be non-JSON).
        # A trial's file is rewritten only when its checkpoint changed: the
        # bytes are the same, and a trainer's checkpoint can be ~1.5 GB.
        for t in self.trials:
            if t.checkpoint is not None and self._pickled.get(t.trial_id) is not t.checkpoint:
                with open(os.path.join(t.local_dir, "checkpoint.pkl"), "wb") as f:
                    pickle.dump(t.checkpoint.to_dict(), f)
                self._pickled[t.trial_id] = t.checkpoint
