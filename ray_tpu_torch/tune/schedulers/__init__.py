"""Trial schedulers.

Reference: tune/schedulers/ — ASHA (async_hyperband.py:17,185 _Bracket), PBT
(pbt.py:216 exploit/explore, _explore :49), MedianStopping
(median_stopping_rule.py), FIFO. Decisions returned to the controller:
CONTINUE / STOP / PAUSE.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Dict, Optional

from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.search.sample import Domain, LogUniform


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    PAUSE = "PAUSE"

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: Optional[str]) -> None:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode

    def _score(self, result: dict) -> float:
        value = result[self.metric]
        return value if self.mode == "max" else -value

    def on_trial_add(self, trial: Trial) -> None:
        pass

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        return TrialScheduler.CONTINUE

    def on_trial_complete(self, trial: Trial, result: Optional[dict]) -> None:
        pass

    def on_trial_remove(self, trial: Trial) -> None:
        pass

    def may_resume(self, trial: Trial) -> bool:
        """Whether the controller may restart this PAUSED trial now
        (synchronous schedulers hold rung members until the cohort lands)."""
        return True


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion in submission order."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py).

    Rung milestones at grace_period * reduction_factor^k; at each rung a trial
    stops unless it is in the top 1/reduction_factor of completed rung entries.
    Asynchronous: decisions use whatever results have arrived, no waiting for
    the full rung population.
    """

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
        brackets: int = 1,
    ):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestone -> list of recorded scores
        self._rungs: Dict[float, list] = defaultdict(list)
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t = math.ceil(t * reduction_factor)
        self._milestones = milestones

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return TrialScheduler.CONTINUE
        t = result[self.time_attr]
        if t >= self.max_t:
            return TrialScheduler.STOP
        score = self._score(result)
        decision = TrialScheduler.CONTINUE
        for milestone in self._milestones:
            if t >= milestone and milestone not in self._passed(trial):
                rung = self._rungs[milestone]
                rung.append(score)
                self._passed(trial).add(milestone)
                cutoff = self._cutoff(rung)
                if cutoff is not None and score < cutoff:
                    decision = TrialScheduler.STOP
        return decision

    def _passed(self, trial: Trial) -> set:
        if not hasattr(trial, "_asha_passed"):
            trial._asha_passed = set()
        return trial._asha_passed

    def _cutoff(self, rung: list) -> Optional[float]:
        if len(rung) < self.rf:
            return None  # not enough evidence yet
        q = 1.0 - 1.0 / self.rf
        s = sorted(rung)
        idx = int(q * (len(s) - 1))
        return s[idx]


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score falls below the median of running
    averages at the same step (reference: tune/schedulers/median_stopping_rule.py)."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._scores: Dict[str, list] = defaultdict(list)

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        if self.metric not in result:
            return TrialScheduler.CONTINUE
        t = result.get(self.time_attr, 0)
        self._scores[trial.trial_id].append(self._score(result))
        if t < self.grace_period or len(self._scores) < self.min_samples:
            return TrialScheduler.CONTINUE
        means = [sum(v) / len(v) for k, v in self._scores.items() if v]
        means.sort()
        median = means[len(means) // 2]
        own_best = max(self._scores[trial.trial_id])
        if own_best < median:
            return TrialScheduler.STOP
        return TrialScheduler.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py:216).

    Past each perturbation_interval, bottom-quantile trials EXPLOIT (restore
    the checkpoint of a random top-quantile trial) then EXPLORE (mutate
    hyperparameters: resample with prob `resample_probability`, else scale
    continuous values by 1.2/0.8). Requires checkpointable trainables; the
    controller performs the actual save/restore when it sees the decision.
    """

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        perturbation_interval: int = 5,
        hyperparam_mutations: Optional[dict] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}
        self._latest: Dict[str, float] = {}
        # trial_id -> (source_trial, new_config) set when exploit is due;
        # the controller pops and applies it.
        self.pending_exploits: Dict[str, tuple] = {}
        self._trials: Dict[str, Trial] = {}

    def on_trial_add(self, trial: Trial) -> None:
        self._trials[trial.trial_id] = trial

    def on_trial_remove(self, trial: Trial) -> None:
        self._trials.pop(trial.trial_id, None)
        self._latest.pop(trial.trial_id, None)

    def on_trial_complete(self, trial: Trial, result: Optional[dict]) -> None:
        self.on_trial_remove(trial)

    def _quantiles(self):
        scored = [
            (tid, self._latest[tid]) for tid in self._trials if tid in self._latest
        ]
        if len(scored) < 2:
            return [], []
        scored.sort(key=lambda kv: kv[1])
        n = max(1, int(len(scored) * self.quantile))
        bottom = [tid for tid, _ in scored[:n]]
        top = [tid for tid, _ in scored[-n:]]
        return bottom, top

    def _explore(self, config: dict) -> dict:
        new = dict(config)
        for key, mutation in self.mutations.items():
            current = new.get(key)
            if isinstance(mutation, Domain):
                if current is None or self._rng.random() < self.resample_prob:
                    new[key] = mutation.sample(self._rng)
                else:
                    new[key] = mutation.perturb(current, self._rng)
            elif isinstance(mutation, list):
                if current in mutation and self._rng.random() >= self.resample_prob:
                    # step to a neighbor value
                    i = mutation.index(current)
                    j = min(len(mutation) - 1, max(0, i + self._rng.choice([-1, 1])))
                    new[key] = mutation[j]
                else:
                    new[key] = self._rng.choice(mutation)
            elif callable(mutation):
                new[key] = mutation()
        return new

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        if self.metric not in result:
            return TrialScheduler.CONTINUE
        t = result.get(self.time_attr, 0)
        self._latest[trial.trial_id] = self._score(result)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return TrialScheduler.CONTINUE
        self._last_perturb[trial.trial_id] = t
        bottom, top = self._quantiles()
        if trial.trial_id in bottom and top:
            src_id = self._rng.choice(top)
            if src_id != trial.trial_id:
                src = self._trials[src_id]
                # Clone the source's config, then explore around it.
                new_config = self._explore(dict(src.config))
                self.pending_exploits[trial.trial_id] = (src, new_config)
        return TrialScheduler.CONTINUE


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference: tune/schedulers/hyperband.py).

    Trials are assigned round-robin to brackets of decreasing initial budget;
    within a bracket, successive-halving keeps the top 1/eta of trials each
    round and multiplies their budget by eta. Unlike ASHA, halving waits for
    the whole bracket cohort to reach the milestone (paused trials resume when
    the cohort decision lands), so no trial is judged on partial evidence.
    """

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        max_t: int = 81,
        reduction_factor: float = 3,
        brackets: int = 1,
    ):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        s_max = int(math.log(max_t) / math.log(reduction_factor))
        # Bracket b's cohort starts at budget max_t * eta^-(s_max - b):
        # bracket 0 explores most aggressively (smallest initial budget).
        self._bracket_budgets = [
            max(1, int(round(max_t * reduction_factor ** (-(s_max - b)))))
            for b in range(min(brackets, s_max + 1))
        ]
        self._next_bracket = 0
        # (bracket, milestone) -> {trial id: score at that milestone}; keying
        # by milestone keeps late-added trials out of veterans' rungs.
        self._cohorts: Dict[tuple, dict] = defaultdict(dict)
        self._bracket_of: Dict[str, int] = {}
        self._milestone_of: Dict[str, int] = {}
        self._trials: list = []
        # Cohort losers that were PAUSED when the halving decision landed;
        # they stop on their next report.
        self._doomed: set = set()
        # Rung members paused awaiting their cohort's halving decision.
        self._held: set = set()

    def on_trial_add(self, trial: Trial) -> None:
        bracket = self._next_bracket
        self._next_bracket = (self._next_bracket + 1) % len(self._bracket_budgets)
        self._bracket_of[trial.trial_id] = bracket
        self._milestone_of[trial.trial_id] = self._bracket_budgets[bracket]
        self._trials.append(trial)

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return TrialScheduler.CONTINUE
        if trial.trial_id in self._doomed:
            return TrialScheduler.STOP
        t = result[self.time_attr]
        if t >= self.max_t:
            return TrialScheduler.STOP
        milestone = self._milestone_of.get(trial.trial_id, self.max_t)
        if t < milestone:
            return TrialScheduler.CONTINUE
        bracket = self._bracket_of.get(trial.trial_id, 0)
        self._cohorts[(bracket, milestone)][trial.trial_id] = self._score(result)
        self._maybe_halve(bracket, milestone)
        if trial.trial_id in self._doomed:
            self._doomed.discard(trial.trial_id)
            return TrialScheduler.STOP
        if self._milestone_of.get(trial.trial_id, milestone) > milestone:
            return TrialScheduler.CONTINUE  # halving landed; promoted
        self._held.add(trial.trial_id)
        return TrialScheduler.PAUSE

    def _maybe_halve(self, bracket: int, milestone: int) -> None:
        """Run the rung's halving once every live member has reported.
        Trials added after a halving sit at a smaller milestone and form
        their own cohort (synchronous — the sole difference from ASHA)."""
        cohort = self._cohorts.get((bracket, milestone))
        if not cohort:
            return
        live = [
            tr.trial_id
            for tr in self._trials
            if self._bracket_of.get(tr.trial_id) == bracket
            and self._milestone_of.get(tr.trial_id) == milestone
            and tr.status not in (Trial.TERMINATED, Trial.ERROR)
        ] or list(cohort)
        if not all(tid in cohort for tid in live):
            return
        scores = sorted(cohort.values(), reverse=True)
        keep_n = max(1, int(len(scores) / self.eta))
        cutoff = scores[keep_n - 1]
        next_milestone = min(self.max_t, int(milestone * self.eta))
        for tid, score in cohort.items():
            self._milestone_of[tid] = next_milestone
            self._held.discard(tid)
            if score < cutoff:
                self._doomed.add(tid)
        del self._cohorts[(bracket, milestone)]

    def on_trial_complete(self, trial: Trial, result: Optional[dict]) -> None:
        # A member erroring/finishing must not deadlock its rung: drop it and
        # re-check whether the cohorts it gated can now halve. Terminal trials
        # also leave the tracking maps so long experiments don't grow them
        # (and _maybe_halve's live scan stays proportional to live trials).
        self._held.discard(trial.trial_id)
        self._doomed.discard(trial.trial_id)
        bracket = self._bracket_of.get(trial.trial_id)
        if bracket is None:
            return
        self._trials = [t for t in self._trials if t.trial_id != trial.trial_id]
        self._bracket_of.pop(trial.trial_id, None)
        self._milestone_of.pop(trial.trial_id, None)
        for (b, milestone) in list(self._cohorts):
            if b == bracket:
                self._cohorts[(b, milestone)].pop(trial.trial_id, None)
                self._maybe_halve(b, milestone)

    def may_resume(self, trial: Trial) -> bool:
        # Doomed trials resume (to receive their STOP); held rung members
        # wait for the cohort.
        return trial.trial_id not in self._held

    def on_trial_remove(self, trial: Trial) -> None:
        # The controller also routes PAUSE through removal — a paused trial's
        # milestone score must stay in the cohort or halving never fires.
        # Terminal removals go through on_trial_complete.
        if trial.status in (Trial.TERMINATED, Trial.ERROR):
            self.on_trial_complete(trial, None)


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand variant for BOHB (reference: tune/schedulers/hb_bohb.py).

    Two changes against plain HyperBand, both serving the paired TuneBOHB
    searcher's per-budget models:

      * brackets fill SEQUENTIALLY, not round-robin — each bracket's cohort
        then shares an initial budget, so rung observations are
        budget-comparable when they reach the searcher;
      * the controller's searcher coupling does the rest: every result is
        routed to TuneBOHB.on_trial_result, which buckets scores by the
        rung milestones this scheduler runs (same max_t/reduction_factor).

    Construct both halves with the same max_t and reduction_factor.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._bracket_fill = 0  # trials assigned to the current bracket
        self._bracket_capacity = [
            # Successive-halving cohort size: bracket b starts eta^(rungs)
            # trials where rungs = number of halvings to reach max_t.
            max(
                1,
                int(
                    round(
                        self.eta
                        ** max(
                            0,
                            round(
                                math.log(self.max_t / budget)
                                / math.log(self.eta)
                            ),
                        )
                    )
                ),
            )
            for budget in self._bracket_budgets
        ]

    def on_trial_add(self, trial: Trial) -> None:
        bracket = self._next_bracket
        self._bracket_fill += 1
        if self._bracket_fill >= self._bracket_capacity[bracket]:
            self._bracket_fill = 0
            self._next_bracket = (
                self._next_bracket + 1
            ) % len(self._bracket_budgets)
        self._bracket_of[trial.trial_id] = bracket
        self._milestone_of[trial.trial_id] = self._bracket_budgets[bracket]
        self._trials.append(trial)


class ResourceChangingScheduler(TrialScheduler):
    """Re-pack running trials onto freed capacity
    (reference: tune/schedulers/resource_changing_scheduler.py).

    Wraps a base scheduler; after each result the
    `resources_allocation_function(controller, trial, result, scheduler)`
    may return a new resource request for the trial. A changed request
    PAUSES the trial (checkpointing it); the controller applies the pending
    request when the trial resumes, so the fresh actor is created at the
    new size. On GPUs this is the utilization story: a finished trial frees
    its share of a card and survivors grow into it.
    """

    def __init__(
        self,
        base_scheduler: Optional[TrialScheduler] = None,
        resources_allocation_function=None,
    ):
        self.base = base_scheduler or FIFOScheduler()
        super().__init__(self.base.metric, self.base.mode)
        self.alloc_fn = resources_allocation_function
        # trial_id -> resources dict, applied by the controller at resume.
        self.pending_resources: Dict[str, dict] = {}
        self._controller = None  # injected by the controller at run start

    def set_controller(self, controller) -> None:
        self._controller = controller

    def set_search_properties(self, metric, mode) -> None:
        super().set_search_properties(metric, mode)
        self.base.set_search_properties(metric, mode)

    def on_trial_add(self, trial: Trial) -> None:
        self.base.on_trial_add(trial)

    def on_trial_remove(self, trial: Trial) -> None:
        self.base.on_trial_remove(trial)

    def on_trial_complete(self, trial: Trial, result: Optional[dict]) -> None:
        self.base.on_trial_complete(trial, result)

    def may_resume(self, trial: Trial) -> bool:
        return self.base.may_resume(trial)

    @property
    def pending_exploits(self):
        # PBT bases surface their exploits through the wrapper.
        return getattr(self.base, "pending_exploits", None)

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        decision = self.base.on_trial_result(trial, result)
        if decision != TrialScheduler.CONTINUE or self.alloc_fn is None:
            return decision
        try:
            new = self.alloc_fn(self._controller, trial, result, self)
        except Exception:
            return decision
        if new and dict(new) != dict(trial.resources):
            self.pending_resources[trial.trial_id] = dict(new)
            return TrialScheduler.PAUSE
        return decision


class DistributeResources:
    """Default allocation policy: grow each live trial's CPU/GPU request to
    an even share of the cluster total (the reference's
    DistributeResources). Shrinks never below the base request."""

    def __init__(self, base_resources: Optional[dict] = None):
        self.base = dict(base_resources or {"CPU": 1.0})

    def __call__(self, controller, trial, result, scheduler):
        import ray_tpu_torch

        total = ray_tpu_torch.cluster_resources()
        live = max(1, len(getattr(controller, "_live", {}) or {1: 1}))
        new = dict(trial.resources)
        for key in ("CPU", "GPU"):
            if key not in total:
                continue
            base = self.base.get(key, 0.0)
            if not base and not new.get(key):
                continue
            share = math.floor(total[key] / live)
            new[key] = max(base, float(share))
        return new


class PB2(PopulationBasedTraining):
    """PBT with a GP-bandit explore step (reference: tune/schedulers/pb2.py,
    Parker-Holder et al. 2020). Instead of random 1.2x/0.8x perturbation,
    the continuous hyperparameters of the exploited config are chosen by
    UCB over a Gaussian-process fit to (hyperparams -> observed score
    improvement) across the population's recent perturbation windows.
    Implemented natively (no GPy or sklearn dependency): an RBF-kernel
    GP on normalized inputs with a small jitter, UCB argmax over sampled
    candidates. Non-continuous mutations fall back to PBT's explore."""

    def __init__(self, *args, ucb_kappa: float = 2.0, n_candidates: int = 64,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.ucb_kappa = ucb_kappa
        self.n_candidates = n_candidates
        # (hyperparam vector, score delta) observations per continuous key set
        self._gp_data: list = []
        self._prev_score: Dict[str, float] = {}

    # -- data collection ----------------------------------------------------

    def _continuous_keys(self) -> list:
        # Only genuinely continuous domains ride the GP: Randint/QUniform
        # values must stay integral/quantized, so they keep PBT's explore.
        from ray_tpu_torch.tune.search.sample import Uniform

        return sorted(
            key for key, m in self.mutations.items()
            if isinstance(m, (Uniform, LogUniform))
        )

    def _bounds(self, key):
        m = self.mutations[key]
        import math as _math

        if isinstance(m, LogUniform):
            return _math.log(m.lower), _math.log(m.upper), True
        return float(m.lower), float(m.upper), False

    def _vec(self, config: dict) -> list:
        import math as _math

        out = []
        for key in self._continuous_keys():
            lo, hi, logspace = self._bounds(key)
            v = float(config.get(key, (lo + hi) / 2.0))
            if logspace:
                v = _math.log(max(v, 1e-300))
            out.append((v - lo) / max(hi - lo, 1e-12))
        return out

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        if self.metric in result:
            tid = trial.trial_id
            score = self._score(result)
            prev = self._prev_score.get(tid)
            if prev is not None:
                self._gp_data.append((self._vec(trial.config), score - prev))
                # Recent-window cap keeps the GP solve cheap (n^3) and the
                # model focused on the current training phase (the PB2
                # paper's time-varying treatment, simplified to a window).
                if len(self._gp_data) > 64:
                    self._gp_data = self._gp_data[-64:]
            self._prev_score[tid] = score
        return super().on_trial_result(trial, result)

    # -- GP-UCB explore ------------------------------------------------------

    def _explore(self, config: dict) -> dict:
        keys = self._continuous_keys()
        if len(self._gp_data) < 4 or not keys:
            return super()._explore(config)
        new = super()._explore(config)  # categorical/fallback mutations
        best = self._ucb_argmax()
        if best is None:
            return new
        import math as _math

        for key, unit in zip(keys, best):
            lo, hi, logspace = self._bounds(key)
            v = lo + unit * (hi - lo)
            new[key] = _math.exp(v) if logspace else v
        return new

    def _ucb_argmax(self):
        import numpy as np

        data = self._gp_data
        n = len(data)
        xs = np.asarray([x for x, _ in data], dtype=np.float64)  # [n, d]
        ys = np.asarray([y for _, y in data], dtype=np.float64)
        sd = ys.std() or 1.0
        ys_n = (ys - ys.mean()) / sd
        ls = 0.3  # RBF lengthscale in normalized space
        noise = 1e-2
        d2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
        K = np.exp(-0.5 * d2 / (ls * ls)) + noise * np.eye(n)
        try:
            chol = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return None
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, ys_n))

        dims = xs.shape[1]
        cands = np.asarray(
            [[self._rng.random() for _ in range(dims)]
             for _ in range(self.n_candidates)]
        )  # [m, d]
        kv = np.exp(
            -0.5 * ((cands[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
            / (ls * ls)
        )  # [m, n]
        mu = kv @ alpha
        v = np.linalg.solve(chol, kv.T)  # [n, m]
        var = np.maximum(1.0 - (v * v).sum(0), 1e-9)
        ucb = mu + self.ucb_kappa * np.sqrt(var)
        return cands[int(ucb.argmax())].tolist()
