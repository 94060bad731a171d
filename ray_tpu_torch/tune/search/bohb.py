"""Native BOHB searcher: multi-fidelity TPE (Falkner et al. 2018).

The reference reaches BOHB through an adapter over HpBandSter
(tune/search/bohb/bohb_search.py, ConfigSpace-based KDEs) paired with the
HyperBandForBOHB scheduler (tune/schedulers/hb_bohb.py). The package
depends on neither hpbandster nor ConfigSpace, so this is the algorithm itself on the same
Searcher ABC, reusing the native TPE kernel-density machinery (tpe.py):

  * observations are bucketed by RUNG BUDGET (the HyperBand milestones of
    the paired scheduler: max_t * eta^-k);
  * suggest() builds the TPE good/bad split from the HIGHEST budget that has
    enough observations — BOHB's core idea: model the most informative
    fidelity available, fall back toward cheaper fidelities, and to random
    sampling before any rung has data;
  * a `random_fraction` of suggestions stays random regardless (the BOHB
    paper's guard against model collapse).

Pair with `ray_tpu_torch.tune.schedulers.HyperBandForBOHB`, which fills brackets
sequentially so rung cohorts are budget-comparable.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.search.sample import Choice, Randint
from ray_tpu_torch.tune.search.tpe import (
    _CONTINUOUS,
    _CategoricalDim,
    _ContinuousDim,
    tpe_best_candidate,
)
from ray_tpu_torch.tune.search.variant_generator import generate_variants


class TuneBOHB(Searcher):
    def __init__(
        self,
        space: dict,
        metric: Optional[str] = None,
        mode: str = "max",
        max_t: int = 81,
        reduction_factor: float = 3,
        time_attr: str = "training_iteration",
        min_points_in_model: Optional[int] = None,
        gamma: float = 0.25,
        n_candidates: int = 24,
        random_fraction: float = 1.0 / 3.0,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self._space = space
        self.time_attr = time_attr
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._random_fraction = random_fraction
        self._rng = random.Random(seed)
        self._dims: Dict[str, object] = {}
        for key, domain in space.items():
            if isinstance(domain, _CONTINUOUS):
                self._dims[key] = _ContinuousDim(domain)
            elif isinstance(domain, Randint):
                if domain.upper - domain.lower <= 64:
                    self._dims[key] = _CategoricalDim(domain)
                else:
                    self._dims[key] = _ContinuousDim(domain)
            elif isinstance(domain, Choice):
                self._dims[key] = _CategoricalDim(domain)
        # A model needs more points than dimensions to beat random (BOHB
        # paper's default: d+1, plus margin for the good/bad split).
        self._min_points = min_points_in_model or (len(self._dims) + 2)
        # Rung budgets of the paired HyperBand scheduler.
        milestones: List[int] = []
        t = max_t
        while t >= 1:
            milestones.append(int(t))
            t = t / reduction_factor
            if int(t) in milestones:
                break
        self._milestones = sorted(set(milestones))
        # budget -> [(config, score)]; (trial_id, budget) dedups recording.
        self._obs: Dict[int, List[tuple]] = {m: [] for m in self._milestones}
        self._recorded: set = set()
        self._pending: Dict[str, dict] = {}

    # -- Searcher interface -------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[dict]:
        config = self._suggest_config()
        self._pending[trial_id] = config
        return config

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        """Record the trial's score at every rung budget it has crossed —
        the multi-fidelity observations the per-budget models train on."""
        if self.metric not in result:
            return
        config = self._pending.get(trial_id)
        if config is None:
            return
        budget = result.get(self.time_attr, 0)
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        for milestone in self._milestones:
            if budget >= milestone and (trial_id, milestone) not in self._recorded:
                self._recorded.add((trial_id, milestone))
                self._obs[milestone].append((config, score))

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        if result is not None and not error:
            self.on_trial_result(trial_id, result)
        self._pending.pop(trial_id, None)

    # -- BOHB core ----------------------------------------------------------

    def _model_budget(self) -> Optional[int]:
        """Highest rung with enough observations to fit the TPE split."""
        for milestone in sorted(self._milestones, reverse=True):
            if len(self._obs[milestone]) >= self._min_points:
                return milestone
        return None

    def _suggest_config(self) -> dict:
        budget = self._model_budget()
        if (
            budget is None
            or not self._dims
            or self._rng.random() < self._random_fraction
        ):
            return next(generate_variants(self._space, 1, self._rng.random()))
        history = self._obs[budget]
        ranked = sorted(history, key=lambda cs: cs[1], reverse=True)
        n_good = max(1, int(math.ceil(self._gamma * len(ranked))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        return tpe_best_candidate(
            self._space, self._dims, good, bad, self._n_candidates, self._rng
        )
