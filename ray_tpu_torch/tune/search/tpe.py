"""Native Tree-structured Parzen Estimator searcher.

The model-based searcher the reference reaches through adapters
(tune/search/optuna/optuna_search.py wraps Optuna, whose default sampler is
TPE; tune/search/hyperopt/ wraps Hyperopt's original implementation). The
package depends on neither optuna nor hyperopt, so this is the algorithm itself,
implemented against the same Searcher ABC the adapters use:

  * completed trials split into good (top `gamma` quantile) and bad sets;
  * per dimension, good/bad observations fit kernel densities (Gaussian
    KDE in the domain's transformed space for continuous dims; smoothed
    categoricals for Choice/Randint);
  * `n_candidates` configs sampled from the good model are scored by the
    summed per-dimension log-likelihood ratio l(x|good) - l(x|bad); the
    argmax is suggested (expected-improvement-proportional, per Bergstra
    et al. 2011 — PAPERS.md).

Plain non-Domain values in the space pass through untouched.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search.sample import (
    Choice,
    Domain,
    LogUniform,
    Normal,
    QNormal,
    QUniform,
    Randint,
    Uniform,
)
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.search.variant_generator import generate_variants

_CONTINUOUS = (Uniform, LogUniform, QUniform, Normal, QNormal)


class _ContinuousDim:
    """Gaussian-KDE model of one continuous dimension (log-transformed for
    LogUniform domains; large Randint ranges model continuously with
    integer rounding — enumerating them would blow up memory)."""

    def __init__(self, domain: Domain):
        self.domain = domain
        self.log = isinstance(domain, LogUniform)
        self.integer = isinstance(domain, Randint)
        lo = getattr(domain, "lower", None)
        hi = getattr(domain, "upper", None)
        if self.integer and hi is not None:
            hi = hi - 1  # Randint upper bound is exclusive
        self.lo = self._tf(lo) if lo is not None else None
        self.hi = self._tf(hi) if hi is not None else None

    def _tf(self, x: float) -> float:
        return math.log(x) if self.log else x

    def _inv(self, x: float) -> float:
        return math.exp(x) if self.log else x

    def _bandwidth(self, obs: List[float]) -> float:
        if len(obs) < 2:
            span = (
                (self.hi - self.lo)
                if self.lo is not None and self.hi is not None
                else 1.0
            )
            return max(1e-6, 0.25 * span)
        mean = sum(obs) / len(obs)
        var = sum((x - mean) ** 2 for x in obs) / (len(obs) - 1)
        sigma = math.sqrt(max(var, 1e-12))
        bw = 1.06 * sigma * len(obs) ** -0.2  # Silverman's rule
        if self.lo is not None and self.hi is not None:
            bw = max(bw, (self.hi - self.lo) / 20.0)
        return max(bw, 1e-6)

    def sample(self, obs: List[float], rng: random.Random) -> float:
        # The good model is a mixture of the observation kernels AND the
        # uniform prior weighted as one pseudo-observation (Bergstra et
        # al.'s prior-smoothed Parzen estimator): without the prior the
        # search collapses onto the best startup point and never explores.
        if not obs or rng.random() < 1.0 / (len(obs) + 1):
            # Unbounded domains (Normal/QNormal) use the domain itself as
            # the prior; bounded ones the uniform span.
            if self.lo is None or self.hi is None:
                return self.domain.sample(rng)
            x = rng.uniform(self.lo, self.hi)
        else:
            bw = self._bandwidth(obs)
            center = rng.choice(obs)
            x = rng.gauss(center, bw)
            if self.lo is not None:
                x = min(max(x, self.lo), self.hi)
        # Q-domains keep their quantization on the way out.
        value = self._inv(x)
        q = getattr(self.domain, "q", None)
        if q:
            value = round(value / q) * q
        if self.integer:
            value = int(round(value))
        return value

    def log_density(self, value: float, obs: List[float]) -> float:
        x = self._tf(max(value, 1e-300) if self.log else value)
        span = (
            max(self.hi - self.lo, 1e-12)
            if self.lo is not None and self.hi is not None
            else None
        )
        if not obs:
            return -math.log(span) if span else 0.0
        bw = self._bandwidth(obs)
        acc = 0.0
        for center in obs:
            z = (x - center) / bw
            acc += math.exp(-0.5 * z * z)
        kde = acc / (len(obs) * bw * math.sqrt(2 * math.pi))
        # Same prior mixture as sample(): 1 pseudo-observation of uniform.
        w = 1.0 / (len(obs) + 1)
        dens = (1.0 - w) * kde + (w / span if span else 0.0)
        return math.log(max(dens, 1e-300))


class _CategoricalDim:
    """Smoothed-count model for Choice / Randint dimensions."""

    def __init__(self, domain: Domain):
        if isinstance(domain, Choice):
            self.values = list(domain.categories)
        else:  # Randint
            self.values = list(range(domain.lower, domain.upper))
        self.k = max(len(self.values), 1)

    def _probs(self, obs: List[Any]) -> Dict[Any, float]:
        prior = 1.0
        counts = {v: prior for v in self.values}
        for x in obs:
            if x in counts:
                counts[x] += 1.0
        total = sum(counts.values())
        return {v: c / total for v, c in counts.items()}

    def sample(self, obs: List[Any], rng: random.Random) -> Any:
        probs = self._probs(obs)
        r = rng.random()
        acc = 0.0
        for v, p in probs.items():
            acc += p
            if r <= acc:
                return v
        return self.values[-1]

    def log_density(self, value: Any, obs: List[Any]) -> float:
        return math.log(self._probs(obs).get(value, 1e-12))


class TPESearch(Searcher):
    """Model-based suggest: random for `n_startup_trials`, then TPE."""

    def __init__(
        self,
        space: dict,
        metric: Optional[str] = None,
        mode: str = "max",
        n_startup_trials: int = 10,
        gamma: float = 0.15,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self._space = space
        self._n_startup = n_startup_trials
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._dims: Dict[str, Any] = {}
        for key, domain in space.items():
            if isinstance(domain, _CONTINUOUS):
                self._dims[key] = _ContinuousDim(domain)
            elif isinstance(domain, Randint):
                # Small integer ranges are categorical counts; large ones
                # would enumerate billions of values — model continuously.
                if domain.upper - domain.lower <= 64:
                    self._dims[key] = _CategoricalDim(domain)
                else:
                    self._dims[key] = _ContinuousDim(domain)
            elif isinstance(domain, Choice):
                self._dims[key] = _CategoricalDim(domain)
        # trial_id -> config for pending trials; (config, score) history.
        self._pending: Dict[str, dict] = {}
        self._history: List[tuple] = []

    # -- Searcher interface -------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[dict]:
        if len(self._history) < self._n_startup or not self._dims:
            config = next(
                generate_variants(self._space, 1, self._rng.random())
            )
        else:
            config = self._suggest_tpe()
        self._pending[trial_id] = config
        return config

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        config = self._pending.pop(trial_id, None)
        if config is None or error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._history.append((config, score))

    # -- TPE core -----------------------------------------------------------

    def _split(self):
        ranked = sorted(self._history, key=lambda cs: cs[1], reverse=True)
        n_good = max(1, int(math.ceil(self._gamma * len(ranked))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        return good, bad

    def _suggest_tpe(self) -> dict:
        good, bad = self._split()
        return tpe_best_candidate(
            self._space, self._dims, good, bad, self._n_candidates, self._rng
        )


def tpe_best_candidate(
    space: dict,
    dims: Dict[str, Any],
    good: List[dict],
    bad: List[dict],
    n_candidates: int,
    rng: random.Random,
) -> dict:
    """The TPE proposal step shared by TPESearch and TuneBOHB: sample
    `n_candidates` configs from the good-set kernel densities and return the
    one maximizing the summed log-likelihood ratio l(x|good) - l(x|bad)."""
    obs_good = {key: [c[key] for c in good if key in c] for key in dims}
    obs_bad = {key: [c[key] for c in bad if key in c] for key in dims}
    for key, dim in dims.items():
        if isinstance(dim, _ContinuousDim):
            obs_good[key] = [dim._tf(v) for v in obs_good[key]]
            obs_bad[key] = [dim._tf(v) for v in obs_bad[key]]

    best_config, best_score = None, -math.inf
    for _ in range(n_candidates):
        candidate = next(generate_variants(space, 1, rng.random()))
        score = 0.0
        for key, dim in dims.items():
            value = dim.sample(obs_good[key], rng)
            candidate[key] = value
            score += dim.log_density(value, obs_good[key])
            score -= dim.log_density(value, obs_bad[key])
        if score > best_score:
            best_config, best_score = candidate, score
    return best_config
