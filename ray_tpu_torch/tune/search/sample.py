"""Search-space domains (reference: python/ray/tune/search/sample.py).

Declarative distributions placed in `param_space`; `BasicVariantGenerator`
resolves them per trial. `grid_search` is a marker expanded into the cartesian
product across all grid entries (reference: tune/search/variant_generator.py).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError

    # PBT-style perturbation support: continuous domains can rescale.
    def perturb(self, value: Any, rng: random.Random) -> Any:
        return self.sample(rng)


@dataclass
class Uniform(Domain):
    lower: float
    upper: float

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)

    def perturb(self, value, rng):
        factor = 1.2 if rng.random() > 0.5 else 0.8
        return min(self.upper, max(self.lower, value * factor))


@dataclass
class LogUniform(Domain):
    lower: float
    upper: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))

    def perturb(self, value, rng):
        factor = 1.2 if rng.random() > 0.5 else 0.8
        return min(self.upper, max(self.lower, value * factor))


@dataclass
class Randint(Domain):
    lower: int
    upper: int  # exclusive

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)

    def perturb(self, value, rng):
        factor = 1.2 if rng.random() > 0.5 else 0.8
        return min(self.upper - 1, max(self.lower, int(value * factor)))


@dataclass
class Choice(Domain):
    categories: Sequence[Any]

    def sample(self, rng):
        return rng.choice(list(self.categories))


@dataclass
class QUniform(Domain):
    lower: float
    upper: float
    q: float

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        return round(round(v / self.q) * self.q, 10)


@dataclass
class Normal(Domain):
    mean: float
    sd: float

    def sample(self, rng):
        return rng.normalvariate(self.mean, self.sd)


@dataclass
class QNormal(Domain):
    mean: float
    sd: float
    q: float

    def sample(self, rng):
        v = rng.normalvariate(self.mean, self.sd)
        return round(round(v / self.q) * self.q, 10)


@dataclass
class Function(Domain):
    """sample_from: arbitrary callable, optionally taking the spec/config."""

    fn: Callable

    def sample(self, rng):
        try:
            return self.fn()
        except TypeError:
            return self.fn(None)


@dataclass
class GridSearch:
    """Marker expanded to one variant per value (not a sampled Domain)."""

    values: Sequence[Any]


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower: float, upper: float) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower: int, upper: int) -> Randint:
    return Randint(lower, upper)


def choice(categories: Sequence[Any]) -> Choice:
    return Choice(categories)


def quniform(lower: float, upper: float, q: float) -> QUniform:
    return QUniform(lower, upper, q)


def qrandn(mean: float, sd: float, q: float) -> QNormal:
    return QNormal(mean, sd, q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> dict:
    """Reference spells grid search as {"grid_search": [...]}; keep that shape
    so user configs are drop-in compatible."""
    return {"grid_search": list(values)}
