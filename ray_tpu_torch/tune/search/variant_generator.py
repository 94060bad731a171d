"""Expand a param_space into concrete trial configs.

Reference: tune/search/variant_generator.py — grid entries multiply
(cartesian product), Domain entries are sampled once per generated variant,
and the whole space is repeated `num_samples` times.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Iterator

from ray_tpu_torch.tune.search.sample import Domain, GridSearch


def _find_special(space: Any, path: tuple = ()):
    """Yield (path, entry) for every grid/domain node in a nested dict."""
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            yield path, GridSearch(space["grid_search"])
            return
        for k, v in space.items():
            yield from _find_special(v, path + (k,))
    elif isinstance(space, (GridSearch, Domain)):
        yield path, space


def _set_path(config: dict, path: tuple, value: Any) -> None:
    node = config
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _deep_copy_resolved(space: Any) -> Any:
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            return None  # placeholder, filled by _set_path
        return {k: _deep_copy_resolved(v) for k, v in space.items()}
    if isinstance(space, (GridSearch, Domain)):
        return None
    if isinstance(space, list):
        return list(space)
    return space


def count_variants(space: dict, num_samples: int = 1) -> int:
    grids = [e for _, e in _find_special(space) if isinstance(e, GridSearch)]
    n = 1
    for g in grids:
        n *= len(g.values)
    return n * num_samples


def generate_variants(
    space: dict, num_samples: int = 1, seed: int | None = None
) -> Iterator[dict]:
    """Yield fully-resolved config dicts."""
    rng = random.Random(seed)
    specials = list(_find_special(space))
    grid_items = [(p, e) for p, e in specials if isinstance(e, GridSearch)]
    domain_items = [(p, e) for p, e in specials if isinstance(e, Domain)]

    grid_axes = [list(e.values) for _, e in grid_items] or [[None]]
    for _ in range(num_samples):
        for combo in itertools.product(*grid_axes):
            config = _deep_copy_resolved(space)
            if grid_items:
                for (path, _), value in zip(grid_items, combo):
                    _set_path(config, path, value)
            for path, domain in domain_items:
                _set_path(config, path, domain.sample(rng))
            yield config
