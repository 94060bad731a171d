"""Aggregation functions for Dataset.groupby / Dataset.aggregate.

Reference: python/ray/data/aggregate.py — an AggregateFn is the classic
(init, accumulate, merge, finalize) fold; built-ins cover Count/Sum/Min/Max/
Mean/Std/AbsMax. Std uses Welford's parallel variance merge like the
reference.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


def _key_getter(on: Optional[str]) -> Callable[[Any], Any]:
    if on is None:
        # Dict rows (the standard block row format): a single-column dataset
        # aggregates over its only column; multi-column needs an explicit
        # `on` (the reference aggregates every numeric column — here we ask
        # the caller to pick one, which is unambiguous).
        def get(row):
            if isinstance(row, dict):
                if len(row) == 1:
                    return next(iter(row.values()))
                raise ValueError(
                    "Aggregation over a multi-column dataset requires "
                    f"`on=<column>`; columns: {sorted(row)}"
                )
            return row

        return get
    if callable(on):
        return on
    return lambda row: row[on]


class AggregateFn:
    def __init__(
        self,
        init: Callable[[Any], Any],
        accumulate_row: Callable[[Any, Any], Any],
        merge: Callable[[Any, Any], Any],
        finalize: Callable[[Any], Any] = lambda a: a,
        name: str = "agg",
    ):
        self.init = init
        self.accumulate_row = accumulate_row
        self.merge = merge
        self.finalize = finalize
        self.name = name


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda k: 0,
            accumulate_row=lambda a, row: a + 1,
            merge=lambda a, b: a + b,
            name="count()",
        )


class Sum(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        get = _key_getter(on)
        super().__init__(
            init=lambda k: 0,
            accumulate_row=lambda a, row: a + get(row),
            merge=lambda a, b: a + b,
            name=f"sum({on})",
        )


class Min(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        get = _key_getter(on)
        super().__init__(
            init=lambda k: None,
            accumulate_row=lambda a, row: get(row)
            if a is None
            else min(a, get(row)),
            merge=lambda a, b: b if a is None else (a if b is None else min(a, b)),
            name=f"min({on})",
        )


class Max(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        get = _key_getter(on)
        super().__init__(
            init=lambda k: None,
            accumulate_row=lambda a, row: get(row)
            if a is None
            else max(a, get(row)),
            merge=lambda a, b: b if a is None else (a if b is None else max(a, b)),
            name=f"max({on})",
        )


class Mean(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        get = _key_getter(on)
        super().__init__(
            init=lambda k: (0, 0.0),  # (count, sum)
            accumulate_row=lambda a, row: (a[0] + 1, a[1] + get(row)),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: a[1] / a[0] if a[0] else None,
            name=f"mean({on})",
        )


class Std(AggregateFn):
    """Parallel/streaming std via Chan et al. merge (reference
    data/aggregate.py Std — same algorithm, ddof=1 default)."""

    def __init__(self, on: Optional[str] = None, ddof: int = 1):
        get = _key_getter(on)

        def accumulate(a, row):
            n, mean, m2 = a
            x = get(row)
            n += 1
            delta = x - mean
            mean += delta / n
            m2 += delta * (x - mean)
            return (n, mean, m2)

        def merge(a, b):
            n1, mean1, m21 = a
            n2, mean2, m22 = b
            if n1 == 0:
                return b
            if n2 == 0:
                return a
            n = n1 + n2
            delta = mean2 - mean1
            mean = mean1 + delta * n2 / n
            m2 = m21 + m22 + delta * delta * n1 * n2 / n
            return (n, mean, m2)

        def finalize(a):
            n, _, m2 = a
            if n - ddof <= 0:
                return None
            return (m2 / (n - ddof)) ** 0.5

        super().__init__(
            init=lambda k: (0, 0.0, 0.0),
            accumulate_row=accumulate,
            merge=merge,
            finalize=finalize,
            name=f"std({on})",
        )


class AbsMax(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        get = _key_getter(on)
        super().__init__(
            init=lambda k: None,
            accumulate_row=lambda a, row: abs(get(row))
            if a is None
            else max(a, abs(get(row))),
            merge=lambda a, b: b if a is None else (a if b is None else max(a, b)),
            name=f"abs_max({on})",
        )
