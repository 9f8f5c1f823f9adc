"""Percentiles and means over whole samples."""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated linearly
    between order statistics (numpy's default).  ``inf`` counts as a value:
    a request that never finished is infinitely late."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    if frac == 0.0 or xs[lo] == xs[hi]:
        return xs[lo]
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def mean(values: Sequence[float]) -> float:
    if not values:
        raise ValueError("mean of an empty sample")
    return math.fsum(values) / len(values)

