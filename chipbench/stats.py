"""Percentiles and rates of a run, taken over all of its samples.

A tail is the tail of every sample (no medians of chunks), and a rate is
work over the whole window.
"""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between order statistics (numpy's default rule): rank
    ``(n - 1) q / 100``."""
    if not values:
        raise ValueError("percentile of no samples")
    xs = sorted(values)
    r = (len(xs) - 1) * q / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def beyond(values: Sequence[float], q: float) -> int:
    """How many samples lie strictly above the ``q``-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)


def rate(count: float, seconds: float) -> float:
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds
