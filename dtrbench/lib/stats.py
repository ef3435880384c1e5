"""The window's arithmetic: rates over all the work and all the time of
the window, and percentiles over every step."""
from __future__ import annotations


def walls(stamps: list) -> list:
    """Each step's wall from consecutive step-start stamps (the last stamp
    is the end of the last step)."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def rate(work_per_step: float, stamps: list) -> float:
    """Work per second over the window: every step completed, from the
    first step's start to the last step's end."""
    steps = len(stamps) - 1
    return work_per_step * steps / (stamps[-1] - stamps[0])


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

