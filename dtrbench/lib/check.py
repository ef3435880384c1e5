"""The comparison that decides ``correct``: what the program's first three
training steps produced against the plain reference's, number by number.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_norm_gap``: the largest relative gap of a step's global gradient
  norm before clipping (what the loop reports).
- ``grad_gap``: the first gradient as the optimizer got it (clipped), by
  the worst layer slice of a leaf: the gap between the two norms over the
  larger of the reference's norm of that slice and of the median slice;
  ``grad_gap_median`` is the median slice's gap.
- ``change_gap``: the norm of the parameters' change over the three
  steps, by the worst slice, measured the same way; ``change_gap_median``
  the median slice's.  Slices whose first gradient in the reference is
  under a thousandth of the median slice's are left out (AdamW moves them
  by round-off alone).
- ``grad_diff``: the first gradient's difference, program against
  reference, on a fixed strided sample of each slice's elements: the norm
  of the difference over the larger of the reference's norm of the sample
  and of the median slice's, by the worst slice; ``grad_diff_median`` the
  median slice's.  A norm hardly moves under rounding noise that is
  uncorrelated with the gradient, its difference does.

A cell compares the numbers its ``limits`` name; every number is read.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_norm_gap", "grad_gap", "grad_gap_median",
           "change_gap", "change_gap_median", "grad_diff", "grad_diff_median")
# A slice moves by round-off alone below this share of the median
# slice's first gradient in the reference.
STILL = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def _slices(prog: dict, ref: dict, keep=None, diff=None) -> tuple:
    """``((worst gap, slice), (median gap, "median"))`` over the slices:
    each slice's ``diff(p, r)`` (default the gap of two norms) over the
    larger of its reference norm and the median slice's."""
    names = [n for n in ref if keep is None or n in keep]
    if set(prog) != set(ref) or not names:
        return (math.inf, "slices differ"), (math.inf, "slices differ")
    if diff is None:
        norm, diff = (lambda r: r), (lambda p, r: abs(p - r))
    else:
        norm = _norm
    floor = statistics.median(norm(ref[n]) for n in names)
    gaps = {}
    for n in names:
        gap = diff(prog[n], ref[n]) / max(norm(ref[n]), floor, 1e-30)
        gaps[n] = gap if math.isfinite(gap) else math.inf
    worst = max(names, key=lambda n: gaps[n])
    return (gaps[worst], worst), (statistics.median(gaps.values()),
                                  "median slice")


def _norm(t) -> float:
    return float(t.double().norm())


def _steps(prog: list, ref: list) -> tuple:
    if len(prog) != len(ref) or not ref:
        return math.inf, "steps differ"
    return max((_rel(a, b), f"step {i}")
               for i, (a, b) in enumerate(zip(prog, ref)))


def compare(prog, ref) -> dict:
    """``{number: (value, where)}`` of two ``Readings``."""
    out = {"loss_gap": _steps(prog.losses, ref.losses),
           "grad_norm_gap": _steps(prog.grad_norms, ref.grad_norms)}
    out["grad_gap"], out["grad_gap_median"] = _slices(prog.first_grad,
                                                      ref.first_grad)
    floor = statistics.median(ref.first_grad.values())
    moved = {n for n, g in ref.first_grad.items() if g >= STILL * floor}
    out["change_gap"], out["change_gap_median"] = _slices(
        prog.change, ref.change, moved)
    out["grad_diff"], out["grad_diff_median"] = _slices(
        prog.first_grad_sample, ref.first_grad_sample,
        diff=lambda p, r: _norm(p - r) if p.shape == r.shape else math.inf)
    return out


def verdict(gaps: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit", "where"}})`` over the
    numbers ``limits`` names: correct when each is finite and within its
    limit."""
    rows = {}
    ok = bool(limits)
    for name, limit in limits.items():
        value, where = gaps[name]
        rows[name] = {"value": value, "limit": limit, "where": where}
        ok &= math.isfinite(value) and value <= limit
    return ok, rows
