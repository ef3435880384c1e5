"""Roofline-aware DTR budget autotuning (beyond-paper).

The counterpart of ``repro.core.autotune`` over the port's planner (aten
graphs traced on fake tensors), priced with the H100 roofline constants
(``analysis.roofline``).  The paper treats the memory budget as given; the
budget is itself a decision variable: saving more activations cuts the
compute term (less recompute) but raises the memory term (more HBM traffic
+ footprint).
Because the DTR planner costs milliseconds per budget (unlike ILP), we can
afford to sweep budgets at trace time and pick the plan minimizing the
estimated step time = max(compute, memory, collective) — "roofline-aware
DTR".

The estimate takes its terms from the DTR simulation's own compute and
byte accounting over the traced graph (the reference's ``"sim"`` mode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from ..analysis.roofline import HBM_BW, PEAK_FLOPS
from . import planner
from .simulator import measure_baseline


@dataclass
class TunedPlan:
    budget_frac: float
    plan: planner.Plan
    est_compute_s: float
    est_memory_s: float
    est_step_s: float


def autotune(grad_fn: Callable, *example_args,
             fracs: Sequence[float] = (0.9, 0.7, 0.5, 0.35, 0.25),
             chips: int = 1, heuristic: str = "h_dtr_eq") -> TunedPlan:
    """Sweep activation budgets; return the roofline-optimal DTR plan.

    ``grad_fn`` is the differentiated step (sees fwd+bwd lifetimes).  The
    sim-mode estimator charges: compute = (base + remat) flops / peak;
    memory = bytes-of-live-writes / HBM bw (both per the traced graph's
    analytic cost model, scaled per chip).
    """
    tg = planner.trace_to_log(grad_fn, *example_args, name="autotune")
    peak, base_cost = measure_baseline(tg.log)
    best: TunedPlan | None = None
    for f in fracs:
        p = planner.plan(grad_fn, *example_args, budget_bytes=f * peak,
                         heuristic=heuristic)
        if not p.feasible:
            continue
        flops = tg.total_flops * p.est_slowdown
        comp = flops / (PEAK_FLOPS * chips)
        memo = (tg.total_bytes * p.est_slowdown) / (HBM_BW * chips)
        cand = TunedPlan(budget_frac=f, plan=p, est_compute_s=comp,
                         est_memory_s=memo, est_step_s=max(comp, memo))
        if best is None or cand.est_step_s < best.est_step_s:
            best = cand
    if best is None:
        raise ValueError("no feasible budget in the sweep")
    return best
