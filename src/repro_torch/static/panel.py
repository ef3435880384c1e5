"""Eval-guided static plan panel: the honest DTR-vs-static comparison.

The chain model (``solvers.py``) is exact on chain-shaped traces but can
be arbitrarily wrong on DAGs: dropping a storage whose rebuild cone
threads the weight-update chain replays half the trace, and the model
cannot see that.  The panel therefore treats solver plans as *proposals*
and judges every plan with the exact evaluator (``evaluate_plan``, the
bit-exact runtime mirror):

1. **Solo screen** — evaluate each candidate's drop in isolation against
   the trim-only baseline; candidates whose solo drop *raises* the real
   peak (cascade-toxic) are excluded from the greedy.
2. **Greedy frontier** — walk the safe candidates (best measured peak
   reduction first), accumulating drops that still reduce the evaluated
   peak; every accepted step yields a (peak, compute, keep) point.
3. **Per-budget selection** — pool the frontier points with solver
   proposals (heterogeneous DP, both Chen variants, keep-all) evaluated
   at each budget; a plan is feasible iff its *evaluated* peak fits the
   budget, and the cheapest feasible plan wins.  Solver proposals are
   pooled across budgets, so the winning cost is monotone non-increasing
   in the budget by construction.

Every number reported for the winner is an exact prediction of what
``execute_plan`` does through the real runtime (the parity gate in the
tests enforces this bit-for-bit), so DTR rows and static rows in a
benchmark table share one accounting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .chain import Chain, LogView
from .executor import PlanEval, StaticPlan, compile_plan, evaluate_plan
from .solvers import chen_greedy, chen_sqrt, optimal_dp

#: Solver proposals are generated at these fractions of each budget —
#: the model's peak is optimistic on DAGs, so planning against a tighter
#: model budget often lands the *evaluated* peak under the real one.
MU_LADDER = (1.0, 0.85, 0.7)


@dataclass
class PlanPoint:
    """One evaluated plan: the frontier/selection currency of the panel."""
    keep: frozenset[int]            # chain item indices kept
    ev: PlanEval                    # exact evaluator profile
    source: str                     # "trim_only" | "greedy" | solver name

    @property
    def peak(self) -> float:
        return self.ev.peak_memory

    @property
    def compute(self) -> float:
        return self.ev.compute

    @property
    def overhead(self) -> float:
        return self.ev.overhead


@dataclass
class Frontier:
    """Trim baseline + greedy peak/compute tradeoff points + pooled
    solver proposals (grows as budgets are queried)."""
    points: list[PlanPoint]
    n_safe: int                     # candidates whose solo drop helped
    n_toxic: int                    # candidates excluded by the screen

    def min_peak(self) -> float:
        return min(p.peak for p in self.points)


def _point(view: LogView, chain: Chain, keep, source: str) -> PlanPoint:
    keep = frozenset(keep)
    return PlanPoint(keep, evaluate_plan(view, compile_plan(view, chain,
                                                            keep)), source)


def build_frontier(view: LogView, chain: Chain,
                   max_screen: int = 512) -> Frontier:
    """Solo-screen all candidates, then grow a greedy drop frontier.

    ``max_screen`` caps the screening work on very long chains (largest
    candidates are screened first; the tail is treated as toxic, which
    only costs plan quality, never correctness).
    """
    n = len(chain)
    allk = frozenset(range(n))
    base = _point(view, chain, allk, "trim_only")
    points = [base]
    if n == 0:
        return Frontier(points, 0, 0)

    order = sorted(range(n), key=lambda i: (-chain.items[i].size, i))
    screened = order[:max_screen]
    solo = []
    for i in screened:
        ev = evaluate_plan(view, compile_plan(view, chain, allk - {i}))
        solo.append((ev.peak_memory - base.peak, ev.compute - base.compute,
                     i))
    safe = sorted((s for s in solo if s[0] < 0))
    n_toxic = len(solo) - len(safe)

    cur: set[int] = set()
    cur_peak = base.peak
    for _, _, i in safe:
        keep = allk - cur - {i}
        ev = evaluate_plan(view, compile_plan(view, chain, keep))
        if ev.peak_memory < cur_peak:
            cur.add(i)
            cur_peak = ev.peak_memory
            points.append(PlanPoint(frozenset(keep), ev, "greedy"))
    return Frontier(points, len(safe), n_toxic)


def _solver_proposals(chain: Chain, budget: float):
    """(source, keep) proposals from the model-level solvers at ``budget``."""
    out = []
    for mu in MU_LADDER:
        p = optimal_dp(chain, mu * budget)
        if p is not None:
            out.append((f"optimal_dp@{mu:g}", p.keep))
    out.append(("chen_sqrt", chen_sqrt(chain, budget).keep))
    out.append(("chen_greedy", chen_greedy(chain, budget).keep))
    return out


def best_static_plan(view: LogView, chain: Chain, frontier: Frontier,
                     budget: float) -> Optional[PlanPoint]:
    """Cheapest plan whose *evaluated* peak fits ``budget`` (None if no
    known plan fits).  Solver proposals generated for this budget are
    pooled into the frontier, so later (smaller) budgets see them too
    and the winning compute is monotone in the budget."""
    seen = {p.keep for p in frontier.points}
    for source, keep in _solver_proposals(chain, budget):
        keep = frozenset(keep)
        if keep in seen:
            continue
        seen.add(keep)
        frontier.points.append(_point(view, chain, keep, source))
    feas = [p for p in frontier.points if p.peak <= budget]
    if not feas:
        return None
    return min(feas, key=lambda p: (p.compute, len(p.keep) - len(chain)))


def compile_point(view: LogView, chain: Chain,
                  point: PlanPoint) -> StaticPlan:
    """The executable plan for a selected panel point."""
    return compile_plan(view, chain, point.keep)


def static_panel(view: LogView, chain: Chain, budgets: Sequence[float]
                 ) -> tuple[Frontier, dict[float, Optional[PlanPoint]]]:
    """Best static plan per budget (largest budget first, pooled plans)."""
    frontier = build_frontier(view, chain)
    out: dict[float, Optional[PlanPoint]] = {}
    for b in sorted(budgets, reverse=True):
        out[b] = best_static_plan(view, chain, frontier, b)
    return frontier, out
