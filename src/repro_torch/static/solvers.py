"""Static checkpoint-selection solvers over a heterogeneous ``Chain``.

The chain model (see ``chain.py``): candidates ``i = 0..n-1`` in
production order, each with byte size ``m_i`` and segment recompute cost
``c_i``.  A *plan* keeps a subset ``S`` resident across their far gaps
and drops the rest:

* extra recompute  ``cost(S) = Σ_{i∉S} c_i``  — each dropped candidate's
  producing segment is replayed once when its far use arrives (exact on
  chain-shaped traces; the plan evaluator reports exact numbers for any
  trace);
* peak bytes  ``peak(S) = floor + Σ_{i∈S} m_i + max-run(S)``  where
  ``max-run`` is the largest total size of a maximal run of consecutive
  dropped candidates — during that run's replay all its intermediates
  are simultaneously live (Chen's segment-residency model).

Solvers:

* ``chen_sqrt``    — √n segmentation by candidate count (budget-oblivious,
                     feasibility reported honestly);
* ``chen_greedy``  — threshold greedy: close a segment when its bytes
                     exceed ``tau``; sweeps ``tau`` and keeps the cheapest
                     feasible plan;
* ``optimal_dp``   — Beaumont-style heterogeneous DP, exact in this model:
                     Pareto frontier over (kept bytes, max run bytes) per
                     last-kept anchor.  Returns the min over {DP, both
                     Chen variants, keep-all}, so DP ≤ Chen by
                     construction on every feasible instance;
* ``enumerate_optimal`` — exhaustive subset oracle for differential tests
                     (n ≤ 20).

All solvers are pure functions of (chain, budget); ties break toward
keeping lower-index candidates, so plans are deterministic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from .chain import Chain, ChainItem

#: Pareto-state cap per anchor; exceeding it truncates by cost and marks
#: the DP answer inexact (never triggered by the golden corpus at the
#: default candidate cap, but the flag keeps truncation honest).
MAX_STATES = 2000

#: Chains longer than this additionally run the DP on a size-balanced
#: block coarsening (keep/drop decided per consecutive block); the
#: expanded plan is scored on the full chain and flagged inexact.
DP_MAX_ITEMS = 48

#: Work budget for the exact DP (transitions + dominance-scan touches).
#: Frontier blowups (loose budgets on long heterogeneous chains) abort
#: the exact solve, leaving the block DP / Chen family to cover the
#: cell; tight-budget instances (small frontiers) still solve exactly
#: well past 100 items.
DP_MAX_STEPS = 4_000_000


class _StepLimit(Exception):
    pass


@dataclass
class Plan:
    """One checkpoint selection, scored under the chain model."""
    keep: frozenset[int]            # item indices kept resident
    cost: float                     # extra recompute (model)
    peak: float                     # floor + kept + max dropped run (model)
    budget: float
    solver: str
    feasible: bool
    exact: bool = True              # False when the DP truncated states
    meta: dict = field(default_factory=dict)

    @property
    def dropped(self) -> int:
        return int(self.meta.get("n", 0)) - len(self.keep)


def plan_cost(chain: Chain, keep) -> float:
    return sum(it.cost for i, it in enumerate(chain.items) if i not in keep)


def plan_peak(chain: Chain, keep) -> float:
    kept = sum(it.size for i, it in enumerate(chain.items) if i in keep)
    run = maxrun = 0.0
    for i, it in enumerate(chain.items):
        if i in keep:
            run = 0.0
        else:
            run += it.size
            maxrun = max(maxrun, run)
    # finalize holds all kept storages at once regardless of the plan
    return max(chain.floor + kept + maxrun, chain.final_bytes)


def _mk(chain: Chain, keep, budget: float, solver: str,
        exact: bool = True, **meta) -> Plan:
    keep = frozenset(keep)
    cost = plan_cost(chain, keep)
    peak = plan_peak(chain, keep)
    meta.setdefault("n", len(chain))
    return Plan(keep, cost, peak, budget, solver,
                feasible=peak <= budget, exact=exact, meta=meta)


# ---------------------------------------------------------------------------
# Chen et al. (2016)
# ---------------------------------------------------------------------------

def chen_sqrt(chain: Chain, budget: float = math.inf) -> Plan:
    """√n segmentation by count: keep every k-th candidate, k = ⌈√n⌉."""
    n = len(chain)
    if n == 0:
        return _mk(chain, (), budget, "chen_sqrt")
    k = max(int(math.ceil(math.sqrt(n))), 1)
    keep = set(range(k - 1, n, k))
    return _mk(chain, keep, budget, "chen_sqrt", k=k)


def chen_greedy(chain: Chain, budget: float) -> Plan:
    """Threshold greedy: drop until the open segment's bytes exceed tau.

    Chen's greedy checkpoints "every b bytes"; with heterogeneous sizes
    the right ``tau`` is not known in closed form, so the solver sweeps
    the distinct candidate thresholds (every prefix-run byte count, plus
    a √(total·mean) pivot) and keeps the cheapest feasible plan.  With no
    feasible threshold it returns the peak-minimizing one, flagged
    infeasible.
    """
    n = len(chain)
    if n == 0:
        return _mk(chain, (), budget, "chen_greedy")
    sizes = [it.size for it in chain.items]
    total = sum(sizes)
    taus = sorted({0.0, total} | {float(s) for s in sizes}
                  | {math.sqrt(total * max(s, 1.0)) for s in sizes})
    best: Optional[Plan] = None
    fallback: Optional[Plan] = None
    for tau in taus:
        keep = set()
        run = 0.0
        for i, m in enumerate(sizes):
            run += m
            if run > tau:
                keep.add(i)
                run = 0.0
        p = _mk(chain, keep, budget, "chen_greedy", tau=tau)
        if fallback is None or p.peak < fallback.peak:
            fallback = p
        if p.feasible and (best is None or p.cost < best.cost):
            best = p
    return best if best is not None else fallback


# ---------------------------------------------------------------------------
# Heterogeneous optimal DP (Beaumont et al., arXiv:1911.13214 regime)
# ---------------------------------------------------------------------------

def _dp(chain: Chain, budget: float,
        max_steps: Optional[int] = None) -> Optional[Plan]:
    """Exact min-cost selection with peak ≤ budget (None if infeasible).

    State: after deciding a prefix ending with kept anchor ``j`` (0 =
    virtual start), a Pareto frontier of (kept_bytes, max_run, cost,
    parent) tuples.  Transition j -> k (keep k, drop j+1..k-1) adds the
    dropped run's cost and folds its bytes into max_run; a final hop to
    the virtual end drops the tail.  Both resources only grow along a
    path, so states with ``floor + kept + maxrun > budget`` prune early.

    Raises ``_StepLimit`` after ``max_steps`` transition steps.
    """
    n = len(chain)
    avail = budget - chain.floor
    if avail < 0 or chain.final_bytes > budget:
        return None
    steps = 0
    sizes = [it.size for it in chain.items]
    costs = [it.cost for it in chain.items]
    pm = [0.0]
    pc = [0.0]
    for m, c in zip(sizes, costs):
        pm.append(pm[-1] + m)
        pc.append(pc[-1] + c)

    # State: (kept_bytes, max_run, cost, anchor, parent_state | None).
    # Parent pointers reference state tuples directly, so dominance pruning
    # (which rewrites frontier lists) cannot invalidate a reconstruction.
    frontier: list[list[tuple]] = [[] for _ in range(n + 2)]
    frontier[0] = [(0.0, 0.0, 0.0, 0, None)]
    exact = True

    def push(j: int, state: tuple) -> None:
        nonlocal steps
        kept, maxrun, cost = state[0], state[1], state[2]
        lst = frontier[j]
        steps += len(lst) + 1
        for s in lst:
            if s[0] <= kept and s[1] <= maxrun and s[2] <= cost:
                return                   # dominated
        lst[:] = [s for s in lst
                  if not (kept <= s[0] and maxrun <= s[1] and cost <= s[2])]
        lst.append(state)

    for j in range(n + 1):               # anchor 0 = start, j = item j-1 kept
        states = frontier[j]
        if not states:
            continue
        if len(states) > MAX_STATES:
            states.sort(key=lambda s: (s[2], s[0], s[1]))
            del states[MAX_STATES:]
            exact = False
        for state in list(states):
            kept, maxrun = state[0], state[1]
            cost = state[2]
            steps += n + 1 - j
            if max_steps is not None and steps > max_steps:
                raise _StepLimit
            for k in range(j + 1, n + 2):
                run_b = pm[min(k - 1, n)] - pm[j]
                run_c = pc[min(k - 1, n)] - pc[j]
                nmax = max(maxrun, run_b)
                if kept + nmax > avail:
                    break                # run bytes only grow with k
                if k <= n:               # keep item k-1
                    if kept + sizes[k - 1] + nmax > avail:
                        continue         # this anchor is too big; later may fit
                    push(k, (kept + sizes[k - 1], nmax, cost + run_c,
                             k, state))
                else:                    # virtual end: tail dropped
                    push(k, (kept, nmax, cost + run_c, k, state))

    end = frontier[n + 1]
    if not end:
        return None
    best = min(end, key=lambda s: (s[2], s[0]))
    keep: set[int] = set()
    node = best[4]                       # skip the virtual-end hop itself
    while node is not None:
        if 1 <= node[3] <= n:
            keep.add(node[3] - 1)
        node = node[4]
    p = _mk(chain, keep, budget, "optimal_dp")
    p.exact = exact
    return p


def _dp_blocks(chain: Chain, budget: float) -> Optional[Plan]:
    """DP on a size-balanced coarsening of a long chain.

    Consecutive items are grouped into at most ``DP_MAX_ITEMS`` blocks of
    roughly equal bytes; the DP keeps or drops whole blocks.  Because
    blocks are consecutive, scoring the expanded keep set on the full
    chain gives exactly the block-level cost and peak — the restriction
    is only over which subsets are reachable, so the answer is feasible
    but possibly suboptimal (``exact=False``).
    """
    n = len(chain)
    sizes = [it.size for it in chain.items]
    target = max(sum(sizes) / DP_MAX_ITEMS, 1.0)
    blocks: list[list[int]] = []
    cur: list[int] = []
    acc = 0.0
    for i, m in enumerate(sizes):
        cur.append(i)
        acc += m
        if acc >= target and len(blocks) < DP_MAX_ITEMS - 1:
            blocks.append(cur)
            cur, acc = [], 0.0
    if cur:
        blocks.append(cur)
    bitems = [ChainItem(sid=-(b + 1),
                        size=sum(chain.items[i].size for i in members),
                        cost=sum(chain.items[i].cost for i in members),
                        producer=chain.items[members[-1]].producer)
              for b, members in enumerate(blocks)]
    bchain = Chain(bitems, chain.floor, chain.base_cost,
                   name=chain.name + "/blocks", n_ops=chain.n_ops,
                   n_candidates_total=chain.n_candidates_total)
    p = _dp(bchain, budget)
    if p is None:
        return None
    keep = {i for b in p.keep for i in blocks[b]}
    out = _mk(chain, keep, budget, "optimal_dp", exact=False,
              coarsened=len(blocks))
    return out


def enumerate_optimal(chain: Chain, budget: float) -> Optional[Plan]:
    """Brute-force subset oracle (differential tests only; n ≤ 20)."""
    n = len(chain)
    assert n <= 20, "enumeration oracle is exponential"
    best: Optional[Plan] = None
    for mask in range(1 << n):
        keep = {i for i in range(n) if mask >> i & 1}
        p = _mk(chain, keep, budget, "enumerate")
        if p.feasible and (best is None or (p.cost, len(p.keep))
                           < (best.cost, len(best.keep))):
            best = p
    return best


def optimal_dp(chain: Chain, budget: float) -> Optional[Plan]:
    """Best known plan at ``budget``: the DP optimum, floored by the Chen
    variants and keep-all (so ``optimal_dp ≤ chen_*`` holds structurally
    even if the DP ever truncates).  None when no selection fits."""
    try:
        dp = _dp(chain, budget, max_steps=DP_MAX_STEPS)
    except _StepLimit:
        dp = None
    blocks = _dp_blocks(chain, budget) if len(chain) > DP_MAX_ITEMS else None
    cands = [p for p in (dp, blocks,
                         chen_greedy(chain, budget),
                         chen_sqrt(chain, budget),
                         _mk(chain, range(len(chain)), budget, "keep_all"))
             if p is not None and p.feasible]
    if not cands:
        return None
    best = min(cands, key=lambda p: (p.cost, len(p.keep)))
    if best.solver != "optimal_dp":
        best = Plan(best.keep, best.cost, best.peak, budget, "optimal_dp",
                    best.feasible, best.exact,
                    dict(best.meta, via=best.solver))
    return best


SOLVERS = {
    "chen_sqrt": chen_sqrt,
    "chen_greedy": chen_greedy,
    "optimal_dp": optimal_dp,
}
