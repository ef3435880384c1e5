"""LP-relaxation lower bound on recompute cost over the full op DAG.

Checkmate (arXiv:1910.02653) lower-bounds any rematerialization schedule
with the LP relaxation of its ILP.  An ILP solver is unavailable in this
container, so we use the *fractional covering* core of that relaxation,
which needs no integer machinery and stays valid for every execution that
follows the trace's operator order — online DTR runs and executed static
plans alike:

* variable ``z_s ∈ [0,1]`` per potentially-evictable storage — "was ``s``
  ever dropped while still needed later";
* at each *pinch* op ``t`` whose must-resident bytes exceed the budget
  ``B``, the bytes shed must cover the deficit:
  ``Σ_{s ∈ L_t} m_s z_s ≥ need_t − B``;
* objective ``min Σ c_s z_s`` where ``c_s`` lower-bounds the recompute
  price of dropping ``s`` (its producer's cost, split across the
  producer's owning outputs — one replay revives all siblings, so each
  may only claim its share).

``L_t`` contains storages produced at or before ``t`` with a touch
strictly after ``t`` (so dropping them implies a later replay), excluding
constants and op ``t``'s own tensors (those are unsheddable at ``t`` and
counted in ``need_t``); storages past their last touch shed for free and
appear in neither side.  Any feasible schedule induces a 0/1 assignment
satisfying every constraint with cost ≤ its true recompute cost, hence
the LP optimum is a valid floor.  Dropping constraints only loosens the
bound, so the constraint set is capped at the deepest deficits.

Solvers: ``scipy.optimize.linprog`` (method="highs") when importable —
the exact LP optimum; otherwise a greedy dual-feasible ascent (process
pinches by descending deficit, raise each dual price to the tightest
remaining ratio ``c_s / m_s``) — a weaker but still valid bound by weak
duality, reported with ``exact=False``.
"""
from __future__ import annotations

from dataclasses import dataclass

from .chain import LogView

#: Constraint cap: pinch ops are ranked by deficit and only the deepest
#: this-many enter the LP (a pure relaxation — the bound stays valid).
MAX_CONSTRAINTS = 128


@dataclass
class LPBound:
    """Lower bound on extra recompute cost at one byte budget."""
    value: float                    # Σ c_s z_s floor (0.0 when unconstrained)
    exact: bool                     # True: LP optimum; False: dual-greedy
    infeasible: bool                # some pinch cannot be covered at all
    n_vars: int
    n_constraints: int
    solver: str                     # "scipy" | "dual_greedy" | "trivial"

    def overhead_floor(self, base_cost: float) -> float:
        return (base_cost + self.value) / max(base_cost, 1e-12)


def _touches(view: LogView):
    """Per-storage sorted touch ordinals (producer, uses, finalize)."""
    n = view.n_ops
    out = []
    for s in view.storages:
        t = list(s.uses)
        if s.producer is not None:
            t.append(s.producer)
        if s.kept:
            t.append(n)             # finalize materializes it once more
        out.append(sorted(set(t)))
    return out

def _remat_price(view: LogView) -> list[float]:
    """c_s: producer cost split across the producer's owning outputs."""
    owners: dict[int, int] = {}
    for s in view.storages:
        if s.producer is not None and s.size > 0:
            owners[s.producer] = owners.get(s.producer, 0) + 1
    price = []
    for s in view.storages:
        if s.producer is None or s.size <= 0:
            price.append(0.0)
        else:
            price.append(s.producer_cost / owners[s.producer])
    return price


def lp_lower_bound(view: LogView, budget: float) -> LPBound:
    """Valid recompute-cost floor for any order-preserving schedule at
    ``budget`` bytes (eager/ignore deallocation; constants resident)."""
    n = view.n_ops
    touches = _touches(view)
    price = _remat_price(view)

    # Build, per op t: must-resident bytes and the sheddable live set L_t.
    # A storage is *fixed* at t when t is one of its touches (inputs/
    # outputs of op t must be resident) or it is a constant; it is
    # *flexible* (in L_t) between touches.  Difference arrays give the
    # fixed/flexible byte profiles in O(storages + touches).
    const_bytes = sum(s.size for s in view.storages if s.constant)

    flex_delta = [0.0] * (n + 1)
    fixed_at: dict[int, float] = {}
    cand: list[int] = []            # storages that are ever flexible
    for s in view.storages:
        if s.constant or s.size <= 0 or s.producer is None:
            continue
        ts = touches[s.sid]
        for t in ts:
            if t < n:
                fixed_at[t] = fixed_at.get(t, 0) + s.size
        flexible = False
        for a, b in zip(ts, ts[1:]):
            if b - a >= 2:          # live-but-untouched span (a, b)
                flex_delta[a + 1] += s.size
                flex_delta[min(b, n)] -= s.size
                flexible = True
        if flexible:
            cand.append(s.sid)

    deficits: list[tuple[float, int]] = []
    acc = 0.0
    for t in range(n):
        acc += flex_delta[t]
        need = const_bytes + fixed_at.get(t, 0.0) + acc
        if need > budget:
            deficits.append((need - budget - acc, t))  # store fixed-side gap
    if not deficits or not cand:
        if deficits:                # pressure exists but nothing sheddable
            return LPBound(float("inf"), True, True, 0, len(deficits),
                           "trivial")
        return LPBound(0.0, True, False, len(cand), 0, "trivial")

    # Keep the deepest pinches (by full deficit need - budget).
    full = sorted(((fd + _flex_at(view, touches, cand, t), t)
                   for fd, t in deficits), reverse=True)
    # _flex_at recomputes Σ L_t; equivalent to acc at t but explicit per
    # retained constraint so rows and right-hand sides cannot drift.
    rows: list[tuple[int, dict[int, float], float]] = []
    for need_minus_b, t in full[:MAX_CONSTRAINTS]:
        members = _live_set(view, touches, cand, t)
        d = need_minus_b
        if d <= 0:
            continue
        cover = sum(view.storages[sid].size for sid in members)
        if cover < d - 1e-9:
            return LPBound(float("inf"), True, True, len(cand),
                           len(rows) + 1, "trivial")
        rows.append((t, {sid: float(view.storages[sid].size)
                         for sid in members}, d))
    if not rows:
        return LPBound(0.0, True, False, len(cand), 0, "trivial")

    var_ids = sorted({sid for _, mem, _ in rows for sid in mem})
    bound, exact, solver = _solve(rows, var_ids, price)
    return LPBound(bound, exact, False, len(var_ids), len(rows), solver)


def _flex_at(view: LogView, touches, cand, t: int) -> float:
    return sum(view.storages[sid].size
               for sid in _live_set(view, touches, cand, t))


def _live_set(view: LogView, touches, cand, t: int) -> list[int]:
    """Members of L_t: flexible (live, untouched, needed-later) at op t."""
    import bisect
    out = []
    for sid in cand:
        ts = touches[sid]
        i = bisect.bisect_right(ts, t)
        # live span (prev touch, next touch) strictly containing t
        if 0 < i < len(ts) and ts[i - 1] < t < ts[i]:
            out.append(sid)
    return out


def _solve(rows, var_ids, price) -> tuple[float, bool, str]:
    try:
        import numpy as np
        from scipy.optimize import linprog
    except ImportError:
        return _dual_greedy(rows, var_ids, price), False, "dual_greedy"
    idx = {sid: i for i, sid in enumerate(var_ids)}
    c = np.array([price[sid] for sid in var_ids])
    A = np.zeros((len(rows), len(var_ids)))
    b = np.zeros(len(rows))
    for r, (_, mem, d) in enumerate(rows):
        for sid, m in mem.items():
            A[r, idx[sid]] = -m
        b[r] = -d
    res = linprog(c, A_ub=A, b_ub=b, bounds=[(0.0, 1.0)] * len(var_ids),
                  method="highs")
    if not res.success:             # numerical trouble: fall back, stay valid
        return _dual_greedy(rows, var_ids, price), False, "dual_greedy"
    return float(res.fun), True, "scipy"


def _dual_greedy(rows, var_ids, price) -> float:
    """Dual-feasible ascent: a valid (weaker) floor without scipy.

    Relaxing the z ≤ 1 caps gives a pure covering LP whose dual asks for
    prices ``y_t ≥ 0`` with ``Σ_t m_s y_t ≤ c_s``; any feasible ``y``
    yields the bound ``Σ_t d_t y_t`` by weak duality (and dropping the
    caps only lowers the optimum, so the bound transfers).  Greedy:
    biggest deficits first, each priced at the tightest remaining
    ``c_s / m_s`` over its members.
    """
    slack = {sid: price[sid] for sid in var_ids}
    bound = 0.0
    for _, mem, d in sorted(rows, key=lambda r: (-r[2], r[0])):
        y = min((slack[sid] / m for sid, m in mem.items() if m > 0),
                default=0.0)
        if y <= 0:
            continue
        bound += d * y
        for sid, m in mem.items():
            slack[sid] -= y * m
    return bound
