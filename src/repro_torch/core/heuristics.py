"""Eviction heuristics (Sec. 4.1 + Appendix C.3/D.1 of the DTR paper).

All heuristics are score functions over storages; the runtime evicts the
minimum-score storage.  The ablation grid h'(s, m, c) of Appendix D.1 is
exposed via ``make_ablation``; the named heuristics from the paper are module
singletons/factories:

    h_dtr        (c0 + Σ_{e*} c0) / (m · s)     exact evicted neighborhood
    h_dtr_eq     (c0 + Σ_{ẽ*} c0) / (m · s)     union-find approximation
    h_dtr_local  c0 / (m · s)
    h_lru        1 / s
    h_size       1 / m                           GreedyRemat (Kumar et al.)
    h_msps       (c0 + Σ_{anc_e} c0) / m         MSPS (Peng et al.)
    h_rand       U(0, 1)
    h_estar      c0 + Σ_{e*} c0                  Thm 3.1 heuristic (h_{e*})
"""
from __future__ import annotations

import random


class Heuristic:
    """Score function over storages; the runtime evicts the minimum.

    A heuristic may additionally declare a *staleness-separable*
    decomposition for the incremental eviction index
    (``repro.core.evict_index``)::

        score(S, clock) == key(S) / staleness(S)   if uses_staleness
        score(S, clock) == key(S)                  otherwise

    ``key`` must be free of the clock: it changes only on discrete events
    (evict / remat / banish / alias registration), so heap entries keyed on
    it stay valid as simulated time advances.  Heuristics that cannot offer
    this (``h_rand`` consumes RNG state per evaluation) leave ``separable``
    False and the runtime falls back to the linear scan.

    Contract for ``uses_staleness=False``: ``key`` must be the *same
    expression* as ``score`` (bit-identical floats, not merely equal
    values) — the index's key-ordered selection breaks ties by sid under
    that identity.  Staleness-aware keys may associate differently from
    their score formula (e.g. ``(c/m)/t`` vs ``c/(m*t)``); the index
    absorbs the ulp-level difference with epsilon slack on its bounds and
    always re-verifies with ``score`` itself.
    """

    name: str = "base"
    needs_uf: bool = False
    separable: bool = False         # has a key()/staleness decomposition
    uses_staleness: bool = False    # score == key / staleness
    cost_aware: bool = False        # key prices recomputation (per byte) —
    #                                 required as the base of the two-choice
    #                                 hybrid offload policy (repro.offload)

    def score(self, rt, s) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def key(self, rt, s) -> float:  # pragma: no cover - interface
        raise NotImplementedError(f"{self.name} is not separable")

    def __repr__(self) -> str:
        return f"<heuristic {self.name}>"


class HDTR(Heuristic):
    """Full h_DTR with exact evicted neighborhood e*.

    The numerator charges the storage's own compute, the aggregate cost of
    dead subgraphs attached to it (``dead_cost`` — evicted cones the e*
    walk no longer traverses member-by-member), and the live evicted
    neighborhood.
    """
    name = "h_dtr"
    separable = True
    uses_staleness = True
    cost_aware = True

    def score(self, rt, s) -> float:
        c = s.local_cost + s.dead_cost + rt.evicted_neighborhood_cost(s)
        return c / (s.size * rt.staleness(s))

    def key(self, rt, s) -> float:
        return (s.local_cost + s.dead_cost
                + rt.evicted_neighborhood_cost(s)) / s.size


class HDTREq(Heuristic):
    """h_DTR^eq: union-find ẽ* with the splitting approximation.

    ``key()`` reads the cached per-root component sums maintained
    incrementally by the union-find (via ``eq_neighborhood_cost``'s
    snapshot fast path) — no neighborhood re-walk per recomputation.
    """
    name = "h_dtr_eq"
    needs_uf = True
    separable = True
    uses_staleness = True
    cost_aware = True

    def score(self, rt, s) -> float:
        # No ``dead_cost`` term here: dead storages are *members* of the
        # equivalence classes, so their compute already sits in the
        # component sums ẽ* reads (the exact walk instead prunes them and
        # charges the attached cones).
        c = s.local_cost + rt.eq_neighborhood_cost(s)
        return c / (s.size * rt.staleness(s))

    def key(self, rt, s) -> float:
        return (s.local_cost + rt.eq_neighborhood_cost(s)) / s.size


class HDTRLocal(Heuristic):
    name = "h_dtr_local"
    separable = True
    uses_staleness = True
    cost_aware = True

    def score(self, rt, s) -> float:
        return s.local_cost / (s.size * rt.staleness(s))

    def key(self, rt, s) -> float:
        return s.local_cost / s.size


class HLRU(Heuristic):
    name = "h_lru"
    separable = True
    uses_staleness = True

    def score(self, rt, s) -> float:
        return 1.0 / rt.staleness(s)

    def key(self, rt, s) -> float:
        return 1.0


class HSize(Heuristic):
    name = "h_size"
    separable = True

    def score(self, rt, s) -> float:
        return 1.0 / max(s.size, 1)

    def key(self, rt, s) -> float:
        return 1.0 / max(s.size, 1)


class HMSPS(Heuristic):
    """MSPS: rematerialization cost over evicted *ancestors*, per byte."""
    name = "h_msps"
    separable = True
    cost_aware = True

    def score(self, rt, s) -> float:
        c = s.local_cost + rt.evicted_ancestor_cost(s)
        return c / max(s.size, 1)

    def key(self, rt, s) -> float:
        return self.score(rt, s)


class HRandom(Heuristic):
    name = "h_rand"
    # Not separable: each evaluation consumes RNG state, so the sampled
    # sequence is tied to the linear scan's evaluation order.

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)

    def score(self, rt, s) -> float:
        return self._rng.random()


class HEStar(Heuristic):
    """h_{e*} from Sec. 3 / App. A: projected cost per byte, no staleness.

    Under unit cost/size this reduces to |e*(t)| + 1, the heuristic of
    Theorem 3.1 (evict the tensor with the smallest evicted neighborhood).
    """
    name = "h_estar"
    separable = True
    cost_aware = True

    def score(self, rt, s) -> float:
        return (s.local_cost + s.dead_cost
                + rt.evicted_neighborhood_cost(s)) / max(s.size, 1)

    def key(self, rt, s) -> float:
        return self.score(rt, s)


class HAblation(Heuristic):
    """Parameterized h'(s, m, c) of Appendix D.1.

    stale  in {True, False}
    mem    in {True, False}
    cost   in {"estar", "eq", "local", "no"}
    """

    separable = True

    def __init__(self, stale: bool, mem: bool, cost: str) -> None:
        assert cost in ("estar", "eq", "local", "no")
        self.stale, self.mem, self.cost = stale, mem, cost
        self.needs_uf = cost == "eq"
        self.uses_staleness = stale
        self.cost_aware = cost != "no"
        self.name = (f"h_s{'1' if stale else '0'}"
                     f"m{'1' if mem else '0'}c_{cost}")

    def _numer(self, rt, s) -> float:
        if self.cost == "estar":
            return (s.local_cost + s.dead_cost
                    + rt.evicted_neighborhood_cost(s))
        if self.cost == "eq":
            return s.local_cost + rt.eq_neighborhood_cost(s)
        if self.cost == "local":
            return s.local_cost
        return 1.0

    def score(self, rt, s) -> float:
        c = self._numer(rt, s)
        denom = 1.0
        if self.mem:
            denom *= max(s.size, 1)
        if self.stale:
            denom *= rt.staleness(s)
        return c / denom

    def key(self, rt, s) -> float:
        c = self._numer(rt, s)
        denom = 1.0
        if self.mem:
            denom *= max(s.size, 1)
        return c / denom


def make_ablation(stale: bool, mem: bool, cost: str) -> Heuristic:
    return HAblation(stale, mem, cost)


def window_cost(rt, heuristic: Heuristic, storages, cache=None) -> float:
    """Summed heuristic score of a candidate eviction window.

    Contiguity-aware eviction (``repro.alloc``) ranks contiguous windows of
    storages by this aggregate instead of scoring storages one at a time.

    When the runtime carries an eviction index, scores come from the
    index's shared per-storage memo (``EvictIndex.cached_score``) — the
    same memo victim-selection verification reads — so the window planner
    and ``_pick_victim`` score each storage once per instant and count
    metadata accesses identically (one per fresh evaluation, zero per
    hit).  Without an index, ``cache`` (sid -> score) amortizes repeated
    scoring within one planning pass, each fresh evaluation counting one
    metadata access as in the linear-scan ``_pick_victim``.  An explicit
    ``cache`` dict is honored (and populated) in both modes.
    """
    idx = getattr(rt, "index", None)
    use_idx = idx is not None and heuristic is rt.heuristic
    total = 0.0
    for s in storages:
        if cache is not None and s.sid in cache:
            total += cache[s.sid]
            continue
        if use_idx:
            sc = idx.cached_score(s)
        else:
            rt.meta_accesses += 1
            sc = heuristic.score(rt, s)
        if cache is not None:
            cache[s.sid] = sc
        total += sc
    return total


def by_name(name: str, seed: int = 0) -> Heuristic:
    table = {
        "h_dtr": HDTR,
        "h_dtr_eq": HDTREq,
        "h_dtr_local": HDTRLocal,
        "h_lru": HLRU,
        "h_size": HSize,
        "h_msps": HMSPS,
        "h_estar": HEStar,
    }
    if name == "h_rand":
        return HRandom(seed)
    return table[name]()


ALL_NAMES = ["h_dtr", "h_dtr_eq", "h_dtr_local", "h_lru", "h_size",
             "h_msps", "h_rand"]
