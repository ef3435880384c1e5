"""Union-find with per-component cost sums and the paper's split approximation.

This is the data structure behind the ``h_DTR^eq`` heuristic (Sec. 4.1 /
Appendix C.2 of the DTR paper): evicted storages form *evicted components*
(connected components of the undirected dependency graph restricted to evicted
storages). Each component tracks the running sum of its members' compute
costs.  Union-find supports near-constant merging; splitting (needed when a
storage is rematerialized) is approximated per the paper: subtract the
storage's own cost from its component sum and move it to a fresh singleton —
leaving "phantom connections" behind, which is exactly the approximation the
paper evaluates.

The per-root sums are maintained *incrementally*: every ``union`` adds the
absorbed root's sum into the surviving root, ``add_cost`` adjusts a
component in place (alias registration on an evicted storage grows its
member cost), and ``split_approx`` subtracts the detached member — so a
component's current sum is always one ``find`` away.  ``h_dtr_eq`` key
recomputation reads these cached root sums directly (``root_sum``) instead
of re-walking a storage's neighborhood per key (see
``DTRRuntime.eq_neighborhood_cost``).
"""
from __future__ import annotations


class CostUnionFind:
    """Union-find over integer handles with a cost accumulator per root.

    ``accesses`` counts element visits (parent-chain hops + cost reads) so the
    runtime can reproduce the metadata-overhead accounting of Appendix D.3.
    ``unions`` / ``splits`` count structural events (telemetry only).
    """

    __slots__ = ("_parent", "_rank", "_cost", "accesses", "unions", "splits")

    def __init__(self) -> None:
        self._parent: list[int] = []
        self._rank: list[int] = []
        self._cost: list[float] = []
        self.accesses = 0
        self.unions = 0
        self.splits = 0

    def make(self, cost: float = 0.0) -> int:
        """Create a fresh singleton set; returns its handle."""
        h = len(self._parent)
        self._parent.append(h)
        self._rank.append(0)
        self._cost.append(float(cost))
        return h

    def find(self, x: int) -> int:
        # Path halving; count hops as metadata accesses.
        p = self._parent
        while p[x] != x:
            self.accesses += 1
            p[x] = p[p[x]]
            x = p[x]
        self.accesses += 1
        return x

    def union(self, a: int, b: int) -> int:
        """Merge the sets of ``a`` and ``b``; cost sums add. Returns new root."""
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        self._cost[ra] += self._cost[rb]
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1
        self.accesses += 1
        self.unions += 1
        return ra

    def cost(self, x: int) -> float:
        """Cost sum of x's component."""
        r = self.find(x)
        self.accesses += 1
        return self._cost[r]

    def root_sum(self, r: int) -> float:
        """Incrementally-maintained cost sum of root ``r`` (no find).

        Callers that already resolved the root (e.g. the ``h_dtr_eq``
        fast-path key rebuild, which dedupes roots across a cached
        adjacency snapshot) read the component sum in O(1); the read is
        charged as one metadata access.
        """
        self.accesses += 1
        return self._cost[r]

    def add_cost(self, x: int, delta: float) -> None:
        r = self.find(x)
        self._cost[r] += delta
        self.accesses += 1

    def split_approx(self, x: int, own_cost: float) -> int:
        """The paper's splitting approximation.

        On rematerialization of storage with handle ``x`` — and equally on
        *death* of an evicted storage (dead-subgraph pruning): subtract its
        own cost from the (old) component sum, then assign it a brand-new
        empty component.  Returns the new handle (callers must re-point the
        storage at it).  No edges are actually removed — "phantom
        dependencies" may persist, per Appendix C.2.
        """
        r = self.find(x)
        self._cost[r] -= own_cost
        # Guard tiny negative drift from float accumulation.
        if self._cost[r] < 0.0:
            self._cost[r] = 0.0
        self.accesses += 1
        self.splits += 1
        return self.make(0.0)

    def same(self, a: int, b: int) -> bool:
        return self.find(a) == self.find(b)
