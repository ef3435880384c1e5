"""Incremental eviction index: sublinear victim selection for the DTR runtime.

The paper's own overhead analysis (App. C.5/D.3) concedes that victim
selection dominates runtime cost: the naive engine rebuilds the candidate
list from *all* storages and re-scores every one on *every* eviction, and a
global version counter discards every cached ``e*`` neighborhood on every
evict/remat.  This module replaces both with incremental structures:

``ScopedInvalidator``
    Tracks *evicted connected components* (the same merge-on-evict /
    phantom-on-remat approximation the paper uses for ``h_DTR^eq``) in a
    lightweight epoch-based union-find, plus a per-component **subscriber
    set**: the resident storages whose cached neighborhood costs were
    computed through that component.  An evict/remat then invalidates only
    the caches in the affected component — not the whole table.  The scope
    is a sound over-approximation: phantom connections left by remats can
    widen a component (extra invalidations), never narrow it (a cached
    value is dropped whenever any storage it summed over changes state).

``EvictIndex``
    A live evictable-storage set maintained on state transitions (storage
    field writes notify the index; no per-eviction rebuild), with
    **verified lazy heaps** over the staleness-free part of the heuristic
    score.  Separable heuristics declare ``score = key(S) / staleness(S)``
    (or ``score = key(S)`` for staleness-free heuristics); ``key`` only
    changes on discrete events (evict / remat / banish / alias
    registration), so heap entries stay valid as the clock advances.
    Staleness-free heuristics use a single min-heap popped in key order.
    Staleness-aware heuristics bucket candidates into geometric key bands
    (quarter-octave: keys within a band differ by less than 2^(1/4)),
    each band a lazy min-heap over last-access times: a band whose floor
    key over its oldest member's staleness exceeds the best score so far
    is skipped whole in O(1), and inside a band the oldest-first walk
    stops as soon as the floor-key bound passes the best.  Every candidate that survives
    its bounds is *verified* — its exact score recomputed with the
    heuristic's own formula — so the selected victim is *bit-exact* with
    the linear scan's argmin, tie-breaking (lowest sid among equal scores,
    i.e. first in ``storages`` iteration order) included.

The linear scan remains in ``DTRRuntime._pick_victim`` as the reference
oracle (``index=False``), and is also the automatic fallback for
non-separable heuristics (``h_rand`` advances an RNG per evaluation) and
for the ``sample_sqrt`` / ``ignore_small_frac`` approximations, whose
sampling sequences the heap cannot reproduce.
"""
from __future__ import annotations

import bisect
import heapq
from math import frexp as _frexp, ldexp as _ldexp
from typing import Optional

# Relative slack on the early-stop bound.  ``key`` is computed with a
# different association of the same factors as ``score`` (e.g. ``(c/m)/t``
# vs ``c/(m*t)``), so the two can differ by a few ulps; the bound must not
# prune a storage whose exact score ties the current best within rounding.
_BOUND_EPS = 1e-9
_MIN_STALENESS = 1e-9  # mirrors DTRRuntime.staleness


class _EpochUF:
    """Identity-only union-find with epoch nodes (no splitting needed).

    A storage gets a *fresh* node each time it is evicted, so a
    rematerialized-then-re-evicted storage rejoins as a singleton and
    merges with the *current* components of its neighbors; its old node
    lingers as a phantom inside whatever component absorbed it, which only
    widens invalidation scopes (sound).  Bookkeeping hops are not counted
    as heuristic metadata accesses.
    """

    __slots__ = ("_parent",)

    def __init__(self) -> None:
        self._parent: list[int] = []

    def make(self) -> int:
        h = len(self._parent)
        self._parent.append(h)
        return h

    def find(self, x: int) -> int:
        p = self._parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        # Union by index: keep the smaller root (deterministic, no rank).
        if ra > rb:
            ra, rb = rb, ra
        self._parent[rb] = ra
        return ra


class ScopedInvalidator:
    """Per-component dirty-sets for cached neighborhood costs.

    The runtime calls :meth:`subscribe` while walking a closure ("the value
    cached for ``consumer`` summed over evicted storage ``dep``") and the
    event hooks on state transitions.  Invalidation distinguishes two
    classes per affected consumer:

    * **full** — the consumer's *adjacency* changed (a neighbor entered or
      left the evicted set): both the cached value and the ẽ* adjacency
      snapshot (``rt._eq_adj``) are dropped, forcing a neighborhood
      re-walk (which re-subscribes);
    * **sum-only** — only an adjacent component's *sum* changed (a merge,
      split, or member cost growth elsewhere in the component): the value
      is dropped but the snapshot survives, so the eq key rebuilds from
      the union-find's incrementally-maintained per-root sums in O(roots)
      — and the consumer stays subscribed to the (possibly merged)
      component.

    Exact e* closures (``_estar_cache``) cannot be rebuilt from component
    sums, so both classes drop them; their consumers re-subscribe on the
    next walk.  Dead storages (``StorageRec.dead``) are pruned: they never
    receive epoch nodes, never merge, and their eviction fires no
    neighborhood invalidation at all (:meth:`on_dead_evict`).
    """

    def __init__(self, rt) -> None:
        self.rt = rt
        self._uf = _EpochUF()
        self._node: dict[int, int] = {}       # sid -> current epoch node
        self._subs: dict[int, set[int]] = {}  # root -> subscriber sids
        self.invalidations = 0                # telemetry: entries dropped
        self.subscribes = 0                   # telemetry: registrations

    # -- closure bookkeeping -------------------------------------------
    def _node_of(self, sid: int) -> int:
        n = self._node.get(sid)
        if n is None:
            n = self._uf.make()
            self._node[sid] = n
        return n

    def subscribe(self, dep_sid: int, consumer_sid: int) -> None:
        self.subscribes += 1
        root = self._uf.find(self._node_of(dep_sid))
        subs = self._subs.get(root)
        if subs is None:
            self._subs[root] = {consumer_sid}
        else:
            subs.add(consumer_sid)

    # -- state-transition hooks ----------------------------------------
    def on_evict(self, s) -> None:
        """``s`` left residency (evicted, or created not-yet-materialized).

        Gives ``s`` a fresh epoch node, merges it with the components of
        its evicted neighbors, and invalidates (a) the subscribers of every
        merged component — their closures can now extend through ``s``
        (sum-only for eq consumers: their adjacency is unchanged) — and
        (b) the resident neighbors of ``s``, whose closures gain ``s``
        itself (full: their adjacency grew).
        """
        rt = self.rt
        node = self._uf.make()
        self._node[s.sid] = node
        full: set[int] = {s.sid}
        moved: set[int] = set()
        for nsid in s.deps | s.children:
            ns = rt.storages.get(nsid)
            if ns is None or ns.banished or (ns.dead and rt.uf is None):
                # Without a cost union-find, dead storages are fully
                # pruned; with one they are ẽ* component members whose
                # epoch components must keep mirroring the cost ones.
                continue
            if ns.resident or ns.offloaded:
                # Offloaded neighbors behave like resident ones here: they
                # are outside the evicted components (no remat needed) but
                # their own keys can sum over ``s`` once it is evicted.
                full.add(nsid)
            else:
                r = self._uf.find(self._node_of(nsid))
                sub = self._subs.pop(r, None)
                if sub:
                    moved |= sub
                node = self._uf.union(node, r)
        self._invalidate_full(full)
        self._invalidate_sum(moved - full)
        # Consumers whose adjacency snapshot survived stay subscribed to
        # the merged component (their remembered handles keep resolving to
        # its root); the rest re-subscribe on their next walk.
        adj = rt._eq_adj
        keep = {c for c in moved if c in adj}
        if keep:
            root = self._uf.find(node)
            cur = self._subs.get(root)
            if cur is None:
                self._subs[root] = keep
            else:
                cur |= keep

    def on_unevict(self, s) -> None:
        """``s`` left the evicted set (rematerialized or banished).

        Every cached value that summed over ``s``'s component is stale.
        Subscribers *adjacent* to ``s`` lose it from their neighborhood —
        adjacency changed, so their ẽ* snapshots are dropped too (the
        component-split case the snapshot cannot express).  The remaining
        subscribers see only the component sum shrink (split_approx):
        sum-only, snapshots and subscriptions intact.
        """
        rt = self.rt
        node = self._node.get(s.sid)
        subs = self._subs.get(self._uf.find(node)) if node is not None \
            else None
        full: set[int] = {s.sid}
        if subs:
            for nsid in s.deps | s.children:
                if nsid in subs:
                    full.add(nsid)
            self._invalidate_sum(subs - full)
            subs -= full
            # Estar-only consumers re-subscribe on their next walk; keep
            # only live snapshot holders subscribed.
            adj = rt._eq_adj
            stale = [c for c in subs if c not in adj]
            subs.difference_update(stale)
        self._invalidate_full(full)

    #: Death of an evicted storage splits it out of its component exactly
    #: like a rematerialization (the runtime detaches its union-find handle
    #: and subtracts its cost right after this hook).
    on_death = on_unevict

    def on_dead_evict(self, s) -> None:
        """A dead storage left residency: neighbors' closures never
        included it and never will — only its own consumer entries go."""
        self._invalidate_full({s.sid})

    def on_cost_change(self, s) -> None:
        """``s.local_cost`` grew (alias registration) while ``s`` evicted:
        cached closures summing over ``s`` hold the old cost.  Adjacency is
        unchanged for every subscriber, so the drop is sum-only (the
        runtime has already added the delta to the component sum)."""
        node = self._node.get(s.sid)
        sum_only: set[int] = set()
        if node is not None:
            sum_only |= self._subs.get(self._uf.find(node), set())
        sum_only.discard(s.sid)
        self._invalidate_full({s.sid})
        self._invalidate_sum(sum_only)

    def _invalidate_full(self, sids: set[int]) -> None:
        """Adjacency changed: drop values *and* ẽ* adjacency snapshots."""
        rt = self.rt
        estar, eq, adj = rt._estar_cache, rt._eq_cache, rt._eq_adj
        idx = rt.index
        self.invalidations += len(sids)
        for sid in sids:
            estar.pop(sid, None)
            eq.pop(sid, None)
            adj.pop(sid, None)
            if idx is not None:
                idx.mark_dirty(sid)

    def _invalidate_sum(self, sids: set[int]) -> None:
        """Component sums changed, adjacency intact: drop values, keep the
        ẽ* snapshots (eq keys rebuild via the per-root-sum fast path)."""
        rt = self.rt
        estar, eq = rt._estar_cache, rt._eq_cache
        idx = rt.index
        self.invalidations += len(sids)
        for sid in sids:
            estar.pop(sid, None)
            eq.pop(sid, None)
            if idx is not None:
                idx.mark_dirty(sid)




class EvictIndex:
    """Live evictable set + verified lazy heaps over heuristic keys.

    Two organizations, chosen by the heuristic's declared decomposition:

    * staleness-free (``score == key``): one min-heap over ``(key, sid)``;
      selection pops in (key, sid) order and stops at the first key that
      can neither beat the best score nor win its sid tie-break.
    * staleness-aware (``score == key / staleness``): candidates live in
      geometric key *bands* (band ``b`` holds keys in
      ``[2^(b/GRAIN), 2^((b+1)/GRAIN))``), each band a min-heap over
      ``(last_access, sid)``.  For a band, the floor key over its oldest
      member's staleness lower-bounds every member's score, so selection
      probes each band once (O(1) skip for hopeless bands), walks
      most-promising bands first, and stops a band's oldest-first walk as
      soon as the floor bound passes the best verified score.

    All heap entries are lazy: membership changes, accesses, and key
    invalidations never search the heaps — stale entries are recognized
    and dropped at pop time (``_slot``/``_ver`` record the one canonical
    live entry per storage).
    """

    #: bucket id for exact-zero keys (sorts before every real exponent)
    _ZERO_BAND = -(1 << 30)
    #: bands per key octave: band b holds keys in [2^(b/GRAIN), 2^((b+1)/GRAIN))
    _GRAIN = 4

    def __init__(self, rt) -> None:
        self.rt = rt
        self.heuristic = rt.heuristic
        assert getattr(self.heuristic, "separable", False), (
            f"{self.heuristic!r} does not declare a separable decomposition")
        self.stale = bool(self.heuristic.uses_staleness)
        # Two-choice offload composition (repro.offload.HybridHeuristic):
        # the effective score is min(base recompute side, transfer side).
        # The base keys live in the structures below as usual; a second
        # *offload key family* (``_okeys``/``_obands``/``_okheap``) holds
        # the transfer keys — constant per storage, computed once at
        # membership, never invalidated.  Selection walks both families
        # (each side's band floors bound that side of the min), and every
        # surviving candidate is verified with the full hybrid score, so
        # bit-exactness against the linear scan is preserved.
        self.hybrid = bool(getattr(self.heuristic, "hybrid", False))
        self.members: set[int] = set()
        self._dirty: set[int] = set()
        # sid -> last computed key, present iff still valid.  Keys survive
        # membership flaps (lock/unlock cycles around every operator) — the
        # storage's heap entry simply goes dormant and revives — so only
        # genuine invalidation events trigger recomputation.
        self._keys: dict[int, float] = {}
        # Shared score memo: sid -> (clock, last_access, score).  Consulted
        # by pop-verification *and* ``heuristics.window_cost`` so the
        # allocator's window planner and victim selection score (and count
        # metadata accesses for) each storage identically.
        self._scores: dict[int, tuple[float, float, float]] = {}
        # Staleness-aware organization: key bands of (la, sid) heaps.
        self._bands: dict[int, list[tuple[float, int]]] = {}
        self._band_ids: list[int] = []    # sorted; bands are never removed
        self._floors: dict[int, float] = {}            # band -> floor key
        self._slot: dict[int, tuple[int, float]] = {}  # sid -> (band, la)
        # Staleness-free organization: one (key, sid, version) heap.
        self._kheap: list[tuple[float, int, int]] = []
        self._ver: dict[int, int] = {}
        # Offload key family (hybrid heuristics only).
        self._okeys: dict[int, float] = {}             # sid -> constant key
        self._obands: dict[int, list[tuple[float, int]]] = {}
        self._oband_ids: list[int] = []
        self._oslot: dict[int, tuple[int, float]] = {}
        self._okheap: list[tuple[float, int]] = []     # staleness-free side
        self._oin: set[int] = set()                    # sids with live entry
        # Telemetry.
        self.picks = 0
        self.pops = 0
        self.key_recomputes = 0

    # -- notifications --------------------------------------------------
    def register(self, s) -> None:
        """Attach a newly created storage to the index."""
        s._index = self
        self.on_storage_event(s, "resident")

    def on_storage_event(self, s, name: str) -> None:
        sid = s.sid
        if name == "last_access":
            if self.stale and sid in self.members:
                if sid in self._keys:
                    self._place(sid, self._keys[sid], s.last_access)
                if self.hybrid:
                    self._oplace(sid, self._okeys[sid], s.last_access)
            return
        if name == "local_cost":
            # The staleness-free key depends on local_cost for every
            # cost-aware heuristic.
            self.mark_dirty(sid)
            return
        # resident / locks / pinned / banished / constant: membership.
        now = (s.resident and not s.pinned and not s.banished
               and s.locks == 0 and not s.constant and s.size > 0)
        if now and sid not in self.members:
            self.members.add(sid)
            k = self._keys.get(sid)
            if k is None:
                self._dirty.add(sid)
            elif self.stale:
                self._place(sid, k, s.last_access)
            # staleness-free: the dormant (k, sid, ver) entry revives.
            if self.hybrid:
                ok = self._okeys.get(sid)
                if ok is None:
                    ok = self._okeys[sid] = self.heuristic.offload_key(s)
                if self.stale:
                    self._oplace(sid, ok, s.last_access)
                elif sid not in self._oin:
                    heapq.heappush(self._okheap, (ok, sid))
                    self._oin.add(sid)
        elif not now and sid in self.members:
            self.members.discard(sid)
            self._dirty.discard(sid)
            # Heap entries go dormant via the membership check on pop; the
            # key itself stays valid unless an invalidation event drops it.

    def mark_dirty(self, sid: int) -> None:
        self._scores.pop(sid, None)
        self._keys.pop(sid, None)
        if sid in self.members:
            self._dirty.add(sid)

    # -- internal placement ---------------------------------------------
    # Quarter-octave mantissa boundaries (frexp mantissas live in [0.5, 1)).
    _Q = (0.5, 2.0 ** -0.75, 2.0 ** -0.5, 2.0 ** -0.25)

    @classmethod
    def _band_of(cls, k: float) -> int:
        """Band id = GRAIN*exponent + quarter; its floor is <= k exactly
        (mantissa thresholds are the same float constants ``_floor_of``
        rescales with exact power-of-two multiplication)."""
        if k <= 0.0:
            return cls._ZERO_BAND
        m, e = _frexp(k)
        q = cls._Q
        j = 3 if m >= q[3] else 2 if m >= q[2] else 1 if m >= q[1] else 0
        return cls._GRAIN * e + j

    def _floor_of(self, b: int) -> float:
        f = self._floors.get(b)
        if f is None:
            if b == self._ZERO_BAND:
                f = 0.0
            else:
                e, j = divmod(b, self._GRAIN)
                f = _ldexp(self._Q[j], e)
            self._floors[b] = f
        return f

    def _place(self, sid: int, k: float, la: float) -> None:
        """Ensure the canonical band entry for ``sid`` is (band(k), la)."""
        b = self._band_of(k)
        if self._slot.get(sid) == (b, la):
            return
        heap = self._bands.get(b)
        if heap is None:
            heap = self._bands[b] = []
            bisect.insort(self._band_ids, b)
        heapq.heappush(heap, (la, sid))
        self._slot[sid] = (b, la)

    def _oplace(self, sid: int, k: float, la: float) -> None:
        """Offload-family twin of :meth:`_place` (hybrid heuristics)."""
        b = self._band_of(k)
        if self._oslot.get(sid) == (b, la):
            return
        heap = self._obands.get(b)
        if heap is None:
            heap = self._obands[b] = []
            bisect.insort(self._oband_ids, b)
        heapq.heappush(heap, (la, sid))
        self._oslot[sid] = (b, la)

    def _flush_dirty(self) -> None:
        rt = self.rt
        h = self.heuristic
        # Hybrid heuristics keep the recompute side in the main key family
        # (the constant transfer side lives in the offload family), so the
        # flushed key is the *base* key, not the min.
        keyfn = h.base_key if self.hybrid else h.key
        for sid in self._dirty:
            s = rt.storages[sid]
            rt.meta_accesses += 1
            self.key_recomputes += 1
            k = keyfn(rt, s)
            self._keys[sid] = k
            if self.stale:
                self._place(sid, k, s.last_access)
            else:
                v = self._ver.get(sid, 0) + 1
                self._ver[sid] = v
                heapq.heappush(self._kheap, (k, sid, v))
        self._dirty.clear()

    # -- scoring --------------------------------------------------------
    def cached_score(self, s) -> float:
        """Exact current score of ``s``, memoized for the current instant.

        A memo entry is valid only at the clock/last-access it was computed
        at; any scoped invalidation drops the entry.  Fresh computations
        count one metadata access (matching the linear scan's
        per-evaluation accounting); hits count none.
        """
        rt = self.rt
        sid = s.sid
        hit = self._scores.get(sid)
        # (mark_dirty pops the memo entry, so a surviving entry is valid
        # even while the *key* is still pending recomputation.)
        if (hit is not None and hit[0] == rt.clock
                and hit[1] == s.last_access):
            return hit[2]
        rt.meta_accesses += 1
        sc = self.heuristic.score(rt, s)
        self._scores[sid] = (rt.clock, s.last_access, sc)
        return sc

    # -- selection ------------------------------------------------------
    def pick(self, exclude: set[int]) -> Optional[object]:
        """Bit-exact argmin of the heuristic over the candidate set.

        Every candidate that is not excluded by an admissible lower bound
        (band floor / staleness, or its own key) is *verified* by
        recomputing its exact score with the heuristic's own formula, and
        the verified minimum — ties broken to the lowest sid, the linear
        scan's first-strictly-smaller rule over ``storages`` insertion
        order — is returned.  The ``_BOUND_EPS`` slack on every bound
        absorbs the ulp-level association difference between
        ``key/staleness`` and the score formula, so near-ties are always
        verified rather than pruned.
        """
        self._flush_dirty()
        self.picks += 1
        if self.stale:
            return self._pick_banded(exclude)
        if self.hybrid:
            return self._pick_keyed_hybrid(exclude)
        return self._pick_keyed(exclude)

    def _pick_banded(self, exclude: set[int]) -> Optional[object]:
        rt = self.rt
        storages = rt.storages
        members = self.members
        clock = rt.clock
        heappop, heappush = heapq.heappop, heapq.heappush

        best = None
        best_score = 0.0
        best_sid = -1
        thresh = float("inf")     # best_score * (1 + eps), cached
        stash: list[tuple[list, tuple[float, int]]] = []
        band_of = self._band_of

        # Key families: the recompute side, plus — for hybrid two-choice
        # heuristics — the offload side.  Each family's band floors bound
        # its own side of the min-score; a storage's hybrid argmin is
        # always discoverable through its *winning* side's family, and
        # every surviving candidate is verified with the full hybrid
        # score, so pruning a storage in the losing family is sound.
        fams = [(self._bands, self._band_ids, self._keys, self._slot)]
        if self.hybrid:
            fams.append((self._obands, self._oband_ids, self._okeys,
                         self._oslot))

        def valid_top(fam: int, b: int, heap: list):
            """Validated (la, sid) top of band ``b``; discards stale entries."""
            keys, slot = fams[fam][2], fams[fam][3]
            while heap:
                la, sid = heap[0]
                if sid in members:
                    k = keys.get(sid)
                    if (k is not None and band_of(k) == b
                            and la == storages[sid].last_access):
                        return la, sid, k
                heappop(heap)
                if slot.get(sid) == (b, la):
                    del slot[sid]            # re-add must place afresh
            return None

        # Probe every band's current lower bound (floor key over its oldest
        # member's staleness) and process most-promising first, so the
        # first walked band sets a near-optimal threshold and the rest are
        # usually skipped whole by their already-known bound.
        order: list[tuple[float, int, int]] = []
        for fam, (bands, band_ids, _k, _s) in enumerate(fams):
            for b in band_ids:
                heap = bands[b]
                if not heap:
                    continue
                top = valid_top(fam, b, heap)
                if top is None:
                    continue
                st = clock - top[0]
                if st < _MIN_STALENESS:
                    st = _MIN_STALENESS
                order.append((self._floor_of(b) / st, fam, b))
        order.sort()

        for initial_bound, fam, b in order:
            if initial_bound > thresh:
                break                        # later bands only start worse
            heap = fams[fam][0][b]
            k_floor = self._floor_of(b)
            while heap:
                top = valid_top(fam, b, heap)
                if top is None:
                    break
                la, sid, k = top
                st = clock - la              # oldest remaining in band
                if st < _MIN_STALENESS:
                    st = _MIN_STALENESS
                if k_floor / st > thresh:
                    break                    # rest of band is fresher still
                stash.append((heap, heappop(heap)))
                if sid in exclude or k / st > thresh:
                    continue                 # unselectable / provably worse
                self.pops += 1
                s = storages[sid]
                sc = self.cached_score(s)
                if (best is None or sc < best_score
                        or (sc == best_score and sid < best_sid)):
                    best, best_score, best_sid = s, sc, sid
                    thresh = best_score * (1.0 + _BOUND_EPS) + 1e-300
        for heap, entry in stash:
            heappush(heap, entry)
        return best

    def _pick_keyed(self, exclude: set[int]) -> Optional[object]:
        rt = self.rt
        storages = rt.storages
        members = self.members
        ver = self._ver
        kheap = self._kheap
        heappop, heappush = heapq.heappop, heapq.heappush

        best = None
        best_score = 0.0
        best_sid = -1
        popped: list[tuple[float, int, int]] = []

        while kheap:
            k, sid, v = kheap[0]
            if v != ver.get(sid):
                heappop(kheap)               # superseded by a newer push
                continue
            if sid not in members:
                # Dormant (locked/evicted) storage: consuming its only live
                # entry, so drop the key — membership re-add re-pushes.
                heappop(kheap)
                self._keys.pop(sid, None)
                continue
            # For staleness-free heuristics ``key`` is the same expression
            # as ``score`` (bit-identical), and equal keys pop in ascending
            # sid order — so a larger-or-equal key can neither beat the
            # best nor win its sid tie-break.
            if best is not None and k >= best_score:
                break
            popped.append(heappop(kheap))
            if sid in exclude:
                continue
            self.pops += 1
            s = storages[sid]
            sc = self.cached_score(s)
            if (best is None or sc < best_score
                    or (sc == best_score and sid < best_sid)):
                best, best_score, best_sid = s, sc, sid
        for entry in popped:
            heappush(kheap, entry)
        return best

    def _pick_keyed_hybrid(self, exclude: set[int]) -> Optional[object]:
        """Merged two-heap walk for staleness-free hybrid heuristics.

        Every member has one live entry per family (base key in
        ``_kheap``, constant offload key in ``_okheap``), and for
        staleness-free heuristics each entry's key *is* that side's score
        bit-exactly — so the hybrid score of any unseen candidate is
        bounded below by the smaller of the two validated heap tops.
        Entries pop in ascending (key, sid) order across both heaps; the
        walk breaks only once the merged top key strictly exceeds the best
        verified score (continuing through ties so the lowest sid among
        equal scores wins, as in the scan).
        """
        rt = self.rt
        storages = rt.storages
        members = self.members
        ver = self._ver
        kheap = self._kheap
        oheap = self._okheap
        oin = self._oin
        heappop, heappush = heapq.heappop, heapq.heappush

        best = None
        best_score = 0.0
        best_sid = -1
        rpopped: list[tuple[float, int, int]] = []
        opopped: list[tuple[float, int]] = []

        def rtop():
            while kheap:
                k, sid, v = kheap[0]
                if v != ver.get(sid):
                    heappop(kheap)           # superseded by a newer push
                    continue
                if sid not in members:
                    heappop(kheap)           # dormant: drop, re-add re-pushes
                    self._keys.pop(sid, None)
                    continue
                return k, sid
            return None

        def otop():
            while oheap:
                k, sid = oheap[0]
                if sid in members and sid in oin:
                    return k, sid
                heappop(oheap)               # dormant: membership re-pushes
                oin.discard(sid)
            return None

        while True:
            rt_top = rtop()
            o_top = otop()
            if rt_top is None and o_top is None:
                break
            use_r = o_top is None or (rt_top is not None and rt_top <= o_top)
            k, sid = rt_top if use_r else o_top
            if best is not None and k > best_score:
                break
            if use_r:
                rpopped.append(heappop(kheap))
            else:
                opopped.append(heappop(oheap))
            if sid in exclude:
                continue
            self.pops += 1
            s = storages[sid]
            sc = self.cached_score(s)
            if (best is None or sc < best_score
                    or (sc == best_score and sid < best_sid)):
                best, best_score, best_sid = s, sc, sid
        for entry in rpopped:
            heappush(kheap, entry)
        for entry in opopped:
            heappush(oheap, entry)
        return best
