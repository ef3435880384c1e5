"""Contiguity-aware allocator backend for the DTR runtime.

``PoolAllocator`` maps every resident storage onto a block of a simulated
:class:`~repro.alloc.pool.MemoryPool`.  Two modes:

  * ``contiguous=True`` — the realistic model: an allocation must find a
    contiguous free block.  When none fits, the allocator plans a
    **contiguous eviction window** (Coop, "Memory is not a Commodity"): a
    sliding window over the address-ordered block list whose blocks are all
    free or evictable, whose span covers the request, and whose summed
    heuristic score (``repro.core.heuristics.window_cost``) is minimal.  The
    whole window is evicted at once, guaranteeing the freed span is a single
    coalesced block that satisfies the request — unlike the byte-counter
    model's globally-cheapest-one-at-a-time loop, which can free many
    scattered bytes while satisfying nothing.

  * ``contiguous=False`` — fragmentation disabled: admission is the exact
    byte-counter check and eviction the runtime's classic loop, so results
    are bit-for-bit identical to pool-less runs; blocks are still placed
    (compacting on fragmented fits) so telemetry stays meaningful.

The allocator is deliberately runtime-agnostic: it only uses the runtime's
public pieces (``storages``, ``heuristic``, ``_pick_victim``/``_evict``,
``memory``/``peak_memory`` accounting), so the eager executor reuses it
unchanged to map real JAX buffers onto pool accounting.
"""
from __future__ import annotations

from typing import Optional

from .pool import FragStats, MemoryPool


class PoolAllocator:
    """Fragmentation-aware allocation policy over a :class:`MemoryPool`."""

    def __init__(self, placement: str = "best_fit", contiguous: bool = True,
                 capacity: Optional[float] = None) -> None:
        from .pool import PLACEMENTS
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"expected one of {PLACEMENTS}")
        self.placement = placement
        self.contiguous = contiguous
        self._capacity = capacity
        self.pool: Optional[MemoryPool] = None
        self.evict_windows = 0
        self.window_evictions = 0

    # ------------------------------------------------------------------
    # Runtime hooks
    # ------------------------------------------------------------------
    def attach(self, rt) -> None:
        cap = self._capacity if self._capacity is not None else rt.budget
        self.pool = MemoryPool(cap, placement=self.placement)

    def allocate(self, rt, s, exclude: frozenset = frozenset()) -> None:
        """Place storage ``s`` (contiguous mode), evicting a window if needed.

        Raises the runtime's ``OOMError`` when no window of free + evictable
        blocks can cover the request.
        """
        assert self.contiguous, "use runtime._alloc + place() in nofrag mode"
        size = s.size
        if size <= 0:
            rt.peak_memory = max(rt.peak_memory, rt.memory)
            return
        faults = getattr(rt, "faults", None)
        if faults is not None and faults.alloc_fault():
            # Injected transient failure of the device allocator itself
            # (fragmentation our block model cannot see): recover with a
            # defrag pass — compaction cannot fail — and proceed.
            rt._degrade("alloc_fault", need=size)
            self.pool.compact()
        # Injected budget squeeze (a co-tenant stole device bytes): the
        # pool's address space is fixed, so the squeeze binds as a byte
        # gate ahead of placement.  Dormant unless a squeeze is active —
        # the fault-free victim stream stays purely window-planned.
        if getattr(rt, "_budget_factor", 1.0) != 1.0:
            while rt.memory + size > rt.effective_budget():
                victim = rt._pick_victim(exclude)
                if victim is None:
                    break           # fall through to the window machinery
                rt._evict_or_offload(victim)
        if not self.pool.alloc(s.sid, size):
            window = self.plan_window(rt, size, exclude)
            tried: set = set()
            while window is None:
                # Before declaring OOM, reclaim in-flight prefetch-back
                # reservations (repro.offload): their blocks are neither
                # free nor evictable, so the planner cannot see them.
                # Then walk the runtime's degradation ladder (compaction /
                # forced offload / heuristic escalation — a no-op without
                # a RecoveryConfig).
                off = getattr(rt, "offload", None)
                if ((off is None or not off.cancel_one_prefetch(rt))
                        and not rt._recovery_step(exclude, tried)):
                    from ..core.runtime import OOMError
                    st = self.pool.stats()
                    raise OOMError(
                        f"no contiguous window for {size} bytes "
                        f"(free={st.free}, largest_free={st.largest_free}, "
                        f"frag_ratio={st.frag_ratio:.3f}, "
                        f"capacity={st.capacity})"
                        + rt._memory_diagnostics())
                if self.pool.alloc(s.sid, size):
                    rt.memory += size
                    rt.peak_memory = max(rt.peak_memory, rt.memory)
                    return
                window = self.plan_window(rt, size, exclude)
            self.evict_windows += 1
            self.window_evictions += len(window)
            for victim in window:
                rt._evict_or_offload(victim)
            ok = self.pool.alloc(s.sid, size)
            assert ok, "window eviction must open a large-enough block"
        rt.memory += size
        rt.peak_memory = max(rt.peak_memory, rt.memory)

    def place(self, s) -> None:
        """Place a storage already admitted by byte-counter accounting.

        Compatibility path for ``contiguous=False``: the classic eviction loop
        has guaranteed ``used + size <= capacity``, so a fragmented fit is
        resolved by compaction (a moving allocator), never by extra eviction.
        """
        if s.size <= 0:
            return
        if not self.pool.alloc(s.sid, s.size):
            self.pool.compact()
            ok = self.pool.alloc(s.sid, s.size)
            assert ok, "nofrag mode admitted more bytes than capacity"

    def free(self, s) -> None:
        self.pool.free(s.sid)

    # ------------------------------------------------------------------
    # Window planning (Coop's sliding window, heuristic-cost-minimal)
    # ------------------------------------------------------------------
    def plan_window(self, rt, need: float,
                    exclude: frozenset = frozenset()):
        """Choose the min-cost contiguous window of storages to evict.

        Scans the address-ordered block list with two pointers.  A block may
        join a window iff it is free or owned by an evictable storage not in
        ``exclude``; pinned/locked/constant blocks are barriers that reset
        the window.  Among all minimal windows spanning >= ``need`` bytes,
        returns the storages of the one minimizing summed heuristic score
        (ties: smaller span, then lower address).  ``None`` if no window
        exists.
        """
        from ..core.heuristics import window_cost

        blocks = list(self.pool.blocks())
        storages = []            # parallel: storage rec or None (free block)
        for b in blocks:
            storages.append(None if b.free else rt.storages[b.sid])

        def usable(k: int) -> bool:
            s = storages[k]
            if s is None:
                return True
            return s.evictable() and s.sid not in exclude

        # With an eviction index attached, window_cost reads the index's
        # shared per-storage score memo (same values and meta-access
        # accounting as victim selection); the ad-hoc per-pass dict is only
        # needed for index-less (oracle) runtimes.
        cache: Optional[dict[int, float]] = (
            None if getattr(rt, "index", None) is not None else {})

        def score(k: int) -> float:
            s = storages[k]
            if s is None:
                return 0.0
            return window_cost(rt, rt.heuristic, [s], cache=cache)

        # Running span + cost keep each planning pass O(blocks).
        best: Optional[tuple[int, int]] = None
        best_cost = best_span = 0.0
        i = 0
        span = cost = 0.0
        for j, b in enumerate(blocks):
            if not usable(j):
                i, span, cost = j + 1, 0.0, 0.0
                continue
            span += b.size
            cost += score(j)
            while i < j and span - blocks[i].size >= need:
                span -= blocks[i].size
                cost -= score(i)
                i += 1
            if span < need:
                continue
            if (best is None or cost < best_cost
                    or (cost == best_cost and span < best_span)):
                best, best_cost, best_span = (i, j), cost, span
        if best is None:
            return None
        lo, hi = best
        return [storages[k] for k in range(lo, hi + 1)
                if storages[k] is not None]

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------
    def stats(self) -> FragStats:
        st = self.pool.stats() if self.pool is not None else FragStats()
        st.evict_windows = self.evict_windows
        st.extra["window_evictions"] = self.window_evictions
        st.extra["placement"] = self.placement
        st.extra["contiguous"] = self.contiguous
        return st
