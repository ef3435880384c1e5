"""The DTR runtime engine (Figure 1 + Appendix C of the paper).

Storage-centric model: tensors are views of storages; operators are pure;
metadata per storage = size, (cached) local compute cost, last access time,
locks (pending remats), refs (external liveness).  On allocation pressure the
runtime evicts the resident storage minimizing the active heuristic's score,
and rematerializes evicted tensors on access by (recursively) replaying parent
operators.  Supports the paper's deallocation policies: ``ignore``, ``eager``
(evict on refcount zero), and ``banish`` (permanent free + pinning children).

The engine is *simulated-time*: the clock advances by operator cost on each
(re)execution, which reproduces the paper's compute-overhead accounting while
staying deterministic (Appendix E.3 recommends exactly this).  It is also the
execution engine for the *eager* executor (``repro.eager``), which attaches
real JAX buffers to storages via the ``materialize_fn`` / ``free_fn`` hooks.

Victim selection runs through the incremental eviction index by default
(``index=True``; see ``repro.core.evict_index``): a live evictable set plus
verified lazy heaps deliver the same victim as the exhaustive linear scan —
bit-exactly, tie-breaks included — in sublinear time, and cached
``e*``/``ẽ*`` neighborhood costs are invalidated per evicted component
instead of globally.  ``index=False`` selects the linear-scan oracle.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..faults.recovery import RecoveryConfig
from ..faults.schedule import FaultSchedule
from .evict_index import EvictIndex, ScopedInvalidator
from .unionfind import CostUnionFind


class OOMError(RuntimeError):
    """Raised when an allocation cannot be satisfied by any eviction."""


class ThrashError(RuntimeError):
    """Raised when rematerialization compute exceeds the thrash limit.

    The paper's prototype could hang in deeply recursive rematerializations
    (App. E.3); the simulator aborts instead once total compute passes
    ``compute_limit`` so budget sweeps terminate."""


class BanishedError(RuntimeError):
    """Raised when a banished (permanently freed) tensor is accessed."""


@dataclass
class Operator:
    op_id: int
    name: str
    cost: float
    input_tids: tuple[int, ...]
    output_tids: tuple[int, ...] = ()


@dataclass
class TensorRec:
    tid: int
    name: str
    op: Optional[Operator]          # parent op; None for constants
    sid: int
    is_alias: bool
    defined: bool = True            # materialized & view metadata valid
    refs: int = 1                   # external references


# Storage fields whose writes can change candidate membership or a heap
# key/staleness bound; writes to them notify the attached eviction index.
_WATCHED = frozenset(("resident", "locks", "pinned", "banished", "constant",
                      "last_access", "local_cost"))


@dataclass
class StorageRec:
    sid: int
    size: int
    root_tid: int
    tensor_tids: list[int] = field(default_factory=list)
    resident: bool = True
    locks: int = 0
    pinned: bool = False            # constant or banish-pinned: unevictable
    banished: bool = False
    constant: bool = False
    offloaded: bool = False         # bytes live on the host tier (contents
    #                                 preserved; fetched back on access —
    #                                 NOT an evicted-set member: offloaded
    #                                 storages never join evicted components
    #                                 or e*/ẽ* walks, they transfer back)
    dead: bool = False              # no refs + every child dead/banished:
    #                                 never rematerialized again (pruned
    #                                 from evicted components and e* walks)
    dead_cost: float = 0.0          # aggregated cost of dead subgraphs
    #                                 attached to this (live) storage: e*
    #                                 walks charge it in O(1) instead of
    #                                 traversing the dead cone
    last_access: float = 0.0
    local_cost: float = 0.0         # cached cost(S) = sum of view op costs
    deps: set[int] = field(default_factory=set)       # parent storages
    children: set[int] = field(default_factory=set)   # dependent storages
    uf: int = -1                    # union-find handle (h_eq heuristics)
    uf_joined: bool = False         # local_cost currently counted in uf sum
    refs: int = 0                   # cached sum of view refs

    # Eviction-index backref (class attr so dataclass __init__ writes are
    # silent; EvictIndex.register() sets it per instance).
    _index = None

    def __setattr__(self, name, value):
        if (name in _WATCHED and self._index is not None
                and getattr(self, name, None) != value):
            object.__setattr__(self, name, value)
            self._index.on_storage_event(self, name)
        else:
            object.__setattr__(self, name, value)

    def evictable(self) -> bool:
        return (self.resident and not self.pinned and not self.banished
                and self.locks == 0 and not self.constant)


class DTRRuntime:
    """Greedy online rematerialization engine, parameterized by heuristic."""

    def __init__(
        self,
        budget: float,
        heuristic,
        dealloc: str = "eager",            # 'ignore' | 'eager' | 'banish'
        ignore_small_frac: float = 0.0,     # E.2: skip tensors < frac*mean size
        sample_sqrt: bool = False,          # E.2: search sqrt(n) random sample
        seed: int = 0,
        materialize_fn: Optional[Callable] = None,  # eager-mode hooks
        free_fn: Optional[Callable] = None,
        compute_limit: float = float("inf"),
        allocator=None,                     # repro.alloc.PoolAllocator | None
        index: bool = True,                 # incremental eviction index
        offload=None,                       # repro.offload.OffloadEngine | None
        offload_fn: Optional[Callable] = None,  # eager hook: bytes -> host
        fetch_fn: Optional[Callable] = None,    # eager hook: bytes -> device
        faults=None,                        # repro.faults FaultConfig|Schedule
        recovery: Optional[RecoveryConfig] = None,  # degradation ladder
        sanitize=False,                     # repro.check shadow sanitizer:
        #                                     True = audit every op, int N =
        #                                     audit every N ops (transition
        #                                     hooks always on when enabled)
    ) -> None:
        assert dealloc in ("ignore", "eager", "banish")
        self.budget = float(budget)
        self.heuristic = heuristic
        self.dealloc = dealloc
        self.ignore_small_frac = ignore_small_frac
        self.sample_sqrt = sample_sqrt
        import random as _random
        self._rng = _random.Random(seed)
        self.materialize_fn = materialize_fn
        self.free_fn = free_fn
        self.compute_limit = float(compute_limit)
        # Optional host offload tier (repro.offload).  None => pure DTR:
        # every code path below is bit-exact with pre-offload engines.
        self.offload = offload
        self.offload_fn = offload_fn
        self.fetch_fn = fetch_fn
        # Fault injection (repro.faults).  Accepts a FaultConfig (wrapped
        # into a per-run schedule here) or a ready FaultSchedule; a config
        # with every class off collapses to None, and None everywhere means
        # not a single fault code path runs — bit-exact with the pre-faults
        # engine by construction.
        if faults is not None and not isinstance(faults, FaultSchedule):
            faults = FaultSchedule(faults) if faults.enabled else None
        self.faults = faults
        # Graceful degradation: attaching faults arms a default ladder
        # (injected pressure with no recovery would just be a crash
        # generator); an explicit RecoveryConfig also works fault-free.
        if recovery is None and faults is not None:
            recovery = RecoveryConfig()
        self.recovery = recovery
        #: structured degradation/fault events, surfaced in RunResult
        self.events: list[dict] = []
        self.degradations = 0           # ladder actions taken (not injections)
        self._budget_factor = 1.0       # current squeeze multiplier
        self._remat_counts: dict[int, int] = {}  # sid -> times rematerialized
        self._escalated = 0             # consumed prefix of escalation_chain
        self._thrash_disabled = False   # guard exhausted its chain
        self._w_ops = 0                 # thrash-guard sliding window
        self._w_total = 0.0
        self._w_base = 0.0
        # Shadow sanitizer (repro.check): a pure observer — it reads state
        # through non-mutating, non-counting paths, so a sanitized run is
        # bit-exact with an unsanitized one (tested in tests/test_check.py).
        if sanitize:
            from ..check.sanitizer import attach as _sanitizer_attach
            self.sanitizer = _sanitizer_attach(self, sanitize)
        else:
            self.sanitizer = None

        self.tensors: dict[int, TensorRec] = {}
        self.storages: dict[int, StorageRec] = {}
        self.ops: dict[int, Operator] = {}
        self._next_tid = 0
        self._next_sid = 0
        self._next_oid = 0

        self.clock = 0.0
        self.memory = 0.0
        self.peak_memory = 0.0
        self.total_compute = 0.0        # includes rematerializations
        self.base_compute = 0.0         # first executions only
        self.stall_time = 0.0           # clock spent waiting on transfers
        self.ops_executed = 0           # op (re)plays, unit counting for Thm 3.1
        self.remat_ops = 0
        self.evictions = 0
        self.offloads = 0               # victims moved to host, not dropped
        self.fetches = 0                # synchronous fetch-backs (misses)
        self.prefetch_hits = 0          # accesses served by a prefetch-back
        self.prefetch_issued = 0
        self.prefetch_cancelled = 0
        self.meta_accesses = 0          # Appendix D.3 accounting
        self.victim_picks = 0           # victim selections (flush events)
        self._pending_banish: set[int] = set()
        # Scoped caches for neighborhood costs: entries are dropped by the
        # ScopedInvalidator when (and only when) their evicted component
        # changes — no global version nuke (App. C.5 overhead fix).
        self._estar_cache: dict[int, tuple[float, int]] = {}  # sid->(cost, n)
        self._eq_cache: dict[int, float] = {}
        # ẽ* adjacency snapshots: sid -> union-find handles of its evicted
        # neighbors at last full walk.  Survives component-sum-only events,
        # so an invalidated eq key rebuilds from the incrementally-
        # maintained per-root sums without re-walking the neighborhood.
        self._eq_adj: dict[int, tuple[int, ...]] = {}

        self.uf = CostUnionFind() if getattr(heuristic, "needs_uf", False) else None
        # Evicted-component bookkeeping for amortized-exact splits: member
        # sids and detached-phantom counts per component root.  When half a
        # component is phantoms, its true partition is re-derived
        # (``_uf_rebuild``) — bounding the over-merge drift of the paper's
        # splitting approximation to 2x instead of letting ẽ* balloon
        # without bound on eager-release workloads.
        self._uf_members: dict[int, list[int]] = {}
        self._uf_phantoms: dict[int, int] = {}
        if hasattr(heuristic, "bind"):
            heuristic.bind(self)

        # Incremental victim-selection index.  The linear scan stays as the
        # reference oracle (index=False) and as the automatic fallback for
        # non-separable heuristics (h_rand consumes RNG state per score) and
        # the E.2 sampling approximations, whose sampled candidate pools the
        # heap cannot reproduce bit-exactly.
        self.index: Optional[EvictIndex] = None
        self._invalidator = ScopedInvalidator(self)
        if (index and getattr(heuristic, "separable", False)
                and not sample_sqrt and ignore_small_frac == 0):
            self.index = EvictIndex(self)

        # Optional fragmentation-aware backend: storages map onto contiguous
        # blocks of a simulated address space, and eviction under pressure
        # selects a contiguous window (repro.alloc).  None => byte counter.
        self.allocator = allocator
        if allocator is not None:
            allocator.attach(self)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def constant(self, size: int, name: str = "const") -> int:
        tid, sid = self._next_tid, self._next_sid
        self._next_tid += 1
        self._next_sid += 1
        t = TensorRec(tid, name, None, sid, is_alias=False)
        s = StorageRec(sid, int(size), tid, [tid], constant=True, pinned=True,
                       last_access=self.clock, refs=1)
        if self.uf is not None:
            s.uf = self.uf.make(0.0)
        self.tensors[tid] = t
        self.storages[sid] = s
        if self.index is not None:
            self.index.register(s)
        self._alloc_storages([s])
        return tid

    def call(
        self,
        op_name: str,
        cost: float,
        input_tids: Sequence[int],
        out_sizes: Sequence[int],
        aliases: Optional[Sequence[Optional[int]]] = None,
        out_names: Optional[Sequence[str]] = None,
    ) -> list[int]:
        """Execute a new pure operator; returns output tensor ids."""
        aliases = list(aliases) if aliases is not None else [None] * len(out_sizes)
        out_names = list(out_names) if out_names else [
            f"{op_name}.{i}" for i in range(len(out_sizes))]
        oid = self._next_oid
        self._next_oid += 1
        op = Operator(oid, op_name, float(cost), tuple(input_tids))
        self.ops[oid] = op

        # Create output tensor/storage records (not yet resident).
        out_tids: list[int] = []
        new_storages: list[StorageRec] = []
        for size, al, nm in zip(out_sizes, aliases, out_names):
            tid = self._next_tid
            self._next_tid += 1
            if al is not None:
                sid = self.tensors[al].sid
                t = TensorRec(tid, nm, op, sid, is_alias=True, defined=False)
                s = self.storages[sid]
                s.tensor_tids.append(tid)
                was_dead = s.dead
                s.local_cost += op.cost
                s.refs += 1
                if self.uf is not None and s.uf_joined:
                    # The component sum tracks member costs incrementally:
                    # the view's cost joins it now, so the later
                    # split_approx subtraction balances.  (Checked before
                    # the revive below — dead evicted members stay joined,
                    # and _revive would skip the re-join for them.)
                    self.uf.add_cost(s.uf, op.cost)
                if was_dead:
                    # A new external view revives a pruned storage: it
                    # rejoins the evicted components with its grown cost.
                    self._revive(s)
                elif s.offloaded:
                    # Offloaded storages sit in no evicted component: only
                    # their own cached key holds the pre-view cost.
                    if self.index is not None:
                        self.index.mark_dirty(s.sid)
                elif not s.resident and not s.banished:
                    # Cached closures summing this evicted storage hold the
                    # pre-view cost: drop them (scoped to its component).
                    self._invalidator.on_cost_change(s)
            else:
                sid = self._next_sid
                self._next_sid += 1
                t = TensorRec(tid, nm, op, sid, is_alias=False, defined=False)
                s = StorageRec(sid, int(size), tid, [tid], resident=False,
                               last_access=self.clock, local_cost=op.cost,
                               refs=1)
                if self.uf is not None:
                    s.uf = self.uf.make(0.0)
                self.storages[sid] = s
                new_storages.append(s)
            self.tensors[tid] = t
            out_tids.append(tid)
        op.output_tids = tuple(out_tids)

        # Wire storage-level dependency edges.
        out_sids = {self.tensors[t].sid for t in out_tids}
        in_sids = {self.tensors[u].sid for u in input_tids}
        for osid in out_sids:
            for isid in in_sids:
                if isid != osid:
                    self.storages[osid].deps.add(isid)
                    self.storages[isid].children.add(osid)

        # New storages are evicted-like until first materialization:
        # neighborhood closures can already reach them, so join them to the
        # evicted components and invalidate adjacent cached costs.
        for s in new_storages:
            if self.index is not None:
                self.index.register(s)
            self._invalidator.on_evict(s)

        # Inputs must be materialized, then perform.  Lock inputs across the
        # whole sequence so rematerializing input B cannot evict input A.
        lock_sids = [self.tensors[u].sid for u in input_tids]
        for sid in lock_sids:
            self.storages[sid].locks += 1
        try:
            self._ensure_defined(list(input_tids))
            self._perform(op, first=True)
        finally:
            for sid in lock_sids:
                self.storages[sid].locks -= 1
        return out_tids

    def get(self, tid: int) -> None:
        """Access a tensor: rematerialize if needed, update staleness."""
        self._ensure_defined([tid])
        s = self.storages[self.tensors[tid].sid]
        s.last_access = self.clock

    def addref(self, tid: int) -> None:
        t = self.tensors[tid]
        t.refs += 1
        s = self.storages[t.sid]
        s.refs += 1
        if s.dead:
            self._revive(s)

    def release(self, tid: int) -> None:
        """External reference dropped (RELEASE in the log)."""
        t = self.tensors[tid]
        t.refs -= 1
        s = self.storages[t.sid]
        s.refs -= 1
        if s.refs <= 0:
            # Dead-subgraph pruning happens *before* the eager evict below,
            # so a storage dying at release never joins evicted components.
            self._maybe_die(s)
        if s.refs > 0 or s.banished:
            return
        if self.dealloc == "ignore":
            return
        if self.dealloc == "eager":
            if s.evictable():
                self._evict(s)
        elif self.dealloc == "banish":
            self._try_banish(s)

    def size_of(self, tid: int) -> int:
        t = self.tensors[tid]
        return 0 if t.is_alias else self.storages[t.sid].size

    def finalize(self) -> None:
        """Output condition: all externally-referenced tensors resident+locked."""
        for t in list(self.tensors.values()):
            if t.refs > 0 and not self.storages[t.sid].banished:
                self._ensure_defined([t.tid])
                self.storages[t.sid].locks += 1
        if self.sanitizer is not None:
            self.sanitizer.audit()

    # -- introspection (benchmarks / adversary) -------------------------
    def resident_tids(self) -> set[int]:
        return {t.tid for t in self.tensors.values()
                if t.defined and self.storages[t.sid].resident}

    def slowdown(self) -> float:
        return self.total_compute / max(self.base_compute, 1e-12)

    def overhead(self) -> float:
        """Compute + transfer-stall overhead over the baseline compute.

        Equals ``slowdown()`` without an offload tier (stalls only come
        from fetch-backs); with one, it is the honest end-to-end cost the
        offload benchmarks compare across policies."""
        return ((self.total_compute + self.stall_time)
                / max(self.base_compute, 1e-12))

    def fragmentation(self):
        """Allocator telemetry (``repro.alloc.FragStats``), None in counter mode."""
        return self.allocator.stats() if self.allocator is not None else None

    # ------------------------------------------------------------------
    # Materialization
    # ------------------------------------------------------------------
    def _ensure_defined(self, tids: list[int]) -> None:
        """Iteratively rematerialize every tensor in ``tids``.

        Lock discipline (*lazy locking*): a frame rematerializing tensor t
        first rebuilds op(t)'s undefined inputs WITHOUT holding locks, then —
        once every input is simultaneously defined — locks them all, performs
        op(t), and unlocks.  The paper's pseudocode locks parents on entry
        before recursing, which pins every resident input along a deep
        rematerialization chain at once (the App. E.3 UNet failure mode);
        lazy locking keeps the pinned set to the current op's inputs only,
        preserving the O(1)-extra-memory behaviour of Lemma A.3 for gradient
        chains as well.  A visit-count guard falls back to incremental
        locking (monotone progress, more pinning) if inputs keep getting
        re-evicted — so termination is guaranteed either way.
        """
        for root in tids:
            if self.tensors[root].defined:
                continue
            # Frame: [tid, visits, locked_sids].
            stack: list[list] = [[root, 0, []]]
            try:
                while stack:
                    frame = stack[-1]
                    tid = frame[0]
                    t = self.tensors[tid]
                    if t.defined:
                        stack.pop()
                        for sid in frame[2]:
                            self.storages[sid].locks -= 1
                        continue
                    s = self.storages[t.sid]
                    if s.banished:
                        raise BanishedError(
                            f"access to banished tensor {t.name}")
                    if s.offloaded:
                        # Contents live on host: fetch them back (stalling
                        # on the transfer, or collecting a prefetch) and
                        # restore the views defined at offload time.  Views
                        # created/evicted since then fall through to the
                        # normal remat path below, now with the storage
                        # resident.
                        self._fetch_in(s)
                        continue
                    op = t.op
                    if op is None:
                        raise BanishedError(f"constant {t.name} unavailable")
                    frame[1] += 1
                    if frame[1] > 8:
                        # Livelock guard: siblings keep evicting each other —
                        # lock defined inputs now so progress is monotone.
                        for u in op.input_tids:
                            sid = self.tensors[u].sid
                            if (self.tensors[u].defined
                                    and sid not in frame[2]):
                                self.storages[sid].locks += 1
                                frame[2].append(sid)
                    undef = [u for u in op.input_tids
                             if not self.tensors[u].defined]
                    if undef:
                        for u in undef:
                            stack.append([u, 0, []])
                        continue
                    # All inputs defined *now*: lock, perform, unlock, pop.
                    lk = [self.tensors[u].sid for u in op.input_tids]
                    for sid in lk:
                        self.storages[sid].locks += 1
                    try:
                        self._perform(op, first=False)
                    finally:
                        for sid in lk:
                            self.storages[sid].locks -= 1
                    stack.pop()
                    for sid in frame[2]:
                        self.storages[sid].locks -= 1
            except BaseException:
                for fr in stack:
                    for sid in fr[2]:
                        self.storages[sid].locks -= 1
                raise

    def _perform(self, op: Operator, first: bool) -> None:
        """(Re)execute ``op``: allocate outputs, charge cost, define views."""
        # Lock inputs during allocation.
        in_sids = [self.tensors[u].sid for u in op.input_tids]
        for sid in in_sids:
            self.storages[sid].locks += 1
        try:
            # Inputs are accessed by this op: update staleness metadata.
            for sid in in_sids:
                self.storages[sid].last_access = self.clock
            if self.offload is not None:
                for sid in in_sids:
                    self.offload.note_access(sid, self.clock)
            out_storages: list[StorageRec] = []
            for tid in op.output_tids:
                t = self.tensors[tid]
                s = self.storages[t.sid]
                if s.banished:
                    continue
                # Offloaded output storages are skipped: their contents are
                # intact on host, so this replay must not re-place them
                # (their undefined views are restored by a later fetch).
                if not t.is_alias and not s.resident and not s.offloaded:
                    out_storages.append(s)
            self._alloc_storages(out_storages,
                                 exclude={s.sid for s in out_storages})
            for s in out_storages:
                s.resident = True
                # The storage leaves the evicted set (first materialization
                # included): closures that summed it are stale.
                self._invalidator.on_unevict(s)
                if not first:
                    self._on_remat(s)
            # Define output views computed by this op (aliases included).
            for tid in op.output_tids:
                t = self.tensors[tid]
                s = self.storages[t.sid]
                if s.banished or not s.resident:
                    # Not resident: either an alias of an evicted storage, or
                    # a doubly-computed output evicted mid-allocation (the
                    # paper's "ephemeral" case) — leave for a later remat.
                    continue
                t.defined = True
                s.last_access = self.clock
            # Charged cost: with a fault schedule attached, the op's true
            # hardware cost carries a consistent per-operator misestimation
            # factor — heuristics keep scoring the unperturbed estimate
            # (their cost model is wrong, not the clock).
            cost = op.cost
            if self.faults is not None:
                cost = op.cost * self.faults.cost_factor(op.op_id)
            self.clock += cost
            self.total_compute += cost
            self.ops_executed += 1
            if self.faults is not None and self.faults.cfg.squeezes:
                f = self.faults.budget_factor(self.ops_executed)
                if f != self._budget_factor:
                    self._budget_factor = f
                    self._event("budget_shrink" if f < 1.0
                                else "budget_restore", factor=f)
            if self.total_compute > self.compute_limit:
                raise ThrashError(
                    f"compute {self.total_compute:.3g} exceeded thrash "
                    f"limit {self.compute_limit:.3g}"
                    + self._memory_diagnostics())
            if first:
                self.base_compute += cost
            else:
                self.remat_ops += 1
            self._thrash_check()
            if self.materialize_fn is not None:
                self.materialize_fn(op, first)
            # Banish retry: a remat may unblock pending banishes.
            if self._pending_banish:
                for sid in list(self._pending_banish):
                    s = self.storages[sid]
                    if s.refs <= 0 and not s.banished:
                        self._try_banish(s)
            if self.offload is not None:
                self.offload.pump(self)
            if self.sanitizer is not None:
                self.sanitizer.on_op()
        finally:
            for sid in in_sids:
                self.storages[sid].locks -= 1

    # ------------------------------------------------------------------
    # Allocation / eviction
    # ------------------------------------------------------------------
    def _alloc_storages(self, storages: list[StorageRec],
                        exclude: set[int] = frozenset()) -> None:
        """Admit ``storages`` (not yet resident) into device memory.

        Byte-counter mode (no allocator, or the allocator's fragmentation-free
        compatibility mode) aggregates the sizes and runs the classic
        globally-cheapest eviction loop — decisions are identical with or
        without a pool attached.  Contiguous mode places each storage into a
        contiguous block, evicting a minimal-cost contiguous window on a
        failed fit.
        """
        if self.allocator is not None and self.allocator.contiguous:
            placed: list[StorageRec] = []
            try:
                for s in storages:
                    self.allocator.allocate(self, s, exclude)
                    placed.append(s)
            except BaseException:
                # Roll back siblings placed before the failure: they are not
                # yet resident, so nothing else will ever free their blocks.
                for s in placed:
                    self.allocator.free(s)
                    self.memory -= s.size
                raise
            self.peak_memory = max(self.peak_memory, self.memory)
            return
        need = sum(s.size for s in storages)
        self._alloc(need, exclude)
        if self.allocator is not None:
            for s in storages:
                self.allocator.place(s)

    def _alloc(self, need: float, exclude: set[int] = frozenset()) -> None:
        if need <= 0:
            self.peak_memory = max(self.peak_memory, self.memory)
            return
        if self.faults is not None and self.faults.alloc_fault():
            self._recover_alloc_fault(need, exclude)
        tried: set[str] = set()
        while self.memory + need > self.effective_budget():
            victim = self._pick_victim(exclude)
            if victim is not None:
                self._evict_or_offload(victim)
                continue
            # Before declaring OOM, reclaim in-flight prefetch
            # reservations (they hold device bytes speculatively)...
            if (self.offload is not None
                    and self.offload.cancel_one_prefetch(self)):
                continue
            # ...then walk the degradation ladder (no-op without a
            # RecoveryConfig).
            if self._recovery_step(exclude, tried):
                continue
            raise OOMError(
                f"cannot free {need} bytes (resident={self.memory}, "
                f"budget={self.effective_budget()})"
                + self._memory_diagnostics())
        self.memory += need
        self.peak_memory = max(self.peak_memory, self.memory)

    def _candidates(self, exclude: set[int]) -> list[StorageRec]:
        pool = [s for s in self.storages.values()
                if s.evictable() and s.sid not in exclude and s.size > 0]
        if not pool:
            return pool
        if self.ignore_small_frac > 0 and len(pool) > 8:
            mean = sum(s.size for s in pool) / len(pool)
            thr = self.ignore_small_frac * mean
            big = [s for s in pool if s.size >= thr]
            if big:
                pool = big
        if self.sample_sqrt and len(pool) > 16:
            k = max(int(len(pool) ** 0.5), 8)
            pool = self._rng.sample(pool, k)
        return pool

    def _pick_victim(self, exclude: set[int]) -> Optional[StorageRec]:
        self.victim_picks += 1
        if self.index is not None:
            return self.index.pick(exclude)
        # Reference oracle: exhaustive linear scan (kept bit-exact; the
        # index's verified heap must select the same victim).
        pool = self._candidates(exclude)
        best, best_score = None, None
        for s in pool:
            self.meta_accesses += 1  # one heuristic evaluation
            score = self.heuristic.score(self, s)
            if best_score is None or score < best_score:
                best, best_score = s, score
        return best

    def _evict(self, s: StorageRec) -> None:
        if self.sanitizer is not None:
            self.sanitizer.pre_evict(s)
        assert s.evictable(), f"evicting unevictable storage {s.sid}"
        s.resident = False
        for tid in s.tensor_tids:
            self.tensors[tid].defined = False
        self.memory -= s.size
        self.evictions += 1
        if s.dead and self.uf is None:
            # Dead-subgraph pruning: a never-again-rematerializable storage
            # must not subscribe or inflate the e* walks — its departure
            # leaves every neighbor's cached closure intact (the exact
            # walk charges its cone through ``dead_cost`` instead).
            self._invalidator.on_dead_evict(s)
        else:
            # Scoped invalidation: drop cached neighborhood costs only in
            # the components this eviction merges / the storages adjacent
            # to it.  (With a cost union-find attached, dead storages do
            # join the ẽ* equivalence classes — see ``_uf_join``.)
            self._invalidator.on_evict(s)
        if self.allocator is not None:
            self.allocator.free(s)
        if self.free_fn is not None:
            self.free_fn(s)
        if self.uf is not None:
            self._uf_join(s)

    def _on_remat(self, s: StorageRec) -> None:
        # (ScopedInvalidator.on_unevict already ran in _perform, before the
        # union-find split below mutates the component cost sums.)
        self._remat_counts[s.sid] = self._remat_counts.get(s.sid, 0) + 1
        if self.uf is not None:
            self._uf_detach(s)

    # ------------------------------------------------------------------
    # Fault injection + graceful degradation (repro.faults)
    # ------------------------------------------------------------------
    def effective_budget(self) -> float:
        """Device byte budget after any injected squeeze.

        Bit-exact with ``budget`` when no squeeze is active (the 1.0
        factor multiplies losslessly), so fault-free admission decisions
        are unchanged."""
        return self.budget * self._budget_factor

    def _event(self, kind: str, **fields) -> None:
        ev = {"kind": kind, "op": self.ops_executed, "clock": self.clock}
        ev.update(fields)
        self.events.append(ev)

    def _degrade(self, kind: str, **fields) -> None:
        """Record a recovery-ladder action (vs. a mere fault injection)."""
        self.degradations += 1
        self._event(kind, **fields)

    def _recover_alloc_fault(self, need: float, exclude: set[int]) -> None:
        """An injected transient allocation failure (byte-counter path).

        Responds like a caching allocator to a failed ``cudaMalloc``:
        free extra headroom beyond the request, then retry — and the
        retry is forced to succeed (the fault is transient by
        construction), so alloc faults alone can never kill a run.
        """
        rc = self.recovery
        self._degrade("alloc_fault", need=need)
        target = need * (1.0 + rc.alloc_headroom)
        while self.memory + target > self.effective_budget():
            victim = self._pick_victim(exclude)
            if victim is None:
                break               # best effort; admission proceeds anyway
            self._evict_or_offload(victim)

    def _recovery_step(self, exclude: set[int], tried: set[str]) -> bool:
        """One rung of the degradation ladder; True => retry the fit.

        Order: pool compaction (rescues window-OOMs where free bytes
        exist but no contiguous span) → forced offload (frees device
        blocks without losing contents) → heuristic escalation (a
        last-ditch policy change; it cannot create structurally missing
        candidates, so its real value is the thrash guard — it is kept
        as an OOM rung because each switch is one bounded retry).
        ``tried`` scopes once-per-allocation rungs; the ladder as a whole
        is bounded (compaction once, offload by host capacity, escalation
        by chain length), so the retry loop always terminates.
        """
        rc = self.recovery
        if rc is None:
            return False
        if (rc.compaction and "compact" not in tried
                and self.allocator is not None and self.allocator.contiguous):
            tried.add("compact")
            st = self.allocator.pool.stats()
            self.allocator.pool.compact()
            if self.sanitizer is not None:
                self.sanitizer.note_compaction(
                    st, self.allocator.pool.stats())
            self._degrade("compaction", free=st.free,
                          largest_free=st.largest_free)
            return True
        if rc.forced_offload and self._forced_offload(exclude):
            return True
        if rc.escalation and self._escalate_heuristic("oom"):
            return True
        return False

    def _forced_offload(self, exclude: set[int]) -> bool:
        """Ladder rung: bypass the two-choice key and move the
        cheapest-to-transfer evictable storage to the host tier.

        Unlike eviction this loses no contents (no future remat debt), so
        it is safe to force regardless of the recompute-vs-transfer
        comparison ``wants_offload`` would make.  Victim choice is
        deterministic: minimum transfer key, lowest sid first.
        """
        eng = self.offload
        if eng is None:
            return False
        best, best_k = None, 0.0
        for sid in sorted(self.storages):
            s = self.storages[sid]
            if (s.size <= 0 or sid in exclude or not s.evictable()
                    or not eng.host.can_fit(s.size)):
                continue
            k = eng.transfer_key(s)
            if best is None or k < best_k:
                best, best_k = s, k
        if best is None:
            return False
        self._degrade("forced_offload", sid=best.sid, size=best.size)
        self._offload(best)
        return True

    def _escalate_heuristic(self, reason: str) -> bool:
        """Switch to the next usable heuristic of the escalation chain.

        Skips entries matching the current (base) heuristic, entries
        needing machinery this run lacks (union-find, separability for an
        attached index), and — under the hybrid offload policy — entries
        that cannot price recomputation.  On success the eviction index
        is rebuilt from scratch over the existing storages, so victim
        selection stays bit-exact with a linear scan under the new
        heuristic.
        """
        rc = self.recovery
        if rc is None or self._escalated >= len(rc.escalation_chain):
            return False
        from .heuristics import by_name
        eng = self.offload
        if eng is not None and eng.cfg.policy == "offload":
            # Victims are ranked by transfer cost alone; swapping the base
            # recompute heuristic would change nothing.
            return False
        cur = self.heuristic
        cur_base = cur.base if getattr(cur, "hybrid", False) else cur
        while self._escalated < len(rc.escalation_chain):
            name = rc.escalation_chain[self._escalated]
            self._escalated += 1
            h = by_name(name)
            if h.name == cur_base.name:
                continue
            if h.needs_uf and self.uf is None:
                continue
            if self.index is not None and not h.separable:
                continue
            if eng is not None:
                if not h.cost_aware:
                    continue
                from ..offload.engine import wrap_heuristic
                h = wrap_heuristic(h, eng)
            if hasattr(h, "bind"):
                h.bind(self)
            old = self.heuristic.name
            self.heuristic = h
            if self.index is not None:
                self.index = EvictIndex(self)
                for s in self.storages.values():
                    self.index.register(s)
            self._degrade("heuristic_escalation", reason=reason,
                          from_=old, to=h.name)
            return True
        return False

    def _thrash_check(self) -> None:
        """Sliding-window remat-livelock detector (one check per op).

        When a full window's charged compute exceeds ``thrash_ratio``
        times its first-execution progress, the run is grinding remats —
        escalate the heuristic now instead of riding into the
        ``ThrashError`` cliff.  With the chain exhausted the guard
        disarms and the hard limit fires as before.
        """
        rc = self.recovery
        if rc is None or not rc.thrash_guard or self._thrash_disabled:
            return
        self._w_ops += 1
        if self._w_ops < rc.thrash_window_ops:
            return
        dt = self.total_compute - self._w_total
        db = self.base_compute - self._w_base
        self._w_ops = 0
        self._w_total = self.total_compute
        self._w_base = self.base_compute
        if dt <= rc.thrash_ratio * db:
            return
        if not self._escalate_heuristic("thrash_guard"):
            self._thrash_disabled = True

    def _memory_diagnostics(self, top_k: int = 5) -> str:
        """Breakdown appended to OOM/Thrash messages: where the resident
        bytes are stuck (pinned / locked / evictable) plus the top-k
        most-rematerialized storages — enough to debug a failed sweep
        cell from the error string alone."""
        live = pinned = locked = evictable = 0.0
        for s in self.storages.values():
            if not s.resident:
                continue
            live += s.size
            if s.pinned or s.constant:
                pinned += s.size
            elif s.locks > 0:
                locked += s.size
            elif s.evictable():
                evictable += s.size
        top = sorted(self._remat_counts.items(),
                     key=lambda kv: (-kv[1], kv[0]))[:top_k]
        hist = ", ".join(f"s{sid}x{n}" for sid, n in top) or "none"
        return (f" [resident={live:g}: pinned={pinned:g}, "
                f"locked={locked:g}, evictable={evictable:g}; "
                f"degradations={self.degradations}; top remats: {hist}]")

    # ------------------------------------------------------------------
    # Host offload tier (repro.offload)
    # ------------------------------------------------------------------
    def _evict_or_offload(self, s: StorageRec) -> None:
        """Free the victim's device bytes by the cheaper mechanism.

        The two-choice policy (``OffloadEngine.wants_offload``) compares
        round-trip transfer cost against the heuristic's recompute cost;
        without an engine this is exactly ``_evict``.
        """
        if self.offload is not None and self.offload.wants_offload(self, s):
            self._offload(s)
        else:
            self._evict(s)

    def _offload(self, s: StorageRec) -> None:
        """Move ``s``'s bytes to the host tier (contents preserved).

        The device block frees immediately (the D2H copy-out proceeds in
        the background on the simulated clock; a fetch-back cannot start
        before it lands).  Unlike eviction, nothing here touches the
        evicted components: an offloaded storage needs no remat, so
        neighboring e*/ẽ* closures are unchanged.
        """
        if self.sanitizer is not None:
            self.sanitizer.pre_offload(s)
        assert s.evictable(), f"offloading unevictable storage {s.sid}"
        defined = tuple(tid for tid in s.tensor_tids
                        if self.tensors[tid].defined)
        s.offloaded = True
        s.resident = False              # index membership exits here
        for tid in s.tensor_tids:
            self.tensors[tid].defined = False
        self.memory -= s.size
        self.offloads += 1
        if self.allocator is not None:
            self.allocator.free(s)
        self.offload.on_offload(self, s, defined)
        if self.offload_fn is not None:
            self.offload_fn(s, defined)

    def _fetch_in(self, s: StorageRec) -> None:
        """Bring an offloaded storage back to device (access miss path).

        A completed/in-flight prefetch already holds a device reservation:
        the access stalls only until its arrival time.  Otherwise device
        space is allocated now (evicting/offloading further victims if
        needed) and the clock stalls for the full synchronous H2D copy.
        """
        if self.sanitizer is not None:
            self.sanitizer.pre_fetch(s)
        eng = self.offload
        if eng.in_flight(s.sid):
            rec = eng._recs[s.sid]
            stall = rec.ready_at - self.clock
            self.prefetch_hits += 1
        else:
            self._alloc_storages([s], exclude={s.sid})
            stall = eng.begin_fetch(self, s)
            self.fetches += 1
        if stall > 0:
            self._stall(stall)
        defined = eng.finish_fetch(self, s)
        s.offloaded = False
        s.resident = True               # index membership re-enters here
        for tid in defined:
            self.tensors[tid].defined = True
        s.last_access = self.clock
        if self.fetch_fn is not None:
            self.fetch_fn(s, defined)

    def _stall(self, dt: float) -> None:
        """Advance the clock waiting on a transfer (no compute charged)."""
        self.clock += dt
        self.stall_time += dt
        if self.total_compute + self.stall_time > self.compute_limit:
            raise ThrashError(
                f"compute+stall {self.total_compute + self.stall_time:.3g} "
                f"exceeded thrash limit {self.compute_limit:.3g}"
                + self._memory_diagnostics())

    # ------------------------------------------------------------------
    # Evicted-component maintenance (h_dtr_eq's equivalence classes)
    # ------------------------------------------------------------------
    def _uf_join(self, s: StorageRec) -> None:
        """``s`` enters the evicted set: merge with evicted neighbor
        components, adding its own cost (App. C.2).

        Dead storages join too: the ẽ* equivalence classes count every
        evicted tensor's compute exactly once *as a member* (the exact
        walk instead prunes the dead and charges their cones through
        ``dead_cost`` — two self-consistent accountings of the same
        quantity).  Pruning the dead out of the *components* was measured
        to invert eq's economics on fan-out traces: the undirected
        approximation relies on their ballast, so they stay.
        """
        uf = self.uf
        members = self._uf_members
        phantoms = self._uf_phantoms
        uf.add_cost(s.uf, s.local_cost)
        s.uf_joined = True
        r = uf.find(s.uf)
        mem = members.pop(r, None)
        ph = phantoms.pop(r, 0)
        if mem is None:
            mem = [s.sid]
        else:
            mem.append(s.sid)
        for nsid in s.deps | s.children:
            ns = self.storages[nsid]
            if not ns.resident and not ns.banished and not ns.offloaded:
                r1 = uf.find(ns.uf)
                if r1 == r:
                    continue
                mem1 = members.pop(r1, None)
                ph += phantoms.pop(r1, 0)
                if mem1 is not None:
                    mem.extend(mem1)
                r = uf.union(r, r1)
                self.meta_accesses += 1
        members[r] = mem
        if ph:
            phantoms[r] = ph

    def _uf_detach(self, s: StorageRec) -> None:
        """``s`` leaves the evicted set (remat / death): the paper's split
        approximation — subtract its cost, move it to a fresh singleton —
        plus amortized *exact* splitting.

        The detached member lingers as a phantom inside the old component.
        On static workloads phantoms are short-lived; on eager-release
        traces they accumulate until ẽ* is pure noise (a single
        mega-component whose sum approaches total trace compute).  So each
        detach bumps the component's phantom count, and once phantoms
        outnumber live members the true partition is re-derived — ẽ*
        tracks e* within a bounded (2x-membership) slack instead of
        diverging with trace length.  (A storage that never joined — the
        created-unmaterialized "ephemeral" case — still detaches to a
        fresh singleton so a later re-eviction merges with its *current*
        neighbors.)
        """
        uf = self.uf
        r = uf.find(s.uf)
        own = s.local_cost if s.uf_joined else 0.0
        joined = s.uf_joined
        s.uf_joined = False
        s.uf = uf.split_approx(s.uf, own)
        self.meta_accesses += 1
        if not joined:
            return
        mem = self._uf_members.get(r)
        if mem is None:
            return
        ph = self._uf_phantoms.get(r, 0) + 1
        if 2 * ph >= len(mem):
            self._uf_rebuild(r)
        else:
            self._uf_phantoms[r] = ph

    def _uf_rebuild(self, root: int) -> None:
        """Re-derive the exact evicted components of a phantom-heavy one.

        Walks the live members' evicted adjacency, assigns each connected
        component a fresh root with an exactly re-summed cost, and
        re-parents every live member's handle — so adjacency snapshots
        held by eq consumers keep resolving (their values were already
        invalidated by the event that triggered the detach).  Stale
        handles of long-gone phantoms may resolve to an arbitrary
        successor component; no live snapshot can hold one (any consumer
        adjacent to a detaching storage is fully invalidated at that
        event).
        """
        uf = self.uf
        storages = self.storages
        mem = self._uf_members.pop(root)
        self._uf_phantoms.pop(root, None)
        live = [sid for sid in mem
                if storages[sid].uf_joined
                and uf.find(storages[sid].uf) == root]
        uf.accesses += len(mem)
        seen: set[int] = set()
        live_set = set(live)
        first_root = None
        for sid in live:
            if sid in seen:
                continue
            comp = [sid]
            seen.add(sid)
            stack = [sid]
            while stack:
                y = stack.pop()
                ys = storages[y]
                for nsid in sorted(ys.deps | ys.children):
                    if nsid in live_set and nsid not in seen:
                        seen.add(nsid)
                        comp.append(nsid)
                        stack.append(nsid)
            nr = uf.make(0.0)
            total = 0.0
            for y in comp:
                ys = storages[y]
                total += ys.local_cost
                uf._parent[ys.uf] = nr
            uf._cost[nr] = total
            uf.accesses += len(comp)
            self._uf_members[nr] = comp
            if first_root is None:
                first_root = nr
        if first_root is not None and uf._parent[root] == root:
            # Point the abandoned root at a successor so stale phantom
            # handles cannot resurrect the old (now meaningless) sum.
            # (Skipped when the old root is itself a live member's handle —
            # the member loop above already re-parented it.)
            uf._parent[root] = first_root
            uf._cost[root] = 0.0

    # ------------------------------------------------------------------
    # Dead-subgraph pruning
    # ------------------------------------------------------------------
    def _maybe_die(self, s: StorageRec) -> None:
        """Mark ``s`` (and transitively its ancestors) dead if unreachable.

        A storage is *dead* when no external reference can ever touch it
        again: its own refcount is zero and every child storage is dead or
        banished — so no rematerialization of a live tensor can require it
        (parents of a live storage are live by induction).  Dead storages
        are pruned from the evicted-component structure: they never join
        components, never subscribe, and never inflate e*/ẽ* — the fix for
        eager-release workloads whose e* walk cost otherwise grows with
        trace length.
        """
        storages = self.storages
        stack = [s]
        while stack:
            x = stack.pop()
            if x.dead or x.banished or x.refs > 0:
                continue
            if any(not (storages[c].dead or storages[c].banished)
                   for c in x.children):
                continue
            self._kill(x)
            for psid in x.deps:
                p = storages[psid]
                if p.refs <= 0 and not p.dead and not p.banished:
                    stack.append(p)

    def _kill(self, x: StorageRec) -> None:
        if self.sanitizer is not None:
            self.sanitizer.pre_kill(x)
        x.dead = True
        if x.offloaded:
            # A dead host copy can never be fetched again: drop it (and
            # any in-flight prefetch reservation).  The storage was never
            # an evicted-component member, so no invalidation beyond its
            # own key is needed.
            self.offload.drop(self, x)
            if self.free_fn is not None:
                self.free_fn(x)      # eager hook: discard the host copy too
            if self.index is not None:
                self.index.mark_dirty(x.sid)
        elif not x.resident and not x.banished:
            # x leaves the exact e* closures (walks prune the dead):
            # cached values that summed it are stale.  Its ẽ* component
            # membership is deliberately kept — dead members stay cost
            # ballast for the undirected equivalence classes.
            self._invalidator.on_death(x)
        elif self.index is not None:
            # Dying while resident: the transfer below zeroes x.dead_cost,
            # so x's own cached heap key (computed with the old weight) is
            # stale — drop it or the index could prune a band the scan
            # would pick from.
            self.index.mark_dirty(x.sid)
        # Attach the dead subgraph's frozen cone cost to its live frontier:
        # every live neighbor that the paper's e* walk would have counted
        # the cone through carries it as ``dead_cost``, charged in O(1)
        # when the neighbor is scored or walked — the cone itself is never
        # traversed or subscribed through again.  Death cascades
        # child-first, so a dying parent forwards the cone weight its own
        # ``dead_cost`` already accumulated.  (A cone shared by several
        # live parents is charged at each of them — a deliberate
        # over-approximation; the pre-pruning walk deduplicated across one
        # closure, but per-parent attachment keeps the charge local and
        # event-free.)  Pinned/constant neighbors are skipped: they are
        # never victims and never walked, so weight parked there would
        # vanish from the score system — exactly as the old walks could
        # never reach a cone hanging only off pinned storages.
        transfer = x.local_cost + x.dead_cost
        x.dead_cost = 0.0
        if transfer <= 0.0:
            return
        for nsid in sorted(x.deps | x.children):
            host = self.storages[nsid]
            if host.dead or host.banished or host.pinned or host.constant:
                continue
            host.dead_cost += transfer
            if host.offloaded:
                # Offloaded host: no closure ever sums it; only its own
                # key carries the new weight.
                if self.index is not None:
                    self.index.mark_dirty(host.sid)
            elif not host.resident:
                # Cached e* closures that summed ``host`` hold its old
                # effective cost; adjacency is unchanged (sum-only).  The
                # ẽ* component sums are untouched: the cone's members
                # carry their own cost there.
                self._invalidator.on_cost_change(host)
            elif self.index is not None:
                # Resident host: only its own key/score carries the weight.
                self.index.mark_dirty(host.sid)

    def _revive(self, s: StorageRec) -> None:
        """A dead storage regained a reference (addref / new view).

        Undo the pruning: the storage (and every dead ancestor — they all
        have a live descendant again) rejoins the evicted components.

        Known drift, accepted: the cone weight ``_kill`` already donated
        to the live frontier is not clawed back, so a revived storage is
        briefly double-counted (once live, once inside its neighbors'
        ``dead_cost``).  A well-formed log cannot reach this path — a
        handle with zero references cannot be addref'd or viewed — so the
        drift only affects hand-driven runtimes, and only as a transient
        over-protection of the revived storage's neighbors.
        """
        storages = self.storages
        stack = [s]
        while stack:
            x = stack.pop()
            if not x.dead:
                continue
            x.dead = False
            if not x.resident and not x.banished and not x.offloaded:
                self._invalidator.on_evict(x)
                if self.uf is not None and not x.uf_joined:
                    self._uf_join(x)
            stack.extend(storages[p] for p in x.deps if storages[p].dead)

    def _try_banish(self, s: StorageRec) -> None:
        # Banishable iff no *live* evicted dependents (children all
        # resident, banished, or dead); otherwise retried after
        # rematerializations.  Dead evicted children never rematerialize,
        # so they must not block the banish forever.
        for csid in s.children:
            c = self.storages[csid]
            # Offloaded children need no remat (they fetch back), so they
            # never block a banish.
            if (not c.resident and not c.banished and not c.dead
                    and not c.offloaded):
                self._pending_banish.add(s.sid)
                return
        self._pending_banish.discard(s.sid)
        if self.sanitizer is not None:
            self.sanitizer.pre_banish(s)
        if s.offloaded:
            # Banish drops the host copy too: permanent free means the
            # bytes are gone from every tier.
            self.offload.drop(self, s)
            if self.free_fn is not None:
                self.free_fn(s)
        if s.resident:
            self.memory -= s.size
            for tid in s.tensor_tids:
                self.tensors[tid].defined = False
            if self.allocator is not None:
                self.allocator.free(s)
            if self.free_fn is not None:
                self.free_fn(s)
        s.resident = False
        s.banished = True
        # Banished storages leave the evicted closures permanently; drop the
        # cached costs of their component's consumers (no-op if s was
        # resident: nothing cached ever summed it).
        self._invalidator.on_unevict(s)
        # Children become non-rematerializable => pin them.
        for csid in s.children:
            c = self.storages[csid]
            if not c.banished:
                c.pinned = True
        # A banished child counts as dead for its parents' liveness rule.
        for psid in s.deps:
            p = self.storages[psid]
            if p.refs <= 0 and not p.dead and not p.banished:
                self._maybe_die(p)

    # ------------------------------------------------------------------
    # Metadata used by heuristics
    # ------------------------------------------------------------------
    def staleness(self, s: StorageRec) -> float:
        return max(self.clock - s.last_access, 1e-9)

    def evicted_neighborhood_cost(self, s: StorageRec) -> float:
        """Exact  Σ_{T ∈ e*(S)} cost(T)  with scoped caching (App. C.5).

        Cache entries live until the ScopedInvalidator drops them: while
        computing, the walk subscribes ``s`` to the evicted component of
        every storage it sums, so an evict/remat elsewhere leaves this
        entry intact.

        The walk visits *live* evicted storages only.  Dead subgraphs
        (eager-released tensors whose whole descendant cone is
        unreferenced) are never traversed: their aggregate cost is charged
        in O(1) through the ``dead_cost`` attached to each walked storage
        — same sum as walking the cone, none of the per-member visits or
        subscriptions, so walk cost is bounded by the live evicted set
        instead of growing with trace length.
        """
        hit = self._estar_cache.get(s.sid)
        if hit is not None:
            return hit[0]
        subscribe = self._invalidator.subscribe
        total = 0.0
        seen: set[int] = set()
        # Evicted ancestors: closure over evicted deps.
        stack = [d for d in s.deps if self._is_evicted(d)]
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            self.meta_accesses += 1
            xs = self.storages[x]
            total += xs.local_cost + xs.dead_cost
            subscribe(x, s.sid)
            stack.extend(d for d in xs.deps if self._is_evicted(d) and d not in seen)
        # Evicted descendants: closure over evicted children.
        stack = [c for c in s.children if self._is_evicted(c)]
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            self.meta_accesses += 1
            xs = self.storages[x]
            total += xs.local_cost + xs.dead_cost
            subscribe(x, s.sid)
            stack.extend(c for c in xs.children
                         if self._is_evicted(c) and c not in seen)
        self._estar_cache[s.sid] = (total, len(seen))
        return total

    def evicted_ancestor_cost(self, s: StorageRec) -> float:
        """Σ cost over evicted ancestors only (MSPS, Peng et al. 2020).

        Uncached (matching the original accounting), but the walk still
        subscribes so the eviction index knows when a cached *score* built
        on this value goes stale.
        """
        subscribe = self._invalidator.subscribe
        total = 0.0
        seen: set[int] = set()
        stack = [d for d in s.deps if self._is_evicted(d)]
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            self.meta_accesses += 1
            xs = self.storages[x]
            total += xs.local_cost
            subscribe(x, s.sid)
            stack.extend(d for d in xs.deps if self._is_evicted(d) and d not in seen)
        return total

    def eq_neighborhood_cost(self, s: StorageRec) -> float:
        """ẽ*(S) via union-find components of evicted neighbors (App. C.2).

        Two-tier scoped caching:

        * the **value** (``_eq_cache``) is dropped whenever any adjacent
          component's sum changes — merges, splits, and member cost growth
          alike (the ScopedInvalidator pops the subscriptions registered
          here);
        * the **adjacency snapshot** (``_eq_adj``) — the union-find handles
          of S's evicted neighbors, in sorted-sid order — survives
          component-*sum*-only events and is dropped only when a neighbor
          actually enters or leaves the evicted set.  While it holds, a
          key rebuild resolves each remembered handle to its current root
          and reads the incrementally-maintained root sum: no neighborhood
          re-walk, no re-subscription.  The sorted order makes the float
          summation a pure function of current state, so scan and index
          engines (whose evaluation times differ) compute bit-identical
          values.
        """
        assert self.uf is not None
        hit = self._eq_cache.get(s.sid)
        if hit is not None:
            return hit
        uf = self.uf
        snap = self._eq_adj.get(s.sid)
        if snap is not None:
            roots: set[int] = set()
            total = 0.0
            for h in snap:
                r = uf.find(h)
                if r not in roots:
                    roots.add(r)
                    total += uf.root_sum(r)
            self.meta_accesses += 1
            self._eq_cache[s.sid] = total
            return total
        subscribe = self._invalidator.subscribe
        roots = set()
        total = 0.0
        handles: list[int] = []
        # Dead neighbors count here (unlike the exact walk): they are
        # members of the equivalence classes, so their component is part
        # of ẽ* by construction.
        for nsid in sorted(s.deps | s.children):
            ns = self.storages[nsid]
            if not ns.resident and not ns.banished and not ns.offloaded:
                r = uf.find(ns.uf)
                self.meta_accesses += 1
                subscribe(nsid, s.sid)
                handles.append(ns.uf)
                if r not in roots:
                    roots.add(r)
                    total += uf.root_sum(r)
        self._eq_adj[s.sid] = tuple(handles)
        self._eq_cache[s.sid] = total
        return total

    def _is_evicted(self, sid: int) -> bool:
        s = self.storages[sid]
        return (not s.resident and not s.banished and not s.dead
                and not s.offloaded)
