"""Execute a static checkpointing plan through the real DTR runtime.

A compiled plan (``StaticPlan``) is a *drop set* plus each dropped
storage's touch ordinals.  The executor enforces the classic static
semantics — a dropped checkpoint is resident only while an adjacent
operator touches it — by evicting, after every replay call, each dropped
storage whose next touch is not the immediately following op.  This rule
covers both the planned gap entries *and* rebuild remnants: a dropped
storage rematerialized as a dependency of some later gap replay is
dropped again right after that call, instead of lingering resident for
the rest of the run (the failure mode of a fixed ordinal->sids schedule,
whose eviction points cannot anticipate remat-triggered rebuilds).

Plans run through the same ``DTRRuntime`` / ``PoolAllocator`` stack the
online heuristics use — budget unconstrained, victim selection disabled
(``_pick_victim`` raises), every eviction dictated by the plan — so
static and online overheads are measured under identical memory
accounting, remat recursion, and clock rules.

Two consumers must agree bit-for-bit:

* ``execute_plan`` — the real run (``PlanRuntime`` + ``graph.replay``);
* ``evaluate_plan`` — a self-contained symbolic simulator over the
  ``LogView`` event stream that predicts remat ops, evictions, compute
  and peak memory *without* constructing a runtime.

``evaluate_plan`` mirrors the runtime's order of operations exactly
(materialization recursion, allocation points, eager-release evictions,
the post-op drop rule and garbage sweep, finalize), so equality of its
prediction with the executed counters is the differential gate that the
planner's model of the runtime is faithful — any drift in either is a
test failure, not a tolerance.

One rule has no counterpart in the online engine: a storage whose last
RELEASE already happened but that was rematerialized again (as a
dependency of a later gap) will never see another release, so with an
unconstrained budget it would stay resident forever.  After each
scheduled op, both sides sweep these refs-zero revenants (collected at
rematerialization time), charging the evictions to the plan.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

from ..core.graph import Log, replay
from ..core.heuristics import by_name
from ..core.runtime import DTRRuntime
from ..core.simulator import RunResult, make_allocator, result_from_runtime
from .chain import Chain, LogView, build_view, trim_touches


@dataclass(frozen=True)
class StaticPlan:
    """Compiled plan: storages to drop / trim, and when they are touched."""
    drop: tuple[int, ...]                       # sids, sorted
    touches: Mapping[int, tuple[int, ...]]      # sid -> sorted op ordinals
    #: free-tail storages (evicted after their last touch in every plan —
    #: zero remat cost; see ``chain.trim_touches``), sorted, disjoint
    #: from ``drop``
    trim: tuple[int, ...] = ()

    def next_touch(self, sid: int, k: int) -> Optional[int]:
        """First touch ordinal strictly after op ``k`` (None if exhausted)."""
        ts = self.touches[sid]
        i = bisect_right(ts, k)
        return ts[i] if i < len(ts) else None


def compile_plan(view: LogView, chain: Chain,
                 keep: frozenset[int] | set[int] | Sequence[int]
                 ) -> StaticPlan:
    """Compile a solver selection (``keep`` = item indices into
    ``chain.items``) into an executable drop plan."""
    keep = set(keep)
    drop = sorted(it.sid for i, it in enumerate(chain.items)
                  if i not in keep)
    touches = {}
    for sid in drop:
        s = view.storages[sid]
        ts = set(s.uses) | ({s.producer} if s.producer is not None
                            else set())
        if s.kept:                  # finalize rematerializes it once more
            ts.add(view.n_ops)
        touches[sid] = tuple(sorted(ts))
    trims = trim_touches(view)
    trim = tuple(sid for sid in sorted(trims) if sid not in touches)
    for sid in trim:
        touches[sid] = trims[sid]
    return StaticPlan(tuple(drop), touches, trim)


class PlanRuntime(DTRRuntime):
    """DTRRuntime with victim selection disabled and plan-driven evictions.

    The budget is unconstrained so the admission loop never looks for a
    victim; ``_pick_victim`` raises to guarantee the heuristic is
    structurally out of the loop (any call would be a bug, not a silent
    fallback to online behaviour).
    """

    def __init__(self, plan: StaticPlan, allocator=None) -> None:
        super().__init__(budget=float("inf"), heuristic=by_name("h_lru"),
                         dealloc="eager", index=False, allocator=allocator)
        self._plan = plan
        self._ordinal = 0               # replay-level call index
        self._in_call = False
        self._garbage: set[int] = set() # rematted storages with refs <= 0
        self.forced_evictions = 0
        self.trimmed = 0
        self.swept = 0

    def _pick_victim(self, exclude):
        raise AssertionError(
            "static plan execution must never consult the online heuristic")

    def _on_remat(self, s):
        super()._on_remat(s)
        if s.refs <= 0:
            self._garbage.add(s.sid)

    def call(self, op_name, cost, input_tids, out_sizes,
             aliases=None, out_names=None):
        if self._in_call:        # a remat replay inside _ensure_defined
            return super().call(op_name, cost, input_tids, out_sizes,
                                aliases=aliases, out_names=out_names)
        self._in_call = True
        try:
            out = super().call(op_name, cost, input_tids, out_sizes,
                               aliases=aliases, out_names=out_names)
        finally:
            self._in_call = False
        k = self._ordinal
        self._ordinal += 1
        self._sweep(k)
        return out

    def _sweep(self, k: int) -> None:
        # Drop rule: a dropped storage stays resident only into an
        # immediately adjacent touch.
        for sid in self._plan.drop:
            s = self.storages.get(sid)
            if s is None or not s.resident or not s.evictable():
                continue
            nt = self._plan.next_touch(sid, k)
            if nt is None or nt > k + 1:
                self._evict(s)
                self.forced_evictions += 1
        # Trim rule: a free-tail storage is evicted once it is past its
        # last touch — no future touch means no remat can ever follow.
        for sid in self._plan.trim:
            s = self.storages.get(sid)
            if s is None or not s.resident or not s.evictable():
                continue
            if self._plan.next_touch(sid, k) is None:
                self._evict(s)
                self.trimmed += 1
        if self._garbage:
            for sid in sorted(self._garbage):
                s = self.storages[sid]
                if s.refs <= 0 and s.evictable():
                    self._evict(s)
                    self.swept += 1
            self._garbage.clear()

    def finalize(self) -> None:
        # Rebuild finalize-kept tensors one at a time, sweeping dropped
        # rebuild dependencies between them: one concurrent remat cone
        # instead of all of them at once.  Mirrors DTRRuntime.finalize
        # (refs > 0 -> ensure + lock) with a sweep after each ensure;
        # locked storages are not evictable, so already-finalized kept
        # tensors survive the sweeps.
        k = self._ordinal               # == n_ops: every touch is past
        for t in list(self.tensors.values()):
            if t.refs > 0 and not self.storages[t.sid].banished:
                self._ensure_defined([t.tid])
                self.storages[t.sid].locks += 1
                self._sweep(k)


def execute_plan(log: Log, plan: StaticPlan,
                 alloc_mode: Optional[str] = None) -> RunResult:
    """Replay ``log`` with evictions forced by ``plan``.

    Returns a standard ``RunResult`` (``budget`` is reported as ``inf``:
    feasibility against a byte budget is judged by comparing
    ``peak_memory`` to it, exactly like the honest fig3 feasibility
    check).
    """
    rt = PlanRuntime(plan, allocator=make_allocator(alloc_mode))
    replay(log, rt)
    return result_from_runtime(rt, budget=float("inf"), ok=True)


# ---------------------------------------------------------------------------
# Symbolic evaluator (the runtime mirror)
# ---------------------------------------------------------------------------

@dataclass
class PlanEval:
    """Predicted execution profile of a plan (must equal the real run)."""
    remat_ops: int
    evictions: int
    compute: float
    base_compute: float
    peak_memory: float
    ops_executed: int

    @property
    def overhead(self) -> float:
        return self.compute / max(self.base_compute, 1e-12)


def evaluate_plan(view: LogView, plan: StaticPlan) -> PlanEval:
    """Predict ``execute_plan``'s counters from the ``LogView`` alone.

    Bit-exact mirror of the runtime path: same float-summation order for
    compute (ops perform in the same sequence), same integer byte
    arithmetic for memory, same eviction triggers (eager release, the
    drop rule, garbage sweep, finalize remats).
    """
    n_t = len(view.tensors)
    n_s = len(view.storages)
    defined = [False] * n_t
    resident = [False] * n_s
    tref = [0] * n_t
    sref = [0] * n_s
    locked = [False] * n_s          # finalize locks (mirror of s.locks)
    sizes = [s.size for s in view.storages]
    const = [s.constant for s in view.storages]
    garbage: set[int] = set()

    mem = 0.0
    peak = 0.0
    compute = 0.0
    base = 0.0
    remats = 0
    evictions = 0
    executed = 0

    tensors = view.tensors
    ops = view.ops

    def evict(sid: int) -> None:
        nonlocal mem, evictions
        resident[sid] = False
        for tid in view.storages[sid].tids:
            defined[tid] = False
        mem -= sizes[sid]
        evictions += 1

    def perform(k: int, first: bool) -> None:
        nonlocal mem, peak, compute, base, remats, executed
        op = ops[k]
        need = 0
        placed = []
        for tid in op.out_tids:
            t = tensors[tid]
            if not t.is_alias and not resident[t.sid]:
                need += sizes[t.sid]
                placed.append(t.sid)
        mem += need
        peak = max(peak, mem)
        for sid in placed:
            resident[sid] = True
            if not first and sref[sid] <= 0:
                garbage.add(sid)
        for tid in op.out_tids:
            if resident[tensors[tid].sid]:
                defined[tid] = True
        compute += op.cost
        executed += 1
        if first:
            base += op.cost
        else:
            remats += 1

    def ensure(tid: int) -> None:
        # Iterative mirror of DTRRuntime._ensure_defined: frames push their
        # undefined inputs in order and pop LIFO, so ops perform in the
        # exact sequence (and float-sum order) the runtime uses.
        if defined[tid]:
            return
        stack = [tid]
        while stack:
            t = stack[-1]
            if defined[t]:
                stack.pop()
                continue
            k = tensors[t].oid
            assert k is not None, "evaluator reached an evicted constant"
            undef = [u for u in ops[k].in_tids if not defined[u]]
            if undef:
                stack.extend(undef)
                continue
            perform(k, first=False)
            stack.pop()

    def release(tid: int) -> None:
        tref[tid] -= 1
        sid = tensors[tid].sid
        sref[sid] -= 1
        if sref[sid] <= 0 and not const[sid] and resident[sid]:
            evict(sid)

    def sweep(k: int) -> None:
        for sid in plan.drop:
            if not resident[sid] or const[sid] or locked[sid]:
                continue
            nt = plan.next_touch(sid, k)
            if nt is None or nt > k + 1:
                evict(sid)
        for sid in plan.trim:
            if not resident[sid] or const[sid] or locked[sid]:
                continue
            if plan.next_touch(sid, k) is None:
                evict(sid)
        if garbage:
            for sid in sorted(garbage):
                if (sref[sid] <= 0 and resident[sid] and not const[sid]
                        and not locked[sid]):
                    evict(sid)
            garbage.clear()

    for ev in view.events:
        kind = ev[0]
        if kind == "const":
            sid = ev[1]
            tid = view.storages[sid].tids[0]
            tref[tid] += 1
            sref[sid] += 1
            resident[sid] = True
            defined[tid] = True
            mem += sizes[sid]
            peak = max(peak, mem)
        elif kind == "op":
            k = ev[1]
            op = ops[k]
            for tid in op.out_tids:
                tref[tid] += 1
                sref[tensors[tid].sid] += 1
            for u in op.in_tids:
                ensure(u)
            perform(k, first=True)
            sweep(k)
        elif kind == "rel":
            release(ev[1])
        elif kind == "addref":
            tid = ev[1]
            tref[tid] += 1
            sref[tensors[tid].sid] += 1
        else:                            # pragma: no cover
            raise AssertionError(f"unknown event {ev!r}")

    # finalize(): every externally referenced tensor is rematerialized and
    # locked, one at a time, with a sweep between rebuilds (mirror of
    # PlanRuntime.finalize).
    n_ops = view.n_ops
    for tid in range(n_t):
        if tref[tid] > 0:
            ensure(tid)
            locked[tensors[tid].sid] = True
            sweep(n_ops)

    return PlanEval(remat_ops=remats, evictions=evictions, compute=compute,
                    base_compute=base, peak_memory=peak,
                    ops_executed=executed)


def predict_and_execute(log: Log, view: LogView | None, plan: StaticPlan,
                        alloc_mode: Optional[str] = None
                        ) -> tuple[PlanEval, RunResult]:
    """Convenience: evaluator prediction + real execution of one plan."""
    if view is None:
        view = build_view(log)
    return evaluate_plan(view, plan), execute_plan(log, plan,
                                                   alloc_mode=alloc_mode)
