"""Static trace verifier: liveness + remat-closure + alias/pin analysis.

One linear pass over a ``core.graph.Log`` mirrors the refcounting state
``graph.replay`` would drive through the runtime — *without* running any
replay — and reports structural defects before they can corrupt a run:

* malformed CALL metadata blocks (via the same ``parse_call_block`` the
  replayer uses, so the two consumers cannot drift);
* uses of tensors that were never defined, or whose external refcount
  already hit zero (``use-after-release``; under the ``banish`` policy a
  refcount-zero storage is eventually *permanently* freed, so the same
  defect is reported as ``use-after-banish``);
* release-underflow / double release;
* alias outputs carrying nonzero MEMORY sizes, aliases of released
  storages, MUTATE targets that are not inputs;
* non-finite / negative op costs and negative sizes (a NaN cost would
  poison the simulated clock and every heuristic score downstream);
* unreachable recompute paths: under ``banish``, a live tensor whose
  remat closure crosses a banished storage without an intervening pinned
  ancestor can never be rematerialized once evicted.

Anything the replayer would survive but that lies about liveness (reusing
a still-live name, releasing a pinned constant that stays resident
anyway, stray metadata instructions) is a *warning*; ``verify_log``
raises only on errors.  ``trace.replay.run_trace`` calls ``check_log``
on every log it replays (memoized per log object), so a malformed trace
fails fast with a structured report instead of a mid-replay KeyError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.graph import (Alias, Call, Constant, Copy, CopyFrom, Log,
                          Memory, Mutate, Release, parse_call_block)

#: fields a lint result is allowed to distinguish severities on
SEVERITIES = ("error", "warning")

#: names of the storage attributes heuristic keys may read — documented
#: here because the trace verifier and the AST lint share the contract.
SUBSCRIBED_KEY_FIELDS = frozenset(("local_cost", "dead_cost", "size", "sid"))


@dataclass(frozen=True)
class TraceIssue:
    code: str
    severity: str           # "error" | "warning"
    index: int              # instruction index (-1 for log-level issues)
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.code} @ instr {self.index}: " \
               f"{self.message}"


class TraceLintError(ValueError):
    """A log failed static verification; ``.issues`` carries the errors."""

    def __init__(self, log_name: str, issues: list[TraceIssue]) -> None:
        errors = [i for i in issues if i.severity == "error"]
        lines = "\n  ".join(str(i) for i in errors[:8])
        more = f"\n  ... and {len(errors) - 8} more" if len(errors) > 8 else ""
        super().__init__(
            f"trace {log_name!r} failed static verification "
            f"({len(errors)} error(s)):\n  {lines}{more}")
        self.issues = issues


class _State:
    """Shadow refcount state for one linear pass (mirrors graph.replay)."""

    def __init__(self, dealloc: str) -> None:
        self.dealloc = dealloc
        self.env: dict[str, int] = {}       # name -> tensor id
        self.trefs: dict[int, int] = {}     # tensor id -> external refcount
        self.tsid: dict[int, int] = {}      # tensor id -> storage id
        self.ssize: dict[int, int] = {}
        self.srefs: dict[int, int] = {}     # storage refcount (sum of views)
        self.sconst: set[int] = set()
        self.sdeps: dict[int, set[int]] = {}
        self.schildren: dict[int, set[int]] = {}
        self.banished: set[int] = set()
        self.pinned: set[int] = set()
        self._safe: dict[int, bool] = {}    # remat-closure memo (per epoch)
        self._next_tid = 0
        self._next_sid = 0

    # -- tensor/storage creation ----------------------------------------
    def new_storage(self, size: int, constant: bool = False) -> int:
        sid = self._next_sid
        self._next_sid += 1
        self.ssize[sid] = size
        self.srefs[sid] = 0
        self.sdeps[sid] = set()
        self.schildren[sid] = set()
        if constant:
            self.sconst.add(sid)
            self.pinned.add(sid)
        return sid

    def new_tensor(self, name: str, sid: int) -> int:
        tid = self._next_tid
        self._next_tid += 1
        self.env[name] = tid
        self.trefs[tid] = 1
        self.tsid[tid] = sid
        self.srefs[sid] += 1
        return tid

    # -- banish simulation ------------------------------------------------
    def storage_released(self, sid: int) -> None:
        """Storage refcount hit zero: under ``banish`` it will eventually
        be permanently freed, pinning its current children (exactly what
        ``DTRRuntime._try_banish`` does; deferral only delays the event)."""
        if self.dealloc != "banish" or sid in self.banished:
            return
        self.banished.add(sid)
        for c in self.schildren[sid]:
            self.pinned.add(c)
        self._safe.clear()              # remat-closure memo is epoch-scoped

    def remat_safe(self, sid: int) -> bool:
        """Can ``sid`` be rematerialized if evicted?  False iff its remat
        closure crosses a banished storage with no pinned ancestor
        shielding it.  Pinned / constant storages are never evicted, so
        the walk stops there; banish-free runs are trivially safe.

        Well-formed logs cannot fail this: the banish path pins every
        surviving child, which shields all transitive consumers — the
        check guards log *producers* (trace editors, plan-to-log
        lowerings) that write Release placement or dep structure by hand.
        """
        if not self.banished:
            return True
        memo = self._safe
        if sid in memo:
            return memo[sid]
        # Iterative post-order DFS; cycle members left unresolved are
        # treated as safe (a dep cycle is only expressible in hand-built
        # logs, and one confusing error beats a cascade).
        visiting: set[int] = set()
        stack: list[tuple[int, bool]] = [(sid, False)]
        while stack:
            x, post = stack.pop()
            if post:
                visiting.discard(x)
                ok = True
                for d in self.sdeps[x]:
                    if d in self.banished:
                        ok = False
                        break
                    if d in self.pinned or d in self.sconst:
                        continue
                    if not memo.get(d, True):
                        ok = False
                        break
                memo[x] = ok
                continue
            if x in memo or x in visiting:
                continue
            if x in self.banished:
                memo[x] = False
                continue
            if x in self.pinned or x in self.sconst:
                memo[x] = True
                continue
            visiting.add(x)
            stack.append((x, True))
            for d in self.sdeps[x]:
                if (d not in memo and d not in visiting
                        and d not in self.banished
                        and d not in self.pinned and d not in self.sconst):
                    stack.append((d, False))
        return memo.get(sid, True)


def lint_log(log: Log, dealloc: str = "eager") -> list[TraceIssue]:
    """Statically verify ``log``; returns all issues (errors + warnings).

    ``dealloc`` selects the deallocation policy the log will replay
    under: the ``banish`` policy turns use-after-release into
    use-after-banish (a permanent-free hazard) and enables the
    remat-closure reachability analysis.
    """
    assert dealloc in ("ignore", "eager", "banish")
    st = _State(dealloc)
    issues: list[TraceIssue] = []

    def err(code: str, i: int, msg: str) -> None:
        issues.append(TraceIssue(code, "error", i, msg))

    def warn(code: str, i: int, msg: str) -> None:
        issues.append(TraceIssue(code, "warning", i, msg))

    def use(name: str, i: int, what: str) -> int | None:
        """Validate a tensor use; returns its tensor id (None if broken)."""
        tid = st.env.get(name)
        if tid is None:
            err("undefined-tensor", i,
                f"{what} {name!r} was never defined")
            return None
        sid = st.tsid[tid]
        if st.trefs[tid] <= 0:
            if sid in st.banished:
                err("use-after-banish", i,
                    f"{what} {name!r} uses a banished storage "
                    f"(refcount hit zero under dealloc='banish')")
            elif sid in st.sconst:
                warn("stale-constant-use", i,
                     f"{what} {name!r} was released but its pinned "
                     f"constant storage stays resident under "
                     f"dealloc={dealloc!r}")
            else:
                err("use-after-release", i,
                    f"{what} {name!r} has no external references left "
                    f"(the runtime may have pruned it as dead)")
        elif not st.remat_safe(sid):
            err("unreachable-recompute", i,
                f"{what} {name!r} cannot be rematerialized if evicted: "
                f"its recompute closure crosses a banished storage")
        return tid

    def release(tid: int, i: int, name: str) -> None:
        if st.trefs[tid] <= 0:
            err("release-underflow", i,
                f"RELEASE of {name!r} underflows its refcount "
                f"(already {st.trefs[tid]})")
            return
        st.trefs[tid] -= 1
        sid = st.tsid[tid]
        st.srefs[sid] -= 1
        if st.srefs[sid] <= 0:
            st.storage_released(sid)

    def define(name: str, sid: int, i: int) -> int:
        old = st.env.get(name)
        if old is not None and st.trefs[old] > 0:
            warn("shadowed-definition", i,
                 f"output {name!r} shadows a still-live tensor "
                 f"(its external reference leaks)")
        return st.new_tensor(name, sid)

    instrs = log.instrs
    n = len(instrs)
    consumed: set[int] = set()          # metadata indices owned by a block
    i = 0
    while i < n:
        ins = instrs[i]
        if isinstance(ins, Constant):
            mem = instrs[i + 1] if i + 1 < n else None
            if not (isinstance(mem, Memory) and mem.t == ins.t):
                err("malformed-constant", i,
                    f"CONSTANT {ins.t!r} is not followed by its MEMORY")
                define(ins.t, st.new_storage(0, constant=True), i)
                i += 1
                continue
            if mem.size < 0:
                err("bad-size", i + 1,
                    f"MEMORY for {ins.t!r} has negative size {mem.size}")
            consumed.add(i + 1)
            define(ins.t, st.new_storage(mem.size, constant=True), i)
            i += 2
            continue
        if isinstance(ins, Call):
            if not (isinstance(ins.cost, (int, float))
                    and math.isfinite(ins.cost) and ins.cost >= 0):
                err("bad-cost", i,
                    f"CALL {ins.op!r} has non-finite or negative cost "
                    f"{ins.cost!r}")
            try:
                sizes, alias_names, j = parse_call_block(instrs, i)
            except (AssertionError, IndexError) as e:
                err("malformed-call-block", i,
                    f"CALL {ins.op!r}: metadata block does not match "
                    f"outputs {ins.outputs} ({e or 'truncated'})")
                sizes = [0] * len(ins.outputs)
                alias_names = [None] * len(ins.outputs)
                j = i + 1
            else:
                consumed.update(range(i + 1, j))
            in_tids = [use(t, i, "CALL input") for t in ins.inputs]
            in_sids = {st.tsid[t] for t in in_tids if t is not None}
            out_sids: list[int] = []
            for k, (t, size, al) in enumerate(
                    zip(ins.outputs, sizes, alias_names)):
                if al is not None:
                    if size != 0:
                        err("alias-size", i,
                            f"output {t!r} aliases {al!r} but carries "
                            f"nonzero MEMORY size {size}")
                    atid = use(al, i, "ALIAS target")
                    sid = (st.tsid[atid] if atid is not None
                           else st.new_storage(0))
                else:
                    if size < 0:
                        err("bad-size", i,
                            f"output {t!r} has negative size {size}")
                    sid = st.new_storage(max(size, 0))
                define(t, sid, i)
                out_sids.append(sid)
            for osid in set(out_sids):
                for isid in in_sids:
                    if isid != osid:
                        st.sdeps[osid].add(isid)
                        st.schildren[isid].add(osid)
            i = j
            continue
        if isinstance(ins, Mutate):
            if not (isinstance(ins.cost, (int, float))
                    and math.isfinite(ins.cost) and ins.cost >= 0):
                err("bad-cost", i,
                    f"MUTATE {ins.op!r} has non-finite or negative cost "
                    f"{ins.cost!r}")
            inputs = set(ins.inputs)
            for t in ins.mutated:
                if t not in inputs:
                    err("mutate-not-input", i,
                        f"MUTATE {ins.op!r} mutates {t!r} which is not "
                        f"among its inputs {ins.inputs}")
            in_tids = {t: use(t, i, "MUTATE input") for t in ins.inputs}
            in_sids = {st.tsid[tid] for tid in in_tids.values()
                       if tid is not None}
            # Copy-on-write rewrite (graph.replay): fresh versions of the
            # mutated tensors replace the old bindings, old refs released.
            for t in ins.mutated:
                old = in_tids.get(t)
                if t not in inputs or old is None:
                    continue
                sid = st.new_storage(st.ssize[st.tsid[old]])
                for isid in in_sids:
                    if isid != sid:
                        st.sdeps[sid].add(isid)
                        st.schildren[isid].add(sid)
                release(old, i, t)
                st.new_tensor(t, sid)
            i += 1
            continue
        if isinstance(ins, Copy):
            tid = use(ins.t_in, i, "COPY source")
            if tid is not None:
                old = st.env.get(ins.t_out)
                if (old is not None and old != tid
                        and st.trefs[old] > 0):
                    warn("shadowed-definition", i,
                         f"COPY target {ins.t_out!r} shadows a "
                         f"still-live tensor")
                st.env[ins.t_out] = tid
                st.trefs[tid] += 1
                st.srefs[st.tsid[tid]] += 1
            i += 1
            continue
        if isinstance(ins, CopyFrom):
            out = st.env.get(ins.t_out)
            if out is None:
                err("undefined-tensor", i,
                    f"COPYFROM target {ins.t_out!r} was never defined")
            tid = use(ins.t_in, i, "COPYFROM source")
            if tid is not None:
                if out is not None:
                    release(out, i, ins.t_out)
                st.env[ins.t_out] = tid
                st.trefs[tid] += 1
                st.srefs[st.tsid[tid]] += 1
            i += 1
            continue
        if isinstance(ins, Release):
            tid = st.env.get(ins.t)
            if tid is None:
                err("undefined-tensor", i,
                    f"RELEASE of {ins.t!r} which was never defined")
            else:
                release(tid, i, ins.t)
            i += 1
            continue
        if isinstance(ins, (Memory, Alias)):
            if i not in consumed:
                warn("stray-metadata", i,
                     f"{type(ins).__name__} instruction not attached to "
                     f"any CONSTANT/CALL block (replay skips it)")
            i += 1
            continue
        err("unknown-instruction", i,
            f"unknown instruction {type(ins).__name__}")
        i += 1
    return issues


def verify_log(log: Log, dealloc: str = "eager") -> list[TraceIssue]:
    """``lint_log`` + raise :class:`TraceLintError` if any errors.

    Returns the warnings (if any) for callers that want to surface them.
    """
    issues = lint_log(log, dealloc=dealloc)
    if any(i.severity == "error" for i in issues):
        raise TraceLintError(log.name, issues)
    return [i for i in issues if i.severity == "warning"]


def check_log(log: Log, dealloc: str = "eager") -> None:
    """Memoized ``verify_log`` for hot replay paths.

    Budget sweeps replay the same ``Log`` object hundreds of times; the
    verdict is cached on the instance per dealloc policy (logs are not
    mutated after construction anywhere in the repo).
    """
    cache = getattr(log, "_lint_verdict", None)
    if cache is None:
        cache = {}
        log._lint_verdict = cache
    hit = cache.get(dealloc)
    if hit is not None:
        if hit is not True:
            raise hit
        return
    try:
        verify_log(log, dealloc=dealloc)
    except TraceLintError as e:
        cache[dealloc] = e
        raise
    cache[dealloc] = True
