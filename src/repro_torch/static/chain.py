"""Linearize a captured ``core.graph.Log`` into a checkpointing chain.

Static planners (Chen segmentation, the heterogeneous optimal DP — see
``solvers.py``) operate on a *chain* abstraction: an ordered list of
checkpoint candidates, each carrying real bytes and the real cost of the
operator segment that produces it.  This module extracts that chain from a
trace:

* ``LogView`` interprets the instruction stream once (mirroring
  ``graph.replay``'s environment handling of CALL/MUTATE/COPY/COPYFROM/
  RELEASE, via the shared ``parse_call_block``) into flat op/tensor/storage
  tables plus per-storage liveness intervals in *op-ordinal* time — the
  substrate shared by the chain extractor, the LP lower bound
  (``lpbound.py``) and the plan evaluator/executor (``executor.py``).

* ``extract_chain`` selects the checkpoint candidate set.  The classic
  construction uses articulation points of the op DAG (cuts crossed by a
  single storage); on captured fwd+bwd traces every forward cut is crossed
  by the whole saved-activation front, so the candidate set generalizes to
  the storages that *span* a cut — storages held across at least one
  operator that does not touch them (a "far" use).  Each candidate carries
  the byte size it pins across its gap and the cost of the operator segment
  separating it from the previous candidate; an articulation point is the
  special case where the candidate is the only storage crossing its cut.

Storages that survive to ``finalize`` (gradients/loss — the output
condition) and constants (pinned weights) are never candidates: they are an
unevictable residency floor shared by every plan, online or static.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.graph import (Call, Constant, Copy, CopyFrom, Log, Memory,
                          Mutate, Release, parse_call_block)

#: Default cap on chain length: the biggest-byte candidates are kept as
#: chain items (they dominate the memory planning problem); the tail is
#: folded into the always-resident floor.
MAX_CANDIDATES = 128


@dataclass
class OpV:
    """One executed operator (CALL, or the copy-on-write rewrite of MUTATE)."""
    k: int                          # op ordinal (replay call index)
    name: str
    cost: float
    in_tids: tuple[int, ...]
    out_tids: tuple[int, ...]


@dataclass
class TensorV:
    tid: int
    sid: int
    oid: Optional[int]              # producer op ordinal; None for constants
    is_alias: bool


@dataclass
class StorageV:
    sid: int
    size: int
    constant: bool = False
    producer: Optional[int] = None  # op ordinal that creates the storage
    producer_cost: float = 0.0      # that op's cost (remat lower bound)
    tids: list[int] = field(default_factory=list)
    uses: list[int] = field(default_factory=list)   # op ordinals consuming it
    death: Optional[int] = None     # refs hit 0 after this op ordinal
    kept: bool = False              # externally referenced at finalize


@dataclass
class LogView:
    """Flat, analysis-friendly interpretation of a log."""
    name: str
    ops: list[OpV]
    tensors: list[TensorV]
    storages: list[StorageV]
    #: replay-ordered event stream: ("const", sid) | ("op", k) |
    #: ("rel", tid) | ("addref", tid) — exactly the runtime calls
    #: ``graph.replay`` makes, so a symbolic simulation over these events
    #: reproduces the runtime's accounting decision-for-decision.
    events: list[tuple]

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def base_cost(self) -> float:
        return sum(o.cost for o in self.ops)

    # -- liveness -----------------------------------------------------------
    def live_interval(self, s: StorageV) -> tuple[int, int]:
        """[first, last] op ordinals during which ``s`` occupies memory.

        Constants are live from op 0; a storage is live *during* its
        producer op (outputs are allocated before the op is charged) and
        until the op after which its refcount hits zero (eager dealloc) —
        or to the end of the trace when it survives to finalize.
        """
        start = 0 if s.producer is None else s.producer
        if s.kept or s.death is None:
            end = self.n_ops - 1
        else:
            end = max(s.death, start)
        return start, end

    def live_bytes(self) -> list[float]:
        """Bytes resident at each op ordinal under unconstrained replay."""
        n = self.n_ops
        delta = [0.0] * (n + 1)
        for s in self.storages:
            if s.size <= 0:
                continue
            a, b = self.live_interval(s)
            delta[a] += s.size
            delta[b + 1] -= s.size
        out, acc = [], 0.0
        for t in range(n):
            acc += delta[t]
            out.append(acc)
        return out


def build_view(log: Log) -> LogView:
    """One symbolic pass over ``log``, mirroring ``graph.replay``.

    Storage/tensor ids are assigned in the exact order ``DTRRuntime``
    assigns them during a replay, so a plan compiled against this view
    addresses runtime storages by sid directly.
    """
    ops: list[OpV] = []
    tensors: list[TensorV] = []
    storages: list[StorageV] = []
    events: list[tuple] = []
    env: dict[str, int] = {}        # log tensor name -> tid
    refs: dict[int, int] = {}       # sid -> external refcount

    def new_tensor(sid: int, oid: Optional[int], is_alias: bool) -> int:
        tid = len(tensors)
        tensors.append(TensorV(tid, sid, oid, is_alias))
        storages[sid].tids.append(tid)
        refs[sid] = refs.get(sid, 0) + 1
        return tid

    def new_storage(size: int, constant: bool = False,
                    producer: Optional[int] = None,
                    producer_cost: float = 0.0) -> int:
        sid = len(storages)
        storages.append(StorageV(sid, int(size), constant=constant,
                                 producer=producer,
                                 producer_cost=producer_cost))
        return sid

    def do_release(tid: int) -> None:
        sid = tensors[tid].sid
        refs[sid] -= 1
        events.append(("rel", tid))
        if refs[sid] <= 0 and not storages[sid].constant:
            storages[sid].death = len(ops) - 1

    def do_call(inputs: Sequence[str], out_specs, cost: float, name: str,
                out_names: Sequence[str]) -> None:
        k = len(ops)
        in_tids = tuple(env[x] for x in inputs)
        out_tids = []
        for (size, alias_of), nm in zip(out_specs, out_names):
            if alias_of is not None:
                sid = tensors[env[alias_of]].sid
            else:
                sid = new_storage(size, producer=k, producer_cost=cost)
            out_tids.append(new_tensor(sid, k, alias_of is not None))
            env[nm] = out_tids[-1]
        ops.append(OpV(k, name, float(cost), in_tids, tuple(out_tids)))
        events.append(("op", k))
        for sid in sorted({tensors[t].sid for t in in_tids}):
            u = storages[sid].uses
            if not u or u[-1] != k:
                u.append(k)

    i, instrs, n = 0, log.instrs, len(log.instrs)
    while i < n:
        ins = instrs[i]
        if isinstance(ins, Constant):
            mem = instrs[i + 1]
            assert isinstance(mem, Memory) and mem.t == ins.t
            sid = new_storage(mem.size, constant=True)
            env[ins.t] = new_tensor(sid, None, False)
            events.append(("const", sid))
            i += 2
            continue
        if isinstance(ins, Call):
            sizes, alias_names, j = parse_call_block(instrs, i)
            do_call(ins.inputs, list(zip(sizes, alias_names)), ins.cost,
                    ins.op, ins.outputs)
            i = j
            continue
        if isinstance(ins, Mutate):
            # Copy-on-write rewrite: fresh non-alias versions sized like the
            # mutated tensors (0 for alias views), then old versions drop.
            old = [env[t] for t in ins.mutated]
            out_sizes = [0 if tensors[t].is_alias
                         else storages[tensors[t].sid].size for t in old]
            do_call(ins.inputs, [(sz, None) for sz in out_sizes], ins.cost,
                    ins.op + "_mut", [t + "'" for t in ins.mutated])
            for t, tid in zip(ins.mutated, old):
                do_release(tid)
                # env already remapped by do_call (name + "'"); restore the
                # original name binding the way replay does.
                env[t] = env[t + "'"]
            i += 1
            continue
        if isinstance(ins, Copy):
            tid = env[ins.t_in]
            env[ins.t_out] = tid
            refs[tensors[tid].sid] += 1
            events.append(("addref", tid))
            i += 1
            continue
        if isinstance(ins, CopyFrom):
            do_release(env[ins.t_out])
            tid = env[ins.t_in]
            refs[tensors[tid].sid] += 1
            events.append(("addref", tid))
            env[ins.t_out] = tid
            i += 1
            continue
        if isinstance(ins, Release):
            do_release(env[ins.t])
            i += 1
            continue
        i += 1  # stray Memory/Alias already consumed

    for s in storages:
        if refs.get(s.sid, 0) > 0 and not s.constant:
            s.kept = True
    return LogView(log.name, ops, tensors, storages, events)


# ---------------------------------------------------------------------------
# Chain extraction
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChainItem:
    """One checkpoint candidate."""
    sid: int
    size: float
    cost: float                     # segment cost x number of far gaps
    producer: int                   # producing op ordinal
    #: op ordinals after which a dropped candidate is force-evicted (the
    #: last touch before each far gap); empty for synthetic chains.
    evict_positions: tuple[int, ...] = ()
    #: live-as-kept interval (floor accounting)
    live: tuple[int, int] = (0, 0)


@dataclass
class Chain:
    """Checkpointing chain: candidates in production order + shared floor."""
    items: list[ChainItem]
    #: bytes resident regardless of the plan (constants, finalize-kept
    #: transients, non-candidate tail) — max over op ordinals of the
    #: non-candidate live profile.
    floor: float
    base_cost: float
    name: str = "chain"
    n_ops: int = 0
    n_candidates_total: int = 0     # before the MAX_CANDIDATES cap
    #: bytes every strategy holds at finalize (constants + all kept
    #: storages, locked simultaneously) — a hard peak floor even for
    #: plans that drop kept candidates mid-trace and remat them at the
    #: end.
    final_bytes: float = 0.0

    def __len__(self) -> int:
        return len(self.items)

    def total_bytes(self) -> float:
        return sum(it.size for it in self.items)


def synthetic_chain(costs: Sequence[float], sizes: Sequence[float],
                    floor: float = 0.0, name: str = "synthetic") -> Chain:
    """Model-level chain for solver tests (no underlying log)."""
    assert len(costs) == len(sizes)
    items = [ChainItem(sid=i, size=float(m), cost=float(c), producer=i)
             for i, (c, m) in enumerate(zip(costs, sizes))]
    return Chain(items, float(floor), base_cost=float(sum(costs)), name=name,
                 n_ops=len(items), n_candidates_total=len(items))


def _far_gaps(s: StorageV, n_ops: int) -> list[tuple[int, int]]:
    """(last touch, far use) pairs: spans crossing >= 1 untouching op.

    A finalize-kept storage is touched once more at ordinal ``n_ops``
    (the runtime rematerializes it in ``finalize()``), so a gap before
    the end counts — dropping it there costs a finalize replay.
    """
    touches = ([s.producer] if s.producer is not None else []) + s.uses
    if s.kept:
        touches = touches + [n_ops]
    return [(a, b) for a, b in zip(touches, touches[1:]) if b - a >= 2]


def _last_touch(s: StorageV) -> int:
    return max([s.producer] + s.uses) if s.producer is not None else 0


def _has_free_tail(s: StorageV) -> bool:
    """True when the storage outlives its last touch (dead zone before its
    RELEASE): evicting there frees bytes at zero recompute cost."""
    if s.kept or s.death is None or s.constant or s.producer is None:
        return False
    return s.death > _last_touch(s)


def trim_touches(view: LogView) -> dict[int, tuple[int, ...]]:
    """sid -> touch ordinals for every free-tail storage.

    Evicting such a storage right after its last touch can never cost a
    remat (no future touch exists), so every static plan applies these
    trims unconditionally — they are the zero-remat evictions the online
    runtime wins on eager-mode traces, and a plan that skipped them
    would be handicapped for no reason.
    """
    out = {}
    for s in view.storages:
        if s.size > 0 and _has_free_tail(s):
            ts = sorted(set(s.uses) | {s.producer})
            out[s.sid] = tuple(ts)
    return out


def extract_chain(log_or_view, max_candidates: int = MAX_CANDIDATES) -> Chain:
    """Chain of checkpoint candidates from a log (or prebuilt ``LogView``).

    Candidates are non-constant storages with at least one far gap
    between touches — dropping one costs a segment replay per gap; a
    finalize-kept storage's last gap ends at the finalize replay.
    Free-tail trims are *not* items: they cost nothing and every plan
    takes them (see ``trim_touches``), so the floor already reflects
    them.  When more than ``max_candidates`` storages qualify, the
    largest by byte size stay chain items and the rest join the floor
    (they are kept by every plan) — the same waist-first truncation a
    cut-enumeration over the liveness profile would make.
    """
    view = log_or_view if isinstance(log_or_view, LogView) \
        else build_view(log_or_view)
    cands: list[tuple[StorageV, list[tuple[int, int]]]] = []
    for s in view.storages:
        if s.constant or s.size <= 0 or s.producer is None:
            continue
        gaps = _far_gaps(s, view.n_ops)
        if gaps:
            cands.append((s, gaps))
    total = len(cands)
    if total > max_candidates:
        cands.sort(key=lambda p: (-p[0].size, p[0].sid))
        cands = cands[:max_candidates]
    cands.sort(key=lambda p: (p[0].producer, p[0].sid))

    # Floor: peak of the liveness profile with candidate intervals
    # removed and free tails trimmed (every plan evicts those for free).
    n = view.n_ops
    delta = [0.0] * (n + 1)
    cand_sids = {s.sid for s, _ in cands}
    for s in view.storages:
        if s.size <= 0 or s.sid in cand_sids:
            continue
        a, b = view.live_interval(s)
        if _has_free_tail(s):
            b = max(_last_touch(s), a)
        delta[a] += s.size
        delta[b + 1] -= s.size
    floor, acc = 0.0, 0.0
    for t in range(n):
        acc += delta[t]
        floor = max(floor, acc)

    # Segment costs: every op since the previous candidate's producer is
    # charged to this candidate (the ops a gap replay re-executes on a
    # chain-shaped trace; an approximation on general DAGs — the evaluator
    # reports the exact numbers for any plan).  A dropped candidate is
    # rebuilt once per far gap under the executor's drop rule, so the
    # model charges the segment once per gap; a free-tail candidate with
    # no gaps is never rebuilt and costs nothing to drop.
    op_cost = [o.cost for o in view.ops]
    prefix = [0.0]
    for c in op_cost:
        prefix.append(prefix[-1] + c)
    items: list[ChainItem] = []
    prev_p = -1
    for s, gaps in cands:
        seg = prefix[s.producer + 1] - prefix[prev_p + 1]
        items.append(ChainItem(
            sid=s.sid, size=float(s.size), cost=seg * len(gaps),
            producer=s.producer,
            evict_positions=tuple(a for a, _ in gaps),
            live=view.live_interval(s)))
        prev_p = s.producer
    final_bytes = float(sum(s.size for s in view.storages
                            if s.size > 0 and (s.constant or s.kept)))
    return Chain(items, floor, base_cost=view.base_cost(), name=view.name,
                 n_ops=n, n_candidates_total=total, final_bytes=final_bytes)
