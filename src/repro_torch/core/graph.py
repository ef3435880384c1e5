"""Operator-DAG / event-log representation (Appendix C.6 of the DTR paper).

A *log* is a sequence of abstract instructions mirroring what the paper's
instrumented PyTorch emits:

  CONSTANT(t)                      — t is a pinned constant (followed by MEMORY)
  MEMORY(t, size)                  — size of t's storage (0 if alias)
  ALIAS(t_o, t_i)                  — t_o views t_i's storage (t_i None => owns)
  CALL(inputs, outputs, cost, op)  — pure operator call
  MUTATE(inputs, mutated, cost, op)— in-place op (rewritten copy-on-write)
  COPY(t_o, t_i)                   — new Python ref to same view
  COPYFROM(t_o, t_i)               — x = y over existing tensors
  RELEASE(t)                       — external refcount decrement

Logs can be built programmatically (``LogBuilder``), synthesized from model
shapes (``graphs.py``), extracted from jaxprs (``planner.py``), captured from
real serve/train workloads (``repro.trace``), or serialized to/from JSON
lines.  ``replay`` drives a DTR runtime from a log.

Serialization is versioned: ``dumps`` emits a ``LogHeader`` line carrying the
schema version, the log name, and log-level metadata (capture source, model
config, slot width, ...); ``loads`` accepts headerless version-1 streams for
backward compatibility.  Every instruction optionally carries ``meta`` — a
tuple of ``(key, value)`` pairs (hashable, JSON-round-trippable) used by the
trace subsystem to tag per-request/slot/phase boundaries in captured serving
traces.  Metadata never influences replay decisions.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence

SCHEMA_VERSION = 2

MetaT = tuple  # tuple[(str, str | int | float), ...]


def as_meta(m) -> MetaT:
    """Normalize a dict/iterable of pairs into the canonical meta tuple."""
    if not m:
        return ()
    items = m.items() if isinstance(m, dict) else m
    return tuple((str(k), v) for k, v in items)


# ---------------------------------------------------------------------------
# Instructions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Constant:
    t: str
    meta: MetaT = ()


@dataclass(frozen=True)
class Memory:
    t: str
    size: int
    meta: MetaT = ()


@dataclass(frozen=True)
class Alias:
    t_out: str
    t_in: str | None  # None => t_out's parent op created its storage
    meta: MetaT = ()


@dataclass(frozen=True)
class Call:
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    cost: float
    op: str
    meta: MetaT = ()


@dataclass(frozen=True)
class Mutate:
    inputs: tuple[str, ...]
    mutated: tuple[str, ...]  # subset of inputs
    cost: float
    op: str
    meta: MetaT = ()


@dataclass(frozen=True)
class Copy:
    t_out: str
    t_in: str
    meta: MetaT = ()


@dataclass(frozen=True)
class CopyFrom:
    t_out: str
    t_in: str
    meta: MetaT = ()


@dataclass(frozen=True)
class Release:
    t: str
    meta: MetaT = ()


Instr = Constant | Memory | Alias | Call | Mutate | Copy | CopyFrom | Release


# ---------------------------------------------------------------------------
# Log container + builder
# ---------------------------------------------------------------------------

@dataclass
class Log:
    instrs: list[Instr] = field(default_factory=list)
    name: str = "log"
    version: int = SCHEMA_VERSION
    meta: dict = field(default_factory=dict)   # log-level capture metadata

    def __iter__(self):
        return iter(self.instrs)

    def __len__(self) -> int:
        return len(self.instrs)

    # -- serialization ------------------------------------------------------
    def dumps(self) -> str:
        header = {"kind": "LogHeader", "version": SCHEMA_VERSION,
                  "name": self.name}
        if self.meta:
            header["meta"] = self.meta
        out = [json.dumps(header, allow_nan=False)]
        for ins in self.instrs:
            d = {"kind": type(ins).__name__}
            for k in ins.__dataclass_fields__:
                v = getattr(ins, k)
                if k == "meta":
                    if v:
                        d[k] = [list(p) for p in v]
                    continue
                d[k] = v
            out.append(json.dumps(d, allow_nan=False))
        return "\n".join(out)

    @staticmethod
    def loads(text: str, name: str | None = None) -> "Log":
        kinds = {c.__name__: c for c in
                 (Constant, Memory, Alias, Call, Mutate, Copy, CopyFrom,
                  Release)}
        instrs: list[Instr] = []
        version = 1
        log_name = name
        log_meta: dict = {}
        for lineno, line in enumerate(text.splitlines(), start=1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"malformed log line {lineno}: {e}") from e
            if not isinstance(d, dict) or "kind" not in d:
                raise ValueError(
                    f"malformed log line {lineno}: not an instruction object")
            kind = d.pop("kind")
            if kind == "LogHeader":
                version = int(d.get("version", 1))
                if version > SCHEMA_VERSION:
                    raise ValueError(
                        f"log schema version {version} is newer than "
                        f"supported ({SCHEMA_VERSION})")
                if log_name is None and "name" in d:
                    log_name = d["name"]
                log_meta = d.get("meta", {}) or {}
                continue
            cls = kinds.get(kind)
            if cls is None:
                raise ValueError(
                    f"malformed log line {lineno}: unknown instruction "
                    f"kind {kind!r}")
            for k in ("inputs", "outputs", "mutated"):
                if k in d:
                    d[k] = tuple(d[k])
            if "meta" in d:
                d["meta"] = as_meta(d["meta"])
            try:
                instrs.append(cls(**d))
            except TypeError as e:
                raise ValueError(
                    f"malformed log line {lineno}: bad fields for "
                    f"{kind}: {e}") from e
        return Log(instrs, name=log_name or "log", version=version,
                   meta=log_meta)

    # -- analysis helpers ---------------------------------------------------
    def baseline_cost(self) -> float:
        """Total op cost with unlimited memory (no rematerialization)."""
        return sum(i.cost for i in self.instrs if isinstance(i, (Call, Mutate)))

    def op_count(self) -> int:
        return sum(1 for i in self.instrs if isinstance(i, (Call, Mutate)))

    def pinned_bytes(self) -> int:
        """Total bytes of CONSTANT storages — the unevictable floor.

        Constant storages are pinned, so even a RELEASE never frees them
        under the ``ignore``/``eager`` policies — once created they occupy
        memory to the end of the run (``banish`` can free them; activation-
        mode budgets are an approximation there).  Serving sweeps express
        budgets as ``pinned + fraction * (peak - pinned)`` to scan the
        meaningful (activation/KV) range.
        """
        total = 0
        for a, b in zip(self.instrs, self.instrs[1:]):
            if isinstance(a, Constant) and isinstance(b, Memory):
                total += b.size
        return total


class LogBuilder:
    """Convenience builder that tracks tensor names and emits releases.

    ``call`` emits CALL + MEMORY/ALIAS per output. ``auto_release`` computes
    last-use positions over the whole program and appends RELEASE right after
    the final consuming instruction — modelling framework refcounting (the
    liveness information DTR receives online, Appendix A.2).
    """

    def __init__(self, name: str = "log") -> None:
        self.log = Log(name=name)
        self._fresh = 0

    def fresh(self, prefix: str = "t") -> str:
        self._fresh += 1
        return f"{prefix}{self._fresh}"

    def constant(self, size: int, name: str | None = None,
                 meta=None) -> str:
        t = name or self.fresh("const")
        self.log.instrs.append(Constant(t, meta=as_meta(meta)))
        self.log.instrs.append(Memory(t, int(size)))
        return t

    def call(
        self,
        inputs: Sequence[str],
        out_sizes: Sequence[int],
        cost: float,
        op: str,
        aliases: Sequence[str | None] | None = None,
        out_names: Sequence[str] | None = None,
        meta=None,
    ) -> list[str]:
        outs = list(out_names) if out_names else [self.fresh() for _ in out_sizes]
        self.log.instrs.append(Call(tuple(inputs), tuple(outs), float(cost),
                                    op, meta=as_meta(meta)))
        aliases = aliases or [None] * len(outs)
        for t, size, al in zip(outs, out_sizes, aliases):
            self.log.instrs.append(Memory(t, 0 if al is not None else int(size)))
            self.log.instrs.append(Alias(t, al))
        return outs

    def mutate(self, inputs: Sequence[str], mutated: Sequence[str],
               cost: float, op: str, meta=None) -> None:
        self.log.instrs.append(
            Mutate(tuple(inputs), tuple(mutated), float(cost), op,
                   meta=as_meta(meta)))

    def release(self, t: str, meta=None) -> None:
        self.log.instrs.append(Release(t, meta=as_meta(meta)))

    def auto_release(self, keep: Iterable[str] = ()) -> Log:
        """Append RELEASE after last use for every tensor not in ``keep``.

        Constants are also released (banishing policies may free them).
        Tensors in ``keep`` stay externally referenced => the runtime's output
        condition will pin them at the end (gradients / loss, Appendix C.6).
        """
        keep = set(keep)
        last_use: dict[str, int] = {}
        for idx, ins in enumerate(self.log.instrs):
            if isinstance(ins, Call):
                # A Call is followed by 2*len(outputs) metadata instructions;
                # releases must land after that block.
                end = idx + 2 * len(ins.outputs)
                for t in ins.inputs:
                    last_use[t] = end
                for t in ins.outputs:
                    last_use.setdefault(t, end)
            elif isinstance(ins, Mutate):
                for t in ins.inputs:
                    last_use[t] = idx
                for t in ins.mutated:
                    last_use.setdefault(t, idx)
            elif isinstance(ins, Constant):
                last_use.setdefault(ins.t, idx + 1)  # after its MEMORY
        # Insert releases in reverse order so indices stay valid.
        inserts: list[tuple[int, Release]] = [
            (idx, Release(t)) for t, idx in last_use.items() if t not in keep
        ]
        inserts.sort(key=lambda p: p[0], reverse=True)
        for idx, rel in inserts:
            self.log.instrs.insert(idx + 1, rel)
        return self.log


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

def parse_call_block(instrs: Sequence[Instr], i: int):
    """Parse the (MEMORY, ALIAS) metadata block following a CALL at ``i``.

    Returns ``(sizes, alias_names, j)`` where ``sizes[k]`` / ``alias_names[k]``
    describe output ``k`` (``alias_names[k] is None`` for an owning output)
    and ``j`` is the index of the first instruction after the block.  Shared
    by ``replay`` and the static-planner trace analysis (``repro.static``),
    so the two consumers cannot drift on the block layout.
    """
    ins = instrs[i]
    assert isinstance(ins, Call)
    sizes: list[int] = []
    alias_names: list[str | None] = []
    j = i + 1
    for t in ins.outputs:
        mem = instrs[j]
        ali = instrs[j + 1]
        assert isinstance(mem, Memory) and mem.t == t
        assert isinstance(ali, Alias) and ali.t_out == t
        sizes.append(mem.size)
        alias_names.append(ali.t_in)
        j += 2
    return sizes, alias_names, j


def replay(log: Log, rt) -> dict[str, int]:
    """Drive runtime ``rt`` (core.runtime.DTRRuntime) from a log.

    Returns the final mapping from log tensor names to runtime tensor ids.
    Implements the paper's mutation rewrite (copy-on-write), COPY/COPYFROM
    refcount semantics, and the output condition (all still-referenced tensors
    are materialized and locked at the end).
    """
    env: dict[str, int] = {}
    pending_mem: dict[str, tuple] = {}

    i = 0
    instrs = log.instrs
    n = len(instrs)
    while i < n:
        ins = instrs[i]
        if isinstance(ins, Constant):
            # MEMORY follows.
            mem = instrs[i + 1]
            assert isinstance(mem, Memory) and mem.t == ins.t
            env[ins.t] = rt.constant(mem.size, name=ins.t)
            i += 2
            continue
        if isinstance(ins, Call):
            # Followed by len(outputs) (MEMORY, ALIAS) pairs.
            sizes, alias_names, j = parse_call_block(instrs, i)
            aliases = [env[a] if a is not None else None for a in alias_names]
            tids = rt.call(ins.op, ins.cost, [env[x] for x in ins.inputs],
                           sizes, aliases=aliases,
                           out_names=list(ins.outputs))
            for t, tid in zip(ins.outputs, tids):
                env[t] = tid
            i = j
            continue
        if isinstance(ins, Mutate):
            # Copy-on-write rewrite: pure op from inputs -> fresh versions of
            # the mutated tensors; remap names (Appendix C.6).
            out_sizes = [rt.size_of(env[t]) for t in ins.mutated]
            tids = rt.call(ins.op + "_mut", ins.cost,
                           [env[x] for x in ins.inputs],
                           out_sizes, aliases=[None] * len(ins.mutated),
                           out_names=[t + "'" for t in ins.mutated])
            for t, tid in zip(ins.mutated, tids):
                rt.release(env[t])
                env[t] = tid
            i += 1
            continue
        if isinstance(ins, Copy):
            env[ins.t_out] = env[ins.t_in]
            rt.addref(env[ins.t_in])
            i += 1
            continue
        if isinstance(ins, CopyFrom):
            rt.release(env[ins.t_out])
            rt.addref(env[ins.t_in])
            env[ins.t_out] = env[ins.t_in]
            i += 1
            continue
        if isinstance(ins, Release):
            rt.release(env[ins.t])
            i += 1
            continue
        if isinstance(ins, (Memory, Alias)):  # stray (already consumed)
            i += 1
            continue
        raise TypeError(f"unknown instruction {ins}")

    # Output condition: everything still externally referenced must be
    # resident at the end (gradients, loss, prediction).
    rt.finalize()
    return env
