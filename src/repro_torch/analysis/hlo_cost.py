"""Loop-aware cost analysis over optimized HLO text.

``compiled.cost_analysis()`` counts every computation ONCE — a while loop
body (layer scan, grad-accum loop) with known_trip_count=N is undercounted
N×, which breaks roofline math for scanned layer stacks.  This module parses
the HLO module, builds the call graph (fusion calls, while bodies with
``known_trip_count``, conditionals), and rolls up per-instruction costs with
loop multipliers:

  flops   — dot ops: 2·|result|·|contracted|; elementwise: |result|
            (counted inside fusion computations too);
  bytes   — operand + result bytes of *top-level* instructions only (fusion
            internals don't touch HBM — matches "bytes accessed" semantics);
  collective_bytes — per kind, × loop multiplier.

All numbers are per-device (the HLO module is the per-device SPMD program).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e5m2": 1, "f8e4m3fn": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"\b([a-z]\d*[a-z0-9]*)\[([0-9,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->\s*.*\{\s*$")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*((?:\([^)]*\)|[^\s(])*?)\s*"
    r"([a-z][a-z0-9\-]*)\((.*)$")
_CALLED_RE = re.compile(
    r"(?:calls|to_apply|condition|body|true_computation|false_computation)"
    r"=%?([\w\.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_TRIP_RE = re.compile(r'known_trip_count[^0-9]*"?n"?[^0-9]*(\d+)')
_CDIMS_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_NO_BYTES = {"parameter", "constant", "tuple", "get-tuple-element",
             "bitcast", "while", "conditional", "call", "after-all",
             "partition-id", "replica-id", "iota", "get-dimension-size"}


def _shape_elems_bytes(text: str) -> tuple[int, int]:
    elems = bts = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        elems += n
        bts += n * _DTYPE_BYTES.get(dt, 4)
    return elems, bts


@dataclass
class Instr:
    name: str
    opcode: str
    result_type: str
    rest: str          # everything after the '(' of the operand list
    flops: float = 0.0
    bytes_: int = 0
    called: list = field(default_factory=list)
    trip: int = 1
    coll_bytes: int = 0
    coll_kind: str = ""
    operands: list = field(default_factory=list)


@dataclass
class Computation:
    name: str
    instrs: list = field(default_factory=list)
    is_fusion: bool = False
    defs: dict = field(default_factory=dict)      # instr name -> opcode
    sym: dict = field(default_factory=dict)       # instr name -> result type
    # parameter index -> effective bytes when the parameter is consumed only
    # through a slicing op inside this computation (the scan-over-stacked-
    # params pattern: a [L, ...] operand is read one slice per iteration).
    param_eff: dict = field(default_factory=dict)
    param_full: dict = field(default_factory=dict)


@dataclass
class HloCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)
    transcendentals: float = 0.0

    def as_cost_dict(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals}


def parse_module(text: str) -> tuple[dict[str, Computation], str]:
    comps: dict[str, Computation] = {}
    entry = None
    cur: Computation | None = None
    symbols: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.rstrip()
        h = _COMP_HDR.match(line) if line and not line[0].isspace() else None
        if h:
            cur = Computation(h.group(1))
            cur.is_fusion = "fused_computation" in cur.name
            comps[cur.name] = cur
            if line.startswith("ENTRY"):
                entry = cur.name
            symbols = {}
            continue
        if cur is None:
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, rtype, opcode, rest = m.groups()
        ins = Instr(name, opcode, rtype, rest)
        symbols[name] = rtype
        # called computations
        ins.called = _CALLED_RE.findall(rest)
        br = _BRANCHES_RE.search(rest)
        if br:
            ins.called += [c.strip().lstrip("%") for c in
                           br.group(1).split(",")]
        if opcode == "while":
            t = _TRIP_RE.search(rest)
            ins.trip = int(t.group(1)) if t else 1
        # flops
        relems, rbytes = _shape_elems_bytes(rtype)
        if opcode == "dot":
            cd = _CDIMS_RE.search(rest)
            contracted = 1
            if cd:
                # lhs shape: CPU/GPU HLO inlines operand types in the call
                # ("dot(f32[64,128]{1,0} %a, ...)"), TPU HLO references by
                # name only ("dot(%a, ...)") — try inline first, then the
                # symbol table.
                ops = rest.split(")")[0]
                shapes = _SHAPE_RE.findall(ops)
                if not shapes:
                    first = re.search(r"%?([\w\.\-]+)", ops)
                    lhs_type = symbols.get(first.group(1), "") if first else ""
                    shapes = _SHAPE_RE.findall(lhs_type)
                if shapes:
                    dims = [int(x) for x in shapes[0][1].split(",") if x]
                    for di in cd.group(1).split(","):
                        if di and int(di) < len(dims):
                            contracted *= dims[int(di)]
            ins.flops = 2.0 * relems * contracted
        elif opcode in ("convolution",):
            ins.flops = 2.0 * relems  # underestimate; convs unused here
        elif opcode in ("exponential", "tanh", "logistic", "log", "rsqrt",
                        "sqrt", "power", "sine", "cosine", "erf"):
            ins.flops = relems
        elif opcode in ("add", "multiply", "subtract", "divide", "maximum",
                        "minimum", "select", "compare", "and", "or", "xor",
                        "negate", "abs", "floor", "ceil", "convert",
                        "reduce", "exponential-minus-one"):
            ins.flops = relems
        # bytes: operands + result, top-level ops only (filtered at rollup)
        operand_part = rest.split("), ")[0] if "), " in rest else \
            rest.split(")")[0]
        ins.operands = re.findall(r"%([\w\.\-]+)", operand_part)
        if opcode not in _NO_BYTES:
            if opcode in ("dynamic-slice", "slice", "gather"):
                # traffic = slice read + result write
                ins.bytes_ = 2 * rbytes
            elif opcode in ("dynamic-update-slice", "scatter",
                            "scatter-add"):
                # traffic ~ update read + region write (buffer aliased)
                upd = (symbols.get(ins.operands[1])
                       if len(ins.operands) > 1 else None)
                ub = _shape_elems_bytes(upd)[1] if upd else rbytes
                ins.bytes_ = 2 * ub
            elif opcode == "broadcast":
                ins.bytes_ = rbytes
            else:
                ob = 0
                for nm in ins.operands:
                    t = symbols.get(nm)
                    if t:
                        ob += _shape_elems_bytes(t)[1]
                ins.bytes_ = ob + rbytes
        # collectives
        for kind in _COLLECTIVES:
            if opcode.startswith(kind):
                if opcode.endswith("-done"):
                    break
                _, b = _shape_elems_bytes(rest.split(")")[0])
                if b == 0:
                    b = rbytes
                ins.coll_bytes = b
                ins.coll_kind = kind
                break
        cur.defs[name] = opcode
        cur.sym[name] = rtype
        cur.instrs.append(ins)

    # Effective parameter bytes for fusion computations (slice-only use).
    for comp in comps.values():
        pidx_of = {}
        for ins in comp.instrs:
            if ins.opcode == "parameter":
                m2 = re.match(r"\s*(\d+)", ins.rest)
                if m2:
                    idx = int(m2.group(1))
                    pidx_of[ins.name] = idx
                    comp.param_full[idx] = _shape_elems_bytes(
                        ins.result_type)[1]
        for pname, idx in pidx_of.items():
            consumers = [i for i in comp.instrs if pname in i.operands]
            if len(consumers) == 1 and consumers[0].opcode in (
                    "dynamic-slice", "slice", "gather"):
                comp.param_eff[idx] = _shape_elems_bytes(
                    consumers[0].result_type)[1]
            else:
                comp.param_eff[idx] = comp.param_full.get(idx, 0)
    return comps, entry


def analyze(text: str, flash_tile_threshold: float | None = None
            ) -> HloCost:
    """``flash_tile_threshold``: if set, instructions in loop nests with
    multiplier > threshold count HBM bytes only for dot ops — modelling a
    Pallas flash-attention kernel whose softmax intermediates stay in VMEM
    (the threshold is the layer-scan multiplier; anything hotter is the
    blocked-attention inner loop).  Labeled "analytic" in §Perf."""
    comps, entry = parse_module(text)
    cost = HloCost()
    if entry is None:
        return cost

    def visit(comp_name: str, mult: float, depth: int = 0):
        comp = comps.get(comp_name)
        if comp is None or depth > 50:
            return
        for ins in comp.instrs:
            cost.flops += ins.flops * mult
            if not comp.is_fusion:
                b = ins.bytes_
                if ins.opcode == "fusion" and ins.called:
                    fc = comps.get(ins.called[0])
                    if fc is not None and fc.param_eff:
                        rb = _shape_elems_bytes(ins.result_type)[1]
                        b = rb + sum(
                            fc.param_eff.get(i, 0)
                            for i in range(len(ins.operands)))
                if (flash_tile_threshold is not None
                        and mult > flash_tile_threshold):
                    # Analytic Pallas-kernel HBM model: only tensors that
                    # cross the kernel boundary are charged.  Dots stream
                    # externally-produced operands (q/k/v tiles); results
                    # and in-body intermediates (logits/probs) stay VMEM.
                    if ins.opcode == "dot":
                        b = 0
                        ext = ("parameter", "get-tuple-element",
                               "dynamic-slice", "bitcast", "copy",
                               "transpose", "reshape", "convert")
                        for nm in ins.operands:
                            if comp.defs.get(nm, "parameter") in ext:
                                b += _shape_elems_bytes(
                                    comp.sym.get(nm, ""))[1]
                    elif "dynamic-update-slice" in ins.name:
                        # o-tile write-back: smallest operand approximates
                        # the update slice.
                        obs = [_shape_elems_bytes(comp.sym.get(nm, ""))[1]
                               for nm in ins.operands
                               if comp.sym.get(nm)]
                        b = 2 * min(obs) if obs else 0
                    else:
                        b = 0
                cost.bytes_accessed += b * mult
            if ins.coll_kind:
                cost.collective_bytes += ins.coll_bytes * mult
                cost.coll_by_kind[ins.coll_kind] = (
                    cost.coll_by_kind.get(ins.coll_kind, 0)
                    + ins.coll_bytes * mult)
            if ins.opcode in ("exponential", "tanh", "logistic", "log",
                              "power", "erf"):
                cost.transcendentals += ins.flops * mult
            child_mult = mult * (ins.trip if ins.opcode == "while" else 1)
            for c in ins.called:
                visit(c, child_mult, depth + 1)

    visit(entry, 1.0)
    return cost
