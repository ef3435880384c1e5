"""Parse collective-communication bytes out of optimized HLO text.

``cost_analysis()`` does not report collective traffic, so we sum operand
sizes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute instruction in ``compiled.as_text()`` (per-device program
=> sizes are per-device shard sizes).
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e5m2": 1, "f8e4m3fn": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# dtype[2,3,4]{...} — shape token
_SHAPE_RE = re.compile(r"\b([a-z]\d*[a-z0-9]*)\[([0-9,]*)\]")
# "  %name = <result> opcode(<operands>)"
_INSTR_RE = re.compile(
    r"=\s*(.*?)\s+("
    + "|".join(_COLLECTIVES)
    + r")(?:-(?:start|done))?\s*\((.*?)\)\s*,?",
)


def _shape_bytes(dtype: str, dims: str) -> int:
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            if d:
                n *= int(d)
    return n * b


@dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    count_by_kind: dict[str, int] = field(
        default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "by_kind": {k: int(v) for k, v in self.bytes_by_kind.items()},
            "counts": {k: int(v) for k, v in self.count_by_kind.items()},
        }


def parse_collectives(hlo_text: str) -> CollectiveStats:
    stats = CollectiveStats()
    seen_done: set[str] = set()
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if m is None:
            continue
        kind = m.group(2)
        # async pairs: count -start, skip -done (same transfer).
        if f"{kind}-done" in line:
            continue
        operands = m.group(3)
        b = sum(_shape_bytes(d, s) for d, s in _SHAPE_RE.findall(operands))
        if b == 0:
            # Operands referenced by name only (e.g. "%param.3") — fall back
            # to the result shape(s) on the lhs.
            b = sum(_shape_bytes(d, s)
                    for d, s in _SHAPE_RE.findall(m.group(1)))
        stats.bytes_by_kind[kind] += b
        stats.count_by_kind[kind] += 1
    return stats


def collective_bytes(hlo_text: str) -> int:
    return parse_collectives(hlo_text).total_bytes


def xla_cost_dict(cost_analysis) -> dict:
    """Normalize ``compiled.cost_analysis()`` across jax versions.

    Older jax returns ``[dict]`` (one entry per program), newer returns the
    dict directly; either may be None for backends without an implementation.
    """
    if cost_analysis is None:
        return {}
    if isinstance(cost_analysis, dict):
        return cost_analysis
    if isinstance(cost_analysis, (list, tuple)):
        return dict(cost_analysis[0]) if cost_analysis else {}
    return dict(cost_analysis)
