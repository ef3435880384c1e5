"""Reuse-distance prediction for prefetch-back scheduling.

``ReusePredictor`` keeps an exponentially-weighted moving average of each
storage's inter-access gap in simulated time — a stack-distance-style
estimate built from the access stream the runtime already produces (every
operator execution touches its input storages).  The predicted next use of
an offloaded storage is ``last_access + ewma_gap``; the prefetch pump
issues the H2D copy-back once that lands within the transfer lead time.

``reuse_oracle`` computes the *exact* forward reuse gaps from a captured
trace (`repro.trace` logs record the full operator stream, so replay makes
the future knowable) — the validation reference for the predictor: on
periodic access patterns the EWMA converges to the oracle gap exactly,
and on captured traces every prediction must fall inside the oracle's
observed [min, max] gap for that storage.
"""
from __future__ import annotations


class ReusePredictor:
    """EWMA of per-storage access intervals over the simulated clock."""

    __slots__ = ("alpha", "_last", "_gap")

    def __init__(self, alpha: float = 0.5) -> None:
        self.alpha = float(alpha)
        self._last: dict[int, float] = {}   # sid -> last access time
        self._gap: dict[int, float] = {}    # sid -> EWMA inter-access gap

    def observe(self, sid: int, now: float) -> None:
        prev = self._last.get(sid)
        self._last[sid] = now
        if prev is None or now <= prev:
            # First sighting, or a same-instant re-touch (several inputs of
            # one op can share a storage): no gap information.
            return
        gap = now - prev
        old = self._gap.get(sid)
        self._gap[sid] = gap if old is None else (
            old + self.alpha * (gap - old))

    def predict_next(self, sid: int, now: float):
        """Predicted next-access time, or None without gap history.

        An overdue prediction (already in the past) clamps to ``now`` —
        the access is imminent as far as the predictor knows."""
        gap = self._gap.get(sid)
        if gap is None:
            return None
        t = self._last.get(sid, now) + gap
        return t if t > now else now


def trace_access_stream(log):
    """(op_index, storage) access events of a trace, in execution order.

    Storages are identified by their root tensor name (aliases collapse
    onto the storage they view).  An op "accesses" the storages of its
    input tensors — the same stream the runtime's staleness updates see.
    """
    from ..core.graph import Alias, Call, Constant, Mutate
    root: dict[str, str] = {}
    events: list[tuple[int, str]] = []
    opi = 0
    for ins in log.instrs:
        if isinstance(ins, Constant):
            root[ins.t] = ins.t
        elif isinstance(ins, Alias):
            root[ins.t_out] = (root.get(ins.t_in, ins.t_in)
                               if ins.t_in is not None else ins.t_out)
        elif isinstance(ins, Call):
            for u in ins.inputs:
                events.append((opi, root.get(u, u)))
            opi += 1
        elif isinstance(ins, Mutate):
            for u in ins.inputs:
                events.append((opi, root.get(u, u)))
            for t in ins.mutated:
                root[t] = t     # copy-on-write: fresh storage, same name
            opi += 1
    return events


def reuse_oracle(log):
    """Exact per-storage reuse gaps (in op-index distance) from a trace.

    Returns ``{storage: [gap, ...]}`` — successive differences of the op
    indices at which each storage is used as an input.  This is the
    ground truth the EWMA predictor approximates; see
    ``tests/test_offload.py`` for the validation harness.
    """
    last: dict[str, int] = {}
    gaps: dict[str, list[int]] = {}
    for opi, key in trace_access_stream(log):
        prev = last.get(key)
        if prev is not None and opi > prev:
            gaps.setdefault(key, []).append(opi - prev)
        last[key] = opi
    return gaps
