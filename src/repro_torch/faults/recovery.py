"""Recovery-ladder configuration for graceful degradation under pressure.

The DTR runtime's failure modes are cliffs: a failed allocation raises
``OOMError`` and a remat livelock runs straight into the ``ThrashError``
compute limit.  With a :class:`RecoveryConfig` attached the runtime
instead escalates through a ladder of increasingly drastic — but always
deterministic — degradations before giving up:

1. **prefetch reclaim** (always on, pre-existing): cancel in-flight
   prefetch-back reservations holding speculative device bytes;
2. **pool compaction**: in contiguous-pool mode, slide resident blocks
   down to coalesce free space (a moving allocator's defrag pass) — this
   can rescue window-OOMs where free bytes exist but no contiguous span;
3. **forced offload**: bypass the two-choice ``wants_offload`` key and
   move the cheapest-to-transfer evictable storage to the host tier
   regardless of its recompute price, freeing device blocks without
   losing contents;
4. **heuristic escalation**: switch the eviction heuristic mid-run to
   the next entry of ``escalation_chain`` and retry (also the thrash
   guard's lever — see below).

Every rung taken is recorded as a structured degradation event in
``DTRRuntime.events`` (and surfaced in ``RunResult``), so sweeps can
distinguish a clean run from a degraded-but-surviving one.

The **thrash guard** watches a sliding window of executed ops: when less
than ``1/thrash_ratio`` of a window's charged compute was first-execution
progress (the signature of a remat livelock), it escalates the heuristic
instead of letting the run slam into the ``ThrashError`` cliff.

None of this fires on a runtime constructed without a config (the
default), so fault-free replays stay bit-exact with the pre-ladder
engine.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RecoveryConfig:
    """Which rungs of the ladder are armed, and the thrash-guard shape."""

    compaction: bool = True
    forced_offload: bool = True
    escalation: bool = True
    #: heuristics tried, in order, by ladder rung 4 and the thrash guard.
    #: Entries equal to the current heuristic (or, under the hybrid
    #: offload policy, entries that are not cost-aware) are skipped.
    escalation_chain: tuple[str, ...] = ("h_dtr_local", "h_lru", "h_size")
    #: on an injected allocation fault, evict down to ``alloc_headroom *
    #: need`` extra free bytes before retrying (how real caching
    #: allocators respond to a failed cudaMalloc: free more than asked).
    alloc_headroom: float = 1.0
    thrash_guard: bool = True
    #: sliding-window length, in executed ops
    thrash_window_ops: int = 256
    #: trip when window charged compute exceeds ``thrash_ratio`` x the
    #: window's first-execution (forward-progress) compute
    thrash_ratio: float = 20.0
