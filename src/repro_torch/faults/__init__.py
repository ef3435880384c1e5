"""Fault injection + graceful degradation (``repro.faults``).

Two pieces, composable with every engine configuration:

* :class:`FaultConfig` / :class:`FaultSchedule` — a seeded, fully
  replayable chaos schedule injecting allocation failures, H2D/D2H
  transfer faults and latency spikes, lost prefetches, per-op cost-model
  misestimation, and square-wave budget squeezes (a simulated co-tenant).
  Every draw is a pure function of ``(seed, fault kind, occurrence
  index)``, so the scan and index engines inject identical faults and
  golden differential tests can pin exact victim + recovery sequences.
* :class:`RecoveryConfig` — arms the runtime's degradation ladder
  (prefetch reclaim → pool compaction → forced offload → heuristic
  escalation) and the sliding-window thrash guard that switches
  heuristics mid-run instead of hitting the ``ThrashError`` cliff.

Wire-through: ``simulate(..., faults=FaultConfig(...),
recovery=RecoveryConfig(...))`` and ``run_trace(..., faults=...,
recovery=...)``; attaching faults auto-arms a default ladder.  With no
faults and no recovery attached (the default everywhere) the runtime is
bit-exact with the pre-faults engine.  ``benchmarks/perf_faults.py``
sweeps survival and degraded overhead over the golden corpus and gates
the differential invariants in CI.
"""
from .recovery import RecoveryConfig
from .schedule import FaultConfig, FaultSchedule

__all__ = ["FaultConfig", "FaultSchedule", "RecoveryConfig"]
