"""Health monitoring for training runs, copied from ``repro.distributed``:
:mod:`.monitor`'s step-time straggler detection, divergence guard, memory
telemetry and timer.

The reference's sharding rules and collectives (``sharding.py``,
``collectives.py``) need a mesh and have no counterpart here yet (ROADMAP
Queue 1 item 11).
"""
from .monitor import (DivergenceGuard, MemoryMonitor, MemorySample,
                      StepStats, StragglerMonitor, Timer)

__all__ = ["DivergenceGuard", "MemoryMonitor", "MemorySample", "StepStats",
           "StragglerMonitor", "Timer"]
