"""The counterparts of ``repro.distributed``: :mod:`.monitor` (copied:
step-time straggler detection, divergence guard, memory telemetry,
timer), :mod:`.sharding` (the logical-axis rules on DTensor) and
:mod:`.collectives` (the int8 gradient all-reduce); and
:mod:`.kernel_sharding`, the kernels' ops' DTensor strategies and FLOP
formulas for the dry run.
"""
from .monitor import (DivergenceGuard, MemoryMonitor, MemorySample,
                      StepStats, StragglerMonitor, Timer)

__all__ = ["DivergenceGuard", "MemoryMonitor", "MemorySample", "StepStats",
           "StragglerMonitor", "Timer"]
