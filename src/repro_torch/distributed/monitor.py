"""Straggler / health monitoring for long-running multi-pod jobs.

No real cluster exists in this container, so this is the framework layer a
deployment would wire to its scheduler: per-step wall-time EWMA + outlier
detection, NaN/divergence guards, and an action hook (log, checkpoint-and-
exclude, abort).  launch/train.py drives it every step; tests exercise the
detection logic directly.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StepStats:
    step: int
    seconds: float
    loss: float
    grad_norm: float
    flagged: bool = False
    reason: str = ""


@dataclass
class StragglerMonitor:
    """EWMA-based step-time outlier detection.

    A step slower than ``threshold``× the EWMA is flagged (straggling host /
    preemption precursor / input stall).  ``patience`` consecutive flags fire
    ``on_straggler`` (deployments: exclude pod, re-shard, checkpoint)."""
    alpha: float = 0.1
    threshold: float = 2.0
    patience: int = 3
    on_straggler: Optional[Callable[[StepStats], None]] = None
    _ewma: float = field(default=0.0, init=False)
    _consecutive: int = field(default=0, init=False)
    history: list[StepStats] = field(default_factory=list, init=False)

    def record(self, step: int, seconds: float, loss: float = 0.0,
               grad_norm: float = 0.0) -> StepStats:
        st = StepStats(step, seconds, loss, grad_norm)
        if self._ewma == 0.0:
            self._ewma = seconds
        elif seconds > self.threshold * self._ewma:
            st.flagged = True
            st.reason = (f"step {seconds:.3f}s > {self.threshold}x "
                         f"ewma {self._ewma:.3f}s")
            self._consecutive += 1
            if self._consecutive >= self.patience and self.on_straggler:
                self.on_straggler(st)
                self._consecutive = 0
        else:
            self._consecutive = 0
        # Only fold non-outliers into the EWMA (robust baseline).
        if not st.flagged:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * seconds
        self.history.append(st)
        return st

    @property
    def ewma(self) -> float:
        return self._ewma


@dataclass
class DivergenceGuard:
    """NaN/inf and loss-spike detection with skip/restore policy.

    ``check`` returns the action for this step: "ok", "skip" (drop the
    update), or "restore" (roll back to the last checkpoint) after
    ``max_skips`` consecutive bad steps."""
    spike_factor: float = 10.0
    max_skips: int = 3
    _ewma_loss: float = field(default=0.0, init=False)
    _skips: int = field(default=0, init=False)

    def check(self, loss: float, grad_norm: float) -> str:
        bad = (math.isnan(loss) or math.isinf(loss)
               or math.isnan(grad_norm) or math.isinf(grad_norm))
        if not bad and self._ewma_loss > 0:
            bad = loss > self.spike_factor * self._ewma_loss
        if bad:
            self._skips += 1
            return "restore" if self._skips > self.max_skips else "skip"
        self._skips = 0
        self._ewma_loss = (0.9 * self._ewma_loss + 0.1 * loss
                           if self._ewma_loss else loss)
        return "ok"


@dataclass
class MemorySample:
    step: int
    peak_bytes: float
    used_bytes: float = 0.0
    largest_free: float = 0.0
    frag_ratio: float = 0.0
    failed_fits: int = 0
    evict_windows: int = 0
    has_frag: bool = False          # frag fields valid (allocator telemetry)


@dataclass
class MemoryMonitor:
    """Memory telemetry for launch-time dashboards.

    Tracks peak bytes per step and, when a fragmentation-aware allocator is
    active (``repro.alloc``), the pool's health: largest free block (the
    number that actually bounds the next allocation, not free bytes),
    external-fragmentation ratio, failed contiguous fits, and window
    evictions.  ``frag`` accepts a ``repro.alloc.FragStats`` or any object
    with those attributes; dashboards alert on ``largest_free`` collapsing
    while free bytes look healthy — the failure mode byte counters miss."""
    history: list[MemorySample] = field(default_factory=list)
    peak_bytes: float = field(default=0.0, init=False)

    def record(self, step: int, peak_bytes: float,
               frag=None) -> MemorySample:
        sample = MemorySample(step=step, peak_bytes=peak_bytes)
        if frag is not None:
            sample.has_frag = True
            sample.used_bytes = getattr(frag, "used", 0.0)
            sample.largest_free = getattr(frag, "largest_free", 0.0)
            sample.frag_ratio = getattr(frag, "frag_ratio", 0.0)
            sample.failed_fits = getattr(frag, "failed_fits", 0)
            sample.evict_windows = getattr(frag, "evict_windows", 0)
        self.peak_bytes = max(self.peak_bytes, peak_bytes)
        self.history.append(sample)
        return sample

    def summary(self) -> dict:
        """Aggregate for dashboards: peak bytes + worst fragmentation seen.

        Fragmentation fields aggregate only over samples that carried
        allocator telemetry — a telemetry-less run (CPU backend) must not
        read as largest-free-block collapse.  None when never recorded."""
        frag = [s for s in self.history if s.has_frag]
        last = frag[-1] if frag else None
        return {
            "peak_bytes": self.peak_bytes,
            "min_largest_free": (min(s.largest_free for s in frag)
                                 if frag else None),
            "max_frag_ratio": (max(s.frag_ratio for s in frag)
                               if frag else None),
            "failed_fits": last.failed_fits if last else 0,
            "evict_windows": last.evict_windows if last else 0,
        }


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
