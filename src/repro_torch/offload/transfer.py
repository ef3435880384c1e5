"""Transfer-cost model for the host offload tier.

Costs are expressed in the runtime's simulated-clock units (the same unit
operator costs use), so offload decisions compare recompute cost against
transfer cost directly.  A transfer of ``n`` bytes on a channel with
bandwidth ``B`` (bytes per cost unit) and fixed latency ``L`` takes
``L + n / B`` units, and channels serialize: a transfer issued while the
channel is busy starts when the previous one completes (simulated-clock
contention).  H2D (fetch / prefetch-back) and D2H (offload copy-out) are
independent channels, as on real accelerators.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OffloadConfig:
    """Knobs for the host tier; ``host_budget`` in bytes, rates in bytes
    per simulated cost unit.  ``host_budget == 0`` disables the tier
    entirely (the runtime is constructed without an engine, so behaviour
    is bit-exact with pre-offload engines).

    ``policy``:
      * ``"hybrid"``  — two-choice eviction: per victim, offload iff the
        round-trip transfer cost per byte undercuts the heuristic's
        recompute cost per byte (and the host has room), else evict.
      * ``"offload"`` — always offload when the host has room (evict only
        when it is full); victims are ranked by transfer cost alone.
    """

    host_budget: float = 0.0
    h2d_bandwidth: float = 1.0
    d2h_bandwidth: float = 1.0
    latency: float = 0.0
    policy: str = "hybrid"            # 'hybrid' | 'offload'
    prefetch: bool = True
    #: issue a prefetch once the predicted reuse is within this multiple of
    #: the transfer duration (2.0 = start when the copy could just finish
    #: twice over — slack for predictor error).
    prefetch_lead: float = 2.0

    def __post_init__(self):
        assert self.policy in ("hybrid", "offload"), self.policy
        assert self.h2d_bandwidth > 0 and self.d2h_bandwidth > 0

    @property
    def enabled(self) -> bool:
        return self.host_budget > 0


class Channel:
    """One direction of the PCIe-like link; serializes its transfers."""

    __slots__ = ("bandwidth", "latency", "busy_until", "transfers", "bytes")

    def __init__(self, bandwidth: float, latency: float) -> None:
        self.bandwidth = float(bandwidth)
        self.latency = float(latency)
        self.busy_until = 0.0
        self.transfers = 0
        self.bytes = 0.0

    def duration(self, nbytes: float) -> float:
        return self.latency + nbytes / self.bandwidth

    def transfer(self, now: float, nbytes: float, extra: float = 0.0,
                 mult: float = 1.0) -> float:
        """Schedule ``nbytes`` at simulated time ``now``; returns the
        completion time (>= now + duration when the channel is busy).

        ``mult`` scales the duration (an injected latency spike) and
        ``extra`` adds flat channel occupancy (failed attempts + backoff
        waits of an injected-fault retry loop, ``repro.faults``); the
        defaults make the fault-free path bit-exact with the two-argument
        form."""
        start = now if now > self.busy_until else self.busy_until
        done = start + self.duration(nbytes) * mult + extra
        self.busy_until = done
        self.transfers += 1
        self.bytes += nbytes
        return done


class TransferModel:
    """H2D + D2H channel pair built from an :class:`OffloadConfig`."""

    def __init__(self, cfg: OffloadConfig) -> None:
        self.cfg = cfg
        self.h2d = Channel(cfg.h2d_bandwidth, cfg.latency)
        self.d2h = Channel(cfg.d2h_bandwidth, cfg.latency)

    def roundtrip(self, nbytes: float) -> float:
        """Static D2H + H2D cost estimate for ``nbytes`` — the transfer
        side of the two-choice comparison.  Deliberately contention-free:
        the estimate must be a pure function of size so index keys built
        on it stay valid between discrete events."""
        return (2.0 * self.cfg.latency
                + nbytes / self.cfg.d2h_bandwidth
                + nbytes / self.cfg.h2d_bandwidth)
