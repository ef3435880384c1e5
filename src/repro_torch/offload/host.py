"""Capacity-bounded host memory tier.

A byte counter in the spirit of the device-side counter mode: the host
pool holds offloaded storages' bytes (contents preserved) until they are
fetched back, dropped on death/banish, or the run ends.  Fragmentation is
deliberately not modeled host-side — host allocators are paging-backed,
so contiguity is not the binding constraint it is on device.
"""
from __future__ import annotations


class HostTier:
    """Byte-accounted host pool: sid -> resident byte count."""

    __slots__ = ("capacity", "used", "peak", "_resident")

    def __init__(self, capacity: float) -> None:
        self.capacity = float(capacity)
        self.used = 0.0
        self.peak = 0.0
        self._resident: dict[int, float] = {}

    def __contains__(self, sid: int) -> bool:
        return sid in self._resident

    def __len__(self) -> int:
        return len(self._resident)

    def can_fit(self, nbytes: float) -> bool:
        return self.used + nbytes <= self.capacity

    def put(self, sid: int, nbytes: float) -> None:
        assert sid not in self._resident, f"sid {sid} already host-resident"
        assert self.can_fit(nbytes), "host tier overcommitted"
        self._resident[sid] = float(nbytes)
        self.used += nbytes
        if self.used > self.peak:
            self.peak = self.used

    def take(self, sid: int) -> float:
        """Remove ``sid`` from the tier; returns its byte count."""
        nbytes = self._resident.pop(sid)
        self.used -= nbytes
        return nbytes
