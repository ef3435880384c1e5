"""repro.alloc — simulated device memory pool + contiguity-aware eviction.

Turns the DTR core's fungible byte counter into an address-space-accurate
model: storages occupy contiguous blocks, allocation requires a contiguous
fit, and memory pressure is resolved by evicting a heuristic-cost-minimal
*contiguous window* of storages (Coop) instead of globally-cheapest storages
one at a time.
"""
from .allocator import PoolAllocator
from .pool import Block, FragStats, MemoryPool, PLACEMENTS

__all__ = ["Block", "FragStats", "MemoryPool", "PLACEMENTS", "PoolAllocator"]
