"""Simulated device memory pool: an address space partitioned into blocks.

The DTR core models memory as a fungible byte counter, but a real accelerator
allocator must return a *contiguous* block, so total-free-bytes is an
optimistic bound (Coop, "Memory is not a Commodity").  ``MemoryPool`` keeps the
whole address space as a doubly-linked, address-ordered list of blocks — each
either free or owned by exactly one storage — with first-class splitting,
coalescing, and fragmentation telemetry:

  * ``alloc(sid, size)`` carves a block under a placement policy
    (``best_fit`` | ``first_fit`` | ``stream``, the latter a bump-pointer
    search from the last placement, echoing stream-ordered pool allocators);
  * ``free(sid)`` returns the block and merges it with free neighbors, so the
    invariant *no two adjacent free blocks* always holds;
  * stats report largest free block, external-fragmentation ratio
    (1 - largest_free/free), and the failed-fit count — the quantities a
    contiguity-aware eviction policy needs.

``capacity`` may be ``float('inf')`` (unconstrained runs): the tail free block
is infinite and every fit succeeds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

PLACEMENTS = ("best_fit", "first_fit", "stream")


class Block:
    """One address range ``[offset, offset+size)``; free iff ``sid is None``."""

    __slots__ = ("offset", "size", "sid", "prev", "next")

    def __init__(self, offset: float, size: float,
                 sid: Optional[int] = None) -> None:
        self.offset = offset
        self.size = size
        self.sid = sid
        self.prev: Optional[Block] = None
        self.next: Optional[Block] = None

    @property
    def free(self) -> bool:
        return self.sid is None

    @property
    def end(self) -> float:
        return self.offset + self.size

    def __repr__(self) -> str:
        who = "free" if self.free else f"sid={self.sid}"
        return f"<Block [{self.offset}, {self.end}) {who}>"


@dataclass
class FragStats:
    """Fragmentation telemetry snapshot (also surfaced by launch monitoring)."""
    capacity: float = 0.0
    used: float = 0.0
    free: float = 0.0
    largest_free: float = 0.0
    frag_ratio: float = 0.0       # 1 - largest_free/free (0 when unfragmented)
    n_blocks: int = 0
    n_free_blocks: int = 0
    failed_fits: int = 0          # allocs that needed eviction to place
    evict_windows: int = 0        # contiguous-window evictions performed
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "capacity": self.capacity, "used": self.used, "free": self.free,
            "largest_free": self.largest_free, "frag_ratio": self.frag_ratio,
            "n_blocks": self.n_blocks, "n_free_blocks": self.n_free_blocks,
            "failed_fits": self.failed_fits,
            "evict_windows": self.evict_windows,
        }


class MemoryPool:
    """Address-ordered free-list allocator over a fixed-capacity region."""

    def __init__(self, capacity: float, placement: str = "best_fit") -> None:
        assert placement in PLACEMENTS, placement
        # capacity <= 0 (degenerate budget probes) => empty address space:
        # every fit fails, which surfaces as a clean OOM upstream.
        self.capacity = max(capacity, 0.0)
        self.placement = placement
        self._head: Optional[Block] = (
            Block(0, self.capacity) if self.capacity > 0 else None)
        self._by_sid: dict[int, Block] = {}
        self.used: float = 0.0
        self.failed_fits = 0
        self.alloc_calls = 0
        self._cursor: float = 0.0   # stream placement resumes here

    # ------------------------------------------------------------------
    # Core operations
    # ------------------------------------------------------------------
    def blocks(self) -> Iterator[Block]:
        b = self._head
        while b is not None:
            yield b
            b = b.next

    def alloc(self, sid: int, size: float) -> bool:
        """Place ``sid`` into a free block; False when no contiguous fit."""
        assert sid not in self._by_sid, f"sid {sid} already resident"
        if size <= 0:
            return True
        self.alloc_calls += 1
        blk = self._find_fit(size)
        if blk is None:
            self.failed_fits += 1
            return False
        self._place(blk, sid, size)
        return True

    def resident_sids(self) -> set[int]:
        """Sids currently owning a block (zero-sized storages never place).

        Public so observers (``repro.check.sanitizer``) can audit
        pool-vs-runtime residency parity without reaching into the
        free-list internals."""
        return set(self._by_sid)

    def free(self, sid: int) -> None:
        """Release ``sid``'s block and coalesce with free neighbors."""
        blk = self._by_sid.pop(sid, None)
        if blk is None:
            return              # zero-sized storage: nothing was placed
        self.used -= blk.size
        blk.sid = None
        # Merge with a free successor, then a free predecessor.
        nxt = blk.next
        if nxt is not None and nxt.free:
            blk.size += nxt.size
            self._unlink(nxt)
        prv = blk.prev
        if prv is not None and prv.free:
            prv.size += blk.size
            self._unlink(blk)

    def block_of(self, sid: int) -> Optional[Block]:
        return self._by_sid.get(sid)

    def compact(self) -> None:
        """Slide used blocks to the bottom of the address space (defrag).

        Models a moving/compacting allocator; used by the fragmentation-free
        compatibility mode so byte-counter semantics stay exact while block
        telemetry remains live.
        """
        sids = [(b.sid, b.size) for b in self.blocks() if not b.free]
        self._head = Block(0, self.capacity) if self.capacity > 0 else None
        self._by_sid.clear()
        self.used = 0.0
        for sid, size in sids:
            ok = self.alloc(sid, size)      # first free block == lowest addr
            assert ok, "compaction cannot fail"
            self.alloc_calls -= 1           # bookkeeping op, not a request
        self._cursor = 0.0

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------
    def free_bytes(self) -> float:
        return self.capacity - self.used

    def largest_free_block(self) -> float:
        return max((b.size for b in self.blocks() if b.free), default=0.0)

    def n_free_blocks(self) -> int:
        return sum(1 for b in self.blocks() if b.free)

    def external_frag(self) -> float:
        free = self.free_bytes()
        if free <= 0 or free == float("inf"):
            return 0.0
        return 1.0 - self.largest_free_block() / free

    def stats(self) -> FragStats:
        free = self.free_bytes()
        return FragStats(
            capacity=self.capacity, used=self.used, free=free,
            largest_free=self.largest_free_block(),
            frag_ratio=self.external_frag(),
            n_blocks=sum(1 for _ in self.blocks()),
            n_free_blocks=self.n_free_blocks(),
            failed_fits=self.failed_fits)

    # ------------------------------------------------------------------
    # Invariant checking (tests)
    # ------------------------------------------------------------------
    def check(self) -> None:
        offset = 0.0
        used = 0.0
        prev: Optional[Block] = None
        seen: set[int] = set()
        for b in self.blocks():
            assert b.offset == offset, (b, offset)
            assert b.size > 0, b
            assert b.prev is prev
            if prev is not None:
                assert prev.next is b
                assert not (prev.free and b.free), "adjacent free blocks"
            if not b.free:
                used += b.size
                assert b.sid not in seen
                seen.add(b.sid)
                assert self._by_sid.get(b.sid) is b
            offset = b.end
            prev = b
        assert offset == self.capacity, (offset, self.capacity)
        assert seen == set(self._by_sid)
        assert used == self.used, (used, self.used)

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _find_fit(self, size: float) -> Optional[Block]:
        if self.placement == "best_fit":
            best = None
            for b in self.blocks():
                if b.free and b.size >= size:
                    if best is None or b.size < best.size:
                        best = b
            return best
        if self.placement == "first_fit":
            for b in self.blocks():
                if b.free and b.size >= size:
                    return b
            return None
        # stream: first fit at/after the cursor, wrapping once.
        wrapped = None
        for b in self.blocks():
            if not (b.free and b.size >= size):
                continue
            if b.end > self._cursor:
                return b
            if wrapped is None:
                wrapped = b
        return wrapped

    def _place(self, blk: Block, sid: int, size: float) -> None:
        assert blk.free and blk.size >= size
        if blk.size > size:
            rest = Block(blk.offset + size, blk.size - size)
            self._link_after(blk, rest)
            blk.size = size
        blk.sid = sid
        self._by_sid[sid] = blk
        self.used += size
        self._cursor = blk.end

    def _link_after(self, blk: Block, new: Block) -> None:
        new.prev = blk
        new.next = blk.next
        if blk.next is not None:
            blk.next.prev = new
        blk.next = new

    def _unlink(self, blk: Block) -> None:
        if blk.prev is not None:
            blk.prev.next = blk.next
        else:
            self._head = blk.next
        if blk.next is not None:
            blk.next.prev = blk.prev
