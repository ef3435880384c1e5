"""Offload engine: the mechanism behind rematerialize-or-offload eviction.

The engine owns the host tier, the transfer channels, the reuse predictor,
and the per-storage offload records.  The runtime drives it:

  * ``wants_offload``  — the two-choice policy decision at victim time;
  * ``on_offload``     — bookkeeping when a victim's bytes move to host
    (D2H scheduled on the simulated clock, device block already freed);
  * ``begin_fetch`` / ``finish_fetch`` — synchronous fetch-back on access
    (the miss path), stalling the clock until the H2D copy lands;
  * ``pump``           — after each operator, issue prefetch-backs for
    offloaded storages whose predicted reuse is imminent, reserving device
    space without evicting (free-space-only, so prefetch can never cause
    an eviction cascade);
  * ``cancel_one_prefetch`` — under allocation pressure, reclaim an
    in-flight reservation before declaring OOM.

Heuristic composition lives here too: ``wrap_heuristic`` lifts a base
(cost-aware) heuristic into the two-choice ``HybridHeuristic`` whose
score is ``min(recompute score, transfer score)``, or replaces it with
the pure ``TransferHeuristic`` for the offload-only policy.  Both keep
the separable key()/staleness contract, so victim selection stays on the
sublinear eviction index and bit-exact against the linear scan.
"""
from __future__ import annotations

from ..core.heuristics import Heuristic
from .host import HostTier
from .predictor import ReusePredictor
from .transfer import OffloadConfig, TransferModel


class _OffRec:
    """Per-offloaded-storage state while its bytes live on host."""

    __slots__ = ("nbytes", "d2h_done", "defined_tids", "ready_at")

    def __init__(self, nbytes: float, d2h_done: float,
                 defined_tids: tuple[int, ...]) -> None:
        self.nbytes = nbytes
        self.d2h_done = d2h_done          # host copy complete at this time
        self.defined_tids = defined_tids  # views defined at offload time
        self.ready_at = None              # prefetch arrival; None = idle


class OffloadEngine:
    """Host tier + transfer channels + prefetcher, attached to one runtime."""

    def __init__(self, cfg: OffloadConfig) -> None:
        assert cfg.enabled, "OffloadEngine requires host_budget > 0"
        self.cfg = cfg
        self.host = HostTier(cfg.host_budget)
        self.model = TransferModel(cfg)
        self.predictor = ReusePredictor()
        self._recs: dict[int, _OffRec] = {}
        self._base: Heuristic | None = None   # set by wrap_heuristic

    # -- scoring ---------------------------------------------------------
    def roundtrip_cost(self, nbytes: float) -> float:
        return self.model.roundtrip(nbytes)

    def transfer_key(self, s) -> float:
        """Round-trip transfer cost per byte — the offload key family.

        Constant per storage (sizes are immutable), so offload keys never
        go stale: the eviction index computes each once at membership."""
        return self.roundtrip_cost(s.size) / s.size

    # -- two-choice policy ----------------------------------------------
    def wants_offload(self, rt, s) -> bool:
        """Two-choice decision; also the *simultaneous exhaustion* rule.

        A full host tier (``can_fit`` False) deterministically demotes
        every would-be offload to a plain eviction — so device pressure
        with both tiers exhausted falls back to pure DTR and, only when
        no evictable storage remains anywhere, a controlled ``OOMError``.
        There is no evict-from-host path: host contents are dropped only
        on death/banish, never to admit another offload.
        """
        if s.size <= 0 or not self.host.can_fit(s.size):
            return False
        if self.cfg.policy == "offload":
            return True
        # Hybrid: offload iff transfer cost per byte undercuts the base
        # heuristic's recompute cost per byte.  Both sides share the
        # staleness denominator, so comparing keys equals comparing
        # scores — the decision is staleness-free and identical for the
        # scan and index engines (cached e*/ẽ* values are shared).
        return self.transfer_key(s) < self._base.key(rt, s)

    # -- fault injection (repro.faults) ----------------------------------
    def _faulted(self, rt, channel: str, ch, nbytes: float):
        """Plan one possibly-faulted transfer: (extra, mult) for the
        channel, with injected retries/spikes recorded as runtime events.
        Fault-free (no schedule attached) this is exactly (0.0, 1.0)."""
        faults = getattr(rt, "faults", None)
        if faults is None:
            return 0.0, 1.0
        extra, retries, mult = faults.transfer_plan(
            channel, nbytes, ch.duration(nbytes))
        if mult != 1.0:
            rt._event("transfer_spike", channel=channel, mult=mult)
        if retries:
            rt._degrade("transfer_retry", channel=channel,
                        retries=retries, extra=extra)
        return extra, mult

    # -- offload ---------------------------------------------------------
    def on_offload(self, rt, s, defined_tids: tuple[int, ...]) -> None:
        extra, mult = self._faulted(rt, "d2h", self.model.d2h, s.size)
        done = self.model.d2h.transfer(rt.clock, s.size, extra, mult)
        self.host.put(s.sid, s.size)
        self._recs[s.sid] = _OffRec(s.size, done, defined_tids)

    def holds(self, sid: int) -> bool:
        return sid in self._recs

    # -- fetch (sync miss path) ------------------------------------------
    def begin_fetch(self, rt, s) -> float:
        """Schedule the synchronous H2D copy-back; returns the stall.

        Injected channel faults retry with capped exponential backoff
        inside the transfer itself (the whole loop is one synchronous
        wait), so every failed attempt lands on the stall metric."""
        rec = self._recs[s.sid]
        start = rt.clock if rt.clock > rec.d2h_done else rec.d2h_done
        extra, mult = self._faulted(rt, "h2d", self.model.h2d, rec.nbytes)
        done = self.model.h2d.transfer(start, rec.nbytes, extra, mult)
        return done - rt.clock

    def finish_fetch(self, rt, s) -> tuple[int, ...]:
        """Host copy consumed: free host bytes, return the saved views."""
        rec = self._recs.pop(s.sid)
        self.host.take(s.sid)
        return rec.defined_tids

    # -- prefetch ---------------------------------------------------------
    def note_access(self, sid: int, now: float) -> None:
        self.predictor.observe(sid, now)

    def pump(self, rt) -> None:
        """Issue prefetch-backs for offloaded storages predicted to be
        reused within the transfer lead time.  Deterministic: offloaded
        sids are visited in sorted order, and reservations use free space
        only (a full device never triggers evictions from here)."""
        if not self.cfg.prefetch or not self._recs:
            return
        now = rt.clock
        lead = self.cfg.prefetch_lead
        for sid in sorted(self._recs):
            rec = self._recs[sid]
            if rec.ready_at is not None:
                continue
            s = rt.storages[sid]
            if s.dead or s.banished:
                continue
            nxt = self.predictor.predict_next(sid, now)
            if nxt is None:
                continue
            if nxt - now > lead * self.model.h2d.duration(rec.nbytes):
                continue
            faults = getattr(rt, "faults", None)
            if faults is not None and faults.prefetch_lost():
                # The prefetch is lost in flight: never issued, no device
                # reservation, no channel time.  The eventual access takes
                # the synchronous-fetch miss path, charged to the stall
                # metric — the prefetch-failure fallback.
                rt._event("prefetch_lost", sid=sid)
                continue
            if not self._reserve(rt, s):
                continue
            start = now if now > rec.d2h_done else rec.d2h_done
            extra, mult = self._faulted(rt, "h2d", self.model.h2d,
                                        rec.nbytes)
            rec.ready_at = self.model.h2d.transfer(start, rec.nbytes,
                                                   extra, mult)
            rt.prefetch_issued += 1

    def _reserve(self, rt, s) -> bool:
        """Claim device space for a prefetch without evicting."""
        alloc = rt.allocator
        if alloc is not None and alloc.contiguous:
            if not alloc.pool.alloc(s.sid, s.size):
                return False
        else:
            if rt.memory + s.size > rt.effective_budget():
                return False
            if alloc is not None:
                alloc.place(s)
        rt.memory += s.size
        if rt.memory > rt.peak_memory:
            rt.peak_memory = rt.memory
        return True

    def in_flight(self, sid: int) -> bool:
        rec = self._recs.get(sid)
        return rec is not None and rec.ready_at is not None

    def cancel_one_prefetch(self, rt) -> bool:
        """Reclaim one prefetch reservation under allocation pressure.

        The channel time already spent stays spent (wasted bus time, as
        on hardware); the storage reverts to plain offloaded state."""
        for sid in sorted(self._recs):
            rec = self._recs[sid]
            if rec.ready_at is None:
                continue
            rec.ready_at = None
            rt.memory -= rec.nbytes
            if rt.allocator is not None:
                rt.allocator.free(rt.storages[sid])
            rt.prefetch_cancelled += 1
            return True
        return False

    # -- drop (death / banish) -------------------------------------------
    def drop(self, rt, s) -> None:
        """Discard the host copy of ``s`` (died or banished)."""
        rec = self._recs.pop(s.sid)
        self.host.take(s.sid)
        if rec.ready_at is not None:
            # An in-flight prefetch dies with it: release the reservation.
            rt.memory -= rec.nbytes
            if rt.allocator is not None:
                rt.allocator.free(s)
            rt.prefetch_cancelled += 1
        # Plain write on purpose: "offloaded" is not in StorageRec._WATCHED
        # (offload membership moves with "resident", which the runtime
        # flips around every transfer), so this never pings the index —
        # but going through __setattr__ keeps that true by construction if
        # the watched set ever grows.  The drop callers (_kill /
        # _try_banish) mark the sid dirty themselves where needed.
        s.offloaded = False


# ---------------------------------------------------------------------------
# Heuristic composition
# ---------------------------------------------------------------------------

class HybridHeuristic(Heuristic):
    """Two-choice score: ``min(base recompute score, transfer score)``.

    Both sides divide by the same staleness, so the min is equivalent to
    taking the min of the per-byte *keys* — which is exactly the decision
    ``wants_offload`` makes.  The wrapper stays separable: the base key
    changes on the base heuristic's discrete events, and the offload key
    is constant per storage, so the eviction index keeps both as
    side-by-side key families (``hybrid = True`` flips that machinery on)
    and verifies candidates with this score — bit-exact with the scan.
    """

    hybrid = True
    separable = True

    def __init__(self, base: Heuristic, engine: OffloadEngine) -> None:
        if not getattr(base, "cost_aware", False):
            raise ValueError(
                f"hybrid policy needs a cost-aware base heuristic to price "
                f"recomputation; {base.name} is not (use policy='offload')")
        self.base = base
        self.engine = engine
        self.name = f"hybrid:{base.name}"
        self.needs_uf = base.needs_uf
        self.uses_staleness = base.uses_staleness

    def bind(self, rt) -> None:
        if hasattr(self.base, "bind"):
            self.base.bind(rt)

    def offload_key(self, s) -> float:
        return self.engine.transfer_key(s)

    def base_key(self, rt, s) -> float:
        return self.base.key(rt, s)

    def score(self, rt, s) -> float:
        b = self.base.score(rt, s)
        o = self.engine.transfer_key(s)
        if self.uses_staleness:
            o = o / rt.staleness(s)
        return b if b <= o else o

    def key(self, rt, s) -> float:
        b = self.base.key(rt, s)
        o = self.engine.transfer_key(s)
        return b if b <= o else o


class TransferHeuristic(Heuristic):
    """Offload-only policy: rank victims by transfer cost alone.

    ``score = roundtrip(size)/size / staleness`` — evict-to-host the
    stalest, cheapest-to-move bytes.  Keys are constant per storage, so
    the standard staleness-aware band machinery applies unchanged.
    """

    separable = True
    uses_staleness = True

    def __init__(self, engine: OffloadEngine) -> None:
        self.engine = engine
        self.name = "transfer"

    def score(self, rt, s) -> float:
        return self.engine.transfer_key(s) / rt.staleness(s)

    def key(self, rt, s) -> float:
        return self.engine.transfer_key(s)


def wrap_heuristic(base: Heuristic, engine: OffloadEngine) -> Heuristic:
    """Compose ``base`` with the engine per the configured policy."""
    if engine.cfg.policy == "offload":
        h = TransferHeuristic(engine)
        engine._base = base
        return h
    h = HybridHeuristic(base, engine)
    engine._base = base
    return h
