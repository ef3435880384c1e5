"""Runtime shadow sanitizer: cross-check every DTR state transition.

Enabled with ``DTRRuntime(..., sanitize=True)`` (or ``simulate(...,
sanitize=True)`` / ``run_trace(..., sanitize=True)``).  The sanitizer is
a pure *observer*: it never writes a storage attribute, never calls the
counting ``CostUnionFind.find`` (a raw parent walk keeps ``accesses``
and therefore ``meta_accesses`` bit-exact), and never touches eviction-
index state — a sanitized run produces byte-identical results to an
unsanitized one or the sanitizer itself is buggy (tested in
``tests/test_check.py``).

Two layers:

* **transition hooks** (O(1), always on): legality of each evict /
  offload / fetch / banish / death / compaction event *before* the
  runtime mutates state — never-evict-pinned/locked/constant, no double
  free, offload state-machine legality (offload only from resident
  non-offloaded, fetch only of an offloaded record the host tier holds),
  host-capacity overcommit, compaction must conserve free bytes;
* **full-state audits** (O(storages), every ``every``-th op and always
  at ``finalize``): per-storage flag consistency, view/storage refcount
  agreement, evictable-set parity with the ``EvictIndex``, byte
  conservation ``device + host(+ in-flight prefetch) == accounted``, and
  union-find root-sum consistency against the ground-truth grouping of
  joined members.

Violations raise :class:`SanitizerViolation` carrying a structured
``.code`` and a ``.state`` dump of the relevant slice of runtime state.
"""
from __future__ import annotations

from typing import Optional

_ABS_TOL = 1e-6


class SanitizerViolation(RuntimeError):
    """An invariant the shadow model tracks was broken.

    ``code`` is a stable machine-readable identifier (e.g.
    ``"evict-pinned"``, ``"byte-conservation"``); ``state`` is a dict
    snapshot of the violating slice of runtime state.
    """

    def __init__(self, code: str, message: str, state: dict) -> None:
        lines = "\n".join(f"    {k} = {v!r}" for k, v in state.items())
        super().__init__(f"[{code}] {message}\n  state:\n{lines}")
        self.code = code
        self.state = state


def _storage_state(s) -> dict:
    return {
        "sid": s.sid, "size": s.size, "resident": s.resident,
        "pinned": s.pinned, "banished": s.banished, "constant": s.constant,
        "offloaded": s.offloaded, "dead": s.dead, "locks": s.locks,
        "refs": s.refs, "local_cost": s.local_cost,
    }


def _raw_root(uf, x: int) -> int:
    """Non-mutating, non-counting parent walk (bit-exactness: the real
    ``find`` path-halves and increments ``accesses``, which feeds the
    ``meta_accesses`` telemetry the benchmarks pin)."""
    p = uf._parent
    while p[x] != x:
        x = p[x]
    return x


class ShadowSanitizer:
    """Observer attached to one :class:`~repro.core.runtime.DTRRuntime`.

    ``every`` sets the full-audit cadence in operators (1 = audit after
    every op; larger values keep the O(storages) sweep off the hot path
    for long traces — transition hooks stay on regardless, and
    ``finalize`` always triggers a final audit).
    """

    def __init__(self, rt, every: int = 1) -> None:
        self.rt = rt
        self.every = max(1, int(every))
        self.audits = 0
        self.checks = 0
        self._ops_seen = 0

    # ------------------------------------------------------------------
    # Transition hooks (O(1), invoked by the runtime *before* mutation)
    # ------------------------------------------------------------------
    def _fail(self, code: str, message: str, state: dict) -> None:
        rt = self.rt
        state = dict(state)
        state.setdefault("clock", rt.clock)
        state.setdefault("ops_executed", rt.ops_executed)
        state.setdefault("memory", rt.memory)
        raise SanitizerViolation(code, message, state)

    def pre_evict(self, s) -> None:
        self.checks += 1
        st = _storage_state(s)
        if s.banished:
            self._fail("evict-banished",
                       f"evicting banished storage {s.sid}", st)
        if not s.resident:
            self._fail("evict-nonresident",
                       f"evicting non-resident storage {s.sid} "
                       f"(double free)", st)
        if s.constant:
            self._fail("evict-constant",
                       f"evicting constant storage {s.sid}", st)
        if s.pinned:
            self._fail("evict-pinned",
                       f"evicting pinned storage {s.sid}", st)
        if s.locks > 0:
            self._fail("evict-locked",
                       f"evicting storage {s.sid} with {s.locks} "
                       f"live lock(s)", st)

    def pre_offload(self, s) -> None:
        self.checks += 1
        st = _storage_state(s)
        eng = self.rt.offload
        if eng is None:
            self._fail("offload-no-engine",
                       f"offloading storage {s.sid} without an engine", st)
        if s.offloaded or (eng is not None and eng.holds(s.sid)):
            self._fail("offload-already",
                       f"offloading storage {s.sid} which is already "
                       f"host-resident", st)
        if s.size <= 0:
            self._fail("offload-empty",
                       f"offloading zero-byte storage {s.sid}", st)
        # Same legality preconditions as eviction (the victim paths share
        # the evictable() gate).
        if s.banished:
            self._fail("evict-banished",
                       f"offloading banished storage {s.sid}", st)
        if not s.resident:
            self._fail("evict-nonresident",
                       f"offloading non-resident storage {s.sid}", st)
        if s.constant:
            self._fail("evict-constant",
                       f"offloading constant storage {s.sid}", st)
        if s.pinned:
            self._fail("evict-pinned",
                       f"offloading pinned storage {s.sid}", st)
        if s.locks > 0:
            self._fail("evict-locked",
                       f"offloading storage {s.sid} with {s.locks} "
                       f"live lock(s)", st)
        if eng is not None and eng.host.used + s.size > eng.host.capacity:
            st["host_used"] = eng.host.used
            st["host_capacity"] = eng.host.capacity
            self._fail("offload-overcommit",
                       f"offloading {s.size}B would overcommit the host "
                       f"tier", st)

    def pre_fetch(self, s) -> None:
        self.checks += 1
        st = _storage_state(s)
        eng = self.rt.offload
        if not s.offloaded:
            self._fail("fetch-not-offloaded",
                       f"fetching storage {s.sid} which is not "
                       f"offloaded", st)
        if eng is None or not eng.holds(s.sid):
            self._fail("fetch-no-record",
                       f"fetching storage {s.sid} with no host-tier "
                       f"record", st)
        if s.resident:
            self._fail("fetch-resident",
                       f"fetching storage {s.sid} which is already "
                       f"device-resident", st)
        if s.banished:
            self._fail("fetch-banished",
                       f"fetching banished storage {s.sid}", st)
        if s.dead:
            self._fail("fetch-dead",
                       f"fetching dead storage {s.sid}", st)

    def pre_banish(self, s) -> None:
        self.checks += 1
        st = _storage_state(s)
        if s.banished:
            self._fail("banish-double",
                       f"banishing already-banished storage {s.sid}", st)
        if s.refs > 0:
            self._fail("banish-live",
                       f"banishing storage {s.sid} with {s.refs} live "
                       f"external reference(s)", st)

    def pre_kill(self, s) -> None:
        self.checks += 1
        st = _storage_state(s)
        if s.dead:
            self._fail("kill-double",
                       f"killing already-dead storage {s.sid}", st)
        if s.refs > 0:
            self._fail("kill-live",
                       f"killing storage {s.sid} with {s.refs} live "
                       f"external reference(s)", st)
        storages = self.rt.storages
        for csid in s.children:
            c = storages[csid]
            if not c.dead and not c.banished:
                st["child"] = _storage_state(c)
                self._fail("kill-live-child",
                           f"killing storage {s.sid} whose child {csid} "
                           f"is neither dead nor banished", st)

    def note_compaction(self, before, after) -> None:
        """Compaction relocates blocks; it must conserve free bytes and
        never shrink the largest free span (that is its whole point)."""
        self.checks += 1
        st = {"before": before.as_dict(), "after": after.as_dict()}
        if abs(after.free - before.free) > _ABS_TOL:
            self._fail("compaction-leak",
                       f"pool compaction changed free bytes "
                       f"{before.free} -> {after.free}", st)
        if after.largest_free + _ABS_TOL < before.largest_free:
            self._fail("compaction-fragmented",
                       f"pool compaction shrank the largest free span "
                       f"{before.largest_free} -> {after.largest_free}", st)

    # ------------------------------------------------------------------
    # Full-state audit (O(storages))
    # ------------------------------------------------------------------
    def on_op(self) -> None:
        self._ops_seen += 1
        if self._ops_seen % self.every == 0:
            self.audit()

    def audit(self) -> None:
        rt = self.rt
        self.audits += 1
        storages = rt.storages
        # -- per-storage flag consistency (sid order => deterministic
        #    first failure, which the mutation tests key on) -------------
        for sid in sorted(storages):
            s = storages[sid]
            st = _storage_state(s)
            if s.resident and s.offloaded:
                self._fail("resident-and-offloaded",
                           f"storage {sid} is both device- and "
                           f"host-resident", st)
            if s.banished and s.resident:
                self._fail("banished-resident",
                           f"banished storage {sid} still resident", st)
            if s.banished and s.offloaded:
                self._fail("banished-resident",
                           f"banished storage {sid} still holds a host "
                           f"copy", st)
            if s.constant and not s.resident and not s.banished:
                self._fail("constant-evicted",
                           f"constant storage {sid} was evicted", st)
            if s.locks < 0:
                self._fail("negative-locks",
                           f"storage {sid} has negative lock count", st)
            if s.dead and s.refs > 0:
                self._fail("dead-live",
                           f"dead storage {sid} has {s.refs} live "
                           f"reference(s)", st)
            if s.dead:
                for csid in s.children:
                    c = storages[csid]
                    if not c.dead and not c.banished:
                        st["child"] = _storage_state(c)
                        self._fail("dead-live-child",
                                   f"dead storage {sid} has live child "
                                   f"{csid}", st)
        # -- view/storage agreement --------------------------------------
        vrefs: dict[int, int] = {sid: 0 for sid in storages}
        for t in rt.tensors.values():
            if t.sid not in storages:
                self._fail("view-orphan",
                           f"tensor {t.tid} points at unknown storage "
                           f"{t.sid}", {"tid": t.tid, "sid": t.sid})
            vrefs[t.sid] += max(t.refs, 0)
            s = storages[t.sid]
            if t.defined and not s.resident:
                self._fail("defined-nonresident",
                           f"tensor {t.tid} is defined but its storage "
                           f"{t.sid} is not resident",
                           {"tid": t.tid, **_storage_state(s)})
        for sid in sorted(storages):
            s = storages[sid]
            if s.refs != vrefs[sid]:
                self._fail("refs-desync",
                           f"storage {sid} caches refs={s.refs} but its "
                           f"views sum to {vrefs[sid]}",
                           {**_storage_state(s), "view_sum": vrefs[sid]})
        # -- evictable-set parity with the EvictIndex --------------------
        if rt.index is not None:
            expect = {sid for sid, s in storages.items()
                      if s.evictable() and s.size > 0}
            got = rt.index.members
            if got != expect:
                self._fail("index-desync",
                           f"EvictIndex membership diverged from the "
                           f"evictable set",
                           {"missing": sorted(expect - got),
                            "extra": sorted(got - expect)})
        # -- byte conservation -------------------------------------------
        dev = sum(s.size for s in storages.values() if s.resident)
        inflight = 0.0
        if rt.offload is not None:
            inflight = sum(rec.nbytes
                           for rec in rt.offload._recs.values()
                           if rec.ready_at is not None)
        accounted = dev + inflight
        if abs(rt.memory - accounted) > _ABS_TOL:
            self._fail("byte-conservation",
                       f"device counter {rt.memory} != resident bytes "
                       f"{dev} + in-flight prefetch {inflight}",
                       {"memory": rt.memory, "resident": dev,
                        "inflight": inflight})
        if rt.peak_memory + _ABS_TOL < rt.memory:
            self._fail("peak-below-memory",
                       f"peak_memory {rt.peak_memory} below current "
                       f"memory {rt.memory}",
                       {"peak": rt.peak_memory, "memory": rt.memory})
        # -- pool-allocator residency parity -------------------------------
        alloc = rt.allocator
        if alloc is not None and alloc.pool is not None:
            pool = alloc.pool
            expect = {sid for sid, s in storages.items()
                      if s.resident and s.size > 0}
            if rt.offload is not None:
                # In-flight prefetches hold a device reservation (a pool
                # block) before the storage flips resident.
                expect |= {sid for sid, rec in rt.offload._recs.items()
                           if rec.ready_at is not None
                           and storages[sid].size > 0}
            got = pool.resident_sids()
            if got != expect:
                self._fail("pool-desync",
                           f"pool block ownership diverged from resident "
                           f"storages",
                           {"missing": sorted(expect - got),
                            "extra": sorted(got - expect)})
            placed = sum(storages[sid].size for sid in got)
            if abs(pool.used - placed) > _ABS_TOL:
                self._fail("pool-bytes",
                           f"pool used={pool.used} but placed storages "
                           f"sum to {placed}",
                           {"used": pool.used, "expected": placed})
        # -- host-tier parity ----------------------------------------------
        if rt.offload is not None:
            eng = rt.offload
            flagged = {sid for sid, s in storages.items() if s.offloaded}
            recs = set(eng._recs)
            hostset = set(eng.host._resident)
            if not (flagged == recs == hostset):
                self._fail("host-desync",
                           f"offloaded flags / engine records / host "
                           f"residency disagree",
                           {"flagged": sorted(flagged),
                            "engine": sorted(recs),
                            "host": sorted(hostset)})
            hbytes = sum(storages[sid].size for sid in flagged)
            if abs(eng.host.used - hbytes) > _ABS_TOL:
                self._fail("host-bytes",
                           f"host tier used={eng.host.used} but offloaded "
                           f"storages sum to {hbytes}",
                           {"used": eng.host.used, "expected": hbytes})
            if eng.host.used > eng.host.capacity + _ABS_TOL:
                self._fail("host-overcommit",
                           f"host tier used={eng.host.used} exceeds "
                           f"capacity={eng.host.capacity}",
                           {"used": eng.host.used,
                            "capacity": eng.host.capacity})
        # -- union-find root-sum consistency -------------------------------
        if rt.uf is not None:
            uf = rt.uf
            expect_sums: dict[int, float] = {}
            for s in storages.values():
                if s.uf_joined and s.uf >= 0:
                    r = _raw_root(uf, s.uf)
                    expect_sums[r] = expect_sums.get(r, 0.0) + s.local_cost
            for r, want in sorted(expect_sums.items()):
                got = uf._cost[r]
                tol = _ABS_TOL + 1e-9 * abs(want)
                if abs(got - want) > tol:
                    self._fail("uf-root-sum",
                               f"union-find root {r} caches cost {got} "
                               f"but joined members sum to {want}",
                               {"root": r, "cached": got, "expected": want,
                                "members": sorted(
                                    s.sid for s in storages.values()
                                    if s.uf_joined and s.uf >= 0
                                    and _raw_root(uf, s.uf) == r)})


def attach(rt, sanitize) -> Optional[ShadowSanitizer]:
    """Resolve the ``sanitize`` runtime argument into a sanitizer.

    ``False``/``None``/``0`` => no sanitizer; ``True`` => audit every op;
    an int N > 0 => audit every N ops (transition hooks always on)."""
    if not sanitize:
        return None
    every = 1 if sanitize is True else int(sanitize)
    return ShadowSanitizer(rt, every=every)
