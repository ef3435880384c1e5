"""Deterministic fault injection for the DTR runtime (``repro.faults``).

Production memory systems fail in ways the happy-path simulator never
exercises: transient allocator failures (the device allocator's own
fragmentation, invisible to our byte model), flaky or contended PCIe
links, co-tenants stealing device memory mid-run, and cost models that
misestimate individual operators.  This module injects all four as a
**seeded, replayable schedule** so the runtime's recovery ladder can be
tested differentially:

* every decision is drawn from ``Random(f"{seed}:{kind}:{n}")`` where
  ``n`` is a per-kind event counter — a *pure function of (seed, kind,
  occurrence index)*, independent of query interleaving, so the scan and
  index engines (whose metadata access patterns differ) draw identical
  faults, and two runs of the same schedule are bit-identical;
* fault *sites* are keyed to streams that are themselves bit-exact across
  engines: allocation admissions, channel transfers, operator ids, and
  the executed-op counter — never to heuristic evaluation counts.

Fault classes (all independently rated; see :class:`FaultConfig`):

``alloc``     an allocation attempt that would succeed fails transiently
              (the runtime runs its recovery ladder and retries);
``transfer``  an H2D/D2H channel transfer faults — the engine retries
              with capped exponential backoff, each failed attempt
              occupying the channel for its full duration;
``spike``     a transfer's duration is multiplied (congestion);
``prefetch``  an async prefetch-back is lost — the access falls back to
              a synchronous fetch charged to the stall metric;
``cost``      per-operator lognormal misestimation: the *charged* cost of
              op ``i`` is ``cost_i * exp(noise * g_i)`` while heuristics
              keep scoring the unperturbed estimate (the cost model is
              wrong, the hardware is not);
``budget``    a square-wave co-tenant: for ``budget_duty`` of every
              ``budget_period`` executed ops (after the first period) the
              effective device budget shrinks by ``budget_shrink``.
"""
from __future__ import annotations

from dataclasses import dataclass
from random import Random


@dataclass(frozen=True)
class FaultConfig:
    """Rates and shapes for the fault classes; all default to *off*.

    A config with every class off is ``enabled == False`` and attaching
    it is bit-exact with no schedule at all (the runtime never consults
    a disabled class, so no counters advance).
    """

    seed: int = 0
    #: probability an allocation attempt fails transiently
    alloc_rate: float = 0.0
    #: probability a channel transfer attempt faults (retried with backoff)
    transfer_rate: float = 0.0
    #: probability a transfer's duration is multiplied by ``spike_mult``
    spike_rate: float = 0.0
    spike_mult: float = 8.0
    #: probability an issued prefetch-back is lost (sync-fetch fallback)
    prefetch_rate: float = 0.0
    #: lognormal sigma of per-op charged-cost misestimation
    cost_noise: float = 0.0
    #: budget squeeze: shrink fraction, period (executed ops), duty cycle
    budget_shrink: float = 0.0
    budget_period: int = 0
    budget_duty: float = 0.25
    #: transfer retry shape: failed attempts before the forced success is
    #: capped, and attempt ``k`` waits ``min(backoff_base * 2**k,
    #: backoff_cap)`` clean-durations before retrying.
    max_transfer_retries: int = 4
    backoff_base: float = 0.5
    backoff_cap: float = 8.0

    def __post_init__(self):
        assert 0.0 <= self.alloc_rate <= 1.0
        assert 0.0 <= self.transfer_rate <= 1.0
        assert 0.0 <= self.prefetch_rate <= 1.0
        assert self.max_transfer_retries >= 0
        assert 0.0 <= self.budget_shrink < 1.0

    @property
    def enabled(self) -> bool:
        return (self.alloc_rate > 0 or self.transfer_rate > 0
                or self.spike_rate > 0 or self.prefetch_rate > 0
                or self.cost_noise > 0
                or (self.budget_shrink > 0 and self.budget_period > 0))

    @property
    def squeezes(self) -> bool:
        return self.budget_shrink > 0 and self.budget_period > 0


class FaultSchedule:
    """Stateful per-run instantiation of a :class:`FaultConfig`.

    One schedule belongs to exactly one runtime run (counters are per-run
    state); build a fresh one per ``simulate`` call, exactly like
    ``OffloadEngine`` wraps ``OffloadConfig``.
    """

    def __init__(self, cfg: FaultConfig) -> None:
        assert cfg.enabled, "FaultSchedule requires an enabled FaultConfig"
        self.cfg = cfg
        self._n: dict[str, int] = {}
        self._cost_cache: dict[int, float] = {}
        self._squeeze_seen: set[int] = set()
        #: faults actually fired this run (used to classify a failed run
        #: as "unlucky" rather than "infeasible")
        self.injected = 0

    # -- deterministic draws --------------------------------------------
    def _draw(self, kind: str) -> Random:
        n = self._n.get(kind, 0)
        self._n[kind] = n + 1
        return Random(f"{self.cfg.seed}:{kind}:{n}")

    def counters(self) -> dict[str, int]:
        """Per-kind draw counts (telemetry / determinism assertions)."""
        return dict(self._n)

    # -- allocation ------------------------------------------------------
    def alloc_fault(self) -> bool:
        """One admission attempt: does it fail transiently?"""
        if self.cfg.alloc_rate <= 0:
            return False
        hit = self._draw("alloc").random() < self.cfg.alloc_rate
        if hit:
            self.injected += 1
        return hit

    # -- transfers -------------------------------------------------------
    def transfer_plan(self, channel: str, nbytes: float,
                      clean: float) -> tuple[float, int, float]:
        """Plan one transfer on ``channel`` ("h2d" | "d2h").

        Returns ``(extra, retries, mult)``: ``mult`` is the latency-spike
        duration multiplier (1.0 normally), ``retries`` the number of
        failed attempts before success, and ``extra`` the total extra
        channel occupancy those failures cost — each failed attempt burns
        the full (possibly spiked) duration plus a capped exponential
        backoff wait, exactly like a driver-level retry loop.  ``clean``
        is the fault-free duration of the transfer.
        """
        cfg = self.cfg
        mult = 1.0
        if cfg.spike_rate > 0:
            if self._draw(f"spike:{channel}").random() < cfg.spike_rate:
                mult = cfg.spike_mult
                self.injected += 1
        retries = 0
        extra = 0.0
        if cfg.transfer_rate > 0:
            dur = clean * mult
            while retries < cfg.max_transfer_retries:
                if self._draw(f"xfer:{channel}").random() >= cfg.transfer_rate:
                    break
                backoff = min(cfg.backoff_base * (2.0 ** retries),
                              cfg.backoff_cap)
                extra += dur + backoff * dur
                retries += 1
                self.injected += 1
            # Past the cap the (retries+1)-th attempt is forced to succeed:
            # links recover; the cap bounds the worst case, it does not
            # turn a flaky channel into a dead one.
        return extra, retries, mult

    def prefetch_lost(self) -> bool:
        """Is this issued prefetch-back lost in flight?"""
        if self.cfg.prefetch_rate <= 0:
            return False
        hit = self._draw("prefetch").random() < self.cfg.prefetch_rate
        if hit:
            self.injected += 1
        return hit

    # -- cost-model misestimation ---------------------------------------
    def cost_factor(self, op_id: int) -> float:
        """Charged-cost multiplier for operator ``op_id``.

        Keyed by *operator identity*, not execution count: a misestimated
        op is misestimated consistently, on first execution and on every
        rematerialization — which is what makes heuristic keys (built
        from the unperturbed estimates) genuinely wrong rather than
        merely noisy.
        """
        if self.cfg.cost_noise <= 0:
            return 1.0
        f = self._cost_cache.get(op_id)
        if f is None:
            import math
            g = Random(f"{self.cfg.seed}:cost:{op_id}").gauss(0.0, 1.0)
            f = math.exp(self.cfg.cost_noise * g)
            self._cost_cache[op_id] = f
            # One injection per misestimated operator (not per execution):
            # a run killed under active noise is "unlucky", not infeasible.
            self.injected += 1
        return f

    # -- budget squeeze --------------------------------------------------
    def budget_factor(self, op_index: int) -> float:
        """Effective-budget multiplier at executed-op index ``op_index``.

        A square wave: after a fault-free first period, the leading
        ``budget_duty`` fraction of every period runs at
        ``1 - budget_shrink``.  Pure function of the executed-op counter,
        so both engines squeeze at identical points.
        """
        cfg = self.cfg
        if not cfg.squeezes:
            return 1.0
        if op_index < cfg.budget_period:
            return 1.0
        duty_ops = max(1, int(cfg.budget_period * cfg.budget_duty))
        if (op_index % cfg.budget_period) < duty_ops:
            # One injection per squeeze window (not per query): a run
            # killed inside a squeeze is "unlucky", not infeasible.
            window = op_index // cfg.budget_period
            if window not in self._squeeze_seen:
                self._squeeze_seen.add(window)
                self.injected += 1
            return 1.0 - cfg.budget_shrink
        return 1.0
