"""Serve-side admission control and preemption-with-requeue.

The continuous-batching loop in ``launch.serve`` historically had no
failure handling: a request whose KV cache could not fit simply could not
exist — slot width was the only limit, and memory pressure was someone
else's problem.  This module gives the loop the same graceful-degradation
contract the DTR runtime got in ``repro.faults``:

  * **Admission control** — each request is priced at its *projected* KV
    footprint (``(prompt + gen) tokens x per-token KV bytes``, what a paged
    allocator would have to guarantee to finish the request without a
    mid-decode OOM).  A request is admitted only when the projected bytes
    of all active slots plus its own fit the KV budget.

  * **Preemption** — when an eligible request does not fit, the controller
    preempts the *cheapest-to-rematerialize* active slots: victims are
    ranked by replayed-compute-per-freed-KV-byte (``tokens_done /
    projected_bytes``), the same key family the runtime's eviction index
    orders storages by (replay cost per byte); at slot counts the scan is
    exact and O(slots).  A preempted request loses its progress — exactly
    a DTR eviction of its KV chunks — and is requeued.

  * **Bounded retries + backoff** — each requeue costs a retry and delays
    the request's next eligibility by ``backoff_steps * 2**(retries-1)``
    decode steps (capped).  Requests out of retries are never chosen as
    victims; a request whose projected bytes exceed the whole budget is
    rejected up front.  Because every preemption consumes a retry, total
    preemptions are bounded by ``max_retries x requests`` — no livelock.

  * **Chaos coupling** — an optional ``repro.faults.FaultSchedule`` drives
    mid-run budget squeezes (a co-tenant stealing device memory): the
    effective budget follows the schedule's square wave, and ``enforce``
    preempts already-running slots to get back under it.

Every decision lands in ``events`` (same structured shape as
``DTRRuntime.events``), and ``counters()`` reports the per-request
completed / requeued / rejected accounting the serve driver prints.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: Admission decisions.
ADMIT, WAIT, REJECT = "admit", "wait", "reject"


@dataclass
class Ticket:
    """Admission-facing view of one request (the prompt stays with the
    serve loop; the controller only prices and schedules)."""

    rid: int
    prompt_len: int
    gen: int
    retries: int = 0
    eligible_step: int = 0

    @property
    def tokens(self) -> int:
        return self.prompt_len + self.gen


class AdmissionController:
    """KV-budget admission + cheapest-first preemption for the serve loop.

    ``kv_budget`` and ``per_token_bytes`` are in the same (byte) units;
    ``faults`` is an optional ``repro.faults.FaultSchedule`` whose budget
    squeeze (if configured) modulates the effective budget by decode step.
    """

    def __init__(self, kv_budget: float, per_token_bytes: float, *,
                 max_retries: int = 3, backoff_steps: int = 8,
                 backoff_cap: int = 256, faults=None) -> None:
        if kv_budget <= 0 or per_token_bytes <= 0:
            raise ValueError("kv_budget and per_token_bytes must be > 0")
        self.kv_budget = float(kv_budget)
        self.per_token_bytes = float(per_token_bytes)
        self.max_retries = int(max_retries)
        self.backoff_steps = int(backoff_steps)
        self.backoff_cap = int(backoff_cap)
        self.faults = faults
        self._factor = 1.0
        self.admitted = 0
        self.completed = 0
        self.requeued = 0
        self.rejected = 0
        self.preemptions = 0
        self.events: list[dict] = []

    # -- pricing ---------------------------------------------------------
    def projected_bytes(self, t: Ticket) -> float:
        return t.tokens * self.per_token_bytes

    def remat_key(self, t: Ticket, tokens_done: int) -> float:
        """Replay cost per freed KV byte — lower is cheaper to preempt."""
        return tokens_done / max(self.projected_bytes(t), 1e-12)

    def effective_budget(self, step: int) -> float:
        """KV budget at ``step``, after any injected squeeze."""
        if self.faults is not None and self.faults.cfg.squeezes:
            f = self.faults.budget_factor(step)
            if f != self._factor:
                self._factor = f
                self._event("budget_shrink" if f < 1.0 else "budget_restore",
                            step=step, factor=f)
        return self.kv_budget * self._factor

    # -- decisions -------------------------------------------------------
    def decide(self, ticket: Ticket, active: dict, step: int):
        """Admission decision for ``ticket`` against ``active`` slots.

        ``active`` maps slot index -> ``(Ticket, tokens_done)``.  Returns
        ``(ADMIT, [victim slots])`` (empty list = plain admit),
        ``(WAIT, [])`` or ``(REJECT, [])``.  Choosing victims does NOT
        mutate state — the caller preempts and then calls ``requeue``.
        """
        if ticket.eligible_step > step:
            return WAIT, []
        need = self.projected_bytes(ticket)
        if need > self.kv_budget:
            # Structurally impossible: exceeds the unsqueezed capacity of
            # an empty system.  Transient squeezes only make requests WAIT.
            self.rejected += 1
            self._event("reject", rid=ticket.rid, step=step, need=need,
                        budget=self.kv_budget)
            return REJECT, []
        budget = self.effective_budget(step)
        if need > budget:
            return WAIT, []
        used = sum(self.projected_bytes(t) for t, _ in active.values())
        if used + need <= budget:
            self.admitted += 1
            return ADMIT, []
        # Preempt cheapest-to-rematerialize slots until the ticket fits.
        # Victims must have retries left (tossing work only to reject the
        # request at requeue time would waste both); ties break on lower
        # slot index, so the choice is deterministic.
        ranked = sorted(
            ((self.remat_key(t, done), slot)
             for slot, (t, done) in active.items()
             if t.retries < self.max_retries),
            key=lambda kv: (kv[0], kv[1]))
        victims = []
        for _, slot in ranked:
            victims.append(slot)
            used -= self.projected_bytes(active[slot][0])
            if used + need <= budget:
                self.admitted += 1
                self.preemptions += len(victims)
                return ADMIT, victims
        return WAIT, []

    def enforce(self, active: dict, step: int) -> list:
        """Slots to preempt so current usage fits a squeezed budget.

        Cheapest-to-rematerialize first; requests out of retries are
        spared (they would be rejected, losing finished work for nothing
        — the squeeze model is a transient co-tenant, not a hard cap).
        """
        budget = self.effective_budget(step)
        used = sum(self.projected_bytes(t) for t, _ in active.values())
        if used <= budget:
            return []
        ranked = sorted(
            ((self.remat_key(t, done), slot)
             for slot, (t, done) in active.items()
             if t.retries < self.max_retries),
            key=lambda kv: (kv[0], kv[1]))
        victims = []
        for _, slot in ranked:
            if used <= budget:
                break
            victims.append(slot)
            used -= self.projected_bytes(active[slot][0])
        self.preemptions += len(victims)
        return victims

    def requeue(self, ticket: Ticket, step: int) -> None:
        """Record a preemption: bounded retry + exponential backoff."""
        ticket.retries += 1
        delay = min(self.backoff_steps * (2 ** (ticket.retries - 1)),
                    self.backoff_cap)
        ticket.eligible_step = step + delay
        self.requeued += 1
        self._event("preempt_requeue", rid=ticket.rid, step=step,
                    retries=ticket.retries, eligible=ticket.eligible_step)

    def retire(self, ticket: Ticket) -> None:
        self.completed += 1

    # -- accounting ------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        self.events.append(dict(kind=kind, **fields))

    def counters(self) -> dict:
        return {"admitted": self.admitted, "completed": self.completed,
                "requeued": self.requeued, "rejected": self.rejected,
                "preemptions": self.preemptions}
