"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a training cell can have: a step that leaves
its state unchanged, half of the batch left out (the mean over the rest),
and an answer altered where it is produced (one leaf's gradient doubled
by the backward).  One card: no exchange between chips to leave out.  The
program runs at smoke size on the CPU; the cells' own limits judge it."""
from __future__ import annotations

import time

import pytest

from dtrbench.lib import harness
from dtrbench.lib.bench import Bench


def _unchanged(monkeypatch, family):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "apply_updates", lambda params, updates:
                        params)


def _half_batch(monkeypatch, family):
    from repro_torch.launch import steps
    real = steps.loss_and_grads

    def half(cfg, params, batch):
        b = batch["tokens"].shape[0]
        return real(cfg, params, {k: v[: b // 2] for k, v in batch.items()})
    monkeypatch.setattr(steps, "loss_and_grads", half)


def _doubled_leaf(monkeypatch, family):
    from repro_torch.launch import steps
    real = steps.clip_by_global_norm

    def clip(grads, max_norm):
        node = grads
        *path, last = family.FAULT_LEAF.split(".")
        for p in path:
            node = node[p]
        node[last] = node[last] * 2
        return real(grads, max_norm)
    monkeypatch.setattr(steps, "clip_by_global_norm", clip)


FAULTS = {"unchanged_state": _unchanged, "half_batch": _half_batch,
          "doubled_leaf": _doubled_leaf}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["mixtral-train-dtr", "rwkv6-train-dtr"])
def test_a_broken_step_is_not_correct(smoke_bench, monkeypatch, cell, fault):
    family = smoke_bench.family(smoke_bench.config(
        smoke_bench.cell(cell + "-smoke")["config"]))
    FAULTS[fault](monkeypatch, family)
    out = harness.run_cell(smoke_bench, cell + "-smoke", 99, 0.2, False,
                           "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]
    assert out["checks"] == {
        k: {**v, "limit": Bench().cell(cell)["limits"][k]}
        for k, v in out["checks"].items()}
