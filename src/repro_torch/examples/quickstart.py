"""Quickstart: DTR in three layers, on the card (or the CPU when asked).

  1. simulate the paper's algorithm on a model graph (core),
  2. run a *real* computation under a byte budget with live eviction (eager),
  3. train a small transformer with the DTR remat policy (each layer group
     under a selective checkpoint that saves its tagged outputs).

The counterpart of ``examples/quickstart.py``.  Run:

  python -m repro_torch.examples.quickstart               # the card
  python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from .. import configs
from ..core import graphs, simulator
from ..core.heuristics import by_name
from ..eager import DTRContext
from ..launch.serve import resolve_device
from ..launch.steps import make_train_step
from ..models import model as M
from ..optim import adamw


def part1_simulate() -> list:
    """Simulated DTR at three budgets; returns the engine's results."""
    print("== 1. simulated DTR on a transformer graph ==")
    log = graphs.transformer(layers=6, d=32, seq=16)
    peak, base = simulator.measure_baseline(log)
    results = []
    for frac in (0.8, 0.5, 0.3):
        r = simulator.simulate(log, by_name("h_dtr_eq"), budget=frac * peak)
        status = f"slowdown {r.slowdown:.2f}x" if r.ok else "OOM"
        print(f"   budget {frac:.0%} of peak -> {status} "
              f"({r.evictions} evictions, {r.remat_ops} remats)")
        results.append(r)
    return results


def part2_eager(device) -> DTRContext:
    """A 24-op chain of 64 KiB tensors under a 6-tensor budget; returns the
    context (evictions, remat runs)."""
    print("== 2. eager DTR: real buffers, real evictions ==")
    n = 64 * 1024 // 4
    budget = 6 * 64 * 1024
    ctx = DTRContext(budget_bytes=budget, device=device)
    x = ctx.wrap(torch.linspace(0, 1, n))
    vals = [x]
    for i in range(24):
        vals.append(ctx.call(f"f{i}", lambda a: torch.cos(a) * 1.01,
                             [vals[-1]])[0])
    print(f"   built 24-op chain under {budget//1024} KiB budget: "
          f"{ctx.rt.evictions} evictions")
    early = vals[3].value   # early value: triggers rematerialization
    print(f"   accessed evicted intermediate -> {ctx.remat_runs} remat runs, "
          f"value correct: {bool(torch.isfinite(early).all())}")
    return ctx


def part3_planned_training(device) -> list:
    """10 AdamW steps of the llama3.2-1b smoke config under ``remat="dtr"``
    (clipped at global norm 1); returns the losses."""
    print("== 3. DTR remat policy on a real train step ==")
    cfg = configs.get_smoke("llama3_2_1b").replace(remat="dtr")
    gen = torch.Generator(device).manual_seed(0)
    params = M.init_params(cfg, gen)
    opt = adamw(lr=1e-3)
    state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                           device=device, dtype=torch.int32)
    step = make_train_step(cfg, opt)
    losses = []
    for i in range(10):
        params, state, metrics = step(params, state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        if i % 3 == 0:
            print(f"   step {i}: loss {losses[-1]:.4f}")
    print("   (each layer group runs under a selective checkpoint with the "
          "DTR policy)")
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU runs only "
                         "when asked for)")
    device = resolve_device(ap.parse_args(argv).device)
    return {"simulated": part1_simulate(), "eager": part2_eager(device),
            "losses": part3_planned_training(device)}


if __name__ == "__main__":
    main()
