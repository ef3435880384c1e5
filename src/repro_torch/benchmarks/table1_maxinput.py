"""Table 1 reproduction: larger-than-memory inputs via DTR.

Two forms, as in ``benchmarks/table1_maxinput.py``:
  1. Simulated (like the paper's Table 1): for each model graph, find the
     largest batch multiplier trainable at a FIXED byte budget with DTR vs
     without (no-DTR = fails as soon as unconstrained peak exceeds budget).
  2. Real buffers: the eager executor builds a TreeLSTM on growing trees
     under a fixed byte budget — actual allocations, actual evictions.  On
     the card the "plain" side is measured too: the same tree as plain torch
     ops with autograd holding what a backward needs, its
     ``max_memory_allocated`` above the start (the weight included) held to
     the budget; the reference's formula is printed beside it.

  python -m repro_torch.benchmarks.table1_maxinput              # the card
  python -m repro_torch.benchmarks.table1_maxinput --device cpu
"""
from __future__ import annotations

import argparse
import gc

import torch

from ..core import graphs, simulator
from ..core.heuristics import by_name
from ..core.runtime import OOMError, ThrashError
from ..eager import DTRContext
from ..launch.serve import resolve_device

MODELS = ("mlp", "transformer", "treelstm", "lstm")


def run_simulated(models=MODELS, multipliers=range(1, 9)):
    """The reference's ``run_simulated`` over the port's copy of the
    engine, its code but for the imports, with the models and multipliers
    as keywords (defaults: the reference's four and 1-8)."""
    rows = []
    cases = {
        "mlp": lambda m: graphs.mlp(depth=16, batch=8 * m),
        "transformer": lambda m: graphs.transformer(layers=6, d=32, seq=8,
                                                    batch=2 * m),
        "treelstm": lambda m: graphs.treelstm(depth=3 + m),
        "lstm": lambda m: graphs.lstm(steps=16 * m),
    }
    for mname in models:
        fn = cases[mname]
        base_peak, _ = simulator.measure_baseline(fn(1))
        budget = 1.05 * base_peak  # fits multiplier 1 without DTR, barely
        max_plain, max_dtr = 0, 0
        for m in multipliers:
            log = fn(m)
            peak, _ = simulator.measure_baseline(log)
            if peak <= budget:
                max_plain = m
            r = simulator.simulate(log, by_name("h_dtr_eq"), budget=budget)
            if r.ok and r.slowdown < 2.0:   # paper's thrash threshold
                max_dtr = m
        rows.append(dict(bench="sim", model=mname,
                         budget=int(budget), max_plain=max_plain,
                         max_dtr=max_dtr,
                         gain=round(max_dtr / max(max_plain, 1), 2)))
    return rows


def formula_peak(dim: int, depth: int) -> int:
    """The reference's plain-framework peak: the weight, every leaf and
    two vectors an inner node, f32."""
    n_leaves = 2 ** depth
    n_inner = 2 ** depth - 1
    return (dim * dim + (n_leaves + 2 * n_inner) * dim) * 4


def measured_plain_peak(dim: int, depth: int, device) -> int:
    """The tree as plain torch ops on the card, autograd recording what a
    backward would need (each cell's input and output): the bytes
    allocated at the peak above the start, the weight included.  One cell
    runs first so that the library's workspaces are in the start, and the
    garbage collector runs before it, so that no earlier run's tensors (an
    eager context's reference cycles) are freed inside the measurement."""
    gc.collect()
    w = (torch.eye(dim, device=device) * 0.3).requires_grad_()
    warm = torch.tanh(torch.full((dim,), 0.1, device=device) @ w)
    del warm
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) - w.numel() * w.element_size()

    def build(d, v):
        if d == 0:
            return torch.full((dim,), v, device=device)
        s = build(d - 1, v) + build(d - 1, v + .01)
        return torch.tanh(s @ w)

    root = build(depth, 0.1)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del root
    return peak


def run_eager_treelstm(dim: int = 128, device="cuda"):
    """Real-buffer version: largest complete tree trainable at fixed bytes,
    with DTR and without (measured on the card, the formula on the CPU)."""
    device = torch.device(device)
    budget = (dim * dim + 40 * dim) * 4  # weight + ~40 activation slots
    measured = device.type == "cuda"

    def try_depth(depth, use_dtr):
        if not use_dtr:
            # "plain" framework: peak live bytes must fit the budget
            peak = (measured_plain_peak(dim, depth, device) if measured
                    else formula_peak(dim, depth))
            return peak <= budget, peak
        ctx = DTRContext(budget_bytes=budget, device=device)
        w = ctx.wrap(torch.eye(dim) * 0.3, name="w")

        def build(d, v):
            if d == 0:
                return ctx.wrap(torch.full((dim,), v), name="leaf")
            a, b = build(d - 1, v), build(d - 1, v + .01)
            s = ctx.call("add", torch.add, [a, b])[0]
            return ctx.call("cell", lambda s_, w_: torch.tanh(s_ @ w_),
                            [s, w])[0]

        try:
            root = build(depth, 0.1)
            _ = root.value
            return True, None
        except (OOMError, ThrashError):
            return False, None

    max_plain = max_dtr = 0
    peaks = {}
    for depth in range(1, 9):
        fits, peaks[depth] = try_depth(depth, use_dtr=False)
        if fits:
            max_plain = depth
        if try_depth(depth, use_dtr=True)[0]:
            max_dtr = depth
    row = dict(bench="eager", model="treelstm_real", budget=budget,
               max_plain=max_plain, max_dtr=max_dtr,
               gain=round(2 ** max_dtr / 2 ** max(max_plain, 0), 2))
    if measured:
        row.update(dim=dim, plain_peaks=peaks,
                   formula_peaks={d: formula_peak(dim, d) for d in peaks},
                   formula_max_plain=max(
                       [d for d in peaks if formula_peak(dim, d) <= budget],
                       default=0))
    return [row]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU runs only "
                         "when asked for)")
    device = resolve_device(ap.parse_args(argv).device)
    rows = run_simulated() + run_eager_treelstm(device=device)
    print("bench,model,budget,max_plain,max_dtr,gain")
    for r in rows:
        print(",".join(str(r[k]) for k in
                       ("bench", "model", "budget", "max_plain", "max_dtr",
                        "gain")))
    for r in rows:
        if "plain_peaks" in r:
            print(f"eager plain peaks by depth, measured on the card: "
                  f"{r['plain_peaks']}; the reference's formula: "
                  f"{r['formula_peaks']} (max_plain "
                  f"{r['formula_max_plain']} by the formula)")
    return rows


if __name__ == "__main__":
    main()
