"""Fig. 4 / App. D.3 reproduction: runtime overhead of the DTR machinery.

Two measurements, as in ``benchmarks/fig4_overhead.py``:
  1. metadata accesses per run for h_dtr vs h_dtr_eq vs h_dtr_local (the
     1-3 orders-of-magnitude separation of App. D.3);
  2. wall-clock planner cost: the trace-time DTR plan for a real torch
     model (the "milliseconds, not ILP-minutes" claim of Sec. 4.3), through
     the port's planner (``core/planner.py``: ``make_fx`` on fake tensors,
     so the plan is host work whatever the device).

  python -m repro_torch.benchmarks.fig4_overhead              # the card
  python -m repro_torch.benchmarks.fig4_overhead --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import graphs, planner, remat, simulator
from ..core.heuristics import by_name
from ..launch.serve import resolve_device

MODELS = ("resnet", "treelstm", "transformer")


def run_meta_accesses(models=MODELS):
    """The reference's ``run_meta_accesses`` over the port's copy of the
    engine, its code but for the imports, with the models as a keyword
    (default: the reference's three)."""
    rows = []
    builders = {"resnet": lambda: graphs.resnet(blocks=24),
                "treelstm": lambda: graphs.treelstm(depth=6),
                "transformer":
                    lambda: graphs.transformer(layers=8, d=32, seq=16)}
    for mname in models:
        log = builders[mname]()
        peak, _ = simulator.measure_baseline(log)
        # index=False throughout so every cell runs ONE engine (the linear
        # scan) — the eviction index, and the automatic scan fallback the
        # E.2 sampling modes would take, would mix two engines into one
        # comparison.  The *relative* separations (h_dtr >> h_dtr_eq >>
        # h_dtr_local, exact vs E.2 sampling) are what reproduce App. D.3.
        for h in ("h_dtr", "h_dtr_eq", "h_dtr_local"):
            for frac in (0.6, 0.4):
                r = simulator.simulate(log, by_name(h), budget=frac * peak,
                                       index=False)
                rows.append(dict(
                    bench="meta", model=mname, heuristic=h, budget=frac,
                    ok=r.ok, meta_accesses=r.meta_accesses,
                    value=r.meta_accesses))
        # E.2 optimizations at 0.5 budget
        for opts, tag in (
                (dict(), "exact"),
                (dict(ignore_small_frac=0.01), "no_small"),
                (dict(sample_sqrt=True), "sqrt_sample"),
                (dict(ignore_small_frac=0.01, sample_sqrt=True), "both")):
            r = simulator.simulate(log, by_name("h_dtr_eq"),
                                   budget=0.5 * peak, index=False, **opts)
            rows.append(dict(
                bench="e2_opts", model=mname, heuristic=f"h_dtr_eq/{tag}",
                budget=0.5, ok=r.ok, meta_accesses=r.meta_accesses,
                value=r.meta_accesses))
    return rows


def run_planner_wallclock(device="cuda"):
    """Plan cost for a real traced model (msec — the paper's selling
    point): the reference's tagged MLP (d 128, 8 layers, batch 256, gelu's
    tanh form), planned at 0.8, 0.6 and 0.4 of its traced peak."""
    d, layers = 128, 8
    gen = torch.Generator(device).manual_seed(0)
    params = [dict(w1=torch.randn(d, 4 * d, generator=gen, device=device)
                   * 0.02,
                   w2=torch.randn(4 * d, d, generator=gen, device=device)
                   * 0.02) for _ in range(layers)]
    x = torch.randn(256, d, generator=gen, device=device)

    def fwd(params, x):
        h = x
        for i, p in enumerate(params):
            a = remat.tag(torch.nn.functional.gelu(h @ p["w1"],
                                                   approximate="tanh"),
                          f"act{i}")
            h = h + remat.tag(a @ p["w2"], f"proj{i}")
        return h

    g = planner.grad_of_sum(lambda p, xx: torch.mean(fwd(p, xx) ** 2))
    tg = planner.trace_to_log(g, params, x)
    peak, _ = simulator.measure_baseline(tg.log)
    rows = []
    for frac in (0.8, 0.6, 0.4):
        t0 = time.perf_counter()
        pl = planner.plan(g, params, x, budget_bytes=frac * peak)
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(bench="planner_ms", model="mlp8x128",
                         heuristic="h_dtr_eq", budget=frac,
                         ok=pl.feasible, meta_accesses="",
                         value=round(wall_ms, 2)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the planned model's tensors "
                         "(default: cuda; the CPU runs only when asked "
                         "for)")
    device = resolve_device(ap.parse_args(argv).device)
    rows = run_meta_accesses() + run_planner_wallclock(device)
    print("bench,model,heuristic,budget,ok,value")
    for r in rows:
        print(",".join(str(r[k]) for k in
                       ("bench", "model", "heuristic", "budget", "ok",
                        "value")))
    return rows


if __name__ == "__main__":
    main()
