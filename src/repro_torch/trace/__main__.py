"""CLI: capture and replay DTR workload traces with the port's engine.

  # Capture a continuous-batching serve trace (smoke scale) and verify that
  # scan and index engines replay it bit-exactly:
  python -m repro_torch.trace capture --smoke --out serve.log --verify

  # The eager MLP loop through the executor, on the card (or --device cpu):
  python -m repro_torch.trace capture --source eager-mlp --out mlp.log

  # Replay an existing trace across budgets/heuristics, or verify it:
  python -m repro_torch.trace replay serve.log --fractions 0.5 0.3
  python -m repro_torch.trace replay serve.log --verify

The counterpart of ``python -m repro.trace`` for the sources the port has;
``serve-step`` and ``train-step`` (jaxpr captures in the JAX package) wait
for the port's planner.
"""
from __future__ import annotations

import argparse
import sys

from ..check.trace_lint import check_log
from ..core.graph import Log
from . import capture as C
from . import replay as R

SOURCES = ("serve", "serve-step", "train-step", "eager-mlp", "treelstm")

#: replay heuristic trio when --heuristics is not given (--verify instead
#: defaults to every separable heuristic).
DEFAULT_HEURISTICS = ("h_dtr", "h_dtr_eq", "h_lru")


def _capture(args) -> Log:
    if args.source == "serve":
        model = C.step_model_from_config(args.arch, smoke=args.smoke)
        return C.capture_serve_trace(
            model, slots=args.slots, requests=args.requests, gen=args.gen,
            seed=args.seed)
    if args.source in ("serve-step", "train-step"):
        raise SystemExit(f"--source {args.source}: not yet ported (ROADMAP "
                         f"item 13)")
    if args.source == "eager-mlp":
        return C.capture_eager_mlp(seed=args.seed, device=args.device)
    if args.source == "treelstm":
        from ..core import graphs
        return graphs.treelstm(depth=4, width=32, seed=args.seed)
    raise SystemExit(f"unknown source {args.source}")


def _verify(log: Log, fractions, thrash_factor=50.0,
            heuristics=None) -> int:
    kw = {"heuristics": tuple(heuristics)} if heuristics else {}
    rep = R.verify_oracle_equivalence(log, fractions=fractions,
                                      thrash_factor=thrash_factor, **kw)
    status = "OK" if rep["ok"] else "MISMATCH"
    n_h = rep['cells'] // max(len(fractions), 1)
    print(f"verify[{log.name}]: {status} over {rep['cells']} cells "
          f"({n_h} heuristics x {len(fractions)} fractions)")
    for m in rep["mismatches"]:
        print(f"  MISMATCH {m['heuristic']}@{m['fraction']}: {m['fields']}")
    return 0 if rep["ok"] else 1


def cmd_capture(args) -> int:
    log = _capture(args)
    with open(args.out, "w") as f:
        f.write(log.dumps() + "\n")
    print(f"captured {log.name}: {log.op_count()} ops, "
          f"{len(log)} instructions, baseline_cost={log.baseline_cost():.3g} "
          f"-> {args.out}")
    if args.verify:
        return _verify(log, tuple(args.fractions), args.thrash_factor)
    return 0


def cmd_replay(args) -> int:
    with open(args.trace) as f:
        log = Log.loads(f.read())
    if args.verify:
        check_log(log)        # raises TraceLintError on a malformed log
        print(f"check_log[{log.name}]: OK")
        return _verify(log, tuple(args.fractions), args.thrash_factor,
                       heuristics=args.heuristics)
    curves = R.replay_budget_curve(
        log, heuristics=tuple(args.heuristics or DEFAULT_HEURISTICS),
        fractions=tuple(args.fractions), index=not args.scan,
        processes=args.processes, thrash_factor=args.thrash_factor)
    for c in curves:
        print(f"{c['trace']} {c['heuristic']}: "
              f"min_feasible={c['min_feasible_fraction']}")
        for r in c["runs"]:
            state = (f"slowdown={r['slowdown']:.3f}" if r["ok"]
                     else f"FAIL({r['error'][:40]})")
            print(f"  {r['budget']:.2f}: {state} evictions={r['evictions']} "
                  f"remats={r['remat_ops']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.trace")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--arch", default="qwen2-0.5b")
        p.add_argument("--smoke", action="store_true")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--heuristics", nargs="+", default=None)
        p.add_argument("--fractions", nargs="+", type=float,
                       default=list(R.DEFAULT_FRACTIONS))
        p.add_argument("--processes", type=int, default=None)
        p.add_argument("--thrash-factor", type=float, default=50.0,
                       help="abort a cell once compute exceeds this multiple "
                            "of the baseline (reports as thrash)")

    cap = sub.add_parser("capture", help="capture a workload trace")
    common(cap)
    cap.add_argument("--source", choices=SOURCES, default="serve")
    cap.add_argument("--slots", type=int, default=4)
    cap.add_argument("--requests", type=int, default=12)
    cap.add_argument("--gen", type=int, default=16)
    cap.add_argument("--device", default="cuda",
                     help="where the eager-mlp source runs its tensors")
    cap.add_argument("--out", default="trace.log")
    cap.add_argument("--verify", action="store_true",
                     help="replay scan-vs-index over all separable "
                          "heuristics and fail on any divergence")
    cap.set_defaults(fn=cmd_capture)

    rep = sub.add_parser("replay", help="replay a captured trace")
    common(rep)
    rep.add_argument("trace")
    rep.add_argument("--scan", action="store_true",
                     help="use the linear-scan oracle instead of the index")
    rep.add_argument("--verify", action="store_true")
    rep.set_defaults(fn=cmd_replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
