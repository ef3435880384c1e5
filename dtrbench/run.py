"""The port's benchmark: one run of one cell.

  python3 dtrbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  A cell
(``workloads/<cell>.json``) names a configuration (``configs/``) and a
traffic mix (``traffic/``); the run trains the configuration's model with
the port's launcher loop on weights and tokens drawn from ``--seed``,
measures ``--seconds`` of whole steps after set-up, checks the first
three steps against the plain reference (``reference/``), and prints the
compared numbers beside their limits as the last lines of standard error
and one JSON object as the last line of standard output.  With ``--trace
0`` its metrics are the end-to-end ones; with ``--trace 1`` the per-layer
metrics (``metrics/<name>.py``, those listed for the cell in
``BENCHMARK.json``) read from profiler sessions inside the window.

It exits non-zero, printing no result, where no card is found or fewer
than the cell asks for, and where the process has loaded JAX or the JAX
package ``repro`` once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="cell name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell: str) -> list:
    """``(name, unit)`` of the per-layer metrics ``BENCHMARK.json`` lists
    for ``cell``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [(m["name"], m["unit"]) for m in spec["per_layer"]
            if cell in m.get("workloads", [cell])]


def result_line(out: dict, bench, traced: bool, names, device: dict) -> dict:
    """The contract's last line: correct, attempted, failed, metrics,
    device, (breakdown), and the compared numbers last."""
    from dtrbench.lib import harness
    run = out["run"]
    if traced:
        metrics = {}
        for name, unit in names:
            value = bench.metric(name)(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        device = dict(device)
        if run.session is not None:
            device["busy_s"] = run.session.busy_s
            device["window_s"] = run.session.window_s
    else:
        metrics = harness.end_to_end(run)
    line = {"correct": out["correct"], "attempted": len(run.stamps) - 1,
            "failed": harness.failed_steps(run), "metrics": metrics,
            "device": device}
    if traced and run.session is not None:
        line["breakdown"] = {"device_ops": run.session.device_ops,
                             "idle_gaps": run.session.idle_gaps}
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in out["checks"].items()}
    return line


def _number(x):
    """A compared number as JSON can hold it: a gap that is not finite (a
    NaN loss, a missing slice) is written as 1e308."""
    return x if math.isfinite(x) else 1e308


def main(argv=None) -> int:
    args = parse_args(argv)
    from dtrbench.lib import harness, isolation
    from dtrbench.lib.bench import Bench
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"dtrbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["run"].peak_bytes}
    names = per_layer(args.workload) if args.trace else []
    line = result_line(out, bench, bool(args.trace), names, device)
    loaded = isolation.forbidden_loaded()
    if loaded:
        print(f"dtrbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r} "
              f"({v['where']})", file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
