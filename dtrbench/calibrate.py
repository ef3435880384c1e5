"""The readings a cell's limits are set from, on the card, in one process.

  python3 dtrbench/calibrate.py --workload <cell> --seeds 12 \\
      --control-seeds 4 --fault-seeds 3 --first-seed <n> [--out FILE]

For each of ``--seeds`` seeds it runs the cell's program through set-up and
a one-step window and compares its first three steps with the plain
reference (``run.py``'s comparison: the lower readings).  On the first
``--control-seeds`` it also reads the control, the reference computed with
fp8 products in the program's place, and on the first ``--fault-seeds``
two planted faults, the reference over half the batch and the reference
with one leaf's gradient doubled (the upper readings).  Each reading is a
JSON line on standard output (and in ``--out``); the last line sums up each
number's largest program reading and smallest control and fault readings.
A state left unchanged reads 1 for ``grad_gap`` and ``change_gap`` and
needs no run.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from dtrbench.lib import check, harness
    from dtrbench.lib.bench import Bench
    from dtrbench.reference import common
    bench = Bench()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = dict(bench.traffic(cell["traffic"]), lr_total=harness.STEPS_CAP)
    family = bench.family(config)
    sink = open(args.out, "a") if args.out else None
    rows = []

    def emit(row):
        rows.append(row)
        text = json.dumps(row)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    def gaps_of(prog, ref):
        return {k: v for k, (v, _) in check.compare(prog, ref).items()}

    for i in range(args.seeds):
        seed = args.first_seed + i
        t = time.perf_counter()
        out = harness.run_cell(bench, args.workload, seed, 0.0, False,
                               args.device, time.perf_counter())
        ref = out["reference"]
        found = check.compare(out["program"], ref)
        emit({"kind": "program", "seed": seed,
              "gaps": {k: v for k, (v, _) in found.items()},
              "where": {k: w for k, (_, w) in found.items()},
            "losses": out["program"].losses, "ref_losses": ref.losses,
            "seconds": time.perf_counter() - t})
        del out
        planted = []
        if i < args.control_seeds:
            planted.append(("control", dict(numerics=common.FP8)))
        if i < args.fault_seeds:
            planted += [("half_batch", dict(half_batch=True)),
                        ("double_leaf", dict(double_leaf=family.FAULT_LEAF)),
                        ("double_unembed",
                         dict(double_leaf="embed.unembed"))]
        for kind, kw in planted:
            t = time.perf_counter()
            got = common.train_readings(family, config["model"], traffic,
                                        seed, args.device, **kw)
            emit({"kind": kind, "seed": seed, "gaps": gaps_of(got, ref),
                  "seconds": time.perf_counter() - t})
            del got
        del ref
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()

    summary = {"kind": "summary", "workload": args.workload}
    for name in check.NUMBERS:
        lows = [r["gaps"][name] for r in rows if r["kind"] == "program"]
        summary[name] = {"lower": max(lows), "program": lows}
        for kind in ("control", "half_batch", "double_leaf",
                     "double_unembed"):
            vals = [r["gaps"][name] for r in rows if r["kind"] == kind]
            if vals:
                summary[name][kind] = min(vals)
    if args.device == "cuda":
        summary["card"] = torch.cuda.get_device_name(0)
    summary["seconds"] = time.perf_counter() - T0
    emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
