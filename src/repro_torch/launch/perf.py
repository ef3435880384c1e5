"""Perf hill-climbing harness over the dry run: the counterpart of
``repro.launch.perf``.

Runs the named variants of a dry-run cell (``launch/dryrun.py``), each a
hypothesis about the cell's dominant roofline term, and prints each
variant's terms beside the baseline's.  Records go under ``--out``
(``experiments/perf_torch`` by default, which ``.gitignore`` lists).

  python -m repro_torch.launch.perf --cell llama3.2-1b/train_4k --device cpu
  python -m repro_torch.launch.perf --cell smollm-135m/train_4k --mesh multi

The reference's variant ``flash_analytic`` (an analytic HBM model of its
Pallas kernel) has no meaning here: the dry run traces the flash kernels'
own dispatcher ops whichever variant runs.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .dryrun import run_cell

_DP = {"batch": ("pod", "data", "model"), "seq": None}

# Each variant: (name, hypothesis, kwargs for build_cell), the reference's.
VARIANTS = {
    "smollm-135m/train_4k": [
        ("baseline", "paper-faithful baseline (remat=full, TP rules)",
         dict(remat="full")),
        ("pure_dp", "135M params fit one card: map batch over ALL axes "
         "(pod,data,model), which kills attention replication and costs a "
         "full-param all-reduce", dict(remat="full", overrides=_DP)),
        ("pure_dp_dtr", "pure DP + DTR remat policy (save attn/ffn outs): "
         "recompute only cheap pointwise, memory now abundant",
         dict(remat="dtr", overrides=_DP)),
        ("pure_dp_bf16sm", "pure DP + bf16 softmax: halve attention logit "
         "traffic", dict(remat="dtr", extra_cfg=dict(softmax_f32=False),
                         overrides=_DP)),
    ],
    "deepseek-v3-671b/train_4k": [
        ("baseline", "paper-faithful baseline (ga=8, FSDP, remat=full)",
         dict(remat="full")),
        ("ga4", "halve grad-accum: FSDP params gathered 4x instead of 8x "
         "per step (~2x activation memory)",
         dict(remat="full", grad_accum=4)),
        ("ga4_dtr", "ga=4 + DTR remat policy: keep attn/ffn outputs",
         dict(remat="dtr", grad_accum=4)),
        ("ga2_dtr", "ga=2 (needs the DTR policy's memory discipline)",
         dict(remat="dtr", grad_accum=2)),
    ],
    "mixtral-8x7b/prefill_32k": [
        ("baseline", "sweep defaults (FSDP on, seq sharding)",
         dict(remat="none")),
        ("no_fsdp", "inference weights are read-only: FSDP buys nothing "
         "and costs per-layer gathers", dict(remat="none", fsdp=False)),
    ],
    "llama3.2-1b/train_4k": [
        ("baseline", "paper-faithful baseline (remat=full)",
         dict(remat="full")),
        ("dtr_policy", "DTR-planned policy (save attn_out+ffn_out): trade "
         "the rematerialized forward for saved residuals",
         dict(remat="dtr")),
        ("no_remat", "remat off entirely (upper bound on memory)",
         dict(remat="none")),
        ("bf16_softmax", "bf16 attention logits",
         dict(remat="dtr", extra_cfg=dict(softmax_f32=False))),
        ("bf16_no_sp", "bf16 softmax + no sequence sharding: no per-block "
         "seq<->heads redistributions, bigger saved activations",
         dict(remat="dtr", extra_cfg=dict(softmax_f32=False),
              overrides={"seq": None})),
    ],
}


def run_variants(cell: str, multi_pod: bool, out_dir: str) -> list:
    """Each variant of ``cell`` on the production mesh; returns the rows
    (a failed variant's row holds its error)."""
    arch, shape = cell.split("/")
    os.makedirs(out_dir, exist_ok=True)
    results, base = [], None
    for name, hypothesis, kw in VARIANTS[cell]:
        t0 = time.time()
        try:
            res = run_cell(arch, shape, multi_pod, **kw)
            r = res["roofline"]
            row = dict(variant=name, hypothesis=hypothesis,
                       compute_ms=r["compute_s"] * 1e3,
                       memory_ms=r["memory_s"] * 1e3,
                       collective_ms=r["collective_s"] * 1e3,
                       dominant=r["dominant"],
                       step_ms=r["step_time_s"] * 1e3,
                       roofline=r["roofline_frac"],
                       mem_gib=res["memory"]["peak_bytes_per_device"]
                       / 2**30, wall_s=time.time() - t0)
            with open(os.path.join(out_dir, f"{arch}_{shape}_{name}.json"),
                      "w") as f:
                json.dump(res, f, indent=1, allow_nan=False)
        except Exception as e:
            row = dict(variant=name, hypothesis=hypothesis, error=repr(e))
        results.append(row)
        if name == "baseline" and "error" not in row:
            base = row
        _print_row(row, base)
    return results


def _print_row(row, base) -> None:
    if "error" in row:
        print(f"{row['variant']:16s} FAILED: {row['error'][:120]}")
        return
    d = ""
    if base is not None and base is not row:
        d = f"  step {row['step_ms'] / base['step_ms'] - 1:+.1%} vs baseline"
    print(f"{row['variant']:16s} comp={row['compute_ms']:8.1f}ms "
          f"mem={row['memory_ms']:8.1f}ms coll={row['collective_ms']:8.1f}ms "
          f"dom={row['dominant']:10s} step={row['step_ms']:8.1f}ms "
          f"roofline={row['roofline'] * 100:5.1f}% "
          f"hbm={row['mem_gib']:5.1f}GiB{d}", flush=True)


def main(argv=None):
    from .serve import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(VARIANTS))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="experiments/perf_torch")
    ap.add_argument("--device", default=None,
                    help="where the trace runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print(f"== {args.cell} ({args.mesh}-pod) ==")
    run_variants(args.cell, args.mesh == "multi", args.out)


if __name__ == "__main__":
    main()
