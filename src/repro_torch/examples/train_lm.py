"""End-to-end training driver: data pipeline -> model -> optimizer ->
checkpointing -> fault tolerance, with the DTR remat policy as a first-class
config knob.

The counterpart of ``examples/train_lm.py``, with its flags and defaults,
on the card unless ``--device cpu``.  The default run trains a ~20M-param
llama-family model (the smoke config widened) in f32 for 300 steps;
``--arch smollm-135m --full`` trains the real 135M config.  The loop is the
launcher's (:func:`repro_torch.launch.train.train_loop`: AdamW on the cosine
schedule at 3e-4, the divergence guard, the straggler monitor, resume from
the latest checkpoint with the data cursor after it), so resuming after an
interruption is exercised by re-running the command.

  python -m repro_torch.examples.train_lm
  python -m repro_torch.examples.train_lm --arch smollm-135m --full \\
      --steps 120 --batch 8
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import configs
from ..ckpt import CheckpointManager
from ..launch import train
from ..launch.serve import resolve_device
from ..models import model as M
from ..models.params import tree_items


def main(argv=None) -> dict:
    """Returns the losses of the steps this run applied, their steps, the
    verdict and the straggler monitor."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true",
                    help="use the full config instead of the smoke config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", default="dtr")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU runs only "
                         "when asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (configs.get(args.arch) if args.full
           else configs.get_smoke(args.arch))
    # ~20M-class default: widen the smoke config a little.
    if not args.full:
        cfg = cfg.replace(n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
                          head_dim=32, d_ff=1024, vocab=8192)
    cfg = cfg.replace(remat=args.remat, dtype="float32")
    n_params_analytic = cfg.param_count()
    print(f"arch={cfg.name} params~{n_params_analytic/1e6:.1f}M "
          f"remat={cfg.remat} device={device}")

    params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
    n_params = sum(int(np.prod(p.shape)) for _, p in tree_items(params))
    print(f"materialized params: {n_params/1e6:.1f}M")

    ckpt = CheckpointManager(args.ckpt_dir, every_steps=args.ckpt_every,
                             keep=2)
    # The example's fixed choices, in the launcher's terms.
    loop_args = argparse.Namespace(**vars(args), optimizer="adamw", lr=3e-4,
                                   grad_accum=1, seed=0)
    res = train.train_loop(cfg, params, loop_args, ckpt=ckpt)

    applied = [(s, loss) for s, loss, a in
               zip(res.steps, res.losses, res.actions) if a == "ok"]
    steps = [s for s, _ in applied]
    losses = [loss for _, loss in applied]
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    verdict = "LEARNING" if last < first else "NOT LEARNING"
    monitor = res.straggler
    print(f"\nloss {first:.4f} -> {last:.4f} ({verdict})")
    print(f"step-time ewma {monitor.ewma*1e3:.0f}ms; "
          f"{sum(s.flagged for s in monitor.history)} straggler flags")
    return {"losses": losses, "steps": steps, "verdict": verdict,
            "monitor": monitor}


if __name__ == "__main__":
    main()
