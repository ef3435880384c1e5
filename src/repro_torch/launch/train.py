"""Training launcher: one card, deterministic synthetic data, AdamW or
Adafactor.

The counterpart of ``repro.launch.train`` without its mesh, sharding,
checkpoints, divergence guard and monitors (ROADMAP Queue 1 item 4): pick
an arch, a batch and sequence length, gradient accumulation, a remat policy
(every one the reference takes: ``none``, ``full``, ``dots``, ``dtr``,
``names:a,b``) and an optimizer, and train from a random init drawn from
``--seed``.  Each step prints the JAX launcher's line; ``mem`` is
``torch.cuda.max_memory_allocated`` on the card.

  # CPU smoke (plain versions of the kernels):
  python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
      --device cpu --steps 3 --batch 2 --seq 32 --remat dtr \\
      --optimizer adafactor
  # full width on the card (flash attention forward and backward kernels;
  # the WKV kernels for --arch rwkv6-1.6b):
  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 4 \\
      --batch 4 --seq 2048

On the card, every attention (rwkv: recurrence) layer launches its forward
kernel once per step and its backward kernel once; with any remat policy
other than ``none`` the group's forward runs again in the backward, so the
forward kernel launches twice.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import configs
from ..data.pipeline import Prefetcher, SyntheticLM
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_items
from ..optim import adafactor, adamw, cosine_schedule
from .serve import resolve_device
from .steps import make_train_step


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)       # per step
    grad_norms: list = field(default_factory=list)   # per step
    step_seconds: list = field(default_factory=list)  # host clock, synced
    peak_bytes: int = 0                               # 0 on the CPU


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    help="none | full | dots | dtr | names:a,b")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU runs only "
                         "when asked for)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the parameters and the data stream")
    return ap.parse_args(argv)


def config_from_args(args) -> ModelConfig:
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    cfg = cfg.replace(remat=args.remat)
    M.remat_policy(cfg)        # raises on a policy the reference lacks
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    return cfg


def train_loop(cfg: ModelConfig, params, args, *, verbose: bool = True,
               on_step=None) -> TrainResult:
    """Train ``params`` (in place, on their device) for ``args.steps`` steps
    on ``SyntheticLM`` batches.  ``on_step(step)``, if given, runs before
    each step (the caller resets kernel counters there)."""
    device = next(t for _, t in tree_items(params)).device
    # The reference's choices: Adafactor at a constant rate, AdamW on the
    # cosine schedule.
    opt = (adafactor(lr=args.lr) if args.optimizer == "adafactor"
           else adamw(lr=cosine_schedule(args.lr, warmup=20,
                                         total=args.steps)))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed, n_codebooks=cfg.n_codebooks)
    on_card = device.type == "cuda"
    res = TrainResult()
    prefetch = Prefetcher(data)
    try:
        for step in range(args.steps):
            _, host_batch = prefetch.next()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host_batch.items()}
            if on_step is not None:
                on_step(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            if on_card:
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            res.losses.append(loss)
            res.grad_norms.append(gn)
            res.step_seconds.append(seconds)
            peak = torch.cuda.max_memory_allocated(device) if on_card else 0
            res.peak_bytes = max(res.peak_bytes, peak)
            if verbose and (step % 10 == 0 or step == args.steps - 1):
                mem = f" mem {peak/1e6:.0f}MB" if peak else ""
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {gn:7.3f} {seconds*1e3:6.0f} ms" + mem,
                      flush=True)
    finally:
        prefetch.stop()
    return res


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = M.init_params(cfg, gen)
    n = sum(int(np.prod(t.shape)) for _, t in tree_items(params))
    print(f"arch={cfg.name} params={n/1e6:.1f}M device={device} "
          f"remat={cfg.remat} ga={args.grad_accum}")
    res = train_loop(cfg, params, args)
    if res.peak_bytes:
        print(f"mem summary: peak {res.peak_bytes/1e6:.0f}MB")
    print("done")


if __name__ == "__main__":
    main()
