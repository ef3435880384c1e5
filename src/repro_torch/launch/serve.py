"""Serving driver: continuous-batching greedy decode loop.

A request queue feeds a fixed-width decode batch; finished slots are
immediately refilled from the queue (continuous batching).  Each slot
carries its own position clock.  On the card every decode step runs the
model's attention through the Hopper flash-attention kernel (mixtral's
sliding-window layers against ring-buffer caches) and, for an MoE model,
each layer's expert FFN through the Hopper grouped-GEMM kernel, three
launches per layer; the rest is plain PyTorch.

  python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 8 --slots 4 --gen 16
  python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke \\
      --device cpu --requests 6 --slots 2 --gen 8 --max-len 32

The full mixtral-8x7b (46.7 B parameters) does not fit one card;
``chip_smoke.py`` serves it at full width with its depth cut to 4 layers.

``--capture PATH`` additionally records the executed per-request/slot
operator stream as a DTR log: every admission, decode step, and retirement
the loop actually performs is mirrored into the trace.  The requests are
drawn from numpy's ``default_rng(0)``, as in the JAX package's driver, so
both serve the same requests and capture the same log.
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import configs
from ..core.graph import Log
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_items
from ..trace.capture import WorkloadTrace, step_model_from_config
from .steps import make_serve_step


@dataclass
class ServeResult:
    completed: dict            # request id -> generated tokens
    steps: int                 # decode steps run
    seconds: float             # wall time of the loop (after set-up)
    log: Optional[Log] = None  # the captured trace, with --capture


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (continuous batching slots)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--capture", default=None, metavar="PATH",
                    help="record the executed operator stream as a DTR "
                         "trace log")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU runs only "
                         "when asked for)")
    return ap.parse_args(argv)


def resolve_device(name: Optional[str]) -> torch.device:
    """``name``, or CUDA when none is given; never a silent CPU fallback."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run on the CPU")
    return device


def serve_loop(cfg: ModelConfig, params, args) -> ServeResult:
    """Serve ``args.requests`` requests greedily with ``params``.

    ``params`` lie on the device the loop runs on.  Weights that the layers
    cast to ``cfg.dtype`` are cast once here, not at every use.
    """
    tracer = None
    if args.capture:
        tracer = WorkloadTrace(
            step_model_from_config(args.arch, smoke=args.smoke),
            name=f"serve_{args.arch}_s{args.slots}",
            meta={"source": "launch.serve", "arch": args.arch,
                  "slots": args.slots, "requests": args.requests,
                  "gen": args.gen, "smoke": bool(args.smoke)})

    rng = np.random.default_rng(0)
    queue = deque(
        (i, rng.integers(0, cfg.vocab, (int(rng.integers(4, 12)),))
         .astype(np.int32)) for i in range(args.requests))

    device = params["embed"]["tokens"].device
    params = M.prepare_params(cfg, params)
    serve = make_serve_step(cfg)
    # The cache is updated in place, step after step (JAX donates it).
    cache = M.init_cache(cfg, args.slots, args.max_len, device)
    leaves = [leaf for _, leaf in tree_items(cache)]

    # True continuous batching: each slot carries its own position clock,
    # so a finished slot is refilled on the very next global step while its
    # neighbors keep decoding.
    slots = [None] * args.slots
    tok = np.zeros((args.slots, 1), np.int32)
    pos = np.zeros(args.slots, np.int32)
    completed = {}
    steps = 0

    def admit_into(i, rid, prompt):
        slots[i] = {"rid": rid, "prompt": prompt, "i": 0, "out": []}
        pos[i] = 0
        # Zero slot i's rows of every [layers, slots, ...] cache leaf.
        # Attention caches (dense or ring) are position-masked, so this is
        # hygiene.
        for leaf in leaves:
            leaf[:, i].zero_()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        while queue or any(s is not None for s in slots):
            for i in range(args.slots):   # mid-stream refill
                if slots[i] is None and queue:
                    admit_into(i, *queue.popleft())
            for i, s in enumerate(slots):
                if s is None:
                    tok[i, 0] = 0
                elif pos[i] < len(s["prompt"]):
                    tok[i, 0] = s["prompt"][pos[i]]
                # else: keep the model-generated token for this slot
            nxt, cache = serve(params, cache,
                               torch.from_numpy(tok).to(device),
                               torch.from_numpy(pos).to(device))
            steps += 1
            nxt_np = nxt.cpu().numpy()
            for i, s in enumerate(slots):
                if s is None:
                    continue
                if tracer is not None:
                    if s["i"] == 0:
                        tracer.prefill(s["rid"], i, 1)
                    else:
                        tracer.decode(
                            s["rid"], i, int(pos[i]),
                            phase="prompt" if pos[i] < len(s["prompt"])
                            else "decode")
                    s["i"] += 1
                if pos[i] >= len(s["prompt"]) - 1:
                    s["out"].append(int(nxt_np[i, 0]))
                    tok[i, 0] = nxt_np[i, 0]
                pos[i] += 1
                if len(s["out"]) >= args.gen or pos[i] >= args.max_len:
                    completed[s["rid"]] = s["out"]
                    if tracer is not None:
                        tracer.retire(s["rid"], i)
                    slots[i] = None
    dt = time.perf_counter() - t0

    log = None
    if tracer is not None:
        log = tracer.finish()
        with open(args.capture, "w") as f:
            f.write(log.dumps() + "\n")
    return ServeResult(completed, steps, dt, log)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
    res = serve_loop(cfg, params, args)
    print(f"served {len(res.completed)}/{args.requests} requests, "
          f"{res.steps} decode steps, {res.seconds:.2f}s "
          f"({res.seconds / max(res.steps, 1) * 1e3:.1f} ms/step batched "
          f"x{args.slots}) on {device}")
    for rid in sorted(res.completed)[:4]:
        print(f"  req{rid}: {res.completed[rid][:10]}...")
    if res.log is not None:
        print(f"captured trace {res.log.name}: {res.log.op_count()} ops "
              f"-> {args.capture}")
    return res


if __name__ == "__main__":
    main()
