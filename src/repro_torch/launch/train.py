"""Training launcher: one card, deterministic synthetic data, AdamW or
Adafactor, periodic atomic checkpoints with resume, a divergence guard,
straggler and memory monitors.

The counterpart of ``repro.launch.train`` with its defaults (llama3.2-1b,
``--remat dtr``, checkpoints every 50 steps under
``/tmp/repro_train_ckpt``) and its mesh flags (``launch/mesh.py``):
``--mesh host`` is the (1, 1) mesh of the one card, where ``--fsdp`` and
``--seq-shard`` resolve to dims of size 1 and change nothing;
``--mesh production`` and ``multipod`` need a world of 256 and 512 ranks
and fail, as the reference's do, on one.  Pick an arch, a batch and sequence length, gradient
accumulation, a remat policy (every one the reference takes: ``none``,
``full``, ``dots``, ``dtr``, ``names:a,b``) and an optimizer, and train from
a random init drawn from ``--seed``, or from the latest checkpoint in
``--ckpt-dir`` (the data stream seeks to the step after it).  Each step
prints the JAX launcher's line; ``mem`` is ``torch.cuda.max_memory_allocated``
on the card, ``free_blk`` the caching allocator's largest free block (see
:func:`device_memory`).

  # CPU smoke (plain versions of the kernels):
  python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
      --device cpu --steps 3 --batch 2 --seq 32 --optimizer adafactor \\
      --ckpt-dir /tmp/qwen2_smoke_ckpt
  # full width on the card (flash attention forward and backward kernels;
  # the WKV kernels for --arch rwkv6-1.6b):
  python -m repro_torch.launch.train --steps 4 --batch 4 --seq 2048

On the card, every attention (rwkv: recurrence) layer launches its forward
kernel once per step and its backward kernel once; with any remat policy
other than ``none`` the group's forward runs again in the backward, so the
forward kernel launches twice.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .. import configs
from ..alloc import FragStats
from ..ckpt import CheckpointManager
from ..data.pipeline import Prefetcher, SyntheticLM
from ..distributed.monitor import (DivergenceGuard, MemoryMonitor,
                                   StragglerMonitor, Timer)
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_items, tree_map
from ..optim import adafactor, adamw, cosine_schedule
from .mesh import launch_mesh
from .serve import resolve_device
from .steps import make_train_step, refuse_like_reference

@dataclass
class TrainResult:
    """What a run did, filled as the loop runs (a caller that interrupts
    the loop keeps what it has).  ``params`` and ``opt_state`` keep the
    run's device state alive for as long as the record is: a caller that
    keeps the record and goes on to measure memory calls
    :meth:`drop_state` first."""
    steps: list = field(default_factory=list)        # step index, per step
    losses: list = field(default_factory=list)       # per step
    grad_norms: list = field(default_factory=list)   # per step
    actions: list = field(default_factory=list)      # the guard's, per step
    step_seconds: list = field(default_factory=list)  # host clock, synced
    peak_bytes: int = 0                               # 0 on the CPU
    start_step: int = 0                # the step after a restored checkpoint
    params: Any = None                 # the live parameters
    opt_state: Any = None              # the live optimizer state
    memory: dict = field(default_factory=dict)       # MemoryMonitor.summary
    straggler: Any = None                            # the StragglerMonitor

    def drop_state(self) -> "TrainResult":
        """Let go of the live parameters and optimizer state."""
        self.params = self.opt_state = None
        return self


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b", help="architecture")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "multipod"],
                    help="device mesh; production and multipod need 256 "
                         "and 512 ranks")
    ap.add_argument("--steps", type=int, default=100, help="train steps")
    ap.add_argument("--batch", type=int, default=8, help="sequences a step")
    ap.add_argument("--seq", type=int, default=128, help="sequence length")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches a step")
    ap.add_argument("--remat", default="dtr",
                    help="none | full | dots | dtr | names:a,b")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard parameters over the data dims")
    ap.add_argument("--seq-shard", action="store_true",
                    help="Megatron-style sequence sharding (seq->model)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"], help="optimizer")
    ap.add_argument("--lr", type=float, default=3e-4, help="peak rate")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_ckpt",
                    help="checkpoint directory; the run resumes from its "
                         "latest step")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="save every this many steps")
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
    # train_loop refuses too, but only after main has drawn the weights.
    refuse_like_reference(cfg, "train launcher")
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    return cfg


def device_memory(device: torch.device) -> tuple[int, Optional[FragStats]]:
    """``(peak_bytes, frag_stats | None)`` from the card's caching
    allocator, the reference's device telemetry in PyTorch's terms.

    ``peak_bytes`` is ``torch.cuda.max_memory_allocated``.  ``capacity`` is
    the card's memory (``torch.cuda.mem_get_info``'s total, as XLA's
    ``bytes_limit`` is the allocator's limit), ``used`` the bytes in live
    tensors (``memory_allocated``, XLA's ``bytes_in_use``), ``free`` the
    difference.  ``largest_free`` is the largest block the next allocation
    can take whole: the larger of the largest inactive block cached in the
    allocator's segments (``torch.cuda.memory_snapshot()``) and the card's
    memory not yet reserved (``mem_get_info``'s free, which one
    ``cudaMalloc`` maps whole).  On the CPU there is no allocator
    telemetry: ``(0, None)``, as the reference degrades."""
    if device.type != "cuda":
        return 0, None
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    peak = torch.cuda.max_memory_allocated(index)
    unreserved, capacity = torch.cuda.mem_get_info(index)
    used = torch.cuda.memory_allocated(index)
    cached = max((b["size"] for seg in torch.cuda.memory_snapshot()
                  if seg["device"] == index
                  for b in seg["blocks"] if b["state"] == "inactive"),
                 default=0)
    free = max(capacity - used, 0)
    largest = max(cached, unreserved)
    return peak, FragStats(capacity=capacity, used=used, free=free,
                           largest_free=largest,
                           frag_ratio=(1 - largest / free) if free else 0.0)


def _restore(ckpt, params, opt_state):
    """The latest checkpoint's step and optimizer state, its parameters
    copied into ``params``; ``(None, opt_state)`` when there is none."""
    step, restored, _ = ckpt.restore({"params": params, "opt": opt_state})
    if step is None:
        return None, opt_state
    with torch.no_grad():
        tree_map(lambda p, r: p.copy_(r), params, restored["params"])
    return step, restored["opt"]


def train_loop(cfg: ModelConfig, params, args, *,
               ckpt: Optional[CheckpointManager] = None,
               verbose: bool = True, on_step=None,
               result: Optional[TrainResult] = None) -> TrainResult:
    """Train ``params`` (in place, on their device) up to step
    ``args.steps`` on ``SyntheticLM`` batches, as the reference's loop
    does: with ``ckpt``, resume after its latest checkpoint and save at its
    cadence; the divergence guard skips a bad step's update and, after
    ``max_skips`` in a row, restores the latest checkpoint.
    ``on_step(step)``, if given, runs before each step (the caller resets
    kernel counters there, or interrupts the run); ``result``, if given, is
    the record to fill.  Its batches hold tokens only (``[B,S]``, or
    ``[B,S,K]`` for codebooks), so it refuses a model with ``cross``
    blocks, as the reference's loop fails on one."""
    refuse_like_reference(cfg, "train launcher")
    device = next(t for _, t in tree_items(params)).device
    # The reference's choices: Adafactor at a constant rate, AdamW on the
    # cosine schedule.
    opt = (adafactor(lr=args.lr) if args.optimizer == "adafactor"
           else adamw(lr=cosine_schedule(args.lr, warmup=20,
                                         total=args.steps)))
    opt_state = opt.init(params)
    guard = DivergenceGuard()
    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum,
                              guard=guard)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed, n_codebooks=cfg.n_codebooks)
    monitor = StragglerMonitor()
    memmon = MemoryMonitor()
    on_card = device.type == "cuda"
    res = result if result is not None else TrainResult()
    start = None
    if ckpt is not None:
        start, opt_state = _restore(ckpt, params, opt_state)
    if start is not None:
        start += 1
        if verbose:
            print(f"resumed at step {start}")
    else:
        start = 0
    res.start_step, res.params, res.opt_state = start, params, opt_state
    res.straggler = monitor
    prefetch = Prefetcher(data, start_step=start)
    try:
        for step in range(start, args.steps):
            _, host_batch = prefetch.next()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host_batch.items()}
            if on_step is not None:
                on_step(step)
            with Timer() as t:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                if on_card:
                    torch.cuda.synchronize(device)
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            action = metrics["action"]
            res.steps.append(step)
            res.losses.append(loss)
            res.grad_norms.append(gn)
            res.actions.append(action)
            res.step_seconds.append(t.seconds)
            res.opt_state = opt_state
            if action == "skip":
                if verbose:
                    print(f"step {step}: bad step ({loss=:.3g}) — skipped")
                continue
            if action == "restore":
                s = None
                if ckpt is not None:
                    s, opt_state = _restore(ckpt, params, opt_state)
                    res.opt_state = opt_state
                if s is not None and verbose:
                    print(f"step {step}: restored from {s}")
                continue
            st = monitor.record(step, t.seconds, loss, gn)
            peak, frag = device_memory(device)
            ms = memmon.record(step, peak, frag=frag)
            res.peak_bytes = max(res.peak_bytes, peak)
            if verbose and (step % 10 == 0 or step == args.steps - 1):
                mem = f" mem {peak/1e6:.0f}MB" if peak else ""
                if frag is not None:
                    mem += (f" free_blk {ms.largest_free/1e6:.0f}MB"
                            f" frag {ms.frag_ratio:.2f}")
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {gn:7.3f} {t.seconds*1e3:6.0f} ms" + mem
                      + (" [straggler]" if st.flagged else ""), flush=True)
            if ckpt is not None:
                ckpt.maybe_save(step, {"params": params, "opt": opt_state},
                                extra={"data_step": step})
    finally:
        prefetch.stop()
    res.memory = ms = memmon.summary()
    if verbose:
        frag_note = ("" if ms["min_largest_free"] is None else
                     f" min_free_blk {ms['min_largest_free']/1e6:.0f}MB"
                     f" max_frag {ms['max_frag_ratio']:.2f}")
        print(f"mem summary: peak {ms['peak_bytes']/1e6:.0f}MB" + frag_note)
    return res


def main(argv=None, *, on_step=None,
         result: Optional[TrainResult] = None) -> TrainResult:
    """The CLI: always checkpoints (every ``--ckpt-every`` steps, the last
    two kept), as the reference's does.  ``on_step`` and ``result`` are
    :func:`train_loop`'s."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    with launch_mesh(args.mesh, device.type, fsdp=args.fsdp,
                     seq_shard=args.seq_shard):
        gen = torch.Generator(device).manual_seed(args.seed)
        params = M.init_params(cfg, gen)
        n = sum(int(np.prod(t.shape)) for _, t in tree_items(params))
        print(f"arch={cfg.name} params={n/1e6:.1f}M device={device} "
              f"mesh={args.mesh} remat={cfg.remat} fsdp={args.fsdp} "
              f"ga={args.grad_accum}")
        ckpt = CheckpointManager(args.ckpt_dir,
                                 every_steps=args.ckpt_every, keep=2)
        res = train_loop(cfg, params, args, ckpt=ckpt, on_step=on_step,
                         result=result)
    print("done")
    return res


if __name__ == "__main__":
    main()
