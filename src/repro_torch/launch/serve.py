"""Serving driver: continuous-batching greedy decode loop.

A request queue feeds a fixed-width decode batch; finished slots are
immediately refilled from the queue (continuous batching).  Each slot
carries its own position clock.  On the card every decode step runs the
model's attention through the Hopper flash-attention kernel (mixtral's
sliding-window layers against ring-buffer caches) and, for an MoE model,
each layer's expert FFN through the Hopper grouped-GEMM kernel, three
launches per layer; rwkv6's decode is the one-token recurrence in plain
PyTorch and launches no kernel.  The rest is plain PyTorch.

The counterpart of ``repro.launch.serve`` with its flags and defaults
(``--arch llama3.2-1b``): ``--mesh host`` is the (1, 1) mesh of the one
card; ``production`` and ``multipod`` need a world of 256 and 512 ranks
and fail, as the reference's do, on one (``launch/mesh.py``).

  python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 8 --slots 4 --gen 16
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke \\
      --device cpu --requests 6 --slots 2 --gen 8 --max-len 32
  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
      --device cpu --requests 8 --slots 4 --gen 8 --max-len 32 \\
      --kv-budget 0.3 --chaos-shrink 0.5 --chaos-period 16 \\
      --capture s.log --offload-sweep

The full mixtral-8x7b (46.7 B parameters) does not fit one card;
``chip_smoke.py`` serves it at full width with its depth cut to 4 layers.

``--capture PATH`` additionally records the executed per-request/slot
operator stream as a DTR log: every admission, decode step, preemption and
retirement the loop actually performs is mirrored into the trace.  The
requests are drawn from numpy's ``default_rng(0)``, as in the JAX package's
driver, so both serve the same requests and capture the same log.

``--kv-budget FRAC`` turns on admission control (``launch.admission``):
requests are priced at their projected KV footprint against FRAC of the
whole cache, and one that does not fit preempts the cheapest-to-
rematerialize slot, which requeues with bounded retries and backoff;
``--chaos-shrink`` squeezes that budget periodically (``faults``).
``--offload-sweep`` replays the captured trace over device and host
budgets through the hybrid remat-or-offload tier (``offload``).
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import configs
from ..core.graph import Log
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_items
from ..trace.capture import WorkloadTrace, step_model_from_config
from .steps import make_serve_step, refuse_like_reference



@dataclass
class ServeResult:
    completed: dict            # request id -> generated tokens
    steps: int                 # decode steps run
    seconds: float             # wall time of the loop (after set-up)
    log: Optional[Log] = None  # the captured trace, with --capture
    # With --kv-budget: the admission controller's counters and events.
    counters: Optional[dict] = None
    events: list = field(default_factory=list)


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
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (continuous batching slots)")
    ap.add_argument("--requests", type=int, default=12,
                    help="requests to serve")
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--max-len", type=int, default=128,
                    help="KV cache length per slot")
    ap.add_argument("--capture", default=None, metavar="PATH",
                    help="record the executed operator stream as a DTR "
                         "trace log")
    ap.add_argument("--kv-budget", type=float, default=None, metavar="FRAC",
                    help="admission control: cap the projected KV footprint "
                         "of admitted requests at FRAC x the full cache "
                         "size; overflow preempts the cheapest-to-"
                         "rematerialize slot and requeues it with bounded "
                         "retries + backoff (None: off)")
    ap.add_argument("--admit-retries", type=int, default=3,
                    help="max requeues per request before rejection")
    ap.add_argument("--admit-backoff", type=int, default=8,
                    help="base requeue backoff in decode steps (doubles "
                         "per retry, capped)")
    ap.add_argument("--chaos-shrink", type=float, default=0.0,
                    help="periodically shrink the admission KV budget to "
                         "this fraction (a co-tenant stealing device "
                         "memory); 0 = off")
    ap.add_argument("--chaos-period", type=int, default=64,
                    help="squeeze period in decode steps")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the squeeze schedule")
    ap.add_argument("--offload-sweep", action="store_true",
                    help="after capture, replay the captured trace through "
                         "the hybrid remat-or-offload tier: the per-slot KV "
                         "chunks and activations become offload candidates "
                         "(weights stay pinned)")
    ap.add_argument("--device-fracs", nargs="+", type=float,
                    default=[0.5, 0.3],
                    help="device budgets, as fractions of the activation "
                         "range (offload sweep)")
    ap.add_argument("--host-fracs", nargs="+", type=float,
                    default=[0.0, 0.5, 1.0],
                    help="host-tier budgets, as fractions of the activation "
                         "range; 0 = DTR-only baseline (offload sweep)")
    ap.add_argument("--offload-bw", type=float, default=2.0,
                    help="transfer bandwidth relative to the trace's "
                         "characteristic bandwidth (peak bytes per unit "
                         "baseline compute)")
    ap.add_argument("--device", default=None,
                    help="torch device (None: cuda; the CPU runs only "
                         "when asked for)")
    args = ap.parse_args(argv)
    if args.offload_sweep and not args.capture:
        ap.error("--offload-sweep needs --capture (it replays the "
                 "captured trace)")
    return args


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
    cast to ``cfg.dtype`` are cast once here, not at every use.  Its token
    buffer is ``[slots, 1]`` and it passes no image, as the reference's
    loop: it refuses a codebook model and one with ``cross`` blocks.
    """
    refuse_like_reference(cfg, "serve launcher")
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

    # Optional admission control + preemption-with-requeue
    # (launch.admission): requests are priced at their projected KV
    # footprint against a fraction of the full cache size; a request that
    # cannot fit preempts the cheapest-to-rematerialize slot instead of the
    # loop dying or the request silently queueing forever.  Default off:
    # the loop below is the plain one without --kv-budget.
    admit = None
    tickets = {}
    if args.kv_budget is not None:
        from .admission import ADMIT, REJECT, AdmissionController, Ticket
        cache_bytes = sum(leaf.nbytes for leaf in leaves)
        per_tok = cache_bytes / (args.slots * args.max_len)
        chaos = None
        if args.chaos_shrink > 0:
            from ..faults import FaultConfig, FaultSchedule
            chaos = FaultSchedule(FaultConfig(
                seed=args.chaos_seed, budget_shrink=args.chaos_shrink,
                budget_period=args.chaos_period))
        admit = AdmissionController(
            args.kv_budget * cache_bytes, per_tok,
            max_retries=args.admit_retries,
            backoff_steps=args.admit_backoff, faults=chaos)
        tickets = {rid: Ticket(rid, len(prompt), args.gen)
                   for rid, prompt in queue}

    # True continuous batching: each slot carries its own position clock,
    # so a finished slot is refilled on the very next global step while its
    # neighbors keep decoding.
    slots = [None] * args.slots
    tok = np.zeros((args.slots, 1), np.int32)
    pos = np.zeros(args.slots, np.int32)
    completed = {}
    steps = 0

    def reset_slot_cache(i):
        """Zero slot ``i``'s rows of every ``[layers, slots, ...]`` cache
        leaf, so a recurrent state (rwkv's, which carries no position and
        is not masked by it) starts the new request clean.  Attention
        caches (dense or ring) are position-masked, so for them this is
        hygiene."""
        for leaf in leaves:
            leaf[:, i].zero_()

    def admit_into(i, rid, prompt):
        slots[i] = {"rid": rid, "prompt": prompt, "i": 0, "out": []}
        pos[i] = 0
        reset_slot_cache(i)

    def active_map():
        """slot -> (Ticket, tokens processed) for the controller."""
        return {j: (tickets[s["rid"]], int(pos[j]))
                for j, s in enumerate(slots) if s is not None}

    def preempt(j, tick):
        """Preempt slot ``j``: its KV chunks are dropped (a DTR eviction of
        the whole request) and the request requeues with backoff; replaying
        it later is the rematerialization."""
        s = slots[j]
        admit.requeue(tickets[s["rid"]], tick)
        queue.append((s["rid"], s["prompt"]))
        if tracer is not None and s["i"] > 0:
            tracer.retire(s["rid"], j)
        slots[j] = None
        pos[j] = 0
        reset_slot_cache(j)

    def refill(tick=0):
        fresh = set()   # admitted this pass: not preemption candidates
        for i in range(args.slots):
            if slots[i] is None and queue:
                if admit is None:
                    admit_into(i, *queue.popleft())
                    continue
                # Arrival order, but requests backing off or waiting for
                # space do not block eligible ones behind them.
                for k in range(len(queue)):
                    rid, prompt = queue[k]
                    verdict, victims = admit.decide(
                        tickets[rid],
                        {j: v for j, v in active_map().items()
                         if j not in fresh}, tick)
                    if verdict == REJECT:
                        del queue[k]
                        break
                    if verdict == ADMIT:
                        del queue[k]
                        for j in victims:
                            preempt(j, tick)
                        admit_into(i, rid, prompt)
                        fresh.add(i)
                        break

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tick = idle = 0
    with torch.inference_mode():
        while queue or any(s is not None for s in slots):
            if admit is not None:
                # Injected budget squeeze (a co-tenant stole device
                # memory): shed load until usage fits again.
                for j in admit.enforce(active_map(), tick):
                    preempt(j, tick)
            refill(tick)   # mid-stream: neighbors keep their positions
            if not any(s is not None for s in slots):
                if admit is None or not queue:
                    break
                # Everything queued is backing off or waiting out a
                # squeeze: idle ticks pass without decode work.  The guard
                # bounds pathological schedules (e.g. a permanent squeeze
                # no request fits under).
                tick += 1
                idle += 1
                if idle > 10000:
                    for rid, _ in queue:
                        admit.rejected += 1
                        admit._event("reject", rid=rid, step=tick,
                                     reason="idle_guard")
                    queue.clear()
                    break
                continue
            idle = 0
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
            tick += 1
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
                    if admit is not None:
                        admit.retire(tickets[s["rid"]])
                    slots[i] = None
    dt = time.perf_counter() - t0

    log = None
    if tracer is not None:
        log = tracer.finish()
        with open(args.capture, "w") as f:
            f.write(log.dumps() + "\n")
    return ServeResult(completed, steps, dt, log,
                       None if admit is None else admit.counters(),
                       [] if admit is None else admit.events)


def report(args, res: ServeResult, device) -> None:
    """The reference driver's summary lines, then the offload sweep."""
    print(f"served {len(res.completed)}/{args.requests} requests, "
          f"{res.steps} decode steps, {res.seconds:.2f}s "
          f"({res.seconds / max(res.steps, 1) * 1e3:.1f} ms/step batched "
          f"x{args.slots}) on {device}")
    if res.counters is not None:
        c = res.counters
        print(f"admission: admitted={c['admitted']} "
              f"completed={c['completed']} requeued={c['requeued']} "
              f"rejected={c['rejected']} "
              f"preemptions={c['preemptions']} "
              f"(kv_budget={args.kv_budget:.2f}x cache)")
    for rid in sorted(res.completed)[:4]:
        print(f"  req{rid}: {res.completed[rid][:10]}...")
    if res.log is not None:
        print(f"captured trace {res.log.name}: {res.log.op_count()} ops "
              f"-> {args.capture}")
        if args.offload_sweep:
            _offload_sweep(res.log, args.device_fracs, args.host_fracs,
                           args.offload_bw)


def _offload_sweep(log, device_fracs, host_fracs, bw_rel,
                   heuristic="h_dtr_eq"):
    """Replay a captured serve trace over a device × host budget grid.

    The host tier gives the serving loop a second lever for its dominant
    memory consumer: per-slot KV chunks (and layer activations) can be
    parked in host memory over the modeled channels instead of being
    recomputed, whichever the two-choice policy prices cheaper.  Budgets
    scan the activation range (weights are pinned and cannot move);
    ``host_frac=0`` is the plain DTR baseline.
    """
    from ..core.simulator import measure_baseline, resolve_budget, simulate
    from ..offload import OffloadConfig

    peak, base_cost = measure_baseline(log)
    pinned = log.pinned_bytes()
    span = max(peak - pinned, 0.0)
    bw = bw_rel * peak / max(base_cost, 1e-12)
    print(f"offload sweep [{log.name}]: peak={peak:.4g} pinned={pinned:.4g} "
          f"bw={bw:.4g} bytes/unit-compute")
    for f in device_fracs:
        budget = resolve_budget(f, peak, pinned, "activation")
        for hf in host_fracs:
            if hf <= 0:
                r = simulate(log, heuristic, budget)
                tag = "dtr-only "
            else:
                cfg = OffloadConfig(host_budget=hf * span,
                                    h2d_bandwidth=bw, d2h_bandwidth=bw)
                r = simulate(log, heuristic, budget, offload=cfg)
                tag = f"host={hf:.2f}"
            state = (f"overhead={r.overhead:.3f} "
                     f"(compute {r.slowdown:.3f}x, stall {r.stall_time:.3g}) "
                     f"offloads={r.offloads} fetches={r.fetches} "
                     f"prefetch_hits={r.prefetch_hits}"
                     if r.ok else f"FAIL({r.error[:48]})")
            print(f"  dev={f:.2f} {tag}: {state}")


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    # serve_loop refuses too, but only after the weights are drawn.
    refuse_like_reference(cfg, "serve launcher")
    from .mesh import launch_mesh
    with launch_mesh(args.mesh, device.type):
        params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
        res = serve_loop(cfg, params, args)
    report(args, res, device)
    return res


if __name__ == "__main__":
    main()
