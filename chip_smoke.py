#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero before the last line is printed:

1. The card's name and power limit; TF32 off; every kernel under
   ``src/repro_torch/kernels/csrc/`` built from source, all in parallel
   (registers and spills of each kernel from ``-Xptxas -v``).
2. Each kernel against its plain PyTorch version on the card, each line
   naming the variant that ran: flash attention and the grouped GEMM run f32
   on their CUDA-core (``simt``) variants and bf16 on the tensor-core
   (``wgmma``) variants where the wrapper's plan sends it.  Flash
   attention: the JAX package's kernel-test sweep in f32 and bf16, the
   serve path's decode shape with mixed ``kv_len``, and one prefill-sized
   shape.  The MoE grouped GEMM: the JAX package's kernel-test sweep and
   ragged shapes in f32 and bf16, mixtral's decode shapes and a prefill
   shape.  The RWKV6 forward and backward kernels: rwkv6-1.6b's train shape
   ``[128,1024,64]``, the smoke head dim 32, a ragged S and both ends of the
   model's clipped decay, f32 on ``simt`` and bf16 on both the chunked
   tensor-core variant (``mma``, as planned) and ``simt``; the backward
   against autograd through the plain version, all five gradients; two
   ``mma`` backward calls at the train shape give the same bits.  The flash
   backward (``csrc/flash_attention_bwd.cu``): a forward that saves the
   LSE, held to ``flash_reference_lse``, then dq/dk/dv against
   ``flash_backward_reference`` on the same output and LSE, f32 (``simt``)
   and bf16 (``wgmma`` where planned, at D 64, with the earlier ``mma``
   design forced beside it, and ``simt``), GQA 14/2 and 32/8, ragged
   lengths, a window, qwen2's train shape ``[4,14,2048,64]``, and a second
   call's bits on every variant.
3. Each serve path at full width, with seeded random weights, 8 requests
   over 4 slots, 16 tokens each, ``--capture``: qwen2-0.5b (24 layers),
   then mixtral-8x7b with its depth cut to 4 layers (the 32-layer model
   does not fit one card).  Kernel launch counts, in all and per variant,
   are reset just before each path and read just after; every bf16 launch
   of phases 3-5 must go to the ``wgmma`` variants.  Then each smoke config
   served on the card and on the CPU gives the same tokens.
4. Path parity, per model: one full-width decode step through the kernels
   and through the plain versions, on the same parameters, cache and tokens;
   and layer 0 alone (below).
5. Times of each kernel, its CUDA-core variant (the previous design, on the
   same inputs), its plain version and the PyTorch library call at the
   decode and prefill shapes, beside the least time the card could take:
   device time per call from the profiler (the kernels' own time, which the
   kernel table reports) and wall time per call from CUDA events around
   back-to-back calls (host dispatch included).  Then, per model, one
   full-width decode step, wall and device-busy time, through the kernels,
   through the CUDA-core variants only and through the plain versions.

6. rwkv6-1.6b training (after the serve models free their tensors): the
   smoke config trains 3 steps (gradient accumulation 2) on the card and on
   the CPU from the same weights and batches; at full width with depth cut
   to 2 layers, one step's loss and gradients through the kernels against
   the plain path, in f32 and bf16; then the full 24-layer model trains 4
   steps at batch 4 x 1024 (bf16 activations, f32 parameters, AdamW) with
   remat none and 1 with remat full, counting each step's kernel launches
   per variant (every bf16 WKV launch on ``mma``).  Times of both WKV
   kernels (``mma``, ``simt`` on the same inputs, the plain versions) beside
   each variant's bound, and of one full-width train step (wall, device
   busy, tokens/s, the card's idle share, the WKV kernels' device time per
   call inside it).

   Then qwen2-0.5b training (after rwkv6 frees its tensors): the flash
   forward (saving the LSE) and backward at the train shape beside their
   bounds, the plain versions and SDPA's forward and backward timed apart,
   the backward on ``wgmma`` with its passes' device times, beside ``mma``
   and ``simt`` on the same inputs;
   at full width cut to 2 layers, batch 4 x 2048, loss and gradients
   through the kernels against the plain path in f32 and bf16; all 24
   layers under remat none, full, dots and dtr (flash launches 24 + 24,
   then 48 + 24, every bf16 forward on ``wgmma`` and every backward on
   the ``wgmma`` backward;
   ``max_memory_allocated`` per policy; loss and gradients
   bit-identical to none's; the step-0 loss against the plain path's); the
   train loop (AdamW, remat none, 3 steps: the main path's launches); one
   Adafactor and one SGDM step; one step's wall, device busy, idle share,
   tokens/s and the flash kernels' device time inside it; the train CLI
   with a named policy and Adafactor.

7. The eager DTR executor (``repro_torch.eager``) on the card, f32, after
   rwkv6 frees its tensors; it reaches none of the kernels.  (a) The chain
   of ``tests/test_eager.py`` at 64 MiB a tensor under a 5-tensor budget:
   evictions and rematerializations, every value bit-equal to the chain at
   no budget, and after every call ``memory_allocated`` above the start
   equal to ``live_bytes()`` (within one allocation and 512 B a tensor),
   ``live_bytes()`` within the budget and one allocation.  (b) The eager MLP
   train loop of ``capture_eager_mlp`` at card width (512 MiB activations),
   4 steps: at no budget against the same torch calls made directly (the
   executor's bookkeeping an op); then under fractions of that run's
   measured peak, losses and weights bit-identical, the peak within the
   budget and one activation, evictions and, with h_dtr_local,
   rematerializations; a budget below the loop's floor is refused.  (c) The
   same with the host tier: offloads and fetches through pinned host
   tensors, the same bits, host bytes within their budget.  (d) Phase 3's
   captured qwen2-0.5b serve log through the port's copy of the engine:
   ``check_log``, then scan == index replay.

8. The trace-time DTR planner on real bytes: fig4's tagged MLP stack at d
   4096, 8 layers, batch 8192, f32, a checkpoint region a layer, traced on
   fake tensors, planned at 0.8 and 0.7 of its traced peak (planning wall
   printed) and run as ``dtr_checkpoint`` applies each plan, then as one
   region: gradients bit-identical to the unplanned step,
   ``max_memory_allocated`` beside the budget and the plan's estimate; 0.6
   and 0.4, below the floor of the parameters and their gradients, refused.
   Then the full-width qwen2-0.5b train-step capture: its peak beside the
   card's step under remat none, ``check_log`` and scan == index at 0.9.

Phase 4 also holds layer 0 alone in bf16 (attention output, MLP or MoE
output), kernel against plain on the same inputs, to the kernels' own
tolerances.  The qwen2 phases run first and free their tensors before
mixtral's 36 GB (f32 weights and their bf16 copy) arrive; rwkv6 comes
next, the eager executor last.  Then one JSON line per kernel table, the
card line, and ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM, dense (NVIDIA's data sheet): memory rate and peak rates by type.
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
ARCH = "qwen2-0.5b"
MOE_ARCH = "mixtral-8x7b"
# Full width; 4 layers hold 24.3 GB of f32 weights and a 12.1 GB bf16 copy.
MOE_LAYERS = 4
# Kernel against plain version: f32 differs only in summation order; bf16
# adds one rounding of the output (the JAX package's kernel tolerances).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MOE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Full-width decode step, kernel path against plain path.  In f32 the two
# differ by summation order only.  In bf16 they round a few attention outputs
# to the other side, and 24 layers of random weights amplify that: qwen2's
# bf16 step, kernel vs plain, is 63.66 of max|logits| 142.3 against the plain
# path's own bf16-vs-f32 distance 85.54 (measured on an H100 80GB HBM3 at
# 700 W; PERF.md), and on the CPU at 4 layers the port's bf16 step lies 3.625
# from JAX's, inside JAX's own 3.861 of 295.4 (tests/test_torch_bf16_width.py).
# So the whole-step bound (the plain path's own bf16-vs-f32 distance) bounds
# little, and layer 0's attention and MLP (MoE) outputs are also held alone,
# before any amplification, to the kernels' own tolerances (TOL, MOE_TOL).
PARITY_F32 = 1e-3
SWEEP = [  # tests/test_kernels.py: (b, hq, hkv, sq, skv, d, causal, window)
    (1, 2, 2, 128, 128, 64, True, 0), (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 1, 256, 256, 64, True, 0), (2, 2, 2, 128, 128, 64, False, 0),
    (1, 2, 2, 256, 256, 64, True, 64), (1, 2, 2, 64, 256, 64, True, 0),
    (1, 2, 2, 96, 96, 32, True, 0), (1, 2, 2, 128, 128, 128, True, 0),
]
DECODE = dict(b=4, hq=14, hkv=2, sq=1, skv=128, d=64, kv_len=(1, 37, 128, 90))
PREFILL = dict(b=1, hq=14, hkv=2, sq=2048, skv=2048, d=64, kv_len=None)
# mixtral's decode attention: 32/8 heads of 128 against a 128-row ring.
MOE_ATTN_DECODE = dict(b=4, hq=32, hkv=8, sq=1, skv=128, d=128,
                       kv_len=(4, 41, 91, 128))
GEMM_SWEEP = [  # (e, c, d, f): tests/test_kernels.py's sweep, then ragged
    (4, 128, 256, 128), (8, 64, 128, 256), (2, 256, 512, 64),
    (1, 128, 128, 128), (3, 40, 200, 72), (5, 33, 48, 40),
]
# mixtral decode, 4 slots x capacity 8 = 32 rows per expert: wi/wg, wo.
GEMM_DECODE = {"wi": (8, 32, 4096, 14336), "wo": (8, 32, 14336, 4096)}
# One 2048-token request: capacity ceil(2048 * 2 / 8 * 1.25) = 640.
GEMM_PREFILL = (8, 640, 4096, 14336)
RWKV_ARCH = "rwkv6-1.6b"
# rwkv6-1.6b's train shape, batch 4 x 32 heads over 1024 steps of 64.
WKV_TRAIN = (128, 1024, 64)
# (bh, s, d, log-decay): None draws -exp(U[-4, 1.2]) (the JAX kernel test's
# range); a number holds every step there.  -e^4 and -e^-8 are the two ends
# of the model's clipped decay.
WKV_SHAPES = [WKV_TRAIN + (None,), (8, 32, 32, None), (6, 37, 64, None),
              (16, 256, 64, -math.exp(4.0)), (16, 256, 32, -math.exp(-8.0))]
# Forward against plain: the JAX package's rwkv6 kernel tolerances.
WKV_TOL = {"float32": 3e-4, "bfloat16": 4e-2}
# Backward against autograd through the plain version, per gradient,
# relative to its largest magnitude: f32 sums of up to S * D terms in another
# order; in bf16 gr/gk/gv are rounded once on both sides (2^-8 of a value).
WKV_GRAD_REL = {"float32": 1e-3, "bfloat16": 1e-2}
# Smoke training, card against CPU, 3 AdamW steps (eps 1e-3, as the CPU
# tests take it, so the step is Lipschitz in the gradient): losses and
# parameters in f32.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = 1e-5
# Full-width rwkv6 cut to 2 layers: loss and gradients, kernel path against
# plain path in f32, as ||d|| / ||grad|| of the worst leaf.  The two paths
# differ by the recurrence's summation order (~1e-7 relative) and by the
# order of atomic adds in the embedding's backward.
TRAIN_PARITY_F32 = 1e-3
RWKV_PARITY_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
# The kernels one call of each WKV wrapper launches on ``mma`` (D 64), by the
# profiler's names: span pass, scan over spans, output or backward pass.
# Phase 7, the eager DTR executor.  7a: test_eager.py's chain at card size,
# 20 ops over 64 MiB f32 tensors under a 5-tensor budget.
CHAIN_N, CHAIN_OPS, CHAIN_BUDGET = 16 << 20, 20, 5
# The caching allocator rounds every block up to 512 B.
ALLOC_ROUND = 512
# 7b: capture_eager_mlp's op stream at card width (an activation is
# 512 MiB); lr 1e-5 keeps the losses finite and falling at this width.
MLP = dict(steps=4, batch=8192, din=4096, dh=16384, lr=1e-5)
MLP_ACT = 4 * MLP["batch"] * MLP["dh"]
# Budgets as fractions of the unbounded run's peak.  0.7: h_dtr_eq (the
# default).  0.5 lies below the loop's floor (relu's backward holds three
# activations and the pinned inputs, 0.68 of the peak), so the engine must
# refuse it; h_dtr_eq meets every budget above the floor by evicting tensors
# no later op reads, so h_dtr_local at 0.8 is the run that rematerializes.
MLP_RUNS = (("h_dtr_eq", 0.7), ("h_dtr_local", 0.8))
MLP_INFEASIBLE = 0.5
# 7c: the host tier, bandwidths in bytes per op (unit costs).
MLP_OFFLOAD = dict(host_budget=8 * MLP_ACT, h2d_bandwidth=4 * MLP_ACT,
                   d2h_bandwidth=4 * MLP_ACT)
# 7d: fractions of the captured serve log's baseline peak.
SERVE_FRACTIONS = (0.9, 0.6)
# The flash backward against its plain version (phase 2): (b, hq, hkv, sq,
# skv, d, causal, window).  GQA 14/2 (qwen2) and 32/8 (mixtral), lengths
# that are not multiples of 64, a window with Sq < Skv, then qwen2's train
# shape.  Each of dq/dk/dv within this share of its max|.|: f32 sums the
# same products in another order; bf16 rounds each gradient once.
FLASH_TRAIN = (4, 14, 2, 2048, 2048, 64, True, 0)
FLASH_BWD_CASES = [(2, 4, 2, 128, 128, 64, True, 0),
                   (1, 14, 2, 100, 100, 64, True, 0),
                   (1, 14, 2, 77, 131, 64, True, 33),
                   (1, 32, 8, 96, 96, 128, True, 0),
                   (2, 4, 1, 64, 96, 32, False, 0), FLASH_TRAIN]
FLASH_BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# The forward's row log-sum-exp, f32 on both sides.
LSE_TOL = 1e-4
# qwen2-0.5b training (phases 5, 6): full width, batch 4 x 2048.
QWEN_BATCH, QWEN_SEQ = 4, 2048
QWEN_PARITY_LAYERS = 2
QWEN_REMATS = ("none", "full", "dots", "dtr")
# The kernels one bf16 flash call launches, by the profiler's names.
FLASH_STEP_KERNELS = {"flash_attention": ("flash_wgmma_kernel",),
                      "flash_attention_bwd": ("flash_bwd_rowstat_kernel",
                                              "flash_bwd_dkdv_wgmma_kernel",
                                              "flash_bwd_reduce_kernel",
                                              "flash_bwd_dq_wgmma_kernel")}
# The kernels of the `mma` backward, the design before `wgmma`, timed beside
# it at the train shape.
FLASH_MMA_BWD_KERNELS = ("flash_bwd_delta_kernel",
                         "flash_bwd_dkdv_mma_kernel",
                         "flash_bwd_dq_mma_kernel")
# Phase 8: fig4's tagged MLP stack (benchmarks/fig4_overhead.py) widened
# from d 128, batch 256 to d 4096, batch 8192 (an activation of 512 MiB),
# 8 layers, f32; planned at fractions of its traced peak.  The parameters
# (4.3 GB) and their gradients hold 0.6 of that peak at the step's end, so
# 0.6 and 0.4 lie below its floor: the planner must refuse them.
PLAN_MLP = dict(d=4096, layers=8, batch=8192)
PLAN_FRACTIONS = (0.8, 0.7)
PLAN_INFEASIBLE = (0.6, 0.4)
CAPTURE_FRACTION = 0.9
WKV_STEP_KERNELS = {
    "rwkv6_fwd": ("span_kernel<64, false>", "scan_kernel<false>",
                  "fwd_kernel<64>"),
    "rwkv6_bwd": ("span_kernel<64, true>", "scan_kernel<true>",
                  "bwd_kernel<64>"),
}


def require(cond, what) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def inputs(torch, shape, dtype, gen):
    b, hq, hkv, sq, skv, d = (shape[k] for k in
                              ("b", "hq", "hkv", "sq", "skv", "d"))
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(dtype)
    kv_len = None if shape["kv_len"] is None else torch.tensor(
        shape["kv_len"], dtype=torch.int32, device="cuda")
    return q, k, v, kv_len


def gemm_inputs(torch, shape, dtype, gen):
    """x ~ N(0, 1), w ~ N(0, 1/d): outputs of unit scale."""
    e, c, d, f = shape
    x = torch.randn(e, c, d, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(e, d, f, generator=gen, device="cuda")
         / math.sqrt(d)).to(dtype)
    return x, w


def compare(torch, kernel, plain, args, kw, tol, what):
    before = dict(getattr(kernel, "variant_launches", {}))
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    ran = [v for v, n in getattr(kernel, "variant_launches", {}).items()
           if n != before.get(v)]
    expect = plain(*args, **kw)
    err = (out.float() - expect.float()).abs().max().item()
    ok = torch.allclose(out.float(), expect.float(), rtol=tol, atol=tol)
    print(f"  {what}{' [' + ran[0] + ']' if ran else ''}: "
          f"max_abs_err={err!r} tol={tol} {'ok' if ok else 'FAIL'}")
    require(ok and math.isfinite(err),
            f"kernel disagrees with plain version: {what}")
    return err


def event_ms(torch, fn, iters):
    """Mean time of one call: CUDA events around ``iters`` back-to-back
    calls.  Where the host enqueues slower than the card runs (small
    kernels, eager model steps), this is the host's rate."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, top=0, by_name=None, per_call=None):
    """Device time of one call (kernels only, no launch gaps) from the
    profiler; None where it sees no device time.  Only the device's own
    events count: a CPU operator's entry repeats its kernels' time.  With
    ``top``, also prints the ``top`` kernels by device time per call; a
    dict ``by_name`` receives each kernel's (ms per call, launches per
    call).  ``per_call``: the launches one call makes; a session that
    recorded fewer is incomplete (after a long run the profiler has come
    back with a part of a session's kernels) and is run again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # A session that follows one of thousands of kernels (a plain scan, a
    # train step) has come back with no device events on the H100; such a
    # session is run again, up to three times.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = sorted(((e.self_device_time_total, e.count, e.key)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         reverse=True)
        total_us = sum(us for us, _, _ in kernels)
        seen = sum(count for _, count, _ in kernels)
        if total_us > 0 and (per_call is None or seen >= per_call * iters):
            break
        print(f"  profiler saw {seen} kernels, {total_us!r} us (attempt "
              f"{attempt + 1}); profiling again")
        total_us = 0
    for us, count, name in kernels[:top]:
        print(f"  {us / 1e3 / iters:9.3f} ms/call {100 * us / total_us:5.1f}% "
              f"x{count // iters} {name[:100]}")
    if by_name is not None:
        by_name.update({name: (us / 1e3 / iters, count / iters)
                        for us, count, name in kernels})
    return total_us / 1e3 / iters if total_us > 0 else None


def bound(nbytes, flops, dtype_name):
    """The larger of bytes over the memory rate and operations over the
    peak rate for the type, in ms, and which of the two it is."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound_ms(shape, causal, itemsize, dtype_name):
    """Least time for the attention function on this input: each input read
    once and the output written once, over the memory rate; q.k and p.v
    FLOPs of the visible (query, key) pairs only, over the peak rate."""
    b, hq, hkv, sq, skv, d = (shape[k] for k in
                              ("b", "hq", "hkv", "sq", "skv", "d"))
    lens = shape["kv_len"] or (skv,) * b
    pairs = 0
    for n in lens:
        for i in range(sq):
            pairs += min(n, i + n - sq + 1) if causal else n
    kv_rows = sum(lens)       # only the keys below kv_len are needed
    nbytes = (2 * b * hq * sq * d + 2 * kv_rows * hkv * d) * itemsize \
        + (4 * b if shape["kv_len"] else 0)
    return bound(nbytes, 4 * hq * d * pairs, dtype_name)


def gemm_bound_ms(shape, itemsize, dtype_name):
    """Least time for the grouped GEMM: x, w read once and the output
    written once; 2 FLOPs per multiply-add of every row (the inputs here
    have no empty rows)."""
    e, c, d, f = shape
    return bound((e * c * d + e * d * f + e * c * f) * itemsize,
                 2 * e * c * d * f, dtype_name)


def causal_pairs(b, sq, skv):
    """Visible (query, key) pairs of one head under a bottom-right causal
    mask, over the batch."""
    return b * sum(min(skv, i + skv - sq + 1) for i in range(sq))


def flash_bwd_bound_ms(case, itemsize):
    """Least time for the attention backward: q, k, v, o, dO and the f32
    LSE read once and dq, dk, dv written once, over the memory rate,
    against its five score-area products (S, dP, dV, dQ, dK: 2 * D FLOPs
    each per visible pair and query head) at the bf16 tensor-core peak."""
    b, hq, hkv, sq, skv, d, causal, window = case
    require(causal and window == 0, "bound for causal, unwindowed calls")
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * skv * d) * itemsize \
        + 4 * b * hq * sq
    return bound(nbytes, 10 * hq * d * causal_pairs(b, sq, skv), "bfloat16")


def flash_bwd_checks(torch, gen) -> float:
    """Phase 2 for the flash backward: the train forward's output and LSE
    against ``flash_reference_lse``, the backward kernels against
    ``flash_backward_reference`` on the same output and LSE, and a second
    call's bits; bf16 on the planned variant, on ``mma`` where it takes the
    shape (D 64) and on ``simt``.  Returns the bf16 train shape's max abs
    errors, forward and backward (both ``wgmma``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    print("phase 2: flash_attention_bwd against flash_backward_reference")
    train_err = None
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for case in FLASH_BWD_CASES:
            b, hq, hkv, sq, skv, d, causal, window = case
            shape = dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                         kv_len=None)
            q, k, v, _ = inputs(torch, shape, dtype, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            before = read_variants()["flash_attention"]
            out, lse = fa._forward(q, k, v, causal, window, None,
                                   save_lse=True)
            fwd_variant = ran_variant({
                v_: n - before[v_] for v_, n in
                read_variants()["flash_attention"].items()})
            want_out, want_lse = ref.flash_reference_lse(
                q, k, v, causal=causal, window=window)
            lse_err = (lse - want_lse).abs().max().item()
            out_err = (out.float() - want_out.float()).abs().max().item()
            out_ok = math.isfinite(out_err) and torch.allclose(
                out.float(), want_out.float(), rtol=TOL[dtype_name],
                atol=TOL[dtype_name])
            expect = ref.flash_backward_reference(
                q, k, v, out, lse, do, causal=causal, window=window)
            planned = fa.plan_backward(b, hq, hkv, sq, skv, d,
                                       dtype)["variant"]
            forced = ("mma",) if dtype == torch.bfloat16 and d == 64 else ()
            for variant in dict.fromkeys((planned, *forced, "simt")):
                before = read_variants()["flash_attention_bwd"]
                with backward_on(variant):
                    grads = fa.flash_attention_bwd(
                        q, k, v, out, lse, do, causal=causal, window=window)
                    again = fa.flash_attention_bwd(
                        q, k, v, out, lse, do, causal=causal, window=window)
                torch.cuda.synchronize()
                ran = ran_variant({
                    v_: n - before[v_] for v_, n in
                    read_variants()["flash_attention_bwd"].items()})
                require(ran == variant, f"planned {variant}, ran {ran}")
                rels, err = [], 0.0
                for g, e in zip(grads, expect):
                    require(g.dtype == dtype
                            and bool(torch.isfinite(g).all()),
                            f"finite flash gradients {case}")
                    d_ = (g.float() - e.float()).abs().max().item()
                    rels.append(d_ / e.float().abs().max().item())
                    err = max(err, d_)
                same = all(bool(torch.equal(a, b_))
                           for a, b_ in zip(grads, again))
                ok = (max(rels) <= FLASH_BWD_REL[dtype_name] and same
                      and lse_err <= LSE_TOL and out_ok)
                print(f"  {dtype_name} {case} fwd [{fwd_variant}] out "
                      f"max_abs_err={out_err!r} (tol {TOL[dtype_name]}), lse "
                      f"max|d|={lse_err!r} (tol {LSE_TOL}); bwd [{variant}] "
                      f"max|d|/max|g| q,k,v = "
                      f"{[float(f'{x:.3g}') for x in rels]} (limit "
                      f"{FLASH_BWD_REL[dtype_name]}); second call same "
                      f"bits: {same} {'ok' if ok else 'FAIL'}")
                require(ok, f"flash backward kernel against plain: "
                        f"{dtype_name} {case} {variant}")
                if (case == FLASH_TRAIN and dtype_name == "bfloat16"
                        and variant == "wgmma"):
                    require(fwd_variant == "wgmma",
                            "bf16 train forward on wgmma")
                    train_err = {"fwd": out_err, "bwd": err}
                del grads, again
            del q, k, v, do, out, lse, expect, want_out
    return train_err


@contextmanager
def plain_kernels(ops, ref):
    """Route the model's kernels to their plain versions, CUDA tensors
    too."""
    kernels = ops.flash_attention, ops.moe_gemm, ops.rwkv6_chunk
    ops.flash_attention = ref.flash_reference
    ops.moe_gemm = ref.moe_gemm_reference
    ops.rwkv6_chunk = ref.rwkv6_reference
    try:
        yield
    finally:
        ops.flash_attention, ops.moe_gemm, ops.rwkv6_chunk = kernels


@contextmanager
def simt_only():
    """Plan every flash (forward and backward), grouped-GEMM and WKV call
    onto its CUDA-core variant (the previous design; the forwards as for an
    unaligned input, the backward by its ``simt`` schedule): the same
    kernels' time before this design, on the same inputs and card."""
    from repro_torch.kernels import flash_attention as fa, moe_gemm as mg
    from repro_torch.kernels import rwkv6_chunk as wkv
    plans = [(m, m.plan) for m in (fa, mg, wkv)]
    for m, plan in plans:
        m.plan = lambda *a, plan=plan, **k: plan(
            *a, **dict(k, aligned=False))
    try:
        with backward_on("simt"):
            yield
    finally:
        for m, plan in plans:
            m.plan = plan


@contextmanager
def backward_on(variant):
    """Plan every flash backward call onto ``variant``'s schedule (the
    planned one, ``mma`` or ``simt``) for the duration."""
    from repro_torch.kernels import flash_attention as fa
    plan_backward = fa.plan_backward
    fa.plan_backward = lambda *shape: fa.backward_schedule(variant,
                                                           *shape[:6])
    try:
        yield
    finally:
        fa.plan_backward = plan_backward


def require_wgmma_backward(counts, what) -> None:
    """Every flash backward launch of a bf16 path went to ``wgmma``."""
    require(counts["wgmma"] > 0 and sum(counts.values()) == counts["wgmma"],
            f"{what}: flash backward launches off wgmma {counts}")


def _wrappers():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.rwkv6_chunk import rwkv6_bwd, rwkv6_fwd
    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd, "moe_gemm": moe_gemm,
            "rwkv6_fwd": rwkv6_fwd, "rwkv6_bwd": rwkv6_bwd}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "variant_launches"):
            fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_variants() -> dict:
    """Launches per variant of the kernels that have several."""
    return {name: dict(fn.variant_launches)
            for name, fn in _wrappers().items()
            if hasattr(fn, "variant_launches")}


def ran_variant(counts) -> str:
    """The variant, or variants joined by '+', that a run's counts show."""
    return "+".join(v for v, n in counts.items() if n)


def require_wgmma(variants, what) -> None:
    """Every bf16 launch of a path went to a tensor-core variant."""
    require(all(v["simt"] == 0 for v in variants.values()),
            f"{what}: bf16 launches on the CUDA-core variant {variants}")


def time_row(torch, fns, iters, bound_ms_by, what, card, per_call=None,
             passes=None):
    """Device and event time of each named call, beside the bound.  A name
    that starts with ``simt`` is timed with its wrappers planned onto the
    CUDA-core variants, one that starts with ``mma`` with the flash
    backward on its ``mma`` schedule.  ``per_call`` maps a name to the
    kernels one call launches (see ``device_ms``); ``passes`` maps a name to
    the kernel names whose device ms per call the row also keeps, under
    ``<name>_passes``."""
    row = {}
    for name, fn in fns:
        forced = (simt_only() if name.startswith("simt") else
                  backward_on("mma") if name.startswith("mma") else
                  nullcontext())
        by_name = {}
        with forced:
            row[name] = device_ms(torch, fn, iters,
                                  by_name=by_name,
                                  per_call=(per_call or {}).get(name))
            require(row[name] is not None, f"profiler device time, {name}")
            row[name.replace("ms", "wall_ms")] = event_ms(torch, fn, iters)
        if name in (passes or {}):
            row[f"{name}_passes"] = {
                part: sum(ms for n, (ms, _) in by_name.items() if part in n)
                for part in passes[name]}
    row["bound_ms"], row["bound_by"] = bound_ms_by
    print(f"phase 5: {what}: " + ", ".join(
        f"{k}={v!r}" for k, v in row.items()) + f" [{card}]")
    return row


def model_phases(torch, arch, cfg, smoke_flags, card, gen) -> tuple:
    """Phases 3-5 for one model at full width: serve, decode-step parity,
    decode-step times.  Returns the serve path's launch counts, in all and
    per variant, and its captured log.  Every tensor it makes is freed when
    it returns."""
    from repro_torch import configs
    from repro_torch.core.graph import Log
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import TORCH_DTYPES, tree_map

    # -- 3. serve at full width ----------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        args = serve.parse_args([
            "--arch", arch, "--requests", "8", "--slots", "4", "--gen", "16",
            "--max-len", "128", "--capture", f"{tmp}/serve.log"])
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        reset_launches()
        res = serve.serve_loop(cfg, params, args)
        launches = read_launches()
        variants = read_variants()
        log = Log.loads(Path(args.capture).read_text())
    tokens = sum(len(t) for t in res.completed.values())
    print(f"phase 3: {arch} ({cfg.n_layers} layers): served "
          f"{len(res.completed)}/8 requests, {res.steps} "
          f"decode steps, {res.seconds * 1e3 / res.steps:.3f} ms/step, "
          f"{tokens / res.seconds:.1f} tokens/s, flash_attention "
          f"launches={launches['flash_attention']}, moe_gemm "
          f"launches={launches['moe_gemm']}, per variant {variants}, "
          f"captured {log.op_count()} ops, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    require(cfg.dtype == "bfloat16", f"{arch} serves in {cfg.dtype}")
    require_wgmma(variants, f"phase 3, {arch} serve")
    require(len(res.completed) == 8, f"completed {sorted(res.completed)}")
    require(all(len(t) == 16 and all(0 <= x < cfg.vocab for x in t)
                for t in res.completed.values()), f"tokens {res.completed}")
    require(launches["flash_attention"] == res.steps * cfg.n_layers,
            f"{launches['flash_attention']} flash launches for "
            f"{res.steps} steps x {cfg.n_layers}")
    moe_per_step = 3 * cfg.n_layers if cfg.moe else 0
    require(launches["moe_gemm"] == res.steps * moe_per_step,
            f"{launches['moe_gemm']} moe_gemm launches for {res.steps} "
            f"steps x {moe_per_step}")
    require(0 < log.op_count() == res.log.op_count(), "captured log")

    smoke = configs.get_smoke(arch)
    small = serve.parse_args(["--arch", arch, "--smoke"] + smoke_flags)
    cpu_params = M.init_params(smoke, torch.Generator().manual_seed(0))
    on_cpu = serve.serve_loop(smoke, cpu_params, small).completed
    on_card = serve.serve_loop(smoke, tree_map(lambda t: t.cuda(),
                                                cpu_params), small).completed
    print(f"  smoke config, card against CPU: {on_card == on_cpu}")
    require(on_card == on_cpu, f"card {on_card} cpu {on_cpu}")

    # -- 4. path parity ------------------------------------------------------
    base = tree_map(lambda c: torch.randn(c.shape, generator=gen,
                                          device="cuda"),
                    M.cache_defs(cfg, 4, 128))
    tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor([3, 40, 90, 127], dtype=torch.int32, device="cuda")

    def cache_in(dtype):
        return tree_map(lambda t: t.to(dtype, copy=True), base)

    def step_logits(dtype, plain):
        c = cfg.replace(dtype=dtype)
        cache = cache_in(TORCH_DTYPES[dtype])
        reset_launches()
        with torch.inference_mode(), (plain_kernels(ops, ref) if plain
                                      else nullcontext()):
            logits, _ = M.decode_step(c, M.prepare_params(c, params), tok,
                                      cache, pos)
        torch.cuda.synchronize()
        if not plain:
            variants = read_variants()
            print(f"  {arch} {dtype} decode step, launches per variant "
                  f"{variants}")
            want = "wgmma" if dtype == "bfloat16" else "simt"
            require(all(v[want] == sum(v.values()) > 0 or
                        (name == "moe_gemm" and not cfg.moe)
                        for name, v in variants.items()
                        if name in ("flash_attention", "moe_gemm")),
                    f"{dtype} decode step on the {want} variants")
        require(bool(torch.isfinite(logits).all())
                and logits.shape == (4, 1, cfg.vocab),
                f"finite {dtype} logits of shape [4, 1, vocab]")
        return logits.float()

    k32, p32 = step_logits("float32", False), step_logits("float32", True)
    k16, p16 = step_logits("bfloat16", False), step_logits("bfloat16", True)
    scale = p32.abs().max().item()
    d32 = (k32 - p32).abs().max().item()
    d16 = (k16 - p16).abs().max().item()
    noise = (p16 - p32).abs().max().item()
    agree = (k16.argmax(-1) == p16.argmax(-1)).float().mean().item()
    print(f"phase 4: {arch} full-width decode step, kernel vs plain: "
          f"f32 max|d|={d32!r} (limit {PARITY_F32} x max|logits|="
          f"{scale!r}); bf16 max|d|={d16!r} (limit: the plain path's own "
          f"bf16-vs-f32 max|d|={noise!r}); bf16 argmax agreement "
          f"{agree:.2f}")
    require(d32 <= PARITY_F32 * scale, f"f32 parity {d32} > {PARITY_F32} x "
            f"{scale}")
    require(d16 <= noise, f"bf16 parity {d16} > bf16 rounding noise {noise}")
    layer0_bf16(torch, arch, cfg, params, base, tok, pos)

    # -- 5. decode-step times ------------------------------------------------
    prepared = M.prepare_params(cfg, params)
    for path, ctx in (("kernel", nullcontext), ("simt kernel", simt_only),
                      ("plain", lambda: plain_kernels(ops, ref))):
        cache = cache_in(torch.bfloat16)

        def run():
            with torch.inference_mode():
                M.decode_step(cfg, prepared, tok, cache, pos)

        reset_launches()
        with ctx():
            step_ms = event_ms(torch, run, 20)
            busy_ms = device_ms(torch, run, 5)
        print(f"phase 5: {arch} full-width decode step, bf16, 4 slots, "
              f"{path} path: {step_ms!r} ms, device busy {busy_ms!r} ms, "
              f"launches per variant {read_variants()} [{card}]")
        if path == "kernel":
            require_wgmma(read_variants(), f"phase 5, {arch} decode step")
    return launches, variants, log


def layer0_bf16(torch, arch, cfg, params, cache, tok, pos) -> None:
    """Phase 4, per layer: layer 0's attention output and its MLP (MoE)
    output in bf16 through the kernels and through the plain versions, each
    pair on the same inputs, held to the kernels' own tolerances."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import tree_map
    c = cfg.replace(dtype="bfloat16")
    p16 = M.prepare_params(c, params)
    p0 = tree_map(lambda t: t[0], p16["groups"])["slot0"]
    window = cfg.window if cfg.pattern[0] == "attn_local" else 0
    ffn = MOE.moe_apply if cfg.moe else L.mlp_apply
    out = {}
    with torch.inference_mode():
        x = L.embed_apply(c, p16["embed"], tok)
        h = L.rmsnorm_apply(c, p0["norm1"], x)
        for plain in (False, True):
            kv = tree_map(lambda t: t[0].to(torch.bfloat16, copy=True),
                          cache["groups"])["slot0"]["attn"]
            with plain_kernels(ops, ref) if plain else nullcontext():
                out["attn", plain], _ = L.attention_apply(
                    c, p0["attn"], h, positions=pos[:, None], window=window,
                    cache={**kv, "pos": pos})
        h2 = L.rmsnorm_apply(c, p0["norm2"], x + out["attn", True])
        for plain in (False, True):
            with plain_kernels(ops, ref) if plain else nullcontext():
                out["ffn", plain] = ffn(c, p0["ffn"], h2)
    torch.cuda.synchronize()
    for part, tol in (("attn", TOL["bfloat16"]),
                      ("ffn", (MOE_TOL if cfg.moe else TOL)["bfloat16"])):
        k, p = out[part, False].float(), out[part, True].float()
        err = (k - p).abs().max().item()
        ok = bool(torch.isfinite(k).all()) and torch.allclose(
            k, p, rtol=tol, atol=tol)
        print(f"phase 4: {arch} layer 0 {part} output, bf16, kernel vs plain:"
              f" max|d|={err!r} of max|out|={p.abs().max().item()!r} "
              f"(tol {tol}) {'ok' if ok else 'FAIL'}")
        require(ok, f"{arch} layer 0 {part} output in bf16, kernel vs plain")


def wkv_bound_ms(shape, itemsize, backward, variant):
    """Least time for the WKV recurrence on [BH,S,D] inputs: bytes of r, k,
    v (``itemsize``), f32 logw, u (and for the backward f32 g in, gr/gk/gv
    out in r's dtype, f32 glogw, gu out) against its operations: per step
    4*D^2 forward (r.S and the state update); 12*D^2 backward (the state
    rebuilt, q = S g, the G recurrence, p = G v, G^T k and the glogw
    reduction).  The rate for those operations is the variant's: ``simt``
    runs them as f32 FMAs on the CUDA cores (67 TFLOP/s); ``mma`` runs the
    same products on the tensor cores with TF32 operands (495 TFLOP/s),
    where bytes bound both directions."""
    bh, s, d = shape
    n = bh * s * d
    if backward:
        nbytes = (3 * n * itemsize + 2 * n * 4 + bh * d * 4     # in
                  + 3 * n * itemsize + n * 4 + bh * d * 4)    # out
        flops = 12 * bh * s * d * d
    else:
        nbytes = 3 * n * itemsize + n * 4 + bh * d * 4 + n * 4  # in, out
        flops = 4 * bh * s * d * d
    return bound(nbytes, flops, "tf32" if variant == "mma" else "float32")


def wkv_inputs(torch, shape, logw, dtype, gen):
    """r, k, v ~ N(0,1) in ``dtype``; f32 logw (drawn or constant), u, and
    an output gradient g ~ N(0,1)."""
    bh, s, d = shape
    r, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if logw is None:
        wl = -torch.exp(torch.rand(bh, s, d, generator=gen, device="cuda")
                        * 5.2 - 4.0)
    else:
        wl = torch.full((bh, s, d), logw, device="cuda")
    u = torch.randn(bh, d, generator=gen, device="cuda") * 0.3
    g = torch.randn(bh, s, d, generator=gen, device="cuda")
    return (r, k, v, wl, u), g


def rwkv_kernel_checks(torch, gen) -> dict:
    """Phase 2 for the WKV kernels, each line naming the variant that ran.
    Returns the bf16 train shape's forward and backward max abs errors on
    ``mma``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_chunk import rwkv6_bwd, rwkv6_fwd
    print("phase 2: rwkv6_fwd / rwkv6_bwd against the plain version")
    errs = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        variants = ("simt",) if dtype_name == "float32" else ("mma", "simt")
        for bh, s, d, logw in WKV_SHAPES:
            args, g = wkv_inputs(torch, (bh, s, d), logw, dtype, gen)
            expect_out = ref.rwkv6_reference(*args)
            expect = ref.rwkv6_backward_reference(*args, g)
            for variant in variants:
                what = f"{dtype_name} [{bh},{s},{d}] logw={logw!r}"
                before = read_variants()
                with simt_only() if variant == "simt" else nullcontext():
                    out = rwkv6_fwd(*args)
                    grads = rwkv6_bwd(*args, g)
                torch.cuda.synchronize()
                after = read_variants()
                ran = {name: ran_variant({v: after[name][v] - before[name][v]
                                          for v in after[name]})
                       for name in ("rwkv6_fwd", "rwkv6_bwd")}
                require(ran == {"rwkv6_fwd": variant, "rwkv6_bwd": variant},
                        f"planned variant {variant}, ran {ran}: {what}")
                require(bool(torch.isfinite(out).all()),
                        f"finite fwd, {what}")
                fwd_err = compare(torch, lambda *a: out,
                                  lambda *a: expect_out, (), {},
                                  WKV_TOL[dtype_name],
                                  f"fwd [{variant}] {what}")
                rels, bwd_err = [], 0.0
                for name, a, b in zip(("r", "k", "v", "w_log", "u"), grads,
                                      expect):
                    require(a.dtype == b.dtype and a.shape == b.shape
                            and bool(torch.isfinite(a).all()),
                            f"finite {name} gradient, {what}")
                    err = (a.float() - b.float()).abs().max().item()
                    scale = b.float().abs().max().item()
                    rels.append(err / scale if scale > 0 else err)
                    bwd_err = max(bwd_err, err)
                ok = max(rels) <= WKV_GRAD_REL[dtype_name]
                print(f"  bwd [{variant}] {what}: max|d|/max|grad| "
                      f"r,k,v,w_log,u = "
                      f"{[float(f'{x:.3g}') for x in rels]} (limit "
                      f"{WKV_GRAD_REL[dtype_name]}) {'ok' if ok else 'FAIL'}")
                require(ok, f"backward kernel disagrees with autograd: "
                        f"{variant} {what}")
                if (bh, s, d) == WKV_TRAIN and variant == "mma":
                    errs = {"fwd": fwd_err, "bwd": bwd_err}
                    again = rwkv6_bwd(*args, g)
                    same = all(bool(torch.equal(a, b))
                               for a, b in zip(grads, again))
                    print(f"  bwd [mma] {what}: a second call gives the "
                          f"same bits: {same}")
                    require(same, "mma backward is not deterministic")
                    del again
                del out, grads
            del args, g, expect_out, expect
    return errs


def _leaf_rel(torch, a, b):
    """The worst leaf's relative distance ||a - b|| / ||b|| (Frobenius),
    and its path."""
    from repro_torch.models.params import tree_items
    worst = (0.0, "")
    for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
        y = y.to(x.device)
        ref_norm = torch.linalg.vector_norm(y.float()).item()
        err = torch.linalg.vector_norm(x.float() - y.float()).item()
        worst = max(worst, (err / ref_norm if ref_norm > 0 else err, path))
    return worst


def rwkv_train_phases(torch, card, gen) -> dict:
    """Phase 6: rwkv6-1.6b training; then the WKV kernels' and a train
    step's times.  Returns the kernel-table rows' numbers."""
    from repro_torch import configs, optim
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rwkv6_chunk import rwkv6_bwd, rwkv6_fwd
    from repro_torch.launch import train
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items, tree_map

    # -- 5. the WKV kernels' device times, before any large profile -------
    # ``mma`` as planned, then ``simt`` (the serial scan, whose time follows
    # the SM clock, printed beside it) on the same inputs.
    args, g = wkv_inputs(torch, WKV_TRAIN, None, torch.bfloat16, gen)
    rows = {}
    for name, fn, backward in (("rwkv6_fwd", lambda: rwkv6_fwd(*args), False),
                               ("rwkv6_bwd", lambda: rwkv6_bwd(*args, g),
                                True)):
        rows[name] = time_row(torch, (("ms", fn), ("simt_ms", fn)), 20,
                              wkv_bound_ms(WKV_TRAIN, 2, backward, "mma"),
                              f"{name} {list(WKV_TRAIN)} bf16, mma", card)
        simt_bound, simt_by = wkv_bound_ms(WKV_TRAIN, 2, backward, "simt")
        print(f"  {name} bound: mma {rows[name]['bound_ms']!r} ms "
              f"({rows[name]['bound_by']}, TF32 operations), simt "
              f"{simt_bound!r} ms ({simt_by}, f32 CUDA-core operations); SM "
              f"clock, power after it: {card_line('clocks.sm,power.draw')}")
    del args, g

    # -- 6.1 smoke config, card against CPU --------------------------------
    smoke = configs.get_smoke(RWKV_ARCH)
    data = SyntheticLM(vocab=smoke.vocab, seq_len=32, batch=4, seed=0)
    runs = {}
    for device in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(device), M.init_params(
            smoke, torch.Generator().manual_seed(0)))
        opt = optim.adamw(lr=optim.cosine_schedule(1e-3, warmup=1, total=3),
                          eps=1e-3)
        state = opt.init(params)
        step = make_train_step(smoke, opt, grad_accum=2)
        losses = []
        for i in range(3):
            batch = {"tokens": torch.from_numpy(
                data.batch_at(i)["tokens"]).to(device)}
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        runs[device] = (losses, tree_map(lambda t: t.cpu(), params))
    (l_cpu, p_cpu), (l_card, p_card) = runs["cpu"], runs["cuda"]
    loss_ok = all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
                  for a, b in zip(l_card, l_cpu))
    param_err = max((a - b).abs().max().item() for (_, a), (_, b)
                    in zip(tree_items(p_card), tree_items(p_cpu)))
    print(f"phase 6: {RWKV_ARCH} smoke, 3 steps (grad_accum 2), card vs "
          f"CPU: losses {l_card} vs {l_cpu} (rtol {TRAIN_LOSS_RTOL}); "
          f"params max|d|={param_err!r} (limit {TRAIN_PARAM_TOL})")
    require(loss_ok, "smoke train losses, card vs CPU")
    require(param_err <= TRAIN_PARAM_TOL, "smoke train params, card vs CPU")

    # -- 6.2 full width, 2 layers: kernel path against plain path ------------
    cut = configs.get(RWKV_ARCH).replace(n_layers=RWKV_PARITY_LAYERS)
    params = M.init_params(cut, torch.Generator("cuda").manual_seed(0))
    batch = {"tokens": torch.from_numpy(SyntheticLM(
        vocab=cut.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
        seed=0).batch_at(0)["tokens"]).cuda()}
    got = {}
    for dtype in ("float32", "bfloat16"):
        for plain in (False, True):
            with plain_kernels(ops, ref) if plain else nullcontext():
                loss, grads = loss_and_grads(cut.replace(dtype=dtype),
                                             params, batch)
            torch.cuda.synchronize()
            require(math.isfinite(float(loss)), f"finite {dtype} loss")
            got[dtype, plain] = (float(loss), grads)
    l32, g32 = got["float32", False]
    p32, gp32 = got["float32", True]
    l16, g16 = got["bfloat16", False]
    p16, gp16 = got["bfloat16", True]
    (d32, at32), (d16, at16), (noise, at_noise) = (
        _leaf_rel(torch, g32, gp32), _leaf_rel(torch, g16, gp16),
        _leaf_rel(torch, gp16, gp32))
    print(f"phase 6: {RWKV_ARCH} full width, {RWKV_PARITY_LAYERS} layers, "
          f"batch {TRAIN_BATCH}x{TRAIN_SEQ}, kernel vs plain: f32 loss "
          f"{l32!r} vs {p32!r}, worst leaf ||d||/||g|| {d32!r} ({at32}; "
          f"limit {TRAIN_PARITY_F32}); bf16 loss |d|={abs(l16 - p16)!r} "
          f"(limit: plain bf16-vs-f32 {abs(p16 - p32)!r}), worst leaf "
          f"{d16!r} ({at16}; limit: plain bf16-vs-f32 {noise!r}, "
          f"{at_noise})")
    require(abs(l32 - p32) <= TRAIN_PARITY_F32 * abs(p32), "f32 loss parity")
    require(d32 <= TRAIN_PARITY_F32, "f32 gradient parity")
    require(abs(l16 - p16) <= abs(p16 - p32), "bf16 loss parity")
    require(d16 <= noise, "bf16 gradient parity")
    del params, batch, got, g32, gp32, g16, gp16, grads
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6.3 full width, all 24 layers: the main path --------------------------
    cfg = configs.get(RWKV_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    runs = {}
    for remat, steps in (("none", 4), ("full", 1)):
        args = train.parse_args([
            "--arch", RWKV_ARCH, "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--remat", remat])
        per_step = []

        def on_step(i, per_step=per_step):
            if i:
                per_step.append((read_launches(), read_variants()))
            reset_launches()

        torch.cuda.reset_peak_memory_stats()
        res = train.train_loop(train.config_from_args(args), params, args,
                               verbose=False, on_step=on_step)
        per_step.append((read_launches(), read_variants()))
        runs[remat] = (res, per_step)
        fwd_per = (2 if remat == "full" else 1) * cfg.n_layers
        print(f"phase 6: {RWKV_ARCH} ({cfg.n_layers} layers) train, remat "
              f"{remat}, batch {TRAIN_BATCH}x{TRAIN_SEQ}: losses "
              f"{res.losses}, grad norms {res.grad_norms}, step ms "
              f"{[round(t * 1e3, 1) for t in res.step_seconds]}, launches "
              f"per step {[(c['rwkv6_fwd'], c['rwkv6_bwd']) for c, _ in per_step]}"
              f", per variant {[(v['rwkv6_fwd'], v['rwkv6_bwd']) for _, v in per_step]}"
              f", peak {res.peak_bytes / 2**30:.2f} GiB [{card}]")
        require(all(math.isfinite(x) for x in res.losses), "finite losses")
        require(all(c["rwkv6_fwd"] == fwd_per and
                    c["rwkv6_bwd"] == cfg.n_layers for c, _ in per_step),
                f"launches per step with remat {remat}")
        require(all(v[k]["mma"] == c[k] for c, v in per_step
                    for k in ("rwkv6_fwd", "rwkv6_bwd")),
                f"every bf16 WKV launch on mma with remat {remat}")
        for _, v in per_step:
            require_wgmma({k: v[k] for k in ("rwkv6_fwd", "rwkv6_bwd")},
                          f"phase 6, train with remat {remat}")
    first = runs["none"][0].losses[0]
    print(f"  step-0 loss {first!r}, ln(vocab) = {math.log(cfg.vocab)!r}")
    require(abs(first - math.log(cfg.vocab)) <= 0.5, "step-0 loss near ln V")
    main_launches = {k: sum(c[k] for c, _ in runs["none"][1])
                     for k in ("rwkv6_fwd", "rwkv6_bwd")}
    main_variants = {k: {var: sum(v[k][var] for _, v in runs["none"][1])
                         for var in runs["none"][1][0][1][k]}
                     for k in ("rwkv6_fwd", "rwkv6_bwd")}

    # -- 5. one full-width train step: wall, device busy, top kernels -------
    opt = optim.adamw(lr=optim.cosine_schedule(3e-4, warmup=20, total=100))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(SyntheticLM(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
        seed=0).batch_at(9)["tokens"]).cuda()}

    def one_step():
        nonlocal params, state
        params, state, m = step_fn(params, state, batch)
        return m

    print(f"phase 5: {RWKV_ARCH} full-width train step, kernels by device "
          f"time:")
    names = {}
    busy_ms = device_ms(torch, one_step, 1, top=12, by_name=names)
    require(busy_ms is not None, "profiler device time, train step")
    for name, parts in WKV_STEP_KERNELS.items():
        found = {p: sum(ms for n, (ms, _) in names.items() if p in n)
                 for p in parts}
        calls = main_launches[name] / len(runs["none"][1])
        print(f"  {name} inside the step: {sum(found.values()) / calls!r} ms "
              f"per call ({calls:g} calls; "
              + ", ".join(f"{p} {ms / calls!r}" for p, ms in found.items())
              + f") [{card}]")
    wall_ms = event_ms(torch, one_step, 2)
    print(f"  SM clock, power after it: {card_line('clocks.sm,power.draw')}")
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3)
    print(f"phase 5: {RWKV_ARCH} full-width train step, batch "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}, bf16, remat none: wall {wall_ms!r} ms"
          f", device busy {busy_ms!r} ms, idle share "
          f"{1 - busy_ms / wall_ms!r}, {tokens_per_s!r} tokens/s [{card}]")
    del params, state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. the plain versions last: each profile holds ~10^4 kernels ------
    args, g = wkv_inputs(torch, WKV_TRAIN, None, torch.bfloat16, gen)
    for name, fn in (
            ("rwkv6_fwd", lambda: ref.rwkv6_reference(*args)),
            ("rwkv6_bwd", lambda: ref.rwkv6_backward_reference(*args, g))):
        row = rows[name]
        row["plain_ms"] = device_ms(torch, fn, 2)
        row["plain_wall_ms"] = event_ms(torch, fn, 2)
        if row["plain_ms"] is None:   # see device_ms: fall back to events
            row["plain_ms"] = row["plain_wall_ms"]
            print(f"  {name} plain: no profiler device time; events only")
        row["launches"] = main_launches[name]
        row["variant"] = ran_variant(main_variants[name])
        how = " (autograd through it)" if name == "rwkv6_bwd" else ""
        print(f"phase 5: {name} plain version{how} {list(WKV_TRAIN)} bf16: "
              f"plain_ms={row['plain_ms']!r}, plain_wall_ms="
              f"{row['plain_wall_ms']!r} [{card}]")
    return rows


def _train_batch(torch, cfg, step=0):
    from repro_torch.data.pipeline import SyntheticLM
    return {"tokens": torch.from_numpy(SyntheticLM(
        vocab=cfg.vocab, seq_len=QWEN_SEQ, batch=QWEN_BATCH,
        seed=0).batch_at(step)["tokens"]).cuda()}


def _step_kernels_ms(names, parts, calls):
    """Device ms per call of a kernel inside a profiled step, from the
    profiler's per-name sums; and each part's."""
    found = {p: sum(ms for n, (ms, _) in names.items() if p in n)
             for p in parts}
    return sum(found.values()) / calls, {p: ms / calls
                                         for p, ms in found.items()}


def flash_train_times(torch, card, gen) -> dict:
    """Phase 5 for the flash kernels at qwen2's train shape, before any
    large profile: the forward that saves the LSE and the backward, beside
    their bounds, their plain versions and SDPA's forward and backward
    (timed apart)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, hq, hkv, sq, skv, d, _, _ = FLASH_TRAIN
    shape = dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d, kv_len=None)
    q, k, v, _ = inputs(torch, shape, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = fa._forward(q, k, v, True, 0, None, save_lse=True)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*xs, is_causal=True,
                                             enable_gqa=True)
    rows = {"fwd": time_row(torch, (
        ("ms", lambda: fa._forward(q, k, v, True, 0, None, save_lse=True)),
        ("plain_ms", lambda: ref.flash_reference_lse(q, k, v, causal=True)),
        ("library_ms", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))), 10,
        attention_bound_ms(shape, True, 2, "bfloat16"),
        f"flash_attention train forward {list(FLASH_TRAIN[:6])} bf16, "
        f"saving the LSE (library: SDPA forward)", card, {"ms": 1})}
    bwd = (lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                          causal=True))
    require(fa.plan_backward(*FLASH_TRAIN[:6], torch.bfloat16)["variant"]
            == "wgmma", "the train shape's backward planned on wgmma")
    rows["bwd"] = time_row(torch, (
        ("ms", bwd), ("mma_ms", bwd), ("simt_ms", bwd),
        ("plain_ms", lambda: ref.flash_backward_reference(
            q, k, v, out, lse, do, causal=True)),
        ("library_ms", lambda: torch.autograd.grad(
            lib_out, xs, do, retain_graph=True))), 5,
        flash_bwd_bound_ms(FLASH_TRAIN, 2),
        f"flash_attention_bwd {list(FLASH_TRAIN[:6])} bf16 (ms: wgmma; "
        f"mma_ms: the previous design; library: SDPA's backward alone)",
        card, {"ms": 4, "mma_ms": 3, "simt_ms": 3},
        {"ms": FLASH_STEP_KERNELS["flash_attention_bwd"],
         "mma_ms": FLASH_MMA_BWD_KERNELS})
    del q, k, v, do, out, lse, xs, lib_out
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def qwen_train_phases(torch, card) -> dict:
    """Phases 5 and 6 for qwen2-0.5b training at full width: 2 layers
    kernel vs plain; 24 layers under every remat policy; the main path (the
    train loop, AdamW, remat none); Adafactor and SGDM steps; the train
    CLI; one step's breakdown.  Returns the main path's flash launches,
    the flash kernels' device ms per call inside the step and each remat
    policy's ``max_memory_allocated``."""
    from repro_torch import configs, optim
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items, tree_map

    # -- 6.1 full width, 2 layers: kernel path against plain path ----------
    cut = configs.get(ARCH).replace(n_layers=QWEN_PARITY_LAYERS)
    params = M.init_params(cut, torch.Generator("cuda").manual_seed(0))
    batch = _train_batch(torch, cut)
    got = {}
    for dtype in ("float32", "bfloat16"):
        for plain in (False, True):
            reset_launches()
            with plain_kernels(ops, ref) if plain else nullcontext():
                loss, grads = loss_and_grads(cut.replace(dtype=dtype),
                                             params, batch)
            torch.cuda.synchronize()
            require(math.isfinite(float(loss)), f"finite {dtype} loss")
            if not plain:
                n = read_launches()
                require(n["flash_attention"] == n["flash_attention_bwd"]
                        == cut.n_layers, f"2-layer launches {n}")
            got[dtype, plain] = (float(loss), grads)
    l32, g32 = got["float32", False]
    p32, gp32 = got["float32", True]
    l16, g16 = got["bfloat16", False]
    p16, gp16 = got["bfloat16", True]
    (d32, at32), (d16, at16), (noise, at_noise) = (
        _leaf_rel(torch, g32, gp32), _leaf_rel(torch, g16, gp16),
        _leaf_rel(torch, gp16, gp32))
    print(f"phase 6: {ARCH} full width, {QWEN_PARITY_LAYERS} layers, batch "
          f"{QWEN_BATCH}x{QWEN_SEQ}, kernel vs plain: f32 loss {l32!r} vs "
          f"{p32!r}, worst leaf ||d||/||g|| {d32!r} ({at32}; limit "
          f"{TRAIN_PARITY_F32}); bf16 loss |d|={abs(l16 - p16)!r} (limit: "
          f"plain bf16-vs-f32 {abs(p16 - p32)!r}), worst leaf {d16!r} "
          f"({at16}; limit: plain bf16-vs-f32 {noise!r}, {at_noise})")
    require(abs(l32 - p32) <= TRAIN_PARITY_F32 * abs(p32), "f32 loss parity")
    require(d32 <= TRAIN_PARITY_F32, "f32 gradient parity")
    require(abs(l16 - p16) <= abs(p16 - p32), "bf16 loss parity")
    require(d16 <= noise, "bf16 gradient parity")
    del params, batch, got, g32, gp32, g16, gp16, grads
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6.2 all 24 layers under every remat policy ------------------------
    cfg = configs.get(ARCH)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    batch = _train_batch(torch, cfg)
    base, peaks = None, {}
    for remat in QWEN_REMATS:
        c = cfg.replace(remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(c, params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n, var = read_launches(), read_variants()
        peak = peaks[remat] = torch.cuda.max_memory_allocated()
        fwd_per = (1 if remat == "none" else 2) * cfg.n_layers
        if base is None:
            # On the host, so that every policy's peak holds the same
            # parameters and batch and nothing else.
            base = (float(loss), tree_map(lambda t: t.cpu(), grads))
            same, (rel, at) = True, (0.0, "")
        else:
            same = float(loss) == base[0] and all(
                bool(torch.equal(a, b_.to(a.device))) for (_, a), (_, b_) in
                zip(tree_items(grads), tree_items(base[1])))
            rel, at = _leaf_rel(torch, grads, base[1])
        print(f"phase 6: {ARCH} ({cfg.n_layers} layers) loss and grads, "
              f"remat {remat}, batch {QWEN_BATCH}x{QWEN_SEQ}: loss "
              f"{float(loss)!r}, flash launches fwd "
              f"{n['flash_attention']} bwd {n['flash_attention_bwd']}, per "
              f"variant {var['flash_attention']} "
              f"{var['flash_attention_bwd']}, max_memory_allocated "
              f"{peak / 2**30:.3f} GiB, {ms:.0f} ms (first call of the "
              f"policy); against remat none: bit-identical {same}, worst "
              f"leaf ||d||/||g|| {rel!r} {at} [{card}]")
        require(n["flash_attention"] == fwd_per and
                n["flash_attention_bwd"] == cfg.n_layers,
                f"launches with remat {remat}: {n}")
        require_wgmma({k_: var[k_] for k_ in FLASH_STEP_KERNELS},
                      f"phase 6, {ARCH} with remat {remat}")
        require_wgmma_backward(var["flash_attention_bwd"],
                               f"phase 6, {ARCH} with remat {remat}")
        require(float(loss) == base[0], f"loss with remat {remat}")
        require(rel <= TRAIN_PARITY_F32, f"gradients with remat {remat}")
        del loss, grads
    # The step-0 loss: qwen2 ties its unembedding to the N(0, 1) token
    # table (the reference's init_scale 1.0), so a random init's logits have
    # a spread of ~sqrt(d_model) and its loss lies far above ln V.  It is
    # held instead, in the forward alone, to the plain path at all 24
    # layers, by the bf16 rule.
    plain = {}
    for dtype in ("bfloat16", "float32"):
        with torch.no_grad(), plain_kernels(ops, ref):
            plain[dtype] = float(M.loss_fn(cfg.replace(dtype=dtype), params,
                                           batch))
    first = base[0]
    print(f"  step-0 loss {first!r} (ln V {math.log(cfg.vocab)!r}); plain "
          f"path bf16 {plain['bfloat16']!r}, f32 {plain['float32']!r}: "
          f"|kernel - plain| {abs(first - plain['bfloat16'])!r} (limit: "
          f"plain bf16-vs-f32 "
          f"{abs(plain['bfloat16'] - plain['float32'])!r})")
    require(abs(first - plain["bfloat16"])
            <= abs(plain["bfloat16"] - plain["float32"]),
            "24-layer step-0 loss, kernel vs plain")
    del base
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6.3 the main path: the train loop, AdamW, remat none --------------
    args = train.parse_args([
        "--arch", ARCH, "--steps", "3", "--batch", str(QWEN_BATCH),
        "--seq", str(QWEN_SEQ), "--remat", "none"])
    per_step = []

    def on_step(i):
        if i:
            per_step.append((read_launches(), read_variants()))
        reset_launches()

    torch.cuda.reset_peak_memory_stats()
    res = train.train_loop(train.config_from_args(args), params, args,
                           verbose=False, on_step=on_step)
    per_step.append((read_launches(), read_variants()))
    print(f"phase 6: {ARCH} ({cfg.n_layers} layers) train loop, AdamW, "
          f"remat none, batch {QWEN_BATCH}x{QWEN_SEQ}: losses {res.losses}, "
          f"grad norms {res.grad_norms}, step ms "
          f"{[round(t * 1e3, 1) for t in res.step_seconds]}, flash launches "
          f"per step "
          f"{[(c['flash_attention'], c['flash_attention_bwd']) for c, _ in per_step]}"
          f", peak {res.peak_bytes / 2**30:.2f} GiB [{card}]")
    require(all(math.isfinite(x) for x in res.losses), "finite losses")
    require(all(c["flash_attention"] == c["flash_attention_bwd"]
                == cfg.n_layers for c, _ in per_step),
            "flash launches per step in the train loop")
    for _, v in per_step:
        require_wgmma({k_: v[k_] for k_ in FLASH_STEP_KERNELS},
                      f"phase 6, {ARCH} train loop")
        require_wgmma_backward(v["flash_attention_bwd"],
                               f"phase 6, {ARCH} train loop")
    main_launches = {k: sum(c[k] for c, _ in per_step)
                     for k in FLASH_STEP_KERNELS}
    bwd_variants = {var: sum(v["flash_attention_bwd"][var]
                             for _, v in per_step)
                    for var in per_step[0][1]["flash_attention_bwd"]}

    # -- 6.4 Adafactor and SGD with momentum, one step each ------------------
    for name in ("adafactor", "sgdm"):
        opt = optim.make_optimizer(name, lr=1e-3)
        state = opt.init(params)
        before = params["embed"]["tokens"][:4].clone()
        params, state, m = make_train_step(cfg, opt)(
            params, state, _train_batch(torch, cfg, 5))
        moved = not torch.equal(before, params["embed"]["tokens"][:4])
        print(f"phase 6: {ARCH} one {name} step: loss {float(m['loss'])!r}, "
              f"grad norm {float(m['grad_norm'])!r}, parameters moved "
              f"{moved}")
        require(math.isfinite(float(m["loss"])) and moved, f"{name} step")
        del opt, state, m
        gc.collect()
        torch.cuda.empty_cache()

    # -- 5. one full-width train step: wall, device busy, top kernels -------
    opt = optim.adamw(lr=optim.cosine_schedule(3e-4, warmup=20, total=100))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    batch = _train_batch(torch, cfg, 9)

    def one_step():
        nonlocal params, state
        params, state, m = step_fn(params, state, batch)
        return m

    print(f"phase 5: {ARCH} full-width train step, kernels by device time:")
    names = {}
    busy_ms = device_ms(torch, one_step, 1, top=12, by_name=names)
    require(busy_ms is not None, "profiler device time, qwen2 train step")
    inside = {}
    for name, parts in FLASH_STEP_KERNELS.items():
        inside[name], each = _step_kernels_ms(names, parts, cfg.n_layers)
        print(f"  {name} inside the step: {inside[name]!r} ms per call "
              f"({cfg.n_layers} calls; {each}) [{card}]")
    wall_ms = event_ms(torch, one_step, 2)
    print(f"  SM clock, power after it: {card_line('clocks.sm,power.draw')}")
    tokens_per_s = QWEN_BATCH * QWEN_SEQ / (wall_ms / 1e3)
    print(f"phase 5: {ARCH} full-width train step, batch "
          f"{QWEN_BATCH}x{QWEN_SEQ}, bf16, AdamW, remat none: wall "
          f"{wall_ms!r} ms, device busy {busy_ms!r} ms, idle share "
          f"{1 - busy_ms / wall_ms!r}, {tokens_per_s!r} tokens/s [{card}]")
    del params, state, step_fn, batch, opt
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6.5 the train CLI, a policy by name and Adafactor -------------------
    train.main(["--arch", ARCH, "--steps", "1", "--batch", "1", "--seq",
                str(QWEN_SEQ), "--remat", "names:attn_out,ffn_out",
                "--optimizer", "adafactor"])
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": main_launches, "variants": bwd_variants,
            "inside": inside, "peaks": peaks}


def eager_chain(torch, card) -> None:
    """Phase 7a: the chain under a budget of real bytes on the card."""
    from repro_torch.eager import DTRContext
    size = 4 * CHAIN_N
    budget = CHAIN_BUDGET * size
    worst = {"held_minus_live": 0, "live_minus_budget": -budget}

    def check(ctx, base, bound):
        live = ctx.live_bytes()
        held = torch.cuda.memory_allocated() - base
        slack = size + ALLOC_ROUND * len(ctx.buffers)
        require(live <= bound + size, f"live {live} over budget {bound}")
        require(abs(held - live) <= slack,
                f"memory_allocated - base {held} against live {live}")
        worst["held_minus_live"] = max(worst["held_minus_live"],
                                       abs(held - live))
        worst["live_minus_budget"] = max(worst["live_minus_budget"],
                                         live - bound)

    def chain(bound):
        # Contexts die in reference cycles (the runtime's hooks are their
        # bound methods): collect earlier ones before taking the base.
        gc.collect()
        ctx = DTRContext(bound)
        base = torch.cuda.memory_allocated()
        vals = [ctx.wrap(torch.linspace(0, 1, CHAIN_N, device="cuda"))]
        for i in range(CHAIN_OPS):
            vals.append(ctx.call(f"f{i}", lambda a: torch.cos(a) * 1.01,
                                 [vals[-1]])[0])
            check(ctx, base, bound)
        return ctx, vals, base

    ref_ctx, ref, _ = chain(float("inf"))
    ctx, vals, base = chain(budget)
    same = True
    for v, r in zip(vals, ref):
        same &= bool(torch.equal(v.value, r.value))
        check(ctx, base, budget)
    print(f"phase 7a: chain of {CHAIN_OPS} ops over {size >> 20} MiB f32 "
          f"tensors, budget {budget >> 20} MiB: evictions "
          f"{ctx.rt.evictions}, remat runs {ctx.remat_runs}, every value "
          f"bit-equal to the unbounded chain: {same}; after every call and "
          f"read, max |memory_allocated - base - live_bytes| = "
          f"{worst['held_minus_live']} B, max live_bytes - budget = "
          f"{worst['live_minus_budget']} B [{card}]")
    require(ctx.rt.evictions > 0 and ctx.remat_runs > 0,
            "7a: evictions and rematerializations")
    require(same, "7a: values read back equal the unbounded chain's")
    del ctx, vals, ref_ctx, ref
    gc.collect()


class Direct:
    """The eager MLP's op stream with no DTR: each call runs at once."""

    class Handle:
        def __init__(self, t):
            self.value = t

        def release(self):
            self.value = None

    def __init__(self, torch):
        self.torch = torch

    def wrap(self, x, name=""):
        return Direct.Handle(self.torch.as_tensor(x, device="cuda"))

    def call(self, name, fn, args):
        out = fn(*[a.value if isinstance(a, Direct.Handle) else a
                   for a in args])
        return [Direct.Handle(o)
                for o in (out if isinstance(out, tuple) else (out,))]


def eager_mlp_run(torch, ctx):
    """One run of the eager MLP through ``ctx``: losses, final weights,
    wall ms of each step after the first, and the peak above the start."""
    from repro_torch.trace.capture import eager_mlp
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, stamps = [], []

    def on_loss(step, loss):
        losses.append(loss.value.item())     # waits for the card
        stamps.append(time.perf_counter())

    w1, w2 = eager_mlp(ctx, on_loss=on_loss, **MLP)
    weights = (w1.value.clone(), w2.value.clone())
    peak = torch.cuda.max_memory_allocated() - base
    steps_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return losses, weights, steps_ms, peak


def eager_mlp_phases(torch, card) -> None:
    """Phases 7b and 7c: the eager MLP train loop at card width under
    budgets, then with the host tier."""
    from repro_torch.core.runtime import OOMError
    from repro_torch.eager import DTRContext
    from repro_torch.offload import OffloadConfig
    from repro_torch.trace.capture import eager_mlp
    ops_per_step = 12
    direct = eager_mlp_run(torch, Direct(torch))
    gc.collect()
    ctx = DTRContext(float("inf"), use_wallclock_cost=False)
    ref = eager_mlp_run(torch, ctx)
    frees = ctx.rt.evictions          # no pressure: every one a release
    del ctx
    gc.collect()
    direct2 = eager_mlp_run(torch, Direct(torch))
    gc.collect()
    losses, (w1, w2), inf_ms, peak = ref
    direct_ms = direct[2] + direct2[2]
    print(f"phase 7b: eager MLP {MLP}, f32, no budget: losses {losses}, "
          f"peak {peak / 2**30:.3f} GiB, {frees} frees at release; step ms "
          f"{inf_ms} against the same "
          f"torch calls made directly {direct_ms}: "
          f"{(statistics.median(inf_ms) - statistics.median(direct_ms)) / ops_per_step!r}"
          f" ms of bookkeeping an op [{card}]")
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"7b: finite, falling losses {losses}")
    require(direct[0] == losses and torch.equal(direct[1][0], w1)
            and torch.equal(direct[1][1], w2),
            "7b: DTR with no budget gives the direct run's bits")

    def budgeted(heuristic, frac, offload=None):
        """One run under ``frac`` of the peak; its runtime's counters."""
        budget = frac * peak
        ctx = DTRContext(budget, heuristic=heuristic,
                         use_wallclock_cost=False, offload=offload)
        got_losses, (g1, g2), ms, got_peak = eager_mlp_run(torch, ctx)
        same = (got_losses == losses and bool(torch.equal(g1, w1))
                and bool(torch.equal(g2, w2)))
        # evictions counts the frees at release too (eager dealloc); the
        # victims that memory pressure chose are the picks.
        n = dict(evictions=ctx.rt.evictions, picks=ctx.rt.victim_picks,
                 remats=ctx.remat_runs, offloads=ctx.rt.offloads,
                 fetches=ctx.rt.fetches, host_bytes=ctx.host_bytes())
        remade = collections.Counter()     # remats by the op replayed
        for sid, k in ctx.rt._remat_counts.items():
            remade[ctx.rt.tensors[ctx.rt.storages[sid].root_tid].op.name] += k
        what = (f"{heuristic} at {frac} of the peak"
                + (" with the host tier" if offload else ""))
        print(f"phase 7{'c' if offload else 'b'}: {what} "
              f"({budget / 2**30:.3f} GiB): {n}, remats by op "
              f"{dict(remade)}; peak - budget "
              f"{(got_peak - budget) / 2**20:.1f} MiB (limit "
              f"{MLP_ACT >> 20}); losses and weights bit-identical to no "
              f"budget: {same}; step ms {ms} against {inf_ms} with no budget "
              f"[{card}]")
        require(same, f"7b/c: {what}: the bits of the unbounded run")
        require(got_peak <= budget + MLP_ACT,
                f"7b/c: {what}: peak {got_peak} over budget + one activation")
        del ctx
        gc.collect()
        return n

    n = budgeted(*MLP_RUNS[0])
    require(n["picks"] > 0, f"7b: evictions under pressure at {MLP_RUNS[0]}")
    n = budgeted(*MLP_RUNS[1])
    require(n["picks"] > 0 and n["remats"] > 0,
            f"7b: evictions under pressure and rematerializations at "
            f"{MLP_RUNS[1]}")
    ctx = DTRContext(MLP_INFEASIBLE * peak, use_wallclock_cost=False)
    refused = None
    try:
        eager_mlp(ctx, **MLP)
    except OOMError as e:
        refused = str(e)
    print(f"phase 7b: h_dtr_eq at {MLP_INFEASIBLE} of the peak, below the "
          f"loop's floor: refused: {refused}")
    require(refused is not None,
            "7b: a budget below the loop's floor must raise OOMError")
    del ctx
    gc.collect()
    cfg = OffloadConfig(**MLP_OFFLOAD)
    n = budgeted(*MLP_RUNS[0], offload=cfg)
    require(n["offloads"] > 0 and n["fetches"] > 0,
            "7c: offloads and fetches")
    require(n["host_bytes"] <= cfg.host_budget, "7c: host bytes in budget")


def serve_log_replay(log) -> None:
    """Phase 7d: the captured qwen2-0.5b serve log through the copied
    engine: the static checker, then scan == index replay."""
    from repro_torch.check import check_log
    from repro_torch.trace.replay import verify_oracle_equivalence
    t0 = time.perf_counter()
    check_log(log)
    rep = verify_oracle_equivalence(log, fractions=SERVE_FRACTIONS)
    runs = rep["index_results"].values()
    print(f"phase 7d: {log.name} ({log.op_count()} ops): check_log ok; "
          f"scan == index over {rep['cells']} cells at {SERVE_FRACTIONS} of "
          f"the baseline peak {rep['baseline_peak']!r}: {rep['ok']} "
          f"(mismatches {rep['mismatches']}); evictions "
          f"{sum(r.evictions for r in runs)}, remats "
          f"{sum(r.remat_ops for r in runs)}; "
          f"{time.perf_counter() - t0:.1f} s")
    require(rep["ok"], "7d: scan and index replays differ")


def planner_phase(torch, card, train_peak) -> None:
    """Phase 8: the DTR planner on real bytes.  fig4's tagged MLP stack at
    card width, a checkpoint region a layer, traced on fake tensors,
    planned at fractions of its traced peak and run as ``dtr_checkpoint``
    applies each plan (gradients against the unplanned run,
    ``max_memory_allocated`` beside the budget and the plan's estimate,
    planning wall), then as one region for contrast; then the full-width
    qwen2-0.5b train-step capture through the checker and both replay
    engines, its peak beside ``train_peak`` (the card's, remat none)."""
    from repro_torch.check import check_log
    from repro_torch.core import planner, remat, simulator
    from repro_torch.kernels.ref import Q_BLOCK
    from repro_torch.trace.capture import capture_train_step
    from repro_torch.trace.replay import verify_oracle_equivalence
    d, layers, batch = PLAN_MLP["d"], PLAN_MLP["layers"], PLAN_MLP["batch"]
    g = torch.Generator("cuda").manual_seed(0)
    params = [{"w1": torch.randn(d, 4 * d, generator=g, device="cuda") * 0.02,
               "w2": torch.randn(4 * d, d, generator=g, device="cuda") * 0.02}
              for _ in range(layers)]
    x = torch.randn(batch, d, generator=g, device="cuda")

    def layer(i, p, h):
        a = remat.tag(torch.nn.functional.gelu(h @ p["w1"],
                                               approximate="tanh"), f"act{i}")
        return h + remat.tag(a @ p["w2"], f"proj{i}")

    def fwd(params, x):
        for i, p in enumerate(params):
            x = remat.region(partial(layer, i))(p, x)
        return x

    def grads_of(f):
        return planner.grad_of_sum(lambda pp, xx: torch.mean(f(pp, xx) ** 2))

    t0 = time.perf_counter()
    traced = planner.trace_to_log(grads_of(fwd), params, x)
    trace_ms = (time.perf_counter() - t0) * 1e3
    peak, _ = simulator.measure_baseline(traced.log)

    def run(f):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = grads_of(f)(params, x)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(), \
            (time.perf_counter() - t0) * 1e3

    ref_grads, ref_peak, ref_ms = run(fwd)
    # On the host, so that every run's peak holds the same parameters and
    # input and nothing else.
    ref_grads = [t.cpu() for t in ref_grads]
    print(f"phase 8: fig4 MLP stack {PLAN_MLP}, f32, a region a layer: "
          f"traced on fake tensors in {trace_ms:.0f} ms "
          f"({traced.log.op_count()} ops), traced peak "
          f"{peak / 2**30:.3f} GiB; unplanned step: max_memory_allocated "
          f"{ref_peak / 2**30:.3f} GiB, {ref_ms:.0f} ms [{card}]")
    for frac in PLAN_FRACTIONS:
        t0 = time.perf_counter()
        ck, plan = planner.dtr_checkpoint(fwd, params, x,
                                          budget_bytes=frac * peak,
                                          grad_fn=grads_of(fwd))
        plan_ms = (time.perf_counter() - t0) * 1e3
        require(plan.feasible and plan.remat_names,
                f"8: a feasible plan that rematerializes at {frac}")
        print(f"phase 8: planned at {frac} of the traced peak "
              f"({frac * peak / 2**30:.3f} GiB): planning wall {plan_ms:.0f} "
              f"ms (the trace included), remat {plan.remat_names}, est "
              f"slowdown {plan.est_slowdown!r}, est_peak_bytes "
              f"{plan.est_peak_bytes / 2**30:.3f} GiB")
        for how, f in (("a region per layer, as dtr_checkpoint applies it",
                        ck),
                       ("one region over the stack",
                        remat.checkpointed(fwd, plan.policy()))):
            grads, real_peak, ms = run(f)
            same = all(bool(torch.equal(a.cpu(), b))
                       for a, b in zip(grads, ref_grads))
            print(f"  planned step, {how}: max_memory_allocated "
                  f"{real_peak / 2**30:.3f} GiB = "
                  f"{real_peak / (frac * peak)!r} of the budget, "
                  f"{real_peak / plan.est_peak_bytes!r} of est_peak_bytes, "
                  f"{real_peak / ref_peak!r} of the unplanned step; step "
                  f"{ms:.0f} ms; gradients bit-identical to the unplanned "
                  f"run: {same} [{card}]")
            require(same, f"8: planned gradients at {frac}, {how}")
            del grads
    for frac in PLAN_INFEASIBLE:
        t0 = time.perf_counter()
        plan = planner.plan(grads_of(fwd), params, x,
                            budget_bytes=frac * peak)
        print(f"phase 8: planned at {frac} of the traced peak, below the "
              f"floor of the parameters and their gradients "
              f"({traced.log.pinned_bytes() / 2**30:.3f} GiB pinned): "
              f"feasible {plan.feasible} "
              f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        require(not plan.feasible, f"8: a plan below the floor at {frac}")
    del params, x, ref_grads
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log = capture_train_step(ARCH, smoke=False, batch=QWEN_BATCH,
                             seq=QWEN_SEQ)
    cap_s = time.perf_counter() - t0
    check_log(log)
    cap_peak, _ = simulator.measure_baseline(log)
    print(f"phase 8: {log.name}: baseline peak {cap_peak / 2**30:.3f} GiB "
          f"(the plain path, attention blocked by {Q_BLOCK} query "
          f"rows) against the card's step under remat none "
          f"{train_peak / 2**30:.3f} GiB (phase 6) [{card}]")
    rep = verify_oracle_equivalence(
        log, fractions=(CAPTURE_FRACTION,), thrash_factor=3.0,
        heuristics=("h_dtr", "h_dtr_eq", "h_lru"))
    runs = rep["index_results"].values()
    print(f"phase 8: {log.name}: captured in {cap_s:.1f} s on fake CPU "
          f"tensors, {log.op_count()} ops, baseline peak "
          f"{rep['baseline_peak']!r} B; check_log ok; scan == index over "
          f"{rep['cells']} cells at {CAPTURE_FRACTION}: {rep['ok']} "
          f"(mismatches {rep['mismatches']}); feasible "
          f"{[r.ok for r in runs]}, evictions "
          f"{[r.evictions for r in runs]}, remats "
          f"{[r.remat_ops for r in runs]}")
    require(rep["ok"], "8: scan and index replays of the train capture")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_gemm

    # -- 1. card, numerics, build --------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = _build.build(sources)
    print(f"phase 1: built {sources} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 2. kernel against plain version -------------------------------------
    print("phase 2: flash_attention against flash_reference")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for b, hq, hkv, sq, skv, d, causal, window in SWEEP:
            shape = dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                         kv_len=None)
            q, k, v, _ = inputs(torch, shape, dtype, gen)
            compare(torch, flash_attention, ref.flash_reference, (q, k, v),
                    dict(causal=causal, window=window), TOL[dtype_name],
                    f"{dtype_name} {(b, hq, hkv, sq, skv, d)} "
                    f"causal={causal} window={window}")
    q, k, v, kv_len = inputs(torch, DECODE, torch.bfloat16, gen)
    decode_args = (q, k, v)
    decode_kw = dict(causal=True, kv_len=kv_len)
    decode_err = compare(torch, flash_attention, ref.flash_reference,
                         decode_args, decode_kw, TOL["bfloat16"],
                         f"bfloat16 decode {DECODE}")
    q, k, v, _ = inputs(torch, PREFILL, torch.bfloat16, gen)
    prefill_args = (q, k, v)
    prefill_err = compare(torch, flash_attention, ref.flash_reference,
                          prefill_args, dict(causal=True), TOL["bfloat16"],
                          f"bfloat16 prefill {PREFILL}")
    q, k, v, moe_kv_len = inputs(torch, MOE_ATTN_DECODE, torch.bfloat16, gen)
    moe_attn_args = (q, k, v)
    moe_attn_kw = dict(causal=True, kv_len=moe_kv_len)
    compare(torch, flash_attention, ref.flash_reference, moe_attn_args,
            moe_attn_kw, TOL["bfloat16"],
            f"bfloat16 mixtral decode {MOE_ATTN_DECODE}")
    flash_train_err = flash_bwd_checks(torch, gen)
    flash_train = flash_train_times(torch, card, gen)

    print("phase 2: moe_gemm against moe_gemm_reference")
    gemm_errs = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        shapes = [("sweep", s) for s in GEMM_SWEEP] + [
            (f"decode {n}", s) for n, s in GEMM_DECODE.items()] + [
            ("prefill", GEMM_PREFILL)]
        for what, shape in shapes:
            x, w = gemm_inputs(torch, shape, dtype, gen)
            gemm_errs[dtype_name, shape] = compare(
                torch, moe_gemm, ref.moe_gemm_reference, (x, w), {},
                MOE_TOL[dtype_name],
                f"{dtype_name} {what} [{shape[0]},{shape[1]},{shape[2]}]@"
                f"[{shape[0]},{shape[2]},{shape[3]}]")
            del x, w
    wkv_errs = rwkv_kernel_checks(torch, gen)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3-5 for qwen2, then its flash-attention times -------------------------
    qwen_launches, qwen_variants, qwen_log = model_phases(
        torch, ARCH, configs.get(ARCH),
        ["--requests", "6", "--slots", "2", "--gen", "8"], card, gen)
    keep = (torch.arange(DECODE["skv"], device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]    # kv_len as SDPA's mask

    def sdpa_decode():
        return F.scaled_dot_product_attention(*decode_args, attn_mask=keep,
                                              enable_gqa=True)

    def sdpa_prefill():
        return F.scaled_dot_product_attention(*prefill_args, is_causal=True,
                                              enable_gqa=True)

    times = {}
    for what, args_, kw, lib, iters in (
            ("decode", decode_args, decode_kw, sdpa_decode, 200),
            ("prefill", prefill_args, dict(causal=True), sdpa_prefill, 20)):
        shape = DECODE if what == "decode" else PREFILL
        times[what] = time_row(
            torch, (("ms", lambda: flash_attention(*args_, **kw)),
                    ("simt_ms", lambda: flash_attention(*args_, **kw)),
                    ("plain_ms", lambda: ref.flash_reference(*args_, **kw)),
                    ("library_ms", lib)), iters,
            attention_bound_ms(shape, True, 2, "bfloat16"),
            f"{what} {shape} bf16", card)
    print(f"  prefill kernel max_abs_err={prefill_err!r}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3-5 for mixtral, then the grouped GEMM's times ----------------------
    torch.cuda.reset_peak_memory_stats()
    moe_launches, moe_variants, _ = model_phases(
        torch, MOE_ARCH, configs.get(MOE_ARCH).replace(n_layers=MOE_LAYERS),
        ["--requests", "6", "--slots", "2", "--gen", "8", "--max-len", "32"],
        card, gen)
    gc.collect()
    torch.cuda.empty_cache()
    moe_keep = (torch.arange(MOE_ATTN_DECODE["skv"], device="cuda")[None, :]
                < moe_kv_len[:, None])[:, None, None, :]
    time_row(torch, (
        ("ms", lambda: flash_attention(*moe_attn_args, **moe_attn_kw)),
        ("simt_ms", lambda: flash_attention(*moe_attn_args, **moe_attn_kw)),
        ("plain_ms", lambda: ref.flash_reference(*moe_attn_args,
                                                 **moe_attn_kw)),
        ("library_ms", lambda: F.scaled_dot_product_attention(
            *moe_attn_args, attn_mask=moe_keep, enable_gqa=True))), 200,
        attention_bound_ms(MOE_ATTN_DECODE, True, 2, "bfloat16"),
        f"flash_attention, mixtral decode {MOE_ATTN_DECODE} bf16", card)
    gemm_times = {}
    for what, shape, iters in (("decode wi", GEMM_DECODE["wi"], 50),
                               ("decode wo", GEMM_DECODE["wo"], 50),
                               ("prefill", GEMM_PREFILL, 10)):
        x, w = gemm_inputs(torch, shape, torch.bfloat16, gen)
        gemm_times[what] = time_row(
            torch, (("ms", lambda: moe_gemm(x, w)),
                    ("simt_ms", lambda: moe_gemm(x, w)),
                    ("plain_ms", lambda: ref.moe_gemm_reference(x, w)),
                    ("library_ms", lambda: torch.bmm(x, w))), iters,
            gemm_bound_ms(shape, 2, "bfloat16"),
            f"moe_gemm {what} [{shape[0]},{shape[1]},{shape[2]}]@"
            f"[{shape[0]},{shape[2]},{shape[3]}] bf16", card)
        del x, w

    gc.collect()
    torch.cuda.empty_cache()

    # -- 6 and 5 for rwkv6, then for qwen2 training ------------------------
    wkv = rwkv_train_phases(torch, card, gen)
    gc.collect()
    torch.cuda.empty_cache()
    qwen_train = qwen_train_phases(torch, card)

    # -- 7. the eager DTR executor, f32 (TF32 off since phase 1) -------------
    eager_chain(torch, card)
    eager_mlp_phases(torch, card)
    serve_log_replay(qwen_log)

    # -- 8. the planner on real bytes -----------------------------------------
    planner_phase(torch, card, qwen_train["peaks"]["none"])

    d = times["decode"]
    tf, tb = flash_train["fwd"], flash_train["bwd"]
    g = gemm_times["decode wi"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "variant": ran_variant(qwen_variants["flash_attention"]),
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": qwen_launches["flash_attention"],
        "max_abs_err": decode_err,
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
        "previous_ms": d["simt_ms"],
        "train_launches": qwen_train["launches"]["flash_attention"],
        "train_max_abs_err": flash_train_err["fwd"],
        "train_ms": tf["ms"], "train_in_step_ms":
            qwen_train["inside"]["flash_attention"],
        "train_plain_ms": tf["plain_ms"], "train_bound_ms": tf["bound_ms"],
        "train_bound_by": tf["bound_by"],
        "train_library_ms": tf["library_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "variant": ran_variant(qwen_train["variants"]),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "note": ("no TPU counterpart: the JAX package differentiates "
                 "_sdpa / _sdpa_blocked (src/repro/models/layers.py:96-172) "
                 "through XLA"),
        "launches": qwen_train["launches"]["flash_attention_bwd"],
        "max_abs_err": flash_train_err["bwd"], "ms": tb["ms"],
        "passes_ms": tb["ms_passes"],
        "in_step_ms": qwen_train["inside"]["flash_attention_bwd"],
        "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "previous_ms": tb["mma_ms"],
        "previous_passes_ms": tb["mma_ms_passes"],
        "simt_ms": tb["simt_ms"]}, {
        "name": "moe_gemm", "route": "cuda",
        "variant": ran_variant(moe_variants["moe_gemm"]),
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:41",
        "launches": moe_launches["moe_gemm"],
        "max_abs_err": gemm_errs["bfloat16", GEMM_DECODE["wi"]],
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "previous_ms": g["simt_ms"]}] + [{
        "name": name, "route": "cuda", "variant": row["variant"],
        "source": "src/repro_torch/kernels/csrc/rwkv6_chunked.cu",
        "replaces": "src/repro/kernels/rwkv6_chunk.py:81",
        "launches": row["launches"], "max_abs_err": wkv_errs[direction],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "previous_ms": row["simt_ms"], **extra}
        for name, direction, row, extra in (
            ("rwkv6_fwd", "fwd", wkv["rwkv6_fwd"], {}),
            ("rwkv6_bwd", "bwd", wkv["rwkv6_bwd"], {"note": (
                "no TPU counterpart: the JAX package differentiates the "
                "model's _chunked_wkv through XLA")}))]},
        allow_nan=False))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
