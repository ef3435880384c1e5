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
   and bf16 (``wgmma`` as planned, at D 64, 128 and 256, with the earlier
   ``mma`` design forced beside it at D 64, and ``simt``), GQA 14/2 and
   32/8, ragged lengths, a window, the train shapes of qwen2
   ``[4,14,2048,64]``, llama3.2-1b ``[4,32,2048,64]`` (kv 8 heads, G = 4),
   smollm-135m ``[8,9,1024,64]`` (kv 3 heads, G = 3) and mixtral-8x7b
   ``[2,32,2048,128]`` (kv 8 heads of 128, ``FLASH_MIXTRAL``, timed beside
   ``simt`` and SDPA), and a second call's bits on every variant.  The grouped GEMM's backward (``moe_gemm_bwd``: dX and dW, on
   ``wgmma`` reading w, x and dY in place) against autograd through the
   plain version, each gradient within 1e-4 (f32, ``simt``) or 3e-2 (bf16)
   of its largest magnitude, and a second call's bits, on the sweep and at
   phase 11's shapes (mixtral's train step, deepseek's decode and train
   step), where the forward is also held to its plain version.
3. Each serve path at full width, with seeded random weights, 8 requests
   over 4 slots, 16 tokens each, ``--capture``: qwen2-0.5b (24 layers),
   then mixtral-8x7b with its depth cut to 4 layers (the 32-layer model
   does not fit one card).  Kernel launch counts, in all and per variant,
   are reset just before each path and read just after; every bf16 launch
   of phases 3-5 must go to the ``wgmma`` variants.  Then each smoke config
   served on the card and on the CPU gives the same tokens.
4. Path parity, per model: one full-width decode step through the kernels
   and through the plain versions, on the same parameters, cache and tokens,
   in f32; in bf16 each path against the f32 plain path on three weight
   draws of their own, by the bf16 rule (``bf16_verdict``; phases 6, 11a
   and 12b hold their bf16 losses and gradients by it too); and layer 0
   alone (below).
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
   forward (saving the LSE) and backward at each model's train shape
   (qwen2, llama3.2-1b, smollm-135m) beside their bounds, the plain
   versions and SDPA's forward and backward timed apart, the backward on
   ``wgmma`` with its passes' device times, at qwen2's beside ``mma`` and
   ``simt`` on the same inputs;
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

9. The training driver and the paper's experiments (its own wall time
   printed).  (a) The train launcher at its defaults (llama3.2-1b, remat
   dtr, AdamW) at full width: 16 layers, batch 4 x 2048, bf16 activations,
   3 steps through ``train_loop`` without a checkpoint manager; flash
   launches 32 + 16 a step, all on ``wgmma``; the step's wall, device
   busy, idle share, tokens/s and the flash kernels inside it;
   ``max_memory_allocated`` and the ``MemoryMonitor`` summary (the caching
   allocator's largest free block); one loss-and-grads call under remat
   none and under dtr, gradients bit-identical, dtr's peak lower.  (b)
   smollm-135m (30 layers, batch 8 x 1024) through the launcher with
   checkpoints every 4 steps into a temp dir, interrupted from ``on_step``
   before step 7; a fresh launcher restores step 4: parameters and
   optimizer state bit-identical to the ones saved, the losses of the
   steps both runs took bit-identical, exactly ``keep`` checkpoints and no
   temp dir left; one step's breakdown.  (c) The examples on the card:
   ``quickstart``'s three parts, ``train_lm`` (60 steps, f32 on ``simt``)
   learning, ``dynamic_treelstm`` (loss falls, remats, ``live_bytes()``
   within the budget and one op's output after every op).  (d) Table 1's
   eager rows at dim 128 and 16384 (a 1 GiB weight) with the plain peak
   measured (``max_memory_allocated``) beside the reference's formula,
   ``max_dtr > max_plain``; one whole simulated case against the JAX
   package's row; Fig. 4's planner times.  The rows as a JSON line.

10. The serve surface (its own wall time printed).  (a) rwkv6, qwen2 and
    mixtral smoke configs serve 8 requests over 4 slots, 8 tokens each, at
    ``--max-len 32 --kv-budget 0.3 --chaos-shrink 0.5 --chaos-period 16``
    with ``--capture``, on the card and on the CPU: the same tokens,
    admission counters, events and captured log; preemptions, none
    rejected; flash launches once a layer and step (mixtral's grouped GEMM
    three times), rwkv6 none.  (b) rwkv6-1.6b at full width (24 layers, d
    2048, bf16 activations) serves 8 requests over 4 slots, 16 tokens each,
    launching no kernel; one decode step's wall, device busy and idle share
    beside the weights' byte bound; one request's 32 decode steps against
    forward over the same tokens through the WKV kernel, f32 on ``simt`` at
    2 and 24 layers, and layer 0's time-mix in bf16 on ``mma``.  (c)
    qwen2-0.5b at full width under (a)'s flags with ``--offload-sweep``:
    8/8 served with preemptions and no rejection, every flash launch on
    ``wgmma``, the capture through ``check_log`` and scan == index; the
    requests admission never preempted against a run without a budget
    (printed).  (d) ``repro_torch.examples.serve`` (one shared position
    clock) on the card and on the CPU: the same tokens.  (e) ``python -m
    repro_torch.trace report`` on (c)'s capture, into a temp dir.

11. MoE training, autotune and deepseek-v3 (its own wall time printed).
    The grouped GEMM's rows at phase 11's shapes (timed beside phase 5's
    decode rows, before the train phases' large profiles): the forward and
    the backward beside ``simt``, the plain versions, ``torch.bmm`` and the
    bound, the backward also beside its design on transposed copies.  (a)
    mixtral-8x7b at full width cut to 2 layers, batch 2 x 2048: loss and
    every gradient through the kernels against the plain path in f32 (worst
    leaf within 1e-3) and with bf16 activations (within the plain path's own
    bf16-against-f32 distance).  (b) 3 AdamW steps (f32 parameters, bf16
    activations): launches a step per variant (grouped GEMMs 3 + 6 a layer,
    flash forward and its D 128 backward, all ``wgmma``), losses,
    ``max_memory_allocated``; then one step's wall,
    device busy, idle share, tokens/s and the kernels' device time inside
    it; one loss-and-grads call at phase 3's 4 layers (finite gradients,
    launches, peak).  (c) ``core.autotune`` on phase 8's MLP (traced on fake tensors):
    the chosen fraction and its estimate; the step's capture under
    ``cost_model="hlo"``, whose FLOPs must be its matrix products exactly.
    (d) deepseek-v3: the smoke config card against CPU (forward at S 16 and
    2048, MLA's two branches; 8 requests served, the same tokens); then
    full width cut to one dense and one MoE layer with bf16 parameters: 8
    requests served over 4 slots (every grouped GEMM on ``wgmma``, no flash
    launch: MLA's attention is plain PyTorch), one decode step's wall and
    busy, and one loss-and-grads call at batch 1 x 2048 (loss and every
    gradient finite, launches, peak).  Its rows join the JSON lines.

12. gemma3-1b and recurrentgemma-2b (its own wall time printed): mixed
    layer patterns (five sliding-window layers to one global; two RG-LRU
    layers to one windowed), a two-layer tail stack, GeGLU and head dim
    256, whose bf16 flash forward and backward run on ``wgmma`` (two
    consumer warpgroups a block; phase 2 holds both at the train shapes,
    ``FLASH_D256``, and the forward at the decode shapes, ``D256_DECODE``,
    and times them beside ``simt``, their previous design, and SDPA on the
    same call).
    Per model: (a) the smoke config on the card against the CPU, logits at
    S 16 and 2048 and 8 requests served under phase 10's admission flags;
    (b) full width cut to one group and the tail: every flash call of the
    forward, f32 and bf16, against its plain version on the q/k/v the
    model feeds it; loss and every gradient through the kernels against
    the plain path (f32: each leaf within 1e-3, or within twice its
    distance between the plain path and the plain path with f64
    attention; bf16 by the bf16 rule), and a decode step at 4 slots at
    positions 600-999 behind 1024 rows (past gemma3's 512-row ring);
    (c) the train
    launcher's loop (remat dtr, AdamW, batch 2 x 2048, 3 steps) at full
    depth (recurrentgemma at 8 layers): flash launches per step by variant,
    all ``wgmma``, finite losses, step wall, device busy, idle share,
    tokens/s and peak; (d) the full-depth model serves 8 requests over 4
    slots, 16 tokens each, every flash launch on ``wgmma``, and one decode
    step's wall and busy.

13. llama-3.2-vision-11b and musicgen-large (each model's wall time
    printed): cross attention (text rows against 1601 image rows, no mask,
    Sq != Skv, on the flash kernels with ``causal=False``) and MHA (G 1) at
    D 64, with codebook embeddings and heads; phase 2 holds the flash
    forward (LSE) and backward at their train shapes (``FLASH_NEW``) and
    the forward at their decode shapes (``NEW_DECODE``), and phase 5 times
    them beside ``simt``, the plain versions and SDPA (non-causal with GQA,
    and its backward).  Per model: (a) the smoke config on the card
    against the CPU: logits (with an image; ``[B,S,K,V]`` for musicgen) at
    S 16 and 2048, greedy tokens through ``make_serve_step`` on both
    position clocks, and for musicgen 3 steps of the train launcher's
    loop; (b) full width cut to one group (vision: 4 self + 1 cross layer,
    batch 1 x 2048 against a [1,1601,7680] image) or 2 layers (musicgen),
    held as phase 12's (b) (vision's f32 gradient at this cut moves
    1e-2 when only the plain attention's rounding changes, so its leaves
    are held by the second limit); (c)
    vision at that cut trains 3 steps at batch 2 x 2048 through
    ``make_train_step`` (remat dtr, AdamW), musicgen whole (48 layers)
    through the train launcher's loop: flash launches per step by
    variant, all ``wgmma`` (vision's also by mask, self and cross), finite
    losses, wall, busy, idle share,
    tokens/s, peak; (d) the whole model decodes 32 greedy steps for 4
    slots (vision against a [4,1601,7680] image): tokens, launches (every
    self layer with ``kv_len``, every cross layer's cross call, all
    ``wgmma``), ms a step, one step's wall and busy.  The launchers refuse
    vision (no ``img_embed``) and musicgen's serve launcher (a ``[slots,
    1]`` token buffer), as the reference's fail there.
14. Attention-logit soft-capping (``logit_softcap``, each scaled logit s
    becomes c tanh(s / c) inside both flash kernels): in phase 2 every
    flash variant with a cap of ``SOFTCAP_CHECK`` (which bends the N(0, 1)
    logits of its inputs) against its plain version at the same
    tolerances (forward ``simt`` f32 and forced bf16, ``wgmma`` at D 64,
    128 and 256 with one and two consumer warpgroups, split-kv decode;
    backward ``simt``, ``mma``, ``wgmma`` and the two-warpgroup kernels),
    and the capped rows' times (``SOFTCAP_TIMED``: qwen2's and gemma3's
    train shapes and qwen2's decode shape) beside the same call uncapped,
    the plain version and ``flex_attention`` with a capping
    ``score_mod``, compiled (the backward's as its forward and backward
    less its forward).  Then gemma3-1b at full width with
    ``logit_softcap`` ``SOFTCAP`` (Gemma 2's): phase 12's (b) parity at
    its cut (bf16 by the bf16 rule), the train launcher's loop for 3
    steps and 8 requests served over 4 slots, every bf16 launch on
    ``wgmma`` (``simt`` 0), wall beside device busy.
15. The train launcher on the card with ``--mesh host --fsdp
    --seq-shard``: the same losses as without the flags (qwen2-0.5b
    smoke, 3 steps); ``--mesh production`` fails with the reference's
    assertion.
16. The dry run (``repro_torch.launch.dryrun``) of ``DRYRUN_CELLS``,
    each on a fake 256- or 512-rank process group in a subprocess of its
    own, all in parallel beside phases 7-10, read after phase 10: each
    must print "all cells OK", and each cell of ``DRYRUN_REFERENCE`` is
    held to the reference's own dry run (peak, FLOPs; the
    context-parallel cells' collective bytes, ``DRYRUN_REFERENCE_COLL``).
17. Context-parallel decode: in phase 2 ``flash_attention_lse`` (decode
    writing each row's LSE, its keys split over blocks, the combine
    writing the merged row statistics) at ``SPLIT_LSE``'s shard shapes
    against ``flash_reference_lse`` (rows past the shard's keys: zeros
    and -inf, no NaN; bits repeat), timed in phase 5 beside the unsplit
    call, ``simt``, the plain version and the efficient attention call
    with its LSE; then ``CP_CACHES``, whole full-width decode caches cut
    into 16 shards, each through the kernel, merged by log-sum-exp, the
    launch counts zeroed just before and read just after, against the
    unsplit kernel call and the plain version.

Phase 4 also holds layer 0 alone in bf16 (attention output, MLP or MoE
output), kernel against plain on the same inputs, to the kernels' own
tolerances.  The qwen2 phases run first and free their tensors before
mixtral's 36 GB (f32 weights and their bf16 copy) arrive; rwkv6 comes
next, then phase 11 (MoE training and deepseek-v3), phases 12 and 13, the
eager executor, the planner, phase 9 and phase 10.  Then
the JSON line of phase 9's rows, phase 11's, 12's and 13's JSON lines, one
JSON line per kernel table (the flash rows with each train shape's
launches, times, bound and SDPA's time, at head dim 256 under
``d256_shapes``, at mixtral's under ``d128_shapes`` (with phase 13a's
self-attention launches) and at phase 13's under
``vision_musicgen_shapes``, each with its ``simt`` time as
``previous_ms``; the grouped GEMM's rows at phase 11's shapes, and its
backward's; ``flash_attention_lse`` with phase 17's launches), the card
line, and ``{"ok": true, "device": {...}}`` as the
last line.
"""
from __future__ import annotations

import atexit
import collections
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
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
# So the whole-step bf16 rule (below) bounds little at 24 layers, and layer
# 0's attention and MLP (MoE) outputs are also held alone, before any
# amplification, to the kernels' own tolerances (TOL, MOE_TOL).
PARITY_F32 = 1e-3
# bf16 parity, kernel path against plain path (phases 4, 6, 11a and 12b).
# Each bf16 path differs from the f32 plain path by rounding that the
# model's random layers amplify, and the kernel path and the plain path are
# two samples of it.  The check used to hold ||k16 - p16|| within
# ||p16 - p32|| (max norms) on one weight draw: two independent samples of
# that noise against each other, which read 0.58 to 1.29 of its limit over
# four draws and failed a clean run.  Now each bf16 path is held against the
# f32 plain path on BF16_DRAWS weight draws, each from its own generator: on
# every draw the ratio of the kernel path's distance ||k16 - p32|| to the
# plain path's ||p16 - p32|| (Frobenius norms of the logits; for gradients,
# ||g - g32|| / ||g32|| at the leaf where that ratio is largest; for the
# loss, |l - l32| against the plain path's root-mean-square over the
# draws), and the median of the ratios within BF16_RATIO (bf16_verdict): a
# fault shows on every draw, draw noise on one.  On an H100 80GB HBM3 at
# 700 W the clean kernels read 0.97 to 1.05 a draw on the logits and 1.00
# to 1.03 on the gradients; the loss 0.20 to 1.78, medians 0.42 to 1.06
# (PERF.md).  An injected wrong tile reads 22 to 37 on the logits and
# 3.4 to 5.8 on the gradients (tests/test_torch_bf16_rule.py).
# BF16_RATIO = 2 is also what the old rule allowed on its one draw:
# ||k16 - p32|| <= ||k16 - p16|| + ||p16 - p32|| <= 2 ||p16 - p32||.
BF16_DRAWS = 3
BF16_RATIO = 2.0
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
# Phase 11: MoE training and deepseek-v3.  Mixtral at full width, depth
# cut to 2 of 32 layers (at AdamW's 16 B a parameter a layer holds 23.2 GB
# and the untied embeddings 4.2 GB), batch 2 x 2048: capacity 640 a row,
# so the grouped GEMMs run at [8, 1280, 4096] @ [8, 4096, 14336] with the
# batch folded into capacity.
MIX_TRAIN_LAYERS = 2
MIX_BATCH, MIX_SEQ = 2, 2048
MIX_STEPS = 3
# deepseek-v3 at full width, cut to one dense and one MoE layer, bf16
# parameters (13.9 B: in f32 they would leave no room for gradients).
DS_ARCH = "deepseek-v3-671b"
DS_CUT = dict(n_layers=2, n_dense_layers=1, param_dtype="bfloat16")
DS_BATCH, DS_SEQ = 1, 2048
# Smoke logits, card against CPU, f32: summation order only.
DS_SMOKE_TOL = 1e-4
# The grouped GEMM at phase 11's shapes: mixtral's train step (C = 1280),
# deepseek's decode (4 slots x capacity 8) and train step (capacity 80).  A
# MoE layer runs the wi shape twice (gate and up) and the wo shape once
# (down), forward and backward.
GEMM_TRAIN = {"mixtral train wi": (8, 1280, 4096, 14336),
              "mixtral train wo": (8, 1280, 14336, 4096),
              "deepseek decode wi": (256, 32, 7168, 2048),
              "deepseek decode wo": (256, 32, 2048, 7168),
              "deepseek train wi": (256, 80, 7168, 2048),
              "deepseek train wo": (256, 80, 2048, 7168)}
# The share of a MoE layer's grouped-GEMM launches at each shape.
GEMM_SHARE = {"wi": 2 / 3, "wo": 1 / 3}
# Shapes that joined phase 2 after the later phases' inputs were fixed:
# they draw from generators of their own (``own_gen``).
GEMM_FRESH = ("deepseek decode wo", "deepseek train wo")
# The backward against autograd through the plain version, each gradient
# relative to its largest magnitude: the forward's tolerances (f32 order of
# summation; bf16 one rounding of each gradient on both sides).
GEMM_BWD_REL = {"float32": 1e-4, "bfloat16": 3e-2}
# The grouped-GEMM kernels one step launches, by the profiler's names.
GEMM_STEP_KERNELS = ("moe_gemm_wgmma_kernel",)
FLASH_SIMT_BWD_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                          "flash_bwd_dq_kernel")
# mixtral-8x7b's flash shape in phase 11's train step, batch 2 x 2048, 32/8
# heads of 128: held in phase 2 like the cases above and timed there beside
# the CUDA-core variants and SDPA.
FLASH_MIXTRAL = {"mixtral-8x7b": (2, 32, 8, 2048, 2048, 128, True, 0)}
RWKV_ARCH = "rwkv6-1.6b"
# Phase 12: gemma3-1b and recurrentgemma-2b at full width, batch 2 x 2048.
# 12b cuts each to one group and the tail (8 and 5 layers); 12c trains
# gemma3-1b at full depth (1.00 B parameters, 16 GB with AdamW's moments
# and the gradients) and recurrentgemma-2b at 8 layers, two groups and the
# tail (1.35 B, 21.6 GB; its 26 layers hold 2.89 B, 46 GB before the
# activations and the 2048 x 256,000 logits); 12d serves both at full
# depth.
GEMMA_ARCH, RG_ARCH = "gemma3-1b", "recurrentgemma-2b"
GEMMA_BATCH, GEMMA_SEQ, GEMMA_STEPS = 2, 2048, 3
GEMMA_PARITY_LAYERS = {GEMMA_ARCH: 8, RG_ARCH: 5}
GEMMA_TRAIN_LAYERS = {RG_ARCH: 8}
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
# The train shapes of phase 9's models: llama3.2-1b at batch 4 x 2048, GQA
# 32/8 (G = 4); smollm-135m at batch 8 x 1024, GQA 9/3 (G = 3, an odd head
# count).
FLASH_LLAMA = (4, 32, 8, 2048, 2048, 64, True, 0)
FLASH_SMOLLM = (8, 9, 3, 1024, 1024, 64, True, 0)
# Phase 9c's f32 attention, on `simt`: the quickstart's llama3.2-1b smoke
# (batch 4 x 64, 8/2 heads of 8) and train_lm's widened smoke (batch 16 x
# 128, 8/4 heads of 32).
FLASH_QUICKSTART = (4, 8, 2, 64, 64, 8, True, 0)
FLASH_TRAIN_LM = (16, 8, 4, 128, 128, 32, True, 0)
FLASH_TRAIN_SHAPES = {"qwen2-0.5b": FLASH_TRAIN, "llama3.2-1b": FLASH_LLAMA,
                      "smollm-135m": FLASH_SMOLLM}
FLASH_BWD_CASES = [(2, 4, 2, 128, 128, 64, True, 0),
                   (1, 14, 2, 100, 100, 64, True, 0),
                   (1, 14, 2, 77, 131, 64, True, 33),
                   (1, 32, 8, 96, 96, 128, True, 0),
                   (2, 4, 1, 64, 96, 32, False, 0), FLASH_TRAIN, FLASH_LLAMA,
                   FLASH_SMOLLM, FLASH_QUICKSTART, FLASH_TRAIN_LM]
FLASH_BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# Phase 12's flash shapes, head dim 256, held in phase 2 like the cases
# above (forward with the LSE, backward, a second call's bits) and timed
# there: gemma3-1b's train step at batch 2 x 2048, 4/1 heads, in its global
# (causal) and local (window 512) layers; recurrentgemma-2b's at batch 1 x
# 2048, 10/1 heads, window 2048 (as long as the sequence).
FLASH_D256 = {"gemma3-1b global": (2, 4, 1, 2048, 2048, 256, True, 0),
              "gemma3-1b local": (2, 4, 1, 2048, 2048, 256, True, 512),
              "recurrentgemma-2b": (1, 10, 1, 2048, 2048, 256, True, 2048)}
# Their decode shapes in phase 12b: 4 slots at positions 600 to 999 behind
# a 1024-row max_len; gemma3's local layers read a 512-row ring (full),
# its global layers 1024 rows, recurrentgemma's local layers a ring of
# min(1024, 2048) rows.  Phase 12d serves at the same max_len.
D256_POS = (600, 733, 866, 999)
D256_MAX_LEN = 1024
D256_DECODE = {
    "gemma3-1b global decode": dict(b=4, hq=4, hkv=1, sq=1, skv=1024, d=256,
                                    kv_len=tuple(p + 1 for p in D256_POS)),
    "gemma3-1b local decode": dict(b=4, hq=4, hkv=1, sq=1, skv=512, d=256,
                                   kv_len=(512,) * 4),
    "recurrentgemma-2b decode": dict(b=4, hq=10, hkv=1, sq=1, skv=1024,
                                     d=256, kv_len=tuple(p + 1
                                                         for p in D256_POS))}
# Phase 13: llama-3.2-vision-11b and musicgen-large at full width.  Their
# flash shapes, held in phase 2 like the cases above (forward with the LSE,
# backward, a second call's bits) and timed there beside ``simt``, the
# plain versions and SDPA: vision's cross layers at batch 2 x 2048 text
# rows against the 1601 image rows, no mask (1601 = 25 key tiles of 64 and
# one of 1 key), GQA 32/8 at D 128; musicgen's train step, MHA 32/32 at D
# 64 (G 1).  Then their decode shapes: one row a slot against the 1601
# image rows (no kv_len: the keys split over blocks), and musicgen's cache
# at phase 12's positions (G 1: one live row of a 64-row block).
VISION_ARCH, MUSIC_ARCH = "llama-3.2-vision-11b", "musicgen-large"
FLASH_NEW = {
    "llama-3.2-vision-11b cross": (2, 32, 8, 2048, 1601, 128, False, 0),
    "musicgen-large": (2, 32, 32, 2048, 2048, 64, True, 0)}
NEW_DECODE = {
    "llama-3.2-vision-11b cross decode": dict(
        b=4, hq=32, hkv=8, sq=1, skv=1601, d=128, kv_len=None,
        causal=False),
    "musicgen-large decode": dict(b=4, hq=32, hkv=32, sq=1,
                                  skv=D256_MAX_LEN, d=64,
                                  kv_len=tuple(p + 1 for p in D256_POS))}
# 13a cuts vision to one group, 4 self + 1 cross layer (2.19 B parameters),
# for kernel-vs-plain parity at batch 1 x 2048 and the train step at batch
# 2 x 2048; its whole 40 layers (10.17 B parameters, 40.7 GB in f32, a
# 20.3 GB bf16 copy kept) decode.  13b cuts musicgen to 2 layers for parity;
# its train launcher and decode run the whole 48 layers (3.23 B parameters,
# 51.7 GB of f32 parameters, gradients and AdamW moments before the
# activations).  Images are N(0, 1) x 0.1, as tests/test_archs.py draws
# them.
VISION_CUT = 5
VISION_PARITY_BATCH = 1
MUSIC_PARITY_LAYERS = 2
NEW_BATCH, NEW_SEQ, NEW_STEPS = 2, 2048, 3
NEW_DECODE_SLOTS, NEW_DECODE_STEPS = 4, 32
SMOKE_DECODE_STEPS = 12
IMG_SCALE = 0.1
# The forward's row log-sum-exp, f32 on both sides.
LSE_TOL = 1e-4
# Phase 14: the logit soft cap.  The models' cap is Gemma 2's
# ``attn_logit_softcapping``; phase 2's bends the N(0, 1) logits of its
# inputs (the models' cap leaves them nearly straight).
SOFTCAP = 50.0
SOFTCAP_CHECK = 2.0
SOFTCAP_CASES = {  # name -> (b, hq, hkv, sq, skv, d, causal, window)
    "D 64": (2, 14, 2, 512, 512, 64, True, 0),
    "D 128": (2, 32, 8, 512, 512, 128, True, 0),
    "D 256": (2, 4, 1, 512, 512, 256, True, 0),
    "D 256 window": (2, 4, 1, 512, 512, 256, True, 128),
    "D 128 cross": (2, 32, 8, 256, 200, 128, False, 0)}
# Phase 14's timed capped rows: gemma3-1b's global train shape, whose
# launches phase 14b counts, and its global decode shape (14c's serve
# loop).
SOFTCAP_TIMED = {"gemma3-1b global": FLASH_D256["gemma3-1b global"]}
SOFTCAP_DECODE = "gemma3-1b global decode"
# Context-parallel decode: each device attends its own shard of a
# sequence-sharded KV cache with each row's LSE (``flash_attention_lse``:
# the keys split over blocks as any decode call's, the combine writing the
# merged row statistics), and the shards merge by log-sum-exp
# (``ops.merge_attention``).  Phase 2 holds the kernel at qwen2-0.5b's
# local shard of its decode_32k cache (8 of the 128 slots on a data shard,
# 2048 of 32768 rows on a model shard; two slots whose position lies
# before this shard: kv_len 0) and gemma3-1b's global shard at long_500k
# (D 256), on ``wgmma`` with split keys, at 64 slots (128 blocks: no
# split), at mixtral-8x7b's local shard at long_500k (D 128: its ring of
# 4096 rows over 256 devices leaves each 16 keys, one tile, no split; a
# device past the slot's position sees none) and in f32 on ``simt``;
# phase 5 times the first.
SPLIT_LSE = {
    "qwen2-0.5b shard": dict(b=8, hq=14, hkv=2, sq=1, skv=2048, d=64,
                             kv_len=(0, 1, 700, 2048, 0, 1500, 64, 2047)),
    "gemma3-1b shard": dict(b=4, hq=4, hkv=1, sq=1, skv=2048, d=256,
                            kv_len=(0, 1, 1000, 2048)),
    "qwen2-0.5b shard unsplit": dict(b=64, hq=14, hkv=2, sq=1, skv=2048,
                                     d=64, kv_len=(0, 1, 700, 2048) * 16),
    "mixtral-8x7b shard unsplit": dict(b=1, hq=32, hkv=8, sq=1, skv=16,
                                       d=128, kv_len=(16,)),
    "mixtral-8x7b empty shard unsplit": dict(b=1, hq=32, hkv=8, sq=1,
                                             skv=16, d=128, kv_len=(0,))}
SPLIT_LSE_TIMED = "qwen2-0.5b shard"
# Phase 17: whole decode caches at full width cut into the 16 shards of
# decode_32k's model dim, each through the kernel, merged, against the
# unsplit kernel call and the plain version: qwen2-0.5b's 8 slots x 32768
# rows (slots at positions that leave up to 15 shards empty), gemma3-1b's
# long_500k caches of one slot at position 299999: its global layers'
# 524288 rows (shards 10-15 empty) and its local layers' full ring of 512.
CP_SHARDS = 16
CP_CACHES = {
    "qwen2-0.5b decode_32k": dict(
        b=8, hq=14, hkv=2, sq=1, skv=32768, d=64,
        kv_len=(1, 2048, 5000, 16384, 20001, 30000, 32768, 777)),
    "gemma3-1b long_500k global": dict(b=1, hq=4, hkv=1, sq=1, skv=524288,
                                       d=256, kv_len=(300000,)),
    "gemma3-1b long_500k local": dict(b=1, hq=4, hkv=1, sq=1, skv=512,
                                      d=256, kv_len=(512,))}
# Phase 16: dry-run cells, each in a subprocess of its own, one of each
# group of cells that once failed on the card's torch or outgrew the
# reference: rwkv6's and recurrentgemma's pads, the MoE's local shards, the
# MoE's and vision's memory, and the context-parallel cells (a
# sequence-sharded cache; mixtral's long_500k rows replicated over FSDP's
# dims).
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k", "both"),
                ("llama3.2-1b", "decode_32k", "single"),
                ("gemma3-1b", "long_500k", "single"),
                ("mixtral-8x7b", "long_500k", "single"),
                ("llama3.2-1b", "train_4k", "single"),
                ("mixtral-8x7b", "train_4k", "single"),
                ("rwkv6-1.6b", "train_4k", "single"),
                ("recurrentgemma-2b", "prefill_32k", "single"),
                ("mixtral-8x7b", "decode_32k", "both"),
                ("deepseek-v3-671b", "decode_32k", "single"),
                ("llama-3.2-vision-11b", "train_4k", "single"))
DRYRUN_TIMEOUT = 900
# The reference's own dry run of those cells on the single-pod mesh (JAX
# 0.9.0, XLA's CPU backend, 256 forced host devices: ``python -m
# repro.launch.dryrun --arch A --shape S --mesh single``): XLA's peak bytes
# a device (arguments + temp) and loop-weighted FLOPs a device.  The card
# has no JAX, so they are kept here.  Phase 16 holds each cell's single-pod
# peak under 80 GiB and within 2x, its FLOPs within 1.5x of these.
DRYRUN_REFERENCE = {  # (arch, shape): (peak bytes, FLOPs)
    ("mixtral-8x7b", "train_4k"): (10697766084, 585101129700383.0),
    ("rwkv6-1.6b", "train_4k"): (10265307044, 47930633438820.0),
    ("recurrentgemma-2b", "prefill_32k"): (6186151152, 202790093621792.0),
    ("mixtral-8x7b", "decode_32k"): (2651876076, 381451930226.0),
    ("deepseek-v3-671b", "decode_32k"): (24419606124, 5699662805738.0),
    ("llama-3.2-vision-11b", "train_4k"): (14432328268, 421061556782779.0),
    ("qwen2-0.5b", "decode_32k"): (1050907036, 9348430077.0),
    ("llama3.2-1b", "decode_32k"): (2460531732, 17410757622.0),
    ("gemma3-1b", "long_500k"): (571441928, 717560727.0),
    ("mixtral-8x7b", "long_500k"): (1223682504, 3768335853.0)}
# The reference's collective bytes a device (its HLO collectives' result
# bytes) on the context-parallel cells, which phase 16 holds within 4x.
DRYRUN_REFERENCE_COLL = {
    ("qwen2-0.5b", "decode_32k"): 1427456.0,
    ("llama3.2-1b", "decode_32k"): 5473280.0,
    ("gemma3-1b", "long_500k"): 231872.0,
    ("mixtral-8x7b", "long_500k"): 221153476.0}
# qwen2-0.5b training (phases 5, 6): full width, batch 4 x 2048.
QWEN_BATCH, QWEN_SEQ = 4, 2048
QWEN_PARITY_LAYERS = 2
QWEN_REMATS = ("none", "full", "dots", "dtr")
# The kernels one bf16 flash call launches, by the start of the profiler's
# names: the backward's tile kernels are ``..._wgmma_kernel`` (one
# warpgroup, D 64) or ``..._wg2_kernel<DP>`` (two, D 128 and 256).
FLASH_STEP_KERNELS = {"flash_attention": ("flash_wgmma_kernel",),
                      "flash_attention_bwd": ("flash_bwd_rowstat_kernel",
                                              "flash_bwd_dkdv_wg",
                                              "flash_bwd_reduce_kernel",
                                              "flash_bwd_dq_wg")}
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
# Phase 9: the training driver and the paper's experiments.  9a: the
# launcher at its defaults (llama3.2-1b, remat dtr, AdamW) at full width,
# batch 4 x 2048, 3 steps, without checkpoints (step 0 would write its
# 14.8 GB of parameters and moments).  9b: smollm-135m at batch 8 x 1024,
# 13 steps, checkpoints every 4 (the CLI keeps 2), interrupted before step
# 11 and resumed from step 8: the first run saves 0, 4, 8 and deletes 0,
# the second saves 12 and deletes 4, and both take steps 9 and 10.  9c: the
# examples; train_lm for 60 steps.  9d: Table 1's eager rows at the
# reference's width (dim 128) and at one whose weight is 1 GiB (vectors of
# 64 KiB), and Fig. 4's planner.
LLAMA_ARCH = "llama3.2-1b"
LLAMA_BATCH, LLAMA_SEQ, LLAMA_STEPS = 4, 2048, 3
SMOLLM_ARCH = "smollm-135m"
SMOLLM_BATCH, SMOLLM_SEQ = 8, 1024
RESUME = dict(steps=13, every=4, interrupt=11, keep=2)
TRAIN_LM_STEPS = 60
TREELSTM_DIMS = (128, 16384)
# Phase 9d: one whole case of Table 1's simulation (run_simulated, the
# engine only), held to the row the JAX package's engine gives on the CPU
# (pinned by tests/test_torch_examples.py).
TABLE1_CASE = "mlp"
TABLE1_ROW = {"bench": "sim", "model": "mlp", "budget": 26882,
              "max_plain": 1, "max_dtr": 4, "gain": 4.0}
# Phase 10: the serve surface.  10a and 10c serve 8 requests over 4 slots, 8
# tokens each, at --max-len 32 under a KV budget of 0.3 of the cache,
# squeezed to half of that for 16 of every 32 steps: each request's projected
# KV then fills most of a slot, so admission preempts (at the default
# --max-len 128 a 0.3 budget holds more than 4 requests and only the
# squeezes would).  10b serves rwkv6-1.6b at the launcher's lengths.
SURFACE_FLAGS = ["--requests", "8", "--slots", "4", "--gen", "8",
                 "--max-len", "32", "--kv-budget", "0.3", "--chaos-shrink",
                 "0.5", "--chaos-period", "16"]
SURFACE_ARCHS = ("rwkv6-1.6b", "qwen2-0.5b", "mixtral-8x7b")
# 10b: one request's 32 decode steps against forward over the same tokens
# through the WKV kernel, f32 (``simt``).  At RWKV_PARITY_LAYERS layers each
# row within RWKV_DECODE_F32 of max|logits| (the recurrence one token at a
# time against the kernel's sums; 1.5e-6 to 1.9e-6 of it on an H100 80GB
# HBM3 at 700 W).  At 24 random layers the first token's logits are
# ill-conditioned: there the WKV output is (r.(u*k)) v alone, and the head
# norm of a head whose dot product nearly cancels amplifies rounding.
# Forward against itself at another matmul row count (over the first 16
# tokens against over 32) differs there by 5.6e-4 to 1.1e-3, and decode
# (one-row matmuls) by 4.2e-4 to 1.4e-3, with max|logits| 0.82 to 0.95;
# from row 8 on decode is within 2.1e-4 (PERF.md, PR 20).  So at 24 layers
# the 32 rows are held as a whole, ||decode - forward|| / ||forward||
# within RWKV_DECODE_F32, the norm phase 6 holds f32 gradients to; the
# rows' max|d| are printed.  bf16 layer 0's time-mix output within the WKV
# kernel's bf16 tolerance (WKV_TOL) of its max, before 24 random layers
# amplify it.
RWKV_DECODE_STEPS = 32
RWKV_DECODE_F32 = 1e-3
WKV_STEP_KERNELS = {
    "rwkv6_fwd": ("span_kernel<64, false>", "scan_kernel<false>",
                  "fwd_kernel<64>"),
    "rwkv6_bwd": ("span_kernel<64, true>", "scan_kernel<true>",
                  "bwd_kernel<64>"),
}


def require(cond, what) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _norm(torch, x) -> float:
    return torch.linalg.vector_norm(x.float()).item()


def bf16_verdict(pairs) -> tuple:
    """The bf16 rule on ``pairs``, one ``(kernel, plain)`` pair a weight
    draw of each path's distance from the f32 plain path: at least
    ``BF16_DRAWS`` draws, every distance finite, and the median of the
    ratios kernel / plain within ``BF16_RATIO``.  Returns ``(ok,
    ratios)``."""
    ratios = [k / p if p > 0 else (1.0 if k == 0 else math.inf)
              for k, p in pairs]
    ok = (len(pairs) >= BF16_DRAWS
          and all(math.isfinite(k) and math.isfinite(p) for k, p in pairs)
          and statistics.median(ratios) <= BF16_RATIO)
    return ok, ratios


def require_bf16(pairs, what) -> None:
    ok, ratios = bf16_verdict(pairs)
    print(f"{what}, bf16 distance from the f32 plain path per draw, (kernel,"
          f" plain): {pairs}; ratios {ratios}, median "
          f"{statistics.median(ratios)!r} (limit {BF16_RATIO}) "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"bf16 parity, kernel path against plain: {what}")


def kernel_entry(mangled: str) -> str:
    """A kernel's name and the start of its template arguments (``If``:
    float, ``I13__nv_bfloat16``; ``Li256E``: 256) from its mangled name,
    past the anonymous namespace the sources put their kernels in."""
    outer = re.match(r"_ZN(\d+)", mangled)
    if outer is None:
        return mangled[:80]
    rest = mangled[outer.end() + int(outer.group(1)):]
    inner = re.match(r"(\d+)", rest)
    if inner is None:
        return mangled[:80]
    n = int(inner.group(1))
    name = rest[inner.end():inner.end() + n]
    return f"{name} {rest[inner.end() + n:][:28]}"


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


def own_gen(torch, what, gen, fresh):
    """``gen``, or for a shape named in ``fresh`` a generator of its own
    (seeded from the name), so that a shape added to a phase leaves every
    later phase's inputs as they were; the bf16 rule's weight draws take
    one each."""
    if what not in fresh:
        return gen
    return torch.Generator("cuda").manual_seed(zlib.crc32(what.encode()))


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


def device_ms(torch, fn, iters, top=0, by_name=None, per_call=None,
              expect=None):
    """Device time of one call (kernels only, no launch gaps) from the
    profiler; None where it sees no device time.  Only the device's own
    events count: a CPU operator's entry repeats its kernels' time.  With
    ``top``, also prints the ``top`` kernels by device time per call; a
    dict ``by_name`` receives each kernel's (ms per call, launches per
    call).  ``per_call``: the launches one call makes; a session that
    recorded fewer is incomplete (after a long run the profiler has come
    back with a part of a session's kernels) and is run again.  ``expect``
    maps a part of a kernel's name to the launches one call makes of the
    kernels so named: a session that recorded another count is run again
    too.  After three incomplete sessions, None."""
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
        named = {part: sum(count for _, count, name in kernels
                           if part in name) for part in expect or {}}
        if total_us > 0 and (per_call is None or seen >= per_call * iters) \
                and all(n == expect[p] * iters for p, n in named.items()):
            break
        print(f"  profiler saw {seen} kernels, {total_us!r} us, by name "
              f"{named} (attempt {attempt + 1}); profiling again")
        total_us = 0
    if total_us == 0:
        return None
    for us, count, name in kernels[:top]:
        print(f"  {us / 1e3 / iters:9.3f} ms/call {100 * us / total_us:5.1f}% "
              f"x{count // iters} {name[:100]}")
    if by_name is not None:
        by_name.update({name: (us / 1e3 / iters, count / iters)
                        for us, count, name in kernels})
    return total_us / 1e3 / iters


def bound(nbytes, flops, dtype_name):
    """The larger of bytes over the memory rate and operations over the
    peak rate for the type, in ms, and which of the two it is."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound_ms(shape, causal, itemsize, dtype_name, window=0,
                       lse=False):
    """Least time for the attention function on this input: each input read
    once and the output written once (with ``lse``, each row's f32 LSE
    too), over the memory rate; q.k and p.v FLOPs of the visible (query,
    key) pairs only, over the peak rate."""
    b, hq, hkv, sq, skv, d = (shape[k] for k in
                              ("b", "hq", "hkv", "sq", "skv", "d"))
    lens = shape["kv_len"] or (skv,) * b
    pairs = 0
    for n in lens:
        pairs += visible_pairs(1, sq, n, window) if causal else sq * n
    kv_rows = sum(lens)       # only the keys below kv_len are needed
    nbytes = (2 * b * hq * sq * d + 2 * kv_rows * hkv * d) * itemsize \
        + (4 * b if shape["kv_len"] else 0) + (4 * b * hq * sq if lse else 0)
    return bound(nbytes, 4 * hq * d * pairs, dtype_name)


def gemm_bound_ms(shape, itemsize, dtype_name):
    """Least time for the grouped GEMM: x, w read once and the output
    written once; 2 FLOPs per multiply-add of every row (the inputs here
    have no empty rows)."""
    e, c, d, f = shape
    return bound((e * c * d + e * d * f + e * c * f) * itemsize,
                 2 * e * c * d * f, dtype_name)


def visible_pairs(b, sq, skv, window=0):
    """Visible (query, key) pairs of one head under a bottom-right causal
    mask, and a sliding window of ``window`` keys if > 0, over the
    batch."""
    return b * sum(min(skv, i + skv - sq + 1, window or skv)
                   for i in range(sq))


def flash_bwd_bound_ms(case, itemsize):
    """Least time for the attention backward: q, k, v, o, dO and the f32
    LSE read once and dq, dk, dv written once, over the memory rate,
    against its five score-area products (S, dP, dV, dQ, dK: 2 * D FLOPs
    each per visible pair and query head) at the bf16 tensor-core peak.
    A non-causal call sees all Sq * Skv pairs."""
    b, hq, hkv, sq, skv, d, causal, window = case
    pairs = visible_pairs(b, sq, skv, window) if causal else b * sq * skv
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * skv * d) * itemsize \
        + 4 * b * hq * sq
    return bound(nbytes, 10 * hq * d * pairs, "bfloat16")


def flash_bwd_checks(torch, gen, cases=FLASH_BWD_CASES,
                     train_shapes=None, fresh=(), softcap=0.0) -> dict:
    """Phase 2 for the flash backward: the train forward's output and LSE
    against ``flash_reference_lse`` and a second call's bits, the backward
    kernels against ``flash_backward_reference`` on the same output and
    LSE, and a second call's bits; bf16 on the planned variant, on ``mma``
    where it takes the shape (D 64) and on ``simt``.  Returns each bf16
    train shape's (``train_shapes``, by name; phase 5's by default) max
    abs errors, forward and backward, on the planned variants.  Cases
    named in ``fresh`` (by ``str(case)``) draw from their own
    generators.  ``softcap`` > 0: the kernels and plain versions with
    the logit soft cap."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    if train_shapes is None:
        train_shapes = FLASH_TRAIN_SHAPES
    print("phase 2: flash_attention_bwd against flash_backward_reference"
          + (f", soft cap {softcap}" if softcap else ""))
    cap = {"softcap": softcap} if softcap else {}
    train_err = {}
    arch_of = {case: arch for arch, case in train_shapes.items()}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for case in cases:
            b, hq, hkv, sq, skv, d, causal, window = case
            shape = dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                         kv_len=None)
            g = own_gen(torch, str(case), gen, fresh)
            q, k, v, _ = inputs(torch, shape, dtype, g)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            before = read_variants()["flash_attention"]
            out, lse = fa._forward(q, k, v, causal, window, None,
                                   save_lse=True, **cap)
            fwd_variant = ran_variant({
                v_: n - before[v_] for v_, n in
                read_variants()["flash_attention"].items()})
            out2, lse2 = fa._forward(q, k, v, causal, window, None,
                                     save_lse=True, **cap)
            fwd_same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
            del out2, lse2
            want_out, want_lse = ref.flash_reference_lse(
                q, k, v, causal=causal, window=window, **cap)
            lse_err = (lse - want_lse).abs().max().item()
            out_err = (out.float() - want_out.float()).abs().max().item()
            out_ok = math.isfinite(out_err) and torch.allclose(
                out.float(), want_out.float(), rtol=TOL[dtype_name],
                atol=TOL[dtype_name])
            expect = ref.flash_backward_reference(
                q, k, v, out, lse, do, causal=causal, window=window, **cap)
            planned = fa.plan_backward(b, hq, hkv, sq, skv, d,
                                       dtype)["variant"]
            forced = ("mma",) if dtype == torch.bfloat16 and d == 64 else ()
            for variant in dict.fromkeys((planned, *forced, "simt")):
                before = read_variants()["flash_attention_bwd"]
                with backward_on(variant):
                    grads = fa.flash_attention_bwd(
                        q, k, v, out, lse, do, causal=causal, window=window,
                        **cap)
                    again = fa.flash_attention_bwd(
                        q, k, v, out, lse, do, causal=causal, window=window,
                        **cap)
                torch.cuda.synchronize()
                ran = ran_variant({
                    v_: n - before[v_] for v_, n in
                    read_variants()["flash_attention_bwd"].items()})
                require(ran == variant, f"planned {variant}, ran {ran}")
                rels, err = [], 0.0
                for g_, e in zip(grads, expect):
                    require(g_.dtype == dtype
                            and bool(torch.isfinite(g_).all()),
                            f"finite flash gradients {case}")
                    d_ = (g_.float() - e.float()).abs().max().item()
                    rels.append(d_ / e.float().abs().max().item())
                    err = max(err, d_)
                same = all(bool(torch.equal(a, b_))
                           for a, b_ in zip(grads, again))
                ok = (max(rels) <= FLASH_BWD_REL[dtype_name] and same
                      and lse_err <= LSE_TOL and out_ok and fwd_same)
                print(f"  {dtype_name} {case} fwd [{fwd_variant}] out "
                      f"max_abs_err={out_err!r} (tol {TOL[dtype_name]}), lse "
                      f"max|d|={lse_err!r} (tol {LSE_TOL}), second call same "
                      f"bits: {fwd_same}; bwd [{variant}] "
                      f"max|d|/max|g| q,k,v = "
                      f"{[float(f'{x:.3g}') for x in rels]} (limit "
                      f"{FLASH_BWD_REL[dtype_name]}); second call same "
                      f"bits: {same} {'ok' if ok else 'FAIL'}")
                require(ok, f"flash backward kernel against plain: "
                        f"{dtype_name} {case} {variant}")
                if (case in arch_of and dtype_name == "bfloat16"
                        and variant == planned):
                    require(fwd_variant == fa.plan(
                        b, hq, hkv, sq, skv, d, dtype,
                        save_lse=True)["variant"],
                        f"bf16 train forward on its planned variant {case}")
                    train_err[arch_of[case]] = {"fwd": out_err, "bwd": err}
                del grads, again
            del q, k, v, do, out, lse, expect, want_out
    require(train_err.keys() == train_shapes.keys(),
            f"every train shape on its planned variant: {sorted(train_err)}")
    return train_err


@contextmanager
def plain_kernels(ops, ref, f64=False):
    """Route the model's kernels to their plain versions, CUDA tensors
    too; ``f64``: flash attention's plain version computes in f64 and its
    output is cast back to the inputs' dtype (the same function rounded
    once, with no kernel in it)."""
    kernels = ops.flash_attention, ops.moe_gemm, ops.rwkv6_chunk

    def flash64(q, k, v, **kw):
        return ref.flash_reference(q.double(), k.double(), v.double(),
                                   **kw).to(q.dtype)

    ops.flash_attention = flash64 if f64 else ref.flash_reference
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
    plans = [(m, name, getattr(m, name)) for m, name in (
        (fa, "plan"), (mg, "plan"), (mg, "plan_backward"), (wkv, "plan"))]
    for m, name, plan in plans:
        setattr(m, name, lambda *a, plan=plan, **k: plan(
            *a, **dict(k, aligned=False)))
    try:
        with backward_on("simt"):
            yield
    finally:
        for m, name, plan in plans:
            setattr(m, name, plan)


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
                                                     flash_attention_bwd,
                                                     flash_attention_lse)
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_bwd
    from repro_torch.kernels.rwkv6_chunk import rwkv6_bwd, rwkv6_fwd
    return {"flash_attention": flash_attention,
            "flash_attention_lse": flash_attention_lse,
            "flash_attention_bwd": flash_attention_bwd, "moe_gemm": moe_gemm,
            "moe_gemm_bwd": moe_gemm_bwd, "rwkv6_fwd": rwkv6_fwd,
            "rwkv6_bwd": rwkv6_bwd}


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


def counting_steps(per_step, hook=None):
    """An ``on_step`` that keeps each finished step's launches (in all and
    per variant) and resets the counts before the next; ``hook(step)``, if
    given, runs after."""
    started = []

    def on_step(step):
        if started:
            per_step.append((read_launches(), read_variants()))
        started.append(step)
        reset_launches()
        if hook is not None:
            hook(step)
    return on_step


def ran_variant(counts) -> str:
    """The variant, or variants joined by '+', that a run's counts show."""
    return "+".join(v for v, n in counts.items() if n)


def require_wgmma(variants, what) -> None:
    """Every bf16 launch of a path went to a tensor-core variant."""
    require(all(v["simt"] == 0 for v in variants.values()),
            f"{what}: bf16 launches on the CUDA-core variant {variants}")


def time_row(torch, fns, iters, bound_ms_by, what, card, per_call=None,
             passes=None, events_only=False):
    """Device and event time of each named call, beside the bound.  A name
    that starts with ``simt`` is timed with its wrappers planned onto the
    CUDA-core variants, one that starts with ``mma`` with the flash
    backward on its ``mma`` schedule.  ``per_call`` maps a name to the
    kernels one call launches (see ``device_ms``); ``passes`` maps a name to
    the kernel names whose device ms per call the row also keeps, under
    ``<name>_passes``.  ``events_only``: each time is CUDA events around
    back-to-back calls (no profiler), for calls of a millisecond or more,
    where the host's enqueue hides under the card's work."""
    row = {}
    for name, fn in fns:
        forced = (simt_only() if name.startswith("simt") else
                  backward_on("mma") if name.startswith("mma") else
                  nullcontext())
        by_name = {}
        with forced:
            if events_only:
                row[name] = event_ms(torch, fn, iters)
                continue
            row[name] = device_ms(torch, fn, iters,
                                  by_name=by_name,
                                  per_call=(per_call or {}).get(name))
            require(row[name] is not None, f"profiler device time, {name}")
            if name == "library_ms":      # the library's heaviest kernel
                row["library_kernel"] = max(
                    by_name, key=lambda n: by_name[n][0])[:120]
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
    from repro_torch.models.params import tree_map

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

    want = {"float32": "simt", "bfloat16": "wgmma"}

    def step_logits(params, base, tok, dtype, plain):
        return decode_logits(torch, cfg, params, base, tok, pos, dtype,
                             plain, want)

    k32 = step_logits(params, base, tok, "float32", False)
    p32 = step_logits(params, base, tok, "float32", True)
    scale = p32.abs().max().item()
    d32 = (k32 - p32).abs().max().item()
    print(f"phase 4: {arch} full-width decode step, kernel vs plain: "
          f"f32 max|d|={d32!r} (limit {PARITY_F32} x max|logits|="
          f"{scale!r})")
    require(d32 <= PARITY_F32 * scale, f"f32 parity {d32} > {PARITY_F32} x "
            f"{scale}")
    del k32, p32
    layer0_bf16(torch, arch, cfg, params, base, tok, pos)

    # -- 5. decode-step times ------------------------------------------------
    prepared = M.prepare_params(cfg, params)
    for path, ctx in (("kernel", nullcontext), ("simt kernel", simt_only),
                      ("plain", lambda: plain_kernels(ops, ref))):
        cache = tree_map(lambda t: t.to(torch.bfloat16, copy=True), base)

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
    del prepared, params, cache, base
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4, bf16: the repaired rule over weight draws of their own -------------
    pairs = []
    for i in range(BF16_DRAWS):
        g = own_gen(torch, f"{arch} phase 4 draw {i}", gen,
                    (f"{arch} phase 4 draw {i}",))
        w = M.init_params(cfg, g)
        c, t = decode_inputs(torch, cfg, 4, 128, g)
        r32 = step_logits(w, c, t, "float32", True)
        r16 = step_logits(w, c, t, "bfloat16", True)
        k16 = step_logits(w, c, t, "bfloat16", False)
        pairs.append((_norm(torch, k16 - r32), _norm(torch, r16 - r32)))
        agree = (k16.argmax(-1) == r16.argmax(-1)).float().mean().item()
        print(f"  {arch} draw {i}: max|logits| {r32.abs().max().item()!r}, "
              f"bf16 argmax agreement, kernel vs plain, {agree:.2f}")
        del w, c, r32, r16, k16
        gc.collect()
        torch.cuda.empty_cache()
    require_bf16(pairs, f"phase 4: {arch} full-width decode-step logits")
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


def _leaf_dists(torch, a, ref) -> dict:
    """Each leaf's ||a - ref|| / ||ref|| (Frobenius), by path."""
    from repro_torch.models.params import tree_items
    out = {}
    for (path, x), (_, y) in zip(tree_items(a), tree_items(ref)):
        y = y.to(x.device).float()
        norm = torch.linalg.vector_norm(y).item()
        err = torch.linalg.vector_norm(x.float() - y).item()
        out[path] = err / norm if norm > 0 else err
    return out


def _worst_ratio_leaf(kernel, plain) -> tuple:
    """The leaf whose kernel distance is the largest multiple of its plain
    distance: ``(kernel, plain, path)``."""
    def ratio(path):
        k, p = kernel[path], plain[path]
        return k / p if p > 0 else (1.0 if k == 0 else math.inf)
    path = max(kernel, key=ratio)
    return kernel[path], plain[path], path


def bf16_train_draws(torch, cfg, what, run, host=False) -> None:
    """The bf16 rule for one loss-and-grads call: on ``BF16_DRAWS`` weight
    draws of ``cfg``, each from its own generator, ``run(params, dtype,
    plain)`` -> ``(loss, grads)`` through the plain path in f32 and bf16 and
    the kernel path in bf16.  Held by :func:`require_bf16`: the kernel
    path's loss distance |l - l32| from the f32 plain path against the
    plain path's, root-mean-square over the draws, and the gradients leaf
    by leaf, ||g - g32|| / ||g32||, at the leaf where the kernel path's
    distance is the largest multiple of the plain path's.
    ``host``: the f32 gradients wait on the host."""
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    losses, leaves = [], []
    for i in range(BF16_DRAWS):
        key = f"{what} draw {i}"
        params = M.init_params(cfg, own_gen(torch, key, None, (key,)))
        l32, g32 = run(params, "float32", True)
        if host:
            g32 = tree_map(lambda t: t.cpu(), g32)
        lp, grads = run(params, "bfloat16", True)
        plain = _leaf_dists(torch, grads, g32)
        del grads
        lk, grads = run(params, "bfloat16", False)
        kernel = _leaf_dists(torch, grads, g32)
        del grads, params, g32
        gc.collect()
        torch.cuda.empty_cache()
        losses.append((abs(lk - l32), abs(lp - l32)))
        dk, dp, at = _worst_ratio_leaf(kernel, plain)
        leaves.append((dk, dp))
        worst_k = max(kernel, key=kernel.get)
        worst_p = max(plain, key=plain.get)
        print(f"  {what} draw {i}: f32 plain loss {l32!r}, bf16 loss kernel "
              f"{lk!r}, plain {lp!r}; ||g - g32||/||g32|| at the leaf of the "
              f"largest kernel/plain ratio ({at}): kernel {dk!r}, plain "
              f"{dp!r}; worst leaves: kernel {kernel[worst_k]!r} "
              f"({worst_k}), plain {plain[worst_p]!r} ({worst_p})")
    # The loss is one number, and the two bf16 paths share all but their
    # kernels' rounding, so the plain path's distance can nearly vanish on
    # one draw: each draw's kernel distance is held against the plain
    # path's root-mean-square distance over the draws.
    pooled = math.sqrt(statistics.fmean(p * p for _, p in losses))
    require_bf16([(k, pooled) for k, _ in losses],
                 f"{what}: loss (against the plain path's RMS distance "
                 f"{pooled!r}; per draw {[p for _, p in losses]})")
    require_bf16(leaves, f"{what}: gradients, the leaf of the largest "
                 f"ratio")


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

    def run(params, dtype, plain):
        with plain_kernels(ops, ref) if plain else nullcontext():
            loss, grads = loss_and_grads(cut.replace(dtype=dtype), params,
                                         batch)
        torch.cuda.synchronize()
        require(math.isfinite(float(loss)), f"finite {dtype} loss")
        return float(loss), grads

    l32, g32 = run(params, "float32", False)
    p32, gp32 = run(params, "float32", True)
    d32, at32 = _leaf_rel(torch, g32, gp32)
    print(f"phase 6: {RWKV_ARCH} full width, {RWKV_PARITY_LAYERS} layers, "
          f"batch {TRAIN_BATCH}x{TRAIN_SEQ}, kernel vs plain: f32 loss "
          f"{l32!r} vs {p32!r}, worst leaf ||d||/||g|| {d32!r} ({at32}; "
          f"limit {TRAIN_PARITY_F32})")
    require(abs(l32 - p32) <= TRAIN_PARITY_F32 * abs(p32), "f32 loss parity")
    require(d32 <= TRAIN_PARITY_F32, "f32 gradient parity")
    del params, g32, gp32
    gc.collect()
    torch.cuda.empty_cache()
    bf16_train_draws(torch, cut, f"phase 6: {RWKV_ARCH} full width, "
                     f"{RWKV_PARITY_LAYERS} layers", run)
    del batch
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
        torch.cuda.reset_peak_memory_stats()
        res = train.train_loop(train.config_from_args(args), params, args,
                               verbose=False,
                               on_step=counting_steps(per_step))
        per_step.append((read_launches(), read_variants()))
        # The record only: the next run's peak holds no moments of this one.
        runs[remat] = (res.drop_state(), per_step)
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


def _train_batch(torch, cfg, step=0, batch=QWEN_BATCH, seq=QWEN_SEQ):
    """Step ``step``'s tokens of the synthetic stream (``[B,S,K]`` for a
    codebook model), on the card."""
    from repro_torch.data.pipeline import SyntheticLM
    return {"tokens": torch.from_numpy(SyntheticLM(
        vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0,
        n_codebooks=cfg.n_codebooks).batch_at(step)["tokens"]).cuda()}


def _step_kernels_ms(names, parts, calls):
    """Device ms per call of a kernel inside a profiled step, from the
    profiler's per-name sums; and each part's."""
    found = {p: sum(ms for n, (ms, _) in names.items() if p in n)
             for p in parts}
    return sum(found.values()) / calls, {p: ms / calls
                                         for p, ms in found.items()}


def flash_train_times(torch, card, gen, shapes=None, fresh=False,
                      simt=False) -> dict:
    """Phase 5 for the flash kernels at each train shape of ``shapes``
    (phase 5's by default), before any large profile: the forward that
    saves the LSE and the backward (with each pass's device time) on
    their planned variants, beside their bounds, their plain versions and
    SDPA's forward and backward on the same call (timed apart; a windowed
    call with an explicit boolean mask, a non-causal one with none); at
    qwen2's shape also the backward's earlier designs, ``mma`` and
    ``simt``; at head dims 128 and 256, and everywhere with ``simt``, the
    forward's and the backward's earlier design, ``simt``, on the same
    inputs.  ``fresh``: each shape draws from a generator of its own.
    Returns the rows by name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = {}
    for arch, case in (shapes or FLASH_TRAIN_SHAPES).items():
        b, hq, hkv, sq, skv, d, causal, window = case
        shape = dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d, kv_len=None)
        g = own_gen(torch, f"{arch} times", gen,
                    (f"{arch} times",) if fresh else ())
        q, k, v, _ = inputs(torch, shape, torch.bfloat16, g)
        do = torch.randn(q.shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        out, lse = fa._forward(q, k, v, causal, window, None, save_lse=True)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        # A window as long as the sequence is plain causal attention.
        lib_kw = ({} if not causal else
                  dict(is_causal=True) if window in (0, sq) else
                  dict(attn_mask=_window_mask(torch, sq, skv, window)))
        earlier_fwd = simt or d != 64
        lib_out = F.scaled_dot_product_attention(*xs, enable_gqa=True,
                                                 **lib_kw)
        variant = fa.plan_backward(*case[:6], torch.bfloat16)["variant"]
        require(variant == "wgmma" and fa.plan(
            *case[:6], torch.bfloat16, save_lse=True)["variant"] == "wgmma",
            f"{arch}'s train forward and backward planned on wgmma")

        def fwd_call():
            return fa._forward(q, k, v, causal, window, None, save_lse=True)

        fwd = time_row(torch, (
            ("ms", fwd_call),
            *((("simt_ms", fwd_call),) if earlier_fwd else ()),
            ("plain_ms", lambda: ref.flash_reference_lse(
                q, k, v, causal=causal, window=window)),
            ("library_ms", lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **lib_kw))), 10,
            attention_bound_ms(shape, causal, 2, "bfloat16", window),
            f"flash_attention train forward, {arch} {list(case[:6])} causal "
            f"{causal} window {window} bf16, saving the LSE (library: SDPA "
            f"forward"
            f"{'; simt_ms: the previous design' if earlier_fwd else ''})",
            card, {"ms": 1, "simt_ms": 1})
        bwd = (lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                              causal=causal, window=window))
        earlier = ((("mma_ms", bwd), ("simt_ms", bwd))
                   if case == FLASH_TRAIN else
                   (("simt_ms", bwd),) if earlier_fwd else ())
        rows[arch] = {"fwd": fwd, "bwd": time_row(torch, (
            ("ms", bwd), *earlier,
            ("plain_ms", lambda: ref.flash_backward_reference(
                q, k, v, out, lse, do, causal=causal, window=window)),
            ("library_ms", lambda: torch.autograd.grad(
                lib_out, xs, do, retain_graph=True))), 5,
            flash_bwd_bound_ms(case, 2),
            f"flash_attention_bwd, {arch} {list(case[:6])} causal {causal} "
            f"window {window} bf16 (ms: {variant}"
            f"{'; mma_ms: the previous design' if case == FLASH_TRAIN else ''}"
            f"{'; simt_ms: the previous design' if earlier_fwd else ''}; "
            f"library: SDPA's backward alone)", card,
            {"ms": 4, "mma_ms": 3, "simt_ms": 3},
            {"ms": FLASH_STEP_KERNELS["flash_attention_bwd"],
             "mma_ms": FLASH_MMA_BWD_KERNELS,
             "simt_ms": FLASH_SIMT_BWD_KERNELS})}
        del q, k, v, do, out, lse, xs, lib_out
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def d256_kernel_checks(torch, gen) -> dict:
    """Phase 2 at head dim 256 (gemma3-1b, recurrentgemma-2b): the train
    shapes' forward with the LSE and backward (``flash_bwd_checks``), then
    the decode shapes' forward with mixed ``kv_len`` against
    ``flash_reference`` and a second call's bits, f32 and bf16.  Every
    shape draws from a generator of its own.  Returns the bf16 max abs
    errors by shape name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    errs = flash_bwd_checks(torch, gen, list(FLASH_D256.values()),
                            FLASH_D256,
                            tuple(str(c) for c in FLASH_D256.values()))
    return {**errs, **decode_kernel_checks(torch, gen, D256_DECODE)}


def decode_kernel_checks(torch, gen, shapes, softcap=0.0) -> dict:
    """Phase 2 for the flash forward at the decode shapes ``shapes`` (by
    name; a shape without ``causal`` is causal, one with ``kv_len`` None
    sees every key): against ``flash_reference`` and a second call's bits,
    f32 on ``simt`` and bf16 on ``wgmma``.  Each shape draws from a
    generator of its own.  Returns the bf16 max abs errors by name.
    ``softcap`` > 0: with the logit soft cap."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    errs = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for what, shape in shapes.items():
            q, k, v, kv_len = inputs(torch, shape, dtype,
                                     own_gen(torch, what, gen, (what,)))
            kw = dict(causal=shape.get("causal", True), kv_len=kv_len,
                      **({"softcap": softcap} if softcap else {}))
            want = "wgmma" if dtype == torch.bfloat16 else "simt"
            require(fa.plan(*(shape[n] for n in ("b", "hq", "hkv", "sq",
                                                  "skv", "d")),
                            dtype)["variant"] == want,
                    f"{what} planned on {want}")
            err = compare(torch, fa.flash_attention, ref.flash_reference,
                          (q, k, v), kw, TOL[dtype_name],
                          f"{dtype_name} {what} {shape}")
            same = bool(torch.equal(fa.flash_attention(q, k, v, **kw),
                                    fa.flash_attention(q, k, v, **kw)))
            print(f"  {what}: second call same bits: {same}")
            require(same, f"{what}: a second call's bits")
            if dtype_name == "bfloat16":
                errs[what] = {"fwd": err}
            del q, k, v, kv_len
    return errs


def _window_mask(torch, sq, skv, window):
    """SDPA's boolean mask for a bottom-right causal window: True where a
    query sees a key."""
    i = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
    j = torch.arange(skv, device="cuda")[None, :]
    return (j <= i) & (i - j < window)


def flash_decode_times(torch, card, gen, shapes) -> dict:
    """Phase 5 for the flash forward at each decode shape of ``shapes``
    (``wgmma``; causal unless the shape says otherwise), beside its
    previous design (``simt``) on the same inputs, the bound, the plain
    version and SDPA with ``kv_len`` as its mask (none where ``kv_len`` is
    None).  Returns the rows by shape name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = {}
    for what, shape in shapes.items():
        q, k, v, kv_len = inputs(torch, shape, torch.bfloat16, own_gen(
            torch, f"{what} times", gen, (f"{what} times",)))
        causal = shape.get("causal", True)
        kw = dict(causal=causal, kv_len=kv_len)
        keep = None if kv_len is None else (
            torch.arange(shape["skv"], device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
        rows[what] = {"fwd": time_row(torch, (
            ("ms", lambda: fa.flash_attention(q, k, v, **kw)),
            ("simt_ms", lambda: fa.flash_attention(q, k, v, **kw)),
            ("plain_ms", lambda: ref.flash_reference(q, k, v, **kw)),
            ("library_ms", lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep, enable_gqa=True))), 100,
            attention_bound_ms(shape, causal, 2, "bfloat16"),
            f"flash_attention, {what} {shape} bf16, wgmma (simt_ms: the "
            f"previous design)", card)}
        del q, k, v, kv_len, keep
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

    def run(params, dtype, plain):
        reset_launches()
        with plain_kernels(ops, ref) if plain else nullcontext():
            loss, grads = loss_and_grads(cut.replace(dtype=dtype), params,
                                         batch)
        torch.cuda.synchronize()
        require(math.isfinite(float(loss)), f"finite {dtype} loss")
        if not plain:
            n = read_launches()
            require(n["flash_attention"] == n["flash_attention_bwd"]
                    == cut.n_layers, f"2-layer launches {n}")
        return float(loss), grads

    l32, g32 = run(params, "float32", False)
    p32, gp32 = run(params, "float32", True)
    d32, at32 = _leaf_rel(torch, g32, gp32)
    print(f"phase 6: {ARCH} full width, {QWEN_PARITY_LAYERS} layers, batch "
          f"{QWEN_BATCH}x{QWEN_SEQ}, kernel vs plain: f32 loss {l32!r} vs "
          f"{p32!r}, worst leaf ||d||/||g|| {d32!r} ({at32}; limit "
          f"{TRAIN_PARITY_F32})")
    require(abs(l32 - p32) <= TRAIN_PARITY_F32 * abs(p32), "f32 loss parity")
    require(d32 <= TRAIN_PARITY_F32, "f32 gradient parity")
    del params, g32, gp32
    gc.collect()
    torch.cuda.empty_cache()
    bf16_train_draws(torch, cut, f"phase 6: {ARCH} full width, "
                     f"{QWEN_PARITY_LAYERS} layers", run)
    del batch
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
    torch.cuda.reset_peak_memory_stats()
    res = train.train_loop(train.config_from_args(args), params, args,
                           verbose=False,
                           on_step=counting_steps(per_step)).drop_state()
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
    with tempfile.TemporaryDirectory() as ckpt_dir:
        train.main(["--arch", ARCH, "--steps", "1", "--batch", "1", "--seq",
                    str(QWEN_SEQ), "--remat", "names:attn_out,ffn_out",
                    "--optimizer", "adafactor", "--ckpt-dir", ckpt_dir])
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


def serve_log_replay(log, phase="7d") -> None:
    """Phase 7d (10c): a captured qwen2-0.5b serve log through the copied
    engine: the static checker, then scan == index replay."""
    from repro_torch.check import check_log
    from repro_torch.trace.replay import verify_oracle_equivalence
    t0 = time.perf_counter()
    check_log(log)
    rep = verify_oracle_equivalence(log, fractions=SERVE_FRACTIONS)
    runs = rep["index_results"].values()
    print(f"phase {phase}: {log.name} ({log.op_count()} ops): check_log ok; "
          f"scan == index over {rep['cells']} cells at {SERVE_FRACTIONS} of "
          f"the baseline peak {rep['baseline_peak']!r}: {rep['ok']} "
          f"(mismatches {rep['mismatches']}); evictions "
          f"{sum(r.evictions for r in runs)}, remats "
          f"{sum(r.remat_ops for r in runs)}; "
          f"{time.perf_counter() - t0:.1f} s")
    require(rep["ok"], f"{phase}: scan and index replays differ")


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


class Interrupt(Exception):
    """Raised from a train loop's ``on_step`` to cut a run short."""


def host_state(res) -> dict:
    """A host copy of a train run's parameters and optimizer state."""
    from repro_torch.models.params import tree_items
    out = {f"params.{p}": t.cpu().clone() for p, t in tree_items(res.params)}
    out.update({f"opt.{p}": t.cpu().clone()
                for p, t in tree_items(res.opt_state.inner)})
    out["opt.step"] = res.opt_state.step
    return out


def same_state(a: dict, b: dict) -> bool:
    import torch
    return a.keys() == b.keys() and all(
        torch.equal(x, b[k]) if isinstance(x, torch.Tensor) else x == b[k]
        for k, x in a.items())


def check_flash_steps(per_step, cfg, fwd_per_layer, what) -> dict:
    """Every step launched the flash forward ``fwd_per_layer`` times a layer
    and the backward once, all on ``wgmma``; returns the sums."""
    for counts, variants in per_step:
        require(counts["flash_attention"] == fwd_per_layer * cfg.n_layers
                and counts["flash_attention_bwd"] == cfg.n_layers,
                f"{what}: flash launches per step {counts}")
        require_wgmma({k: variants[k] for k in FLASH_STEP_KERNELS}, what)
        require_wgmma_backward(variants["flash_attention_bwd"], what)
    return {k: sum(c[k] for c, _ in per_step) for k in FLASH_STEP_KERNELS}


def loop_stamps(per_step, hook=None):
    """:func:`counting_steps` that also keeps the host clock at each step's
    start; returns the ``on_step`` and the list of clock readings."""
    stamps = []

    def stamp(step):
        stamps.append(time.perf_counter())
        if hook is not None:
            hook(step)
    return counting_steps(per_step, stamp), stamps


def loop_walls_ms(stamps, end) -> list:
    """The loop's wall per step from its start stamps and the clock at the
    loop's end: the step, its host syncs, its telemetry and checkpoint,
    and the next step's batch."""
    return [round((b - a) * 1e3, 1) for a, b in zip(stamps, stamps[1:]
                                                   + [end])]


def guarded_step(cfg, opt):
    """The launcher's step: ``make_train_step`` with a fresh divergence
    guard, as ``train_loop`` builds it (its loss and gradient norm reach
    the host before the update).  Returns ``one(params, state, batch)``
    and the list of the guard's actions."""
    from repro_torch.distributed.monitor import DivergenceGuard
    from repro_torch.launch.steps import make_train_step
    step_fn = make_train_step(cfg, opt, guard=DivergenceGuard())
    actions = []

    def one(params, state, batch):
        actions.append(step_fn(params, state, batch)[2]["action"])
    return one, actions


def step_breakdown(torch, card, what, one_step, tokens, calls) -> dict:
    """One step's device busy time (profiler), wall (CUDA events), idle
    share and tokens/s, and the flash kernels' device ms per call inside
    it (``calls``: each kernel's launches in the step)."""
    print(f"phase 9: {what}, kernels by device time:")
    names = {}
    busy_ms = device_ms(torch, one_step, 1, top=8, by_name=names)
    require(busy_ms is not None, f"profiler device time, {what}")
    inside = {}
    for name, parts in FLASH_STEP_KERNELS.items():
        inside[name], each = _step_kernels_ms(names, parts, calls[name])
        print(f"  {name} inside the step: {inside[name]!r} ms per call "
              f"({calls[name]} calls; {each}) [{card}]")
    wall_ms = event_ms(torch, one_step, 2)
    row = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms,
           "tokens_per_s": tokens / (wall_ms / 1e3), "inside": inside}
    print(f"phase 9: {what}: wall {wall_ms!r} ms, device busy {busy_ms!r} "
          f"ms, idle share {row['idle_share']!r}, {row['tokens_per_s']!r} "
          f"tokens/s [{card}]")
    return row


def launcher_phase(torch, card) -> dict:
    """Phase 9a: the train launcher at its defaults on llama3.2-1b at full
    width; then one loss-and-grads call under remat none and under dtr.
    Returns the loop's flash launches and the step's breakdown."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items, tree_map
    from repro_torch.optim import adamw, cosine_schedule
    args = train.parse_args(["--steps", str(LLAMA_STEPS), "--batch",
                             str(LLAMA_BATCH), "--seq", str(LLAMA_SEQ)])
    require((args.arch, args.remat, args.optimizer)
            == (LLAMA_ARCH, "dtr", "adamw"), f"launcher defaults {args}")
    cfg = train.config_from_args(args)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n = sum(t.numel() for _, t in tree_items(params))
    print(f"phase 9a: {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab}, tied {cfg.tie_embeddings}: {n} parameters; the "
          f"launcher's defaults (remat {args.remat}, {args.optimizer}), "
          f"batch {args.batch}x{args.seq}, {args.steps} steps, no "
          f"checkpoints")
    per_step = []
    on_step, stamps = loop_stamps(per_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.train_loop(cfg, params, args, on_step=on_step)
    end = time.perf_counter()
    per_step.append((read_launches(), read_variants()))
    launches = check_flash_steps(per_step, cfg, 2, "phase 9a, train loop")
    mem = res.memory
    walls = loop_walls_ms(stamps, end)
    print(f"phase 9a: {cfg.name} train loop: losses {res.losses}, grad "
          f"norms {res.grad_norms}, step ms "
          f"{[round(t * 1e3, 1) for t in res.step_seconds]}, the loop's wall "
          f"per step (telemetry and the next batch included) {walls} "
          f"({end - t0:.1f} s with set-up), flash launches per step "
          f"{[(c['flash_attention'], c['flash_attention_bwd']) for c, _ in per_step]}"
          f" per variant {[(v['flash_attention'], v['flash_attention_bwd']) for _, v in per_step]}"
          f", max_memory_allocated {res.peak_bytes / 2**30:.3f} GiB; "
          f"MemoryMonitor summary {mem} [{card}]")
    require(all(math.isfinite(x) for x in res.losses)
            and res.actions == ["ok"] * LLAMA_STEPS, "9a: finite steps")
    require(mem["min_largest_free"] is not None and mem["peak_bytes"] > 0,
            "9a: the allocator's telemetry")

    opt = adamw(lr=cosine_schedule(args.lr, warmup=20, total=args.steps))
    one, actions = guarded_step(cfg, opt)
    state = res.opt_state
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed)
    batch = {"tokens": torch.from_numpy(
        data.batch_at(args.steps)["tokens"]).cuda()}
    row = step_breakdown(
        torch, card, f"9a {cfg.name} full-width train step as the launcher "
        f"runs it (the guard's host sync before the update), batch "
        f"{args.batch}x{args.seq}, bf16, AdamW, remat dtr",
        lambda: one(params, state, batch), args.batch * args.seq,
        {"flash_attention": 2 * cfg.n_layers,
         "flash_attention_bwd": cfg.n_layers})
    require(set(actions) == {"ok"}, f"9a: the guard passed {actions}")
    bare = make_train_step(cfg, opt)
    row["wall_ms_unguarded"] = event_ms(
        torch, lambda: bare(params, state, batch), 2)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    for _ in range(5):
        train.device_memory(device)
    row["telemetry_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    row["loop_wall_ms"] = walls
    print(f"phase 9a: the same step without the guard: wall "
          f"{row['wall_ms_unguarded']!r} ms; the launcher's per-step "
          f"telemetry (device_memory: memory_snapshot and mem_get_info) "
          f"{row['telemetry_ms']!r} ms on the host [{card}]")
    row["peak_bytes"] = res.peak_bytes
    del opt, one, bare, state, res
    gc.collect()
    torch.cuda.empty_cache()

    base, peaks = None, {}
    for remat in ("none", "dtr"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss, grads = loss_and_grads(cfg.replace(remat=remat), params,
                                     batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        n_launch = read_launches()
        if base is None:
            base = (float(loss), tree_map(lambda t: t.cpu(), grads))
            same = True
        else:
            same = float(loss) == base[0] and all(
                torch.equal(a.cpu(), b_) for (_, a), (_, b_) in
                zip(tree_items(grads), tree_items(base[1])))
        print(f"phase 9a: {cfg.name} loss and grads, remat {remat}: loss "
              f"{float(loss)!r}, flash launches fwd "
              f"{n_launch['flash_attention']} bwd "
              f"{n_launch['flash_attention_bwd']}, max_memory_allocated "
              f"{peaks[remat] / 2**30:.3f} GiB; bit-identical to none: "
              f"{same} [{card}]")
        require(same, f"9a: remat {remat} changes no number")
        del loss, grads
    require(peaks["dtr"] < peaks["none"], "9a: dtr holds less than none")
    row["peaks"] = peaks
    del params, batch, base
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step": row}


def resume_phase(torch, card) -> dict:
    """Phase 9b: checkpoint and resume at full width on smollm-135m: a
    launcher run interrupted before step ``RESUME['interrupt']``, then a
    fresh launcher with the same arguments, which restores the last
    checkpoint.  Returns the first run's flash launches and a step's
    breakdown."""
    import os
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw, cosine_schedule
    cfg = configs.get(SMOLLM_ARCH).replace(remat="dtr")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        argv = ["--arch", SMOLLM_ARCH, "--steps", str(RESUME["steps"]),
                "--batch", str(SMOLLM_BATCH), "--seq", str(SMOLLM_SEQ),
                "--ckpt-every", str(RESUME["every"]), "--ckpt-dir", ckpt_dir]
        first, saved, per_step = train.TrainResult(), {}, []
        resumed_at = RESUME["interrupt"] // RESUME["every"] * RESUME["every"]

        def kept_after(n_steps):
            return [f"step_{s_:010d}" for s_ in
                    range(0, n_steps, RESUME["every"])][-RESUME["keep"]:]

        def stop(step):
            if step == resumed_at + 1:
                saved.update(host_state(first))
            if step == RESUME["interrupt"]:
                raise Interrupt

        on_step, stamps = loop_stamps(per_step, stop)
        t0 = time.perf_counter()
        try:
            train.main(argv, on_step=on_step, result=first)
        except Interrupt:
            pass
        else:
            require(False, "9b: the run was not interrupted")
        end = time.perf_counter()
        first_s = end - t0
        first.drop_state()
        # The interrupt is raised at the start of the last stamped step.
        walls = loop_walls_ms(stamps[:-1], stamps[-1])
        launches = check_flash_steps(per_step, cfg, 2, "phase 9b, first run")
        kept = sorted(os.listdir(ckpt_dir))
        second, restored = train.TrainResult(), {}

        def check(step):
            if step == resumed_at + 1:
                restored["same"] = same_state(host_state(second), saved)

        t0 = time.perf_counter()
        train.main(argv, on_step=check, result=second)
        second_s = time.perf_counter() - t0
        after = sorted(os.listdir(ckpt_dir))
        both = [s_ for s_ in second.steps if s_ in first.steps]
        same_losses = both and all(
            first.losses[first.steps.index(s_)]
            == second.losses[second.steps.index(s_)] for s_ in both)
        print(f"phase 9b: {SMOLLM_ARCH} ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads), batch "
              f"{SMOLLM_BATCH}x{SMOLLM_SEQ}, bf16, AdamW, remat dtr: first "
              f"run steps {first.steps} losses {first.losses} "
              f"({first_s:.1f} s with set-up), the loop's wall per step "
              f"(checkpoints at steps 0, {RESUME['every']}, ... included) "
              f"{walls}, interrupted before step {RESUME['interrupt']}; "
              f"checkpoints {kept}; the resumed "
              f"run started at {second.start_step} ({second_s:.1f} s), "
              f"restored parameters and optimizer state bit-identical to "
              f"the ones saved: {restored.get('same')}; steps {second.steps}"
              f" losses {second.losses}; steps {both} bit-identical to the "
              f"first run's: {same_losses}; directories after {after}; "
              f"flash launches per step "
              f"{[(c['flash_attention'], c['flash_attention_bwd']) for c, _ in per_step]}"
              f" [{card}]")
        require(second.start_step == resumed_at + 1, "9b: resumed step")
        require(restored.get("same") is True, "9b: restored state")
        require(same_losses and len(both) == RESUME["interrupt"]
                - resumed_at - 1, "9b: resumed losses")
        require(kept == kept_after(RESUME["interrupt"])
                and after == kept_after(RESUME["steps"]),
                f"9b: the kept checkpoints {kept}, {after}")

        opt = adamw(lr=cosine_schedule(3e-4, warmup=20,
                                       total=RESUME["steps"]))
        one, actions = guarded_step(cfg, opt)
        batch = {"tokens": torch.from_numpy(SyntheticLM(
            vocab=cfg.vocab, seq_len=SMOLLM_SEQ, batch=SMOLLM_BATCH,
            seed=0).batch_at(RESUME["steps"])["tokens"]).cuda()}
        row = step_breakdown(
            torch, card, f"9b {SMOLLM_ARCH} full-width train step as the "
            f"launcher runs it (the guard's host sync before the update), "
            f"batch {SMOLLM_BATCH}x{SMOLLM_SEQ}, bf16, AdamW, remat dtr",
            lambda: one(second.params, second.opt_state, batch),
            SMOLLM_BATCH * SMOLLM_SEQ,
            {"flash_attention": 2 * cfg.n_layers,
             "flash_attention_bwd": cfg.n_layers})
        require(set(actions) == {"ok"}, f"9b: the guard passed {actions}")
        bare = make_train_step(cfg, opt)
        row["wall_ms_unguarded"] = event_ms(
            torch, lambda: bare(second.params, second.opt_state, batch), 2)
        print(f"phase 9b: the same step without the guard: wall "
              f"{row['wall_ms_unguarded']!r} ms [{card}]")
        row["loop_wall_ms"] = walls
        del first, second, saved, one, bare, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step": row}


def examples_phase(torch, card) -> None:
    """Phase 9c: the three examples on the card."""
    from repro_torch.examples import dynamic_treelstm, quickstart, train_lm
    reset_launches()
    t0 = time.perf_counter()
    qs = quickstart.main([])
    sim, ctx, losses = qs["simulated"], qs["eager"], qs["losses"]
    print(f"phase 9c: quickstart ({time.perf_counter() - t0:.1f} s): "
          f"simulated ok {[r.ok for r in sim]}, evictions "
          f"{[r.evictions for r in sim]}; eager chain evictions "
          f"{ctx.rt.evictions}, remats {ctx.remat_runs}; llama3.2-1b smoke "
          f"losses {losses}; flash launches per variant "
          f"{read_variants()['flash_attention']} "
          f"{read_variants()['flash_attention_bwd']}")
    require([r.ok for r in sim] == [True, True, False], "9c: simulated")
    require(ctx.rt.evictions > 0 and ctx.remat_runs > 0, "9c: eager chain")
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            "9c: quickstart losses fall")
    del qs, sim, ctx
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        lm = train_lm.main(["--steps", str(TRAIN_LM_STEPS),
                            "--ckpt-dir", ckpt_dir])
    print(f"phase 9c: train_lm ({time.perf_counter() - t0:.1f} s): "
          f"{lm['verdict']}, losses {lm['losses'][:3]} ... "
          f"{lm['losses'][-3:]}, step-time ewma "
          f"{lm['monitor'].ewma * 1e3!r} ms; flash launches per variant "
          f"{read_variants()['flash_attention']} "
          f"{read_variants()['flash_attention_bwd']}")
    require(lm["verdict"] == "LEARNING", "9c: train_lm learns")
    t0 = time.perf_counter()
    tl = dynamic_treelstm.main([])
    losses, ctx = tl["losses"], tl["ctx"]
    first, last = statistics.mean(losses[:15]), statistics.mean(losses[-15:])
    print(f"phase 9c: dynamic_treelstm ({time.perf_counter() - t0:.1f} s): "
          f"loss {first!r} -> {last!r}, evictions {ctx.rt.evictions}, "
          f"remats {ctx.remat_runs}, live bytes at most "
          f"{tl['over_budget']} B above the budget {tl['budget']} B beyond "
          f"each op's largest output")
    require(last < first and ctx.remat_runs > 0 and tl["over_budget"] <= 0,
            "9c: dynamic_treelstm")
    del tl, ctx
    gc.collect()
    torch.cuda.empty_cache()


def paper_phase(torch, card) -> list:
    """Phase 9d: Table 1's eager rows on the card (the plain side
    measured), one whole simulated case, and Fig. 4's planner timing.
    Returns the rows."""
    from repro_torch.benchmarks import fig4_overhead, table1_maxinput
    rows = []
    for dim in TREELSTM_DIMS:
        t0 = time.perf_counter()
        row = table1_maxinput.run_eager_treelstm(dim=dim, device="cuda")[0]
        print(f"phase 9d: Table 1 eager treelstm, dim {dim}, budget "
              f"{row['budget']} B ({time.perf_counter() - t0:.1f} s): "
              f"max_plain {row['max_plain']} (measured; by the formula "
              f"{row['formula_max_plain']}), max_dtr {row['max_dtr']}, gain "
              f"{row['gain']}; plain peaks by depth, measured "
              f"{row['plain_peaks']}, formula {row['formula_peaks']} "
              f"[{card}]")
        peaks = [row["plain_peaks"][d] for d in sorted(row["plain_peaks"])]
        require(peaks == sorted(peaks), f"9d: plain peaks grow with depth "
                f"at dim {dim}")
        require(row["max_dtr"] > row["max_plain"],
                f"9d: DTR trains a larger tree at dim {dim}")
        rows.append(row)
    t0 = time.perf_counter()
    sim = table1_maxinput.run_simulated(models=(TABLE1_CASE,))
    print(f"phase 9d: Table 1 simulated, {TABLE1_CASE} "
          f"({time.perf_counter() - t0:.1f} s): {sim} (the JAX package's "
          f"row: {TABLE1_ROW})")
    require(sim == [TABLE1_ROW], "9d: the simulated row")
    rows += sim
    plan = fig4_overhead.run_planner_wallclock("cuda")
    print(f"phase 9d: Fig. 4 planner on the tagged MLP (d 128, 8 layers, "
          f"batch 256): {[(r['budget'], r['ok'], r['value']) for r in plan]}"
          f" (budget, feasible, planning ms on the host)")
    require(plan[0]["ok"], "9d: a feasible plan at 0.8")
    gc.collect()
    torch.cuda.empty_cache()
    return rows + plan


def surface_smoke(torch, tmp) -> None:
    """Phase 10a: each smoke model served under admission and chaos on the
    card and on the CPU, from the same parameters: the same tokens,
    counters, events and captured log; the card run's launches."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    for arch in SURFACE_ARCHS:
        cfg = configs.get_smoke(arch)
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        runs = {}
        for dev in ("cpu", "cuda"):
            args = serve.parse_args(["--arch", arch, "--smoke",
                                     *SURFACE_FLAGS, "--capture",
                                     f"{tmp}/{arch}-{dev}.log"])
            on = params if dev == "cpu" else tree_map(lambda t: t.cuda(),
                                                      params)
            torch.cuda.synchronize()
            reset_launches()
            res = serve.serve_loop(cfg, on, args)
            runs[dev] = (res, read_launches(),
                         Path(args.capture).read_bytes())
        (cpu, _, cpu_log), (card, launches, card_log) = (runs["cpu"],
                                                         runs["cuda"])
        attn = 0 if cfg.pattern == ("rwkv",) else cfg.n_layers
        moe = 3 * cfg.n_layers if cfg.moe else 0
        print(f"phase 10a: {arch} smoke, {' '.join(SURFACE_FLAGS)}: "
              f"served {len(card.completed)}/8 in {card.steps} steps, "
              f"{card.counters}; card == CPU: tokens "
              f"{card.completed == cpu.completed}, counters and events "
              f"{(card.counters, card.events) == (cpu.counters, cpu.events)}"
              f", log {card_log == cpu_log}; launches {launches}")
        require(card.completed == cpu.completed,
                f"10a {arch}: card {card.completed} cpu {cpu.completed}")
        require((card.counters, card.events) == (cpu.counters, cpu.events),
                f"10a {arch}: admission differs")
        require(card_log == cpu_log, f"10a {arch}: captured logs differ")
        require(sorted(card.completed) == list(range(8))
                and card.counters["preemptions"] > 0
                and card.counters["rejected"] == 0,
                f"10a {arch}: {card.counters}")
        require(launches["flash_attention"] == card.steps * attn
                and launches["moe_gemm"] == card.steps * moe
                and launches["rwkv6_fwd"] == 0,
                f"10a {arch}: launches {launches} for {card.steps} steps")


def surface_rwkv(torch, card, gen) -> dict:
    """Phase 10b: rwkv6-1.6b at full width (24 layers, d 2048, bf16
    activations) serves 8 requests over 4 slots, 16 tokens each, with no
    kernel; one decode step's wall and device busy; then 32 decode steps
    against forward through the WKV kernel (f32, 24 layers on ``simt``;
    bf16 layer 0's time-mix on ``mma``)."""
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import rwkv as RW
    from repro_torch.models.params import tree_items, tree_map
    cfg = configs.get(RWKV_ARCH)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    args = serve.parse_args(["--arch", RWKV_ARCH, "--requests", "8",
                             "--slots", "4", "--gen", "16"])
    torch.cuda.synchronize()
    reset_launches()
    res = serve.serve_loop(cfg, params, args)
    launches = read_launches()
    tokens = sum(len(t) for t in res.completed.values())
    require(sorted(res.completed) == list(range(8))
            and all(len(t) == 16 and all(0 <= x < cfg.vocab for x in t)
                    for t in res.completed.values()),
            f"10b: completed {res.completed}")
    require(sum(launches.values()) == 0, f"10b: rwkv decode launched "
            f"{launches}")

    prepared = M.prepare_params(cfg, params)
    cache = M.init_cache(cfg, 4, 128, "cuda")
    tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor([3, 10, 20, 40], dtype=torch.int32, device="cuda")

    def run():
        with torch.inference_mode():
            M.decode_step(cfg, prepared, tok, cache, pos)

    step_ms = event_ms(torch, run, 20)
    busy_ms = device_ms(torch, run, 5, top=5)
    weight_bytes = sum(t.nbytes for _, t in tree_items(prepared))
    row = {"loop_ms_per_step": res.seconds * 1e3 / res.steps,
           "tokens_per_s": tokens / res.seconds, "step_wall_ms": step_ms,
           "step_busy_ms": busy_ms, "idle_share": 1 - busy_ms / step_ms,
           "weight_bytes": weight_bytes,
           "byte_bound_ms": weight_bytes / MEM_BYTES_PER_S * 1e3}
    print(f"phase 10b: {RWKV_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}) served {len(res.completed)}/8 requests, "
          f"{res.steps} decode steps, {row['loop_ms_per_step']!r} ms/step, "
          f"{row['tokens_per_s']!r} tokens/s, launches {launches}; one "
          f"decode step at 4 slots: wall {step_ms!r} ms, device busy "
          f"{busy_ms!r} ms, idle share {row['idle_share']!r}, "
          f"{weight_bytes} weight bytes, byte bound "
          f"{row['byte_bound_ms']!r} ms [{card}]")

    # 32 decode steps against forward over the same tokens, f32: each row
    # at 2 layers, the whole at 24 (see RWKV_DECODE_F32).
    c32 = cfg.replace(dtype="float32")
    p32 = M.prepare_params(c32, params)
    toks = torch.randint(0, cfg.vocab, (1, RWKV_DECODE_STEPS), generator=gen,
                         device="cuda", dtype=torch.int32)
    half = RWKV_DECODE_STEPS // 2
    for layers in (RWKV_PARITY_LAYERS, cfg.n_layers):
        cut = c32.replace(n_layers=layers)
        pl = {**p32, "groups": tree_map(lambda t: t[:layers], p32["groups"])}
        reset_launches()
        with torch.inference_mode():
            full = M.forward(cut, pl, toks).float()
            fwd = read_variants()["rwkv6_fwd"]
            prefix = M.forward(cut, pl, toks[:, :half]).float()
            with plain_kernels(ops, ref):
                plain = M.forward(cut, pl, toks).float()
            cache = M.init_cache(cut, 1, RWKV_DECODE_STEPS, "cuda")
            rows = []
            for t in range(RWKV_DECODE_STEPS):
                logits, cache = M.decode_step(
                    cut, pl, toks[:, t:t + 1], cache,
                    torch.tensor(t, dtype=torch.int32, device="cuda"))
                rows.append(logits[:, 0].float())
        dec = torch.stack(rows, 1)
        by_row = (dec - full).abs().amax(-1)[0]
        worst = by_row.max().item()
        rel = ((dec - full).norm() / full.norm()).item()
        d_plain = (plain - full).abs().max().item()
        d_prefix = (prefix - full[:, :half]).abs().max().item()
        scale = full.abs().max().item()
        print(f"phase 10b: {RWKV_ARCH} f32, {layers} layers, "
              f"{RWKV_DECODE_STEPS} decode steps against forward (WKV "
              f"launches per variant {fwd}): worst row max|d|={worst!r} "
              f"(max|logits|={scale!r}), rows 0, 8, 16, 24: "
              f"{by_row[::8].tolist()}, ||d||/||logits||={rel!r}; decode "
              f"against the plain forward "
              f"{(dec - plain).abs().max().item()!r}; forward: kernel "
              f"against plain {d_plain!r}, over {half} tokens against over "
              f"{RWKV_DECODE_STEPS} {d_prefix!r}")
        require(fwd["simt"] == layers and sum(fwd.values()) == layers,
                f"10b: f32 forward WKV launches {fwd}")
        if layers < cfg.n_layers:
            require(math.isfinite(worst) and worst <= RWKV_DECODE_F32 * scale,
                    f"10b: f32 decode vs forward at {layers} layers: "
                    f"{worst} > {RWKV_DECODE_F32} x {scale}")
        else:
            require(math.isfinite(rel) and rel <= RWKV_DECODE_F32,
                    f"10b: f32 decode vs forward at {layers} layers: "
                    f"||d||/||logits|| {rel} > {RWKV_DECODE_F32}")
        row[f"f32_{layers}_layers"] = {
            "worst": worst, "rel_norm": rel, "kernel_vs_plain": d_plain,
            "prefix_vs_full": d_prefix, "scale": scale}
    del p32, pl, full, prefix, plain, cache

    # Layer 0's time-mix in bf16: the one-token branch against the kernel.
    mix = {k: v[0] for k, v in prepared["groups"]["slot0"]["mix"].items()}
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = torch.randn(1, RWKV_DECODE_STEPS, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    reset_launches()
    with torch.inference_mode():
        y_full = RW.rwkv_time_mix(cfg, mix, x).float()
        fwd = read_variants()["rwkv6_fwd"]
        state = {"state": torch.zeros(1, h, dh, dh, device="cuda"),
                 "x_att": torch.zeros(1, cfg.d_model, device="cuda",
                                      dtype=torch.bfloat16)}
        ys = []
        for t in range(RWKV_DECODE_STEPS):
            y, state = RW.rwkv_time_mix(cfg, mix, x[:, t:t + 1], cache=state)
            ys.append(y)
        err = (torch.cat(ys, 1).float() - y_full).abs().max().item()
    scale16 = y_full.abs().max().item()
    tol = WKV_TOL["bfloat16"]
    print(f"phase 10b: {RWKV_ARCH} layer 0 time-mix, bf16, "
          f"{RWKV_DECODE_STEPS} one-token steps against the WKV kernel "
          f"(launches per variant {fwd}): max|d|={err!r} (limit {tol} x "
          f"max|y|={scale16!r})")
    require(fwd["mma"] == 1 and sum(fwd.values()) == 1,
            f"10b: bf16 WKV launches {fwd}")
    require(math.isfinite(err) and err <= tol * scale16,
            f"10b: bf16 time-mix {err} > {tol} x {scale16}")
    row.update(bf16_layer0_err=err, bf16_layer0_scale=scale16)
    return row


def surface_qwen(torch, card, tmp) -> dict:
    """Phase 10c: qwen2-0.5b at full width under admission and chaos, with
    the capture and the offload sweep; its log through the copied engine;
    then the same requests with no budget, for the requests admission never
    preempted."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = configs.get(ARCH)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    args = serve.parse_args(["--arch", ARCH, *SURFACE_FLAGS, "--capture",
                             f"{tmp}/qwen.log", "--offload-sweep"])
    torch.cuda.synchronize()
    reset_launches()
    res = serve.serve_loop(cfg, params, args)
    launches, variants = read_launches(), read_variants()
    serve.report(args, res, torch.device("cuda"))
    c = res.counters
    print(f"phase 10c: {ARCH} ({cfg.n_layers} layers), "
          f"{' '.join(SURFACE_FLAGS)}: {res.seconds * 1e3 / res.steps!r} "
          f"ms/step, {c}, flash launches {launches['flash_attention']} per "
          f"variant {variants['flash_attention']} [{card}]")
    require(sorted(res.completed) == list(range(8)) and c["preemptions"] > 0
            and c["rejected"] == 0, f"10c: {c}")
    require(launches["flash_attention"] == res.steps * cfg.n_layers,
            f"10c: {launches['flash_attention']} flash launches for "
            f"{res.steps} steps x {cfg.n_layers}")
    require_wgmma(variants, "phase 10c, qwen2 serve under admission")
    serve_log_replay(res.log, "10c")

    free = serve.parse_args(["--arch", ARCH, *SURFACE_FLAGS[:8]])
    unbudgeted = serve.serve_loop(cfg, params, free).completed
    preempted = {e["rid"] for e in res.events
                 if e["kind"] == "preempt_requeue"}
    kept = sorted(set(res.completed) - preempted)
    same = [r for r in kept if res.completed[r] == unbudgeted[r]]
    print(f"phase 10c: requests never preempted {kept}; tokens equal to the "
          f"run without a budget: {same}")
    return {"launches": launches["flash_attention"],
            "variants": variants["flash_attention"], "counters": c,
            "ms_per_step": res.seconds * 1e3 / res.steps,
            "capture": args.capture}


def surface_phase(torch, card, gen) -> dict:
    """Phase 10: the serve surface, (a)-(e); prints its own wall time."""
    from repro_torch import configs
    from repro_torch.examples import serve as example
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    from repro_torch.trace import __main__ as trace_cli
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        surface_smoke(torch, tmp)
        rwkv = surface_rwkv(torch, card, gen)
        gc.collect()
        torch.cuda.empty_cache()
        qwen = surface_qwen(torch, card, tmp)
        gc.collect()
        torch.cuda.empty_cache()

        # -- 10d. the scalar-clock example, card against CPU ----------------
        cfg = configs.get_smoke("llama3_2_1b")
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        on_cpu, _ = example.serve_batch(cfg, params)
        reset_launches()
        on_card, secs = example.serve_batch(
            cfg, tree_map(lambda t: t.cuda(), params))
        launches, variants = read_launches(), read_variants()
        steps = max(example.PROMPT_LENS) + example.GEN_LEN - 1
        print(f"phase 10d: examples.serve (llama3.2-1b smoke, f32, one "
              f"shared clock, {steps} steps): card == CPU "
              f"{on_card == on_cpu}, {secs * 1e3 / steps:.2f} ms/step, flash "
              f"launches {launches['flash_attention']} per variant "
              f"{variants['flash_attention']}")
        require(on_card == on_cpu, f"10d: card {on_card} cpu {on_cpu}")
        require(launches["flash_attention"] == steps * cfg.n_layers
                and variants["flash_attention"]["simt"] ==
                launches["flash_attention"],
                f"10d: flash launches {launches} {variants}")

        # -- 10e. the budget-curve report on 10c's capture -------------------
        out = f"{tmp}/report.json"
        require(trace_cli.main(["report", "--traces", qwen["capture"],
                                "--out", out]) == 0, "10e: trace report")
        report = json.loads(Path(out).read_text())
        require(report["equivalence_failures"] == 0
                and len(report["curves"]) == 3, "10e: report")
    print(f"phase 10: {time.perf_counter() - t10:.1f} s of wall time")
    return {"rwkv": rwkv, "qwen": qwen}


def gemm_bwd_bound_ms(shape, itemsize, dtype_name):
    """Least time for the grouped GEMM's backward: x, w and dY read once,
    dX and dW written once; its two products, 4 FLOPs per multiply-add of
    the forward."""
    e, c, d, f = shape
    return bound(2 * (e * c * d + e * d * f) * itemsize + e * c * f * itemsize,
                 4 * e * c * d * f, dtype_name)


def max_abs(a, b=None, rows=8) -> float:
    """max |a - b| (max |a| without ``b``) in f32, a few slices of the
    leading axis at a time: the f32 copies of a 7.5 GB bf16 gradient
    would not fit beside it."""
    out = 0.0
    for i in range(0, a.shape[0], rows):
        x = a[i:i + rows].float()
        if b is not None:
            x = x - b[i:i + rows].float()
        out = max(out, x.abs().max().item())
    return out


def all_finite(torch, t, rows=8) -> bool:
    """Every element finite, a few slices of the leading axis at a time."""
    return all(bool(torch.isfinite(t[i:i + rows]).all())
               for i in range(0, t.shape[0], rows))


def gemm_bwd_checks(torch, gen) -> dict:
    """Phase 2 for the grouped GEMM's backward: ``moe_gemm_bwd`` (dX and dW,
    one kernel launch each) against autograd through the plain version on
    the kernel-test sweep and phase 11's train and decode shapes, each
    gradient within ``GEMM_BWD_REL`` of its largest magnitude, and a second
    call's bits; f32 on ``simt``, bf16 on ``wgmma``.  One gradient at a
    time: deepseek's f32 dW is 15 GB.  Returns the bf16 max abs error of
    each phase-11 shape."""
    from repro_torch.kernels import moe_gemm as mg, ref
    from repro_torch.kernels.moe_gemm import moe_gemm_bwd
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 2: moe_gemm_bwd against autograd through "
          f"moe_gemm_reference (memory_allocated at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB)")
    errs = {}
    shapes = [("sweep", s) for s in GEMM_SWEEP] + list(GEMM_TRAIN.items())
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for what, shape in shapes:
            e, c, d, f = shape
            # bf16 reads the operands in place on wgmma where d and F
            # allow; otherwise dX = dY w^T runs as [E,C,F]@[E,F,d] and
            # dW = x^T dY as [E,d,C]@[E,C,F] on copies, each planned as a
            # forward (f32 on simt).
            want = ["wgmma"] * 2 if mg.plan_backward(
                e, c, d, f, dtype)["variant"] == "wgmma" else [
                mg.plan(e, c, f, d, dtype)["variant"],
                mg.plan(e, d, c, f, dtype)["variant"]]
            require(what == "sweep" or want == [
                "wgmma" if dtype == torch.bfloat16 else "simt"] * 2,
                f"moe_gemm_bwd {what} {dtype_name} planned {want}")
            g = own_gen(torch, what, gen, GEMM_FRESH)
            x, w = gemm_inputs(torch, shape, dtype, g)
            dy = torch.randn(e, c, f, generator=g, device="cuda").to(dtype)
            rels, err, same = [], 0.0, True
            for which in (0, 1):             # dX, then dW
                need = (which == 0, which == 1)
                before = dict(moe_gemm_bwd.variant_launches)
                got = moe_gemm_bwd(x, w, dy, need=need)[which]
                again = moe_gemm_bwd(x, w, dy, need=need)[which]
                torch.cuda.synchronize()
                ran = {v: n - before[v]
                       for v, n in moe_gemm_bwd.variant_launches.items()}
                require(ran == {v: 2 * (v == want[which]) for v in ran},
                        f"moe_gemm_bwd {what} {dtype_name} ran {ran}")
                same = same and bool(torch.equal(got, again))
                del again
                with torch.enable_grad():
                    xs = [t.detach().requires_grad_(i == which)
                          for i, t in enumerate((x, w))]
                    (expect,) = torch.autograd.grad(
                        ref.moe_gemm_reference(*xs), [xs[which]], dy)
                require(got.dtype == dtype and all_finite(torch, got),
                        f"finite moe_gemm_bwd gradients {what}")
                d_ = max_abs(got, expect)
                rels.append(d_ / max_abs(expect))
                err = max(err, d_)
                del got, expect, xs
                gc.collect()
                torch.cuda.empty_cache()
            ok = max(rels) <= GEMM_BWD_REL[dtype_name] and same
            print(f"  {dtype_name} {what} [{e},{c},{d}]@[{e},{d},{f}] "
                  f"[{'+'.join(want)}]: max|d|/max|g| dx,dw = "
                  f"{[float(f'{r:.3g}') for r in rels]} (limit "
                  f"{GEMM_BWD_REL[dtype_name]}), max_abs_err={err!r}; "
                  f"second call same bits: {same} {'ok' if ok else 'FAIL'}")
            require(ok, f"moe_gemm_bwd against plain: {dtype_name} {what}")
            if dtype == torch.bfloat16 and what in GEMM_TRAIN:
                errs[what] = err
            del x, w, dy
            gc.collect()
            torch.cuda.empty_cache()
    return errs


def gemm_train_times(torch, card, gen) -> dict:
    """Phase 11's grouped-GEMM rows, bf16, timed with CUDA events around
    back-to-back calls (each call is a millisecond or more; the profiler
    has dropped kernels from these sessions): the forward at every
    ``GEMM_TRAIN`` shape, the backward (``<shape> bwd``) at the train
    shapes; each beside the ``simt`` variant, the plain version,
    ``torch.bmm`` (for the backward, the pair of ``torch.bmm`` calls that
    computes dX and dW) and the bound.  The backward's row also keeps the
    design before the in-place layouts, the forward kernel on transposed
    copies of w and x (``previous_ms``), and those two copies timed alone
    (``copies_ms``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_bwd,
                                              moe_gemm_bwd_reference)

    def on_copies(x, w, dy):
        return (moe_gemm(dy, w.transpose(1, 2).contiguous()),
                moe_gemm(x.transpose(1, 2).contiguous(), dy))

    rows = {}
    for what, shape in GEMM_TRAIN.items():
        e, c, d, f = shape
        # Before the wo shapes, this loop timed the wi shapes alone.
        g = own_gen(torch, what, gen, GEMM_FRESH + ("mixtral train wo",))
        x, w = gemm_inputs(torch, shape, torch.bfloat16, g)
        rows[what] = time_row(
            torch, (("ms", lambda: moe_gemm(x, w)),
                    ("simt_ms", lambda: moe_gemm(x, w)),
                    ("plain_ms", lambda: ref.moe_gemm_reference(x, w)),
                    ("library_ms", lambda: torch.bmm(x, w))), 10,
            gemm_bound_ms(shape, 2, "bfloat16"),
            f"moe_gemm {what} [{e},{c},{d}]@[{e},{d},{f}] bf16", card,
            events_only=True)
        if "decode" in what:
            del x, w
            continue
        dy = torch.randn(e, c, f, generator=g, device="cuda").to(
            torch.bfloat16)
        key = f"{what} bwd"
        rows[key] = time_row(
            torch, (("ms", lambda: moe_gemm_bwd(x, w, dy)),
                    ("previous_ms", lambda: on_copies(x, w, dy)),
                    ("simt_ms", lambda: moe_gemm_bwd(x, w, dy)),
                    ("plain_ms", lambda: moe_gemm_bwd_reference(x, w, dy)),
                    ("library_ms", lambda: (
                        torch.bmm(dy, w.transpose(1, 2)),
                        torch.bmm(x.transpose(1, 2), dy)))), 5,
            gemm_bwd_bound_ms(shape, 2, "bfloat16"),
            f"moe_gemm_bwd {what} dX [{e},{c},{f}]@[{e},{f},{d}], dW "
            f"[{e},{d},{c}]@[{e},{c},{f}] bf16", card, events_only=True)
        rows[key]["copies_ms"] = event_ms(
            torch, lambda: (w.transpose(1, 2).contiguous(),
                            x.transpose(1, 2).contiguous()), 5)
        print(f"  {key}: the transposed copies of w and x alone "
              f"{rows[key]['copies_ms']!r} ms [{card}]")
        del x, w, dy
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def require_moe_step(n, v, cfg, dtype, what) -> None:
    """One MoE loss-and-grads call's launches: the forward's three grouped
    GEMMs and the backward's six a MoE layer, one flash forward and
    backward an attention layer, bf16 all on ``wgmma`` (f32 on
    ``simt``)."""
    moe = cfg.n_groups
    attn = 0 if cfg.mla else cfg.n_layers
    want = "wgmma" if dtype == "bfloat16" else "simt"
    require(n["moe_gemm"] == 3 * moe and n["moe_gemm_bwd"] == 6 * moe
            and n["flash_attention"] == n["flash_attention_bwd"] == attn,
            f"{what}: launches {n}")
    for name in ("moe_gemm", "moe_gemm_bwd", "flash_attention",
                 "flash_attention_bwd"):
        require(v[name][want] == n[name], f"{what}: {name} off {want} "
                f"{v[name]}")


def moe_train_phase(torch, card) -> dict:
    """Phase 11a-b: mixtral-8x7b at full width, 2 layers, batch 2 x 2048.
    (a) Loss and every gradient through the kernels against the plain
    path, f32 (worst leaf within ``TRAIN_PARITY_F32``), then bf16
    activations by the bf16 rule over weight draws (``bf16_train_draws``).
    (b) AdamW steps (the main path): launches a step per variant, losses,
    step wall, device busy, idle share, tokens/s, the kernels' device time
    inside the step and ``max_memory_allocated``; then one loss-and-grads
    call at phase 3's 4 layers (finite, launches, peak)."""
    from repro_torch import configs, optim
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items, tree_map
    cut = configs.get(MOE_ARCH).replace(n_layers=MIX_TRAIN_LAYERS)
    params = M.init_params(cut, torch.Generator("cuda").manual_seed(0))
    batch = _train_batch(torch, cut, 0, MIX_BATCH, MIX_SEQ)

    def run(params, dtype, plain):
        c = cut.replace(dtype=dtype)
        reset_launches()
        with plain_kernels(ops, ref) if plain else nullcontext():
            loss, grads = loss_and_grads(c, params, batch)
        torch.cuda.synchronize()
        require(math.isfinite(float(loss)), f"finite {dtype} loss")
        if not plain:
            n, v = read_launches(), read_variants()
            print(f"  {MOE_ARCH} {dtype} loss-and-grads launches {n}, per "
                  f"variant {v['moe_gemm']} {v['moe_gemm_bwd']} "
                  f"{v['flash_attention']} {v['flash_attention_bwd']}")
            require_moe_step(n, v, c, dtype, f"phase 11a {dtype}")
        return float(loss), grads

    t11 = time.perf_counter()
    p32, gp32 = run(params, "float32", True)
    gp32 = tree_map(lambda t: t.cpu(), gp32)      # the host holds it
    l32, g32 = run(params, "float32", False)
    d32, at32 = _leaf_rel(torch, g32, gp32)
    print(f"phase 11a: {MOE_ARCH} full width, {MIX_TRAIN_LAYERS} layers, "
          f"batch {MIX_BATCH}x{MIX_SEQ}, kernel vs plain: f32 loss {l32!r} "
          f"vs {p32!r}, worst leaf ||d||/||g|| {d32!r} ({at32}; limit "
          f"{TRAIN_PARITY_F32}) [{card}]")
    require(abs(l32 - p32) <= TRAIN_PARITY_F32 * abs(p32), "f32 loss parity")
    require(d32 <= TRAIN_PARITY_F32, "f32 gradient parity")
    # The draws need the room: 11b draws the same weights again.
    del gp32, g32, params
    gc.collect()
    torch.cuda.empty_cache()
    bf16_train_draws(torch, cut, f"phase 11a: {MOE_ARCH} full width, "
                     f"{MIX_TRAIN_LAYERS} layers", run, host=True)
    params = M.init_params(cut, torch.Generator("cuda").manual_seed(0))

    # -- 11b: the main path, AdamW steps at bf16 activations ---------------
    opt = optim.adamw(lr=optim.cosine_schedule(3e-4, warmup=20, total=100))
    state = opt.init(params)
    step_fn = make_train_step(cut, opt)
    per_step, walls, losses = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(MIX_STEPS):
        b = _train_batch(torch, cut, i, MIX_BATCH, MIX_SEQ)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        per_step.append((read_launches(), read_variants()))
    peak = torch.cuda.max_memory_allocated()
    for n, v in per_step:
        require_moe_step(n, v, cut, "bfloat16", "phase 11b")
    print(f"phase 11b: {MOE_ARCH} ({cut.n_layers} layers) AdamW, bf16 "
          f"activations, f32 parameters, batch {MIX_BATCH}x{MIX_SEQ}: losses "
          f"{losses}, step ms {[round(t, 1) for t in walls]}, launches per "
          f"step {[n for n, _ in per_step]}, per variant (last step) "
          f"{per_step[-1][1]}, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB [{card}]")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    b = _train_batch(torch, cut, MIX_STEPS, MIX_BATCH, MIX_SEQ)

    def one_step():
        nonlocal params, state
        params, state, m_ = step_fn(params, state, b)
        return m_

    print(f"phase 11b: {MOE_ARCH} step, kernels by device time:")
    calls = {"moe_gemm (fwd + bwd)": (GEMM_STEP_KERNELS,
                                     9 * cut.n_groups),
             "flash_attention": (FLASH_STEP_KERNELS["flash_attention"],
                                 cut.n_layers),
             "flash_attention_bwd": (
                 FLASH_STEP_KERNELS["flash_attention_bwd"], cut.n_layers)}
    # The per-launch times below divide each name's sum by its launches:
    # only a session that recorded every one of them is read.
    names = {}
    busy_ms = device_ms(torch, one_step, 1, top=12, by_name=names, expect={
        part: n_calls for parts, n_calls in calls.values() for part in parts})
    require(busy_ms is not None, "profiler device time, mixtral step, "
            "every grouped-GEMM and flash launch recorded")
    inside = {}
    for name, (parts, n_calls) in calls.items():
        inside[name], each = _step_kernels_ms(names, parts, n_calls)
        print(f"  {name} inside the step: {inside[name]!r} ms per launch "
              f"({n_calls} launches; {each}) [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    tokens = MIX_BATCH * MIX_SEQ
    row = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms,
           "tokens_per_s": tokens / (wall_ms / 1e3), "inside": inside,
           "peak_gib": peak / 2**30, "launches": per_step[-1][0],
           "variants": per_step[-1][1], "losses": losses}
    print(f"phase 11b: {MOE_ARCH} train step: wall {wall_ms!r} ms, device "
          f"busy {busy_ms!r} ms, idle share {row['idle_share']!r}, "
          f"{row['tokens_per_s']!r} tokens/s; phase 11a-b took "
          f"{time.perf_counter() - t11:.1f} s [{card}]")
    del params, state, step_fn, opt, batch, b
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11b: one loss-and-grads call at phase 3's depth -------------------
    deep = configs.get(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    params = M.init_params(deep, torch.Generator("cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss, grads = loss_and_grads(deep, params, _train_batch(
        torch, deep, 0, MIX_BATCH, MIX_SEQ))
    torch.cuda.synchronize()
    n, v = read_launches(), read_variants()
    row["peak_4_layers_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finite = all(all_finite(torch, t) for _, t in tree_items(grads))
    print(f"phase 11b: {MOE_ARCH} ({deep.n_layers} layers) loss-and-grads, "
          f"batch {MIX_BATCH}x{MIX_SEQ}: loss {float(loss)!r}, every "
          f"gradient finite {finite}, launches {n}, max_memory_allocated "
          f"{row['peak_4_layers_gib']:.3f} GiB [{card}]")
    require(math.isfinite(float(loss)) and finite, "11b: 4-layer grads")
    require_moe_step(n, v, deep, "bfloat16", "phase 11b, 4 layers")
    del params, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return row


def autotune_phase(torch, card) -> dict:
    """Phase 11c: ``core.autotune`` on fig4's tagged MLP stack at phase 8's
    card width (traced on fake tensors: nothing is allocated), the chosen
    fraction and its estimate; then the same step's capture under
    ``cost_model="hlo"``, whose FLOPs must be exactly the step's matrix
    products: 6 L - 1 of them (the first layer's input takes no
    gradient), each 2 B d 4d."""
    from repro_torch.core import planner, remat
    from repro_torch.core.autotune import autotune
    from repro_torch.trace.capture import capture_fn
    d, layers, batch = PLAN_MLP["d"], PLAN_MLP["layers"], PLAN_MLP["batch"]
    g = torch.Generator("cuda").manual_seed(0)
    params = [{"w1": torch.randn(d, 4 * d, generator=g, device="cuda") * 0.02,
               "w2": torch.randn(4 * d, d, generator=g, device="cuda") * 0.02}
              for _ in range(layers)]
    x = torch.randn(batch, d, generator=g, device="cuda")

    def fwd(params, x):
        for i, p in enumerate(params):
            a = remat.tag(torch.nn.functional.gelu(x @ p["w1"],
                                                   approximate="tanh"),
                          f"act{i}")
            x = x + remat.tag(a @ p["w2"], f"proj{i}")
        return x

    grad_fn = planner.grad_of_sum(lambda pp, xx: torch.mean(fwd(pp, xx) ** 2))
    t0 = time.perf_counter()
    tuned = autotune(grad_fn, params, x)
    tune_ms = (time.perf_counter() - t0) * 1e3
    log = capture_fn(grad_fn, params, x, cost_model="hlo")
    expect = 2 * batch * d * 4 * d * (6 * layers - 1)
    row = {"budget_frac": tuned.budget_frac, "est_step_s": tuned.est_step_s,
           "est_compute_s": tuned.est_compute_s,
           "est_memory_s": tuned.est_memory_s,
           "est_slowdown": tuned.plan.est_slowdown, "tune_ms": tune_ms,
           "hlo_flops": log.meta.get("hlo_flops")}
    print(f"phase 11c: autotune on fig4's MLP {PLAN_MLP}, f32: chosen "
          f"fraction {tuned.budget_frac}, estimate {tuned.est_step_s!r} s "
          f"(compute {tuned.est_compute_s!r}, memory "
          f"{tuned.est_memory_s!r}; H100 roofline constants), planned "
          f"slowdown {tuned.plan.est_slowdown!r}, saves "
          f"{len(tuned.plan.save_names)} of "
          f"{len(tuned.plan.save_names) + len(tuned.plan.remat_names)} "
          f"tags, {tune_ms:.0f} ms of host time; capture under "
          f"cost_model='hlo': {log.meta['cost_model']} "
          f"({log.meta.get('flop_counter')}), {log.meta.get('hlo_flops')} "
          f"FLOPs (the step's products: {expect}), {log.op_count()} ops")
    require(tuned.plan.feasible and 0 < tuned.budget_frac <= 0.9,
            f"autotune chose {tuned.budget_frac}")
    require(log.meta["cost_model"] == "hlo" and
            log.meta["hlo_flops"] == expect, f"hlo capture {log.meta}")
    require(abs(log.baseline_cost() - expect) <= 1e-6 * expect,
            "hlo capture's costs sum to the counted FLOPs")
    del params, x
    return row


def deepseek_phase(torch, card, gen) -> dict:
    """Phase 11d: deepseek-v3.  The smoke config on the card against the
    CPU: forward logits at S 16 (MLA's dense logits) and S 2048 (its
    blocked loop), and 8 requests served, the same tokens.  Then full width
    cut to one dense and one MoE layer with bf16 parameters: 8 requests
    served over 4 slots (launches per variant; every grouped GEMM on
    ``wgmma``, no flash launch), one decode step's wall and device busy,
    and one loss-and-grads call at batch 1 x 2048 (loss and every
    gradient finite, launches, ``max_memory_allocated``)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items, tree_map
    t11 = time.perf_counter()
    smoke = configs.get_smoke(DS_ARCH)
    cpu_params = M.init_params(smoke, torch.Generator().manual_seed(0))
    card_params = tree_map(lambda t: t.cuda(), cpu_params)
    cpu_gen = torch.Generator().manual_seed(1)
    for b, s in ((2, 16), (1, 2048)):
        tokens = torch.randint(0, smoke.vocab, (b, s), generator=cpu_gen,
                               dtype=torch.int32)
        reset_launches()
        with torch.no_grad():
            on_cpu = M.forward(smoke, cpu_params, tokens)
            on_card = M.forward(smoke, card_params, tokens.cuda()).cpu()
        err = (on_card - on_cpu).abs().max().item()
        scale = on_cpu.abs().max().item()
        n = read_launches()
        print(f"phase 11d: {DS_ARCH} smoke forward [{b},{s}], card vs CPU: "
              f"max|d| {err!r} of max|logits| {scale!r} (limit "
              f"{DS_SMOKE_TOL} x max), launches {n}")
        require(err <= DS_SMOKE_TOL * scale, f"11d smoke logits at S {s}")
        require(n["moe_gemm"] == 3 * smoke.n_groups
                and n["flash_attention"] == 0, f"11d smoke launches {n}")
    flags = ["--arch", DS_ARCH, "--smoke", "--requests", "8", "--slots",
             "4", "--gen", "8", "--max-len", "32"]
    on_cpu = serve.serve_loop(smoke, cpu_params,
                              serve.parse_args(flags)).completed
    on_card = serve.serve_loop(smoke, card_params,
                               serve.parse_args(flags)).completed
    print(f"phase 11d: {DS_ARCH} smoke serve, card vs CPU: same tokens "
          f"{on_card == on_cpu}, {len(on_card)}/8 served")
    require(on_card == on_cpu and sorted(on_card) == list(range(8)),
            f"11d smoke serve: card {on_card} cpu {on_cpu}")
    del cpu_params, card_params

    cfg = configs.get(DS_ARCH).replace(**DS_CUT)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_items(params))
    args = serve.parse_args(["--arch", DS_ARCH, "--requests", "8",
                             "--slots", "4", "--gen", "16", "--max-len",
                             "128"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = serve.serve_loop(cfg, params, args)
    launches, variants = read_launches(), read_variants()
    serve_peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(t) for t in res.completed.values())
    print(f"phase 11d: {DS_ARCH} full width, {cfg.n_dense_layers} dense + "
          f"{cfg.n_groups} MoE layer, {n_params / 1e9:.3f} B bf16 parameters:"
          f" served {len(res.completed)}/8 in {res.steps} steps, "
          f"{res.seconds * 1e3 / res.steps!r} ms/step, "
          f"{tokens / res.seconds!r} tokens/s, launches {launches}, per "
          f"variant {variants['moe_gemm']}, max_memory_allocated "
          f"{serve_peak / 2**30:.3f} GiB [{card}]")
    require(sorted(res.completed) == list(range(8)) and all(
        len(t) == 16 and all(0 <= x < cfg.vocab for x in t)
        for t in res.completed.values()), f"11d: completed {res.completed}")
    require(launches["moe_gemm"] == 3 * cfg.n_groups * res.steps
            and variants["moe_gemm"]["wgmma"] == launches["moe_gemm"]
            and launches["flash_attention"] == 0,
            f"11d serve launches {launches} {variants}")

    cache = M.init_cache(cfg, 4, 128, "cuda")
    tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor([3, 40, 90, 127], dtype=torch.int32, device="cuda")

    def decode():
        with torch.inference_mode():
            M.decode_step(cfg, params, tok, cache, pos)

    step_ms = event_ms(torch, decode, 10)
    busy_ms = device_ms(torch, decode, 3, top=6, expect={
        GEMM_STEP_KERNELS[0]: 3 * cfg.n_groups})
    require(busy_ms is not None, "profiler device time, deepseek decode, "
            "every grouped-GEMM launch recorded")
    print(f"phase 11d: {DS_ARCH} decode step, bf16, 4 slots: wall "
          f"{step_ms!r} ms, device busy {busy_ms!r} ms, idle share "
          f"{1 - busy_ms / step_ms!r} [{card}]")
    served = {"serve_launches": launches["moe_gemm"], "steps": res.steps,
              "ms_per_step": res.seconds * 1e3 / res.steps}
    del cache, res

    g = torch.Generator("cuda").manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (DS_BATCH, DS_SEQ),
                                     generator=g, device="cuda",
                                     dtype=torch.int32)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t0) * 1e3
    n, v = read_launches(), read_variants()
    train_peak = torch.cuda.max_memory_allocated()
    finite = all(all_finite(torch, t) for _, t in tree_items(grads))
    print(f"phase 11d: {DS_ARCH} loss-and-grads, batch {DS_BATCH}x{DS_SEQ} "
          f"(MLA's blocked branch): loss {float(loss)!r}, every gradient "
          f"finite {finite}, launches {n}, per variant {v['moe_gemm']} "
          f"{v['moe_gemm_bwd']}, max_memory_allocated "
          f"{train_peak / 2**30:.3f} GiB, {grad_ms:.0f} ms (first call); "
          f"phase 11d took {time.perf_counter() - t11:.1f} s [{card}]")
    require(math.isfinite(float(loss)) and finite, "11d finite loss, grads")
    require_moe_step(n, v, cfg, "bfloat16", "phase 11d")
    del params, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {**served, "decode_wall_ms": step_ms, "decode_busy_ms": busy_ms,
            "train_launches": {k: n[k] for k in ("moe_gemm",
                                                 "moe_gemm_bwd")},
            "train_peak_gib": train_peak / 2**30,
            "serve_peak_gib": serve_peak / 2**30}


def attention_kinds(cfg) -> collections.Counter:
    """Layers of each attention kind (``attn``, ``attn_local``, ``cross``)
    in the order-free count of ``cfg``'s stacks."""
    kinds = (["attn"] * cfg.n_dense_layers + list(cfg.pattern) * cfg.n_groups
             + list(cfg.tail))
    return collections.Counter(k for k in kinds
                               if k.startswith("attn") or k == "cross")


def decode_logits(torch, cfg, params, base, tok, pos, dtype, plain,
                  want, img=None) -> "torch.Tensor":
    """One decode step's f32 logits at ``dtype`` through the kernels or
    (``plain``) their plain versions, on a copy of the cache ``base``
    (against the image ``img`` for a model with ``cross`` blocks).  A
    kernel step must launch flash attention (and the grouped GEMM, for an
    MoE model) on the variant ``want[dtype]`` only."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.models.params import TORCH_DTYPES, tree_map
    c = cfg.replace(dtype=dtype)
    cache = tree_map(lambda t: t.to(TORCH_DTYPES[dtype], copy=True), base)
    reset_launches()
    with torch.inference_mode(), (plain_kernels(ops, ref) if plain
                                  else nullcontext()):
        logits, _ = M.decode_step(c, M.prepare_params(c, params), tok,
                                  cache, pos, img)
    torch.cuda.synchronize()
    if not plain:
        variants = read_variants()
        print(f"  {cfg.name} {dtype} decode step, launches per variant "
              f"{variants}")
        require(all(v[want[dtype]] == sum(v.values()) > 0 or
                    (name == "moe_gemm" and not cfg.moe)
                    for name, v in variants.items()
                    if name in ("flash_attention", "moe_gemm")),
                f"{dtype} decode step on the {want[dtype]} variants")
    require(bool(torch.isfinite(logits).all())
            and logits.shape == token_shape(cfg, len(pos), 1)
            + (cfg.vocab,),
            f"finite {dtype} logits of shape [slots, 1, (K,) vocab]")
    return logits.float()


def token_shape(cfg, b, s) -> tuple:
    """``(b, s)``, or ``(b, s, K)`` for a codebook model."""
    return (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)


def decode_inputs(torch, cfg, slots, max_len, g):
    """A random cache of ``max_len`` rows a slot and one token a slot."""
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    base = tree_map(lambda c: torch.randn(c.shape, generator=g,
                                          device="cuda"),
                    M.cache_defs(cfg, slots, max_len))
    tok = torch.randint(0, cfg.vocab, token_shape(cfg, slots, 1),
                        generator=g, device="cuda", dtype=torch.int32)
    return base, tok


def flash_layers(cfg) -> tuple:
    """``(self, cross)``: the layers of ``cfg`` that run self attention (a
    ``cross`` block's first half included) and those that also run cross
    attention; each is one flash call a forward."""
    kinds = attention_kinds(cfg)
    return sum(kinds.values()), kinds["cross"]


def image(torch, cfg, b, g):
    """``[b, cross_attn_tokens, cross_attn_dim]`` image embeddings, N(0, 1)
    x ``IMG_SCALE``, drawn from ``g`` on its device; None (and nothing
    drawn) for a model without ``cross`` blocks."""
    if not cfg.cross_attn_dim:
        return None
    return torch.randn(b, cfg.cross_attn_tokens, cfg.cross_attn_dim,
                       generator=g, device=g.device) * IMG_SCALE


@contextmanager
def flash_by_mask():
    """Count flash launches by direction and mask while the block runs:
    yields a Counter keyed ``(fwd or bwd, self or cross)``, read off each
    launch's ``causal`` flag (a model's only non-causal calls are its cross
    attention): the forward's at ``_forward``, the backward's at the
    autograd function's ``backward``, each of which launches its kernels
    once.  It observes the launches; the wrappers' counts are untouched."""
    from repro_torch.kernels import flash_attention as fa
    tally = collections.Counter()
    forward, backward = fa._forward, fa._Flash.backward

    def counted_forward(q, k, v, causal, window, kv_len, save_lse, **kw):
        out = forward(q, k, v, causal, window, kv_len, save_lse, **kw)
        tally["fwd", "self" if causal else "cross"] += 1
        return out

    def counted_backward(ctx, do):
        grads = backward(ctx, do)
        tally["bwd", "self" if ctx.causal else "cross"] += 1
        return grads

    fa._forward, fa._Flash.backward = (counted_forward,
                                       staticmethod(counted_backward))
    try:
        yield tally
    finally:
        fa._forward, fa._Flash.backward = forward, staticmethod(backward)


def smoke_phase(torch, arch, phase) -> None:
    """Phases 12a and 13a/13b, first part: the smoke config on the card
    against the CPU.  Forward logits at S 16 and at S 2048 (the plain
    attention's blocked branch on the CPU), with an image for a model with
    ``cross`` blocks and ``[B,S,K,V]`` for codebooks; flash launches once a
    self-attention layer and once more a cross layer.  Then, where the
    serve launcher takes the model (gemma3, recurrentgemma), 8 requests
    served over 4 slots under phase 10's admission flags (preemptions on):
    the same tokens and counters; where it refuses the model, as the
    reference's fails on it (vision, musicgen), greedy decode through
    ``make_serve_step`` on the scalar clock and on per-slot clocks,
    ``SMOKE_DECODE_STEPS`` steps: the same tokens.  A codebook model also
    runs 3 steps of the train launcher's loop (its defaults): the same
    losses."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    smoke = configs.get_smoke(arch)
    calls = sum(flash_layers(smoke))
    cpu_params = M.init_params(smoke, torch.Generator().manual_seed(0))
    card_params = tree_map(lambda t: t.cuda(), cpu_params)
    cpu_gen = torch.Generator().manual_seed(1)
    for b, s in ((2, 16), (1, 2048)):
        tokens = torch.randint(0, smoke.vocab, token_shape(smoke, b, s),
                               generator=cpu_gen, dtype=torch.int32)
        img = image(torch, smoke, b, cpu_gen)
        reset_launches()
        with torch.no_grad():
            on_cpu = M.forward(smoke, cpu_params, tokens, img)
            on_card = M.forward(smoke, card_params, tokens.cuda(),
                                None if img is None else img.cuda()).cpu()
        err = (on_card - on_cpu).abs().max().item()
        scale = on_cpu.abs().max().item()
        n = read_launches()
        print(f"phase {phase}: {arch} smoke forward {list(on_card.shape)}, "
              f"card vs CPU: max|d| {err!r} of max|logits| {scale!r} (limit "
              f"{DS_SMOKE_TOL} x max), flash launches "
              f"{n['flash_attention']}")
        require(on_card.shape == token_shape(smoke, b, s) + (smoke.vocab,),
                f"{phase} {arch} logits shape")
        require(err <= DS_SMOKE_TOL * scale,
                f"{phase} {arch} logits at S {s}")
        require(n["flash_attention"] == calls, f"{phase} launches {n}")
    if M.has_cross(smoke) or smoke.n_codebooks:
        _smoke_decode(torch, smoke, cpu_params, card_params, cpu_gen, phase)
    else:
        _smoke_serve(torch, smoke, cpu_params, card_params, phase)
    if not smoke.n_codebooks:
        return
    args = train.parse_args(["--arch", arch, "--smoke", "--steps", "3",
                             "--batch", "2", "--seq", "32"])
    cfg = train.config_from_args(args)
    losses = {}
    for device in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(device, copy=True), cpu_params)
        losses[device] = train.train_loop(cfg, params, args,
                                          verbose=False).losses
    print(f"phase {phase}: {arch} smoke train launcher loop (remat "
          f"{cfg.remat}, AdamW), 3 steps, card vs CPU: losses "
          f"{losses['cuda']} vs {losses['cpu']} (rtol {TRAIN_LOSS_RTOL})")
    require(all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
                for a, b in zip(losses["cuda"], losses["cpu"]))
            and len(losses["cuda"]) == 3, f"{phase} smoke train losses")


def _smoke_serve(torch, smoke, cpu_params, card_params, phase) -> None:
    """``smoke_phase``'s serve launcher loop, card against CPU."""
    from repro_torch.launch import serve
    arch = smoke.name
    flags = serve.parse_args(["--arch", arch, "--smoke"] + SURFACE_FLAGS)
    on_cpu = serve.serve_loop(smoke, cpu_params, flags)
    reset_launches()
    on_card = serve.serve_loop(smoke, card_params, flags)
    n = read_launches()["flash_attention"]
    print(f"phase {phase}: {arch} smoke served card vs CPU: tokens equal "
          f"{on_card.completed == on_cpu.completed}, counters "
          f"{on_card.counters}, flash launches {n} over {on_card.steps} "
          f"steps")
    require(on_card.completed == on_cpu.completed
            and on_card.counters == on_cpu.counters,
            f"{phase} {arch} serve, card vs CPU")
    require(len(on_card.completed) == 8
            and on_card.counters["preemptions"] > 0,
            f"{phase} preempted, 8/8")
    require(n == on_card.steps * sum(flash_layers(smoke)),
            f"{phase} {arch} serve launches")


def _smoke_decode(torch, smoke, cpu_params, card_params, cpu_gen,
                  phase) -> None:
    """``smoke_phase``'s greedy decode on both clocks, card against CPU."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as M
    arch = smoke.name
    for clock, start in (("scalar", (0, 0, 0, 0)),
                         ("per-slot", (0, 3, 5, 14))):
        tok0 = torch.randint(0, smoke.vocab, token_shape(smoke, 4, 1),
                             generator=cpu_gen, dtype=torch.int32)
        img = image(torch, smoke, 4, cpu_gen)
        runs = {}
        for device, params in (("cpu", cpu_params), ("cuda", card_params)):
            serve = make_serve_step(smoke)
            cache = M.init_cache(smoke, 4, 32, device)
            tok, im = tok0.to(device), None if img is None else img.to(device)
            pos = torch.tensor(start, dtype=torch.int32, device=device)
            out = []
            reset_launches()
            with torch.inference_mode():
                for _ in range(SMOKE_DECODE_STEPS):
                    tok, cache = serve(params, cache, tok,
                                       pos[0] if clock == "scalar" else pos,
                                       im)
                    out.append(tok.cpu())
                    pos = pos + 1
            runs[device] = (torch.stack(out), read_launches())
        same = torch.equal(runs["cpu"][0], runs["cuda"][0])
        n = runs["cuda"][1]["flash_attention"]
        print(f"phase {phase}: {arch} smoke greedy decode, {clock} clock "
              f"from {start}, {SMOKE_DECODE_STEPS} steps of tokens "
              f"{list(runs['cuda'][0].shape[1:])}: card vs CPU the same "
              f"tokens {same}, flash launches {n}")
        require(same, f"{phase} {arch} greedy decode, card vs CPU")
        require(n == SMOKE_DECODE_STEPS * sum(flash_layers(smoke)),
                f"{phase} decode launches {n}")


def flash_call_checks(torch, cfg, params, batch, what) -> dict:
    """Every flash call of one forward of ``cfg`` on ``batch`` (its tokens,
    and its image), f32 and bf16, on the q/k/v the model feeds it: the
    forward kernel's output and LSE against ``flash_reference_lse``, and the
    backward kernels against ``flash_backward_reference`` on that output
    and LSE with an N(0, 1) output gradient.  Each gradient within
    ``FLASH_BWD_REL`` of its max|.|, as in phase 2.  The output within
    ``TOL`` of its max|.|, and the LSE within ``TOL["float32"]`` of
    max|lse|, or either within ``BF16_RATIO`` times the plain version's own
    distance from the plain version computed in f64: the model's q and k
    are not phase 2's unit ones, and logits of a few hundred carry f32
    rounding of ~1e-4 into every probability, on both sides.  Returns the
    worst of each by dtype (``out_f64``, ``lse_f64``: the plain version's
    own distances), with the calls' variants and max|lse|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    g = torch.Generator("cuda").manual_seed(13)
    kernel = ops.flash_attention
    worst = {}
    for dtype in ("float32", "bfloat16"):
        rows = []

        def probe(q, k, v, *, causal=True, window=0, kv_len=None,
                  softcap=0.0):
            before = read_variants()
            out, lse = fa._forward(q, k, v, causal, window, kv_len,
                                   save_lse=True, softcap=softcap)
            want, want_lse = ref.flash_reference_lse(
                q, k, v, causal=causal, window=window, kv_len=kv_len,
                softcap=softcap)
            exact, exact_lse = ref.flash_reference_lse(
                q.double(), k.double(), v.double(), causal=causal,
                window=window, kv_len=kv_len, softcap=softcap)
            do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=causal, window=window,
                                           softcap=softcap)
            expect = ref.flash_backward_reference(
                q, k, v, out, lse, do, causal=causal, window=window,
                softcap=softcap)
            after = read_variants()
            ran = {name: ran_variant({x: n - before[name][x]
                                      for x, n in after[name].items()})
                   for name in ("flash_attention", "flash_attention_bwd")}
            top = max(1.0, want_lse.abs().max().item())
            scale = want.float().abs().max().item()

            def dist(a, b, by):
                return (a.double() - b.double()).abs().max().item() / by
            rows.append({
                "call": (tuple(q.shape), tuple(k.shape),
                         "causal" if causal else "cross"),
                "variants": ran,
                "out": dist(out, want, scale),
                "out_f64": dist(want, exact, scale),
                "lse": dist(lse, want_lse, top),
                "lse_f64": dist(want_lse, exact_lse, top),
                "max_lse": top,
                "bwd": max((a.float() - e.float()).abs().max().item()
                           / e.float().abs().max().item()
                           for a, e in zip(grads, expect))})
            return out

        ops.flash_attention = probe
        try:
            with torch.no_grad():
                M.forward(cfg.replace(dtype=dtype), params, batch["tokens"],
                          batch.get("img_embed"))
        finally:
            ops.flash_attention = kernel
        torch.cuda.synchronize()
        want = "simt" if dtype == "float32" else "wgmma"
        worst[dtype] = {key: max(r[key] for r in rows)
                        for key in ("out", "out_f64", "lse", "lse_f64",
                                    "bwd", "max_lse")}
        worst[dtype]["calls"] = len(rows)
        for r in rows:
            print(f"  {what} {dtype} flash call {r['call']} "
                  f"[{r['variants']['flash_attention']}/"
                  f"{r['variants']['flash_attention_bwd']}]: out "
                  f"max|d|/max {r['out']:.3g} (plain vs f64 "
                  f"{r['out_f64']:.3g}), lse max|d|/max|lse| {r['lse']:.3g} "
                  f"(plain vs f64 {r['lse_f64']:.3g}; max|lse| "
                  f"{r['max_lse']:.4g}), dq/dk/dv worst max|d|/max "
                  f"{r['bwd']:.3g}")
        far = [r["call"] for r in rows
               if r["out"] > max(TOL[dtype], BF16_RATIO * r["out_f64"])
               or r["lse"] > max(TOL["float32"], BF16_RATIO * r["lse_f64"])
               or r["bwd"] > FLASH_BWD_REL[dtype]]
        require(len(rows) == sum(flash_layers(cfg))
                and all(r["variants"]["flash_attention"] == want
                        and r["variants"]["flash_attention_bwd"] == want
                        for r in rows), f"{what} {dtype} flash calls on "
                f"{want}: {[r['variants'] for r in rows]}")
        require(not far, f"{what} {dtype} flash calls against their plain "
                f"versions on the model's q/k/v: {far} past the limits "
                f"(out max({TOL[dtype]}, {BF16_RATIO} x plain vs f64), lse "
                f"max({TOL['float32']}, {BF16_RATIO} x plain vs f64), bwd "
                f"{FLASH_BWD_REL[dtype]}); worst {worst[dtype]}")
    print(f"{what}: every flash call of the f32 and bf16 forwards against "
          f"its plain version on the model's q/k/v, worst: {worst}")
    return worst


def parity_phase(torch, arch, phase, layers, shape, gen,
                 change=None) -> dict:
    """Phases 12b and 13a/13b, second part: full width cut to ``layers``
    layers, batch ``shape`` (``(B, S)``), against one image for a model
    with ``cross`` blocks.

    1. Every flash call of the forward, f32 and bf16, kernel against plain
       on the q/k/v the model feeds it (:func:`flash_call_checks`).
    2. The loss and every gradient, kernel path against plain path.  f32:
       the loss within ``TRAIN_PARITY_F32`` relative; each leaf within
       ``TRAIN_PARITY_F32``, or within ``BF16_RATIO`` times that leaf's
       distance between the plain path and the plain path with its
       attention computed in f64 (how far the gradient moves when the
       attention is rounded otherwise, with no kernel in either path).
       bf16 by the bf16 rule (``bf16_train_draws``).
    3. One decode step at 4 slots, positions ``D256_POS`` behind
       ``D256_MAX_LEN`` rows (against a [4,1601,7680] image): f32 within
       ``PARITY_F32`` of max|logits| and bf16 by the bf16 rule.

    ``change``: config fields replaced (phase 14's logit soft cap).
    Returns the per-call errors, the f32 gradients' worst leaf and its
    witness, and the decode's max|d|."""
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items
    cut = configs.get(arch).replace(n_layers=layers, **(change or {}))
    calls = sum(flash_layers(cut))
    batch = _train_batch(torch, cut, 0, *shape)
    img = image(torch, cut, shape[0], torch.Generator("cuda").manual_seed(7))
    if img is not None:
        batch["img_embed"] = img

    def run(params, dtype, plain, f64=False):
        reset_launches()
        with plain_kernels(ops, ref, f64) if plain else nullcontext():
            loss, grads = loss_and_grads(cut.replace(dtype=dtype), params,
                                         batch)
        torch.cuda.synchronize()
        require(math.isfinite(float(loss)), f"finite {dtype} loss")
        if not plain:
            n, v = read_launches(), read_variants()
            on = "wgmma" if dtype == "bfloat16" else "simt"
            require(n["flash_attention"] == n["flash_attention_bwd"]
                    == calls and v["flash_attention"][on] == calls
                    and v["flash_attention_bwd"][on] == calls,
                    f"{phase} {arch} {dtype} launches {n} {v}")
        return float(loss), grads

    params = M.init_params(cut, torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_items(params))
    what = f"phase {phase}: {arch} full width, {cut.n_layers} layers"
    per_call = flash_call_checks(torch, cut, params, batch, what)
    p32, gp32 = run(params, "float32", True)
    w32, gw = run(params, "float32", True, f64=True)
    witness = _leaf_dists(torch, gw, gp32)
    l32, g32 = run(params, "float32", False)
    kernel = _leaf_dists(torch, g32, gp32)
    from_f64 = _leaf_dists(torch, g32, gw)
    del g32, gp32, gw
    far = [p for p in kernel
           if kernel[p] > max(TRAIN_PARITY_F32, BF16_RATIO * witness[p])]
    top = sorted(kernel, key=kernel.get, reverse=True)[:3]
    at = top[0]
    print(f"{what} ({n_params} parameters; {calls} flash calls a "
          f"forward), batch {shape[0]}x{shape[1]}"
          f"{', image ' + str(list(img.shape)) if img is not None else ''}"
          f", f32 loss: kernels {l32!r}, plain {p32!r}, plain with f64 "
          f"attention {w32!r}; ||g - g_plain||/||g_plain|| by leaf, the "
          f"kernel path's beside the f64-attention plain path's (limit "
          f"max({TRAIN_PARITY_F32}, {BF16_RATIO} x the latter)): "
          + ", ".join(f"{p} {kernel[p]!r} beside {witness[p]!r}"
                      for p in top)
          + f"; the latter's worst {max(witness.values())!r}; the kernel "
          f"path's worst distance from the f64-attention path "
          f"{max(from_f64.values())!r}; leaves past the limit {far}")
    require(abs(l32 - p32) <= TRAIN_PARITY_F32 * abs(p32), "f32 loss parity")
    require(not far, f"{phase} {arch} f32 gradient parity")
    gc.collect()
    torch.cuda.empty_cache()

    want = {"float32": "simt", "bfloat16": "wgmma"}
    slots = len(D256_POS)
    pos = torch.tensor(D256_POS, dtype=torch.int32, device="cuda")
    base, tok = decode_inputs(torch, cut, slots, D256_MAX_LEN, gen)
    img = image(torch, cut, slots, gen)
    k32 = decode_logits(torch, cut, params, base, tok, pos, "float32",
                        False, want, img)
    r32 = decode_logits(torch, cut, params, base, tok, pos, "float32", True,
                        want, img)
    scale = r32.abs().max().item()
    dec32 = (k32 - r32).abs().max().item()
    print(f"phase {phase}: {arch} decode step, {slots} slots at {D256_POS} "
          f"behind {D256_MAX_LEN} rows, kernel vs plain: f32 "
          f"max|d|={dec32!r} (limit {PARITY_F32} x max|logits|={scale!r})")
    require(dec32 <= PARITY_F32 * scale, f"{phase} {arch} f32 decode parity")
    del params, base, img, k32, r32
    gc.collect()
    torch.cuda.empty_cache()

    bf16_train_draws(torch, cut, what, run)
    pairs = []
    for i in range(BF16_DRAWS):
        key = f"phase {phase}: {arch} decode draw {i}"
        g = own_gen(torch, key, None, (key,))
        w = M.init_params(cut, g)
        c, t = decode_inputs(torch, cut, slots, D256_MAX_LEN, g)
        im = image(torch, cut, slots, g)
        r32 = decode_logits(torch, cut, w, c, t, pos, "float32", True, want,
                            im)
        r16 = decode_logits(torch, cut, w, c, t, pos, "bfloat16", True, want,
                            im)
        k16 = decode_logits(torch, cut, w, c, t, pos, "bfloat16", False,
                            want, im)
        pairs.append((_norm(torch, k16 - r32), _norm(torch, r16 - r32)))
        del w, c, im, r32, r16, k16
        gc.collect()
        torch.cuda.empty_cache()
    require_bf16(pairs, f"phase {phase}: {arch} decode-step logits")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cut.n_layers, "params": n_params,
            "flash_calls": per_call, "f32_worst_leaf": (kernel[at], at),
            "f32_witness_at_worst": witness[at],
            "f32_witness_worst": max(witness.values()),
            "f32_worst_from_f64": max(from_f64.values()),
            "f32_decode_max_abs": dec32}


def launcher_train_phase(torch, card, arch, phase="12c",
                         change=None) -> dict:
    """Phase 12c (and 13b): the train launcher's loop (its defaults: remat
    dtr, AdamW) at batch 2 x 2048, 3 steps, depth ``GEMMA_TRAIN_LAYERS``
    (the whole model where it names none): each
    step's flash launches per variant (forward twice an attention layer,
    backward once, all on ``wgmma``), finite losses, the step's wall (the
    loop's), device busy and idle share (one more step, profiled),
    tokens/s, ``max_memory_allocated``.  ``change``: config fields
    replaced.  Returns the launches, in all and by attention kind, and the
    step's numbers."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items
    from repro_torch.optim import adamw, cosine_schedule
    args = train.parse_args(["--arch", arch, "--steps", str(GEMMA_STEPS),
                             "--batch", str(GEMMA_BATCH), "--seq",
                             str(GEMMA_SEQ)])
    require((args.remat, args.optimizer) == ("dtr", "adamw"),
            f"launcher defaults {args}")
    cfg = train.config_from_args(args).replace(
        n_layers=GEMMA_TRAIN_LAYERS.get(arch, configs.get(arch).n_layers),
        **(change or {}))
    kinds = attention_kinds(cfg)
    n_attn = sum(kinds.values())
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n = sum(t.numel() for _, t in tree_items(params))
    per_step = []
    on_step, stamps = loop_stamps(per_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.train_loop(cfg, params, args, verbose=False, on_step=on_step)
    end = time.perf_counter()
    per_step.append((read_launches(), read_variants()))
    peak = torch.cuda.max_memory_allocated()
    for counts, variants in per_step:
        fwd, bwd = (variants["flash_attention"],
                    variants["flash_attention_bwd"])
        require(counts["flash_attention"] == fwd["wgmma"] == 2 * n_attn
                and counts["flash_attention_bwd"] == bwd["wgmma"] == n_attn,
                f"{phase} {arch}: flash launches per step {counts} "
                f"{variants}")
    require(all(math.isfinite(x) for x in res.losses)
            and res.actions == ["ok"] * GEMMA_STEPS,
            f"{phase} {arch} finite")
    opt = adamw(lr=cosine_schedule(args.lr, warmup=20, total=args.steps))
    one, _ = guarded_step(cfg, opt)
    batch = _train_batch(torch, cfg, GEMMA_STEPS, GEMMA_BATCH, GEMMA_SEQ)
    busy = device_ms(torch, lambda: one(params, res.opt_state, batch), 1,
                     top=6)
    require(busy is not None, f"{phase} {arch} profiler device time")
    wall = statistics.median(res.step_seconds[1:]) * 1e3
    row = {"layers": cfg.n_layers, "params": n, "losses": res.losses,
           "step_ms": [t * 1e3 for t in res.step_seconds],
           "loop_wall_ms": loop_walls_ms(stamps, end), "wall_ms": wall,
           "busy_ms": busy, "idle_share": 1 - busy / wall,
           "tokens_per_s": GEMMA_BATCH * GEMMA_SEQ / (wall / 1e3),
           "peak_bytes": peak,
           "launches": {k: sum(c[k] for c, _ in per_step)
                        for k in FLASH_STEP_KERNELS},
           "kinds": dict(kinds)}
    print(f"phase {phase}: {arch} ({cfg.n_layers} layers, {n} parameters, "
          f"attention layers {dict(kinds)}) train loop, batch "
          f"{GEMMA_BATCH}x{GEMMA_SEQ}, remat dtr, AdamW: losses "
          f"{res.losses}, step ms {row['step_ms']}, loop wall per step "
          f"{row['loop_wall_ms']} ({end - t0:.1f} s with set-up); one more "
          f"step: device busy {busy!r} ms against the loop's median wall "
          f"{wall!r} ms, idle share {row['idle_share']!r}, "
          f"{row['tokens_per_s']!r} tokens/s; flash launches per step "
          f"(fwd, bwd) {[(c['flash_attention'], c['flash_attention_bwd']) for c, _ in per_step]}"
          f", per variant {[(v['flash_attention'], v['flash_attention_bwd']) for _, v in per_step]}"
          f"; max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    del params, res, one, batch
    gc.collect()
    torch.cuda.empty_cache()
    return row


def gemma_serve_phase(torch, card, arch, change=None,
                      phase="12d") -> dict:
    """Phase 12d: the full-depth model serves 8 requests over 4 slots, 16
    tokens each, bf16, at ``--max-len D256_MAX_LEN``: 8/8 served, flash
    launches once an attention layer and step, all on ``wgmma`` (D 256);
    the loop's ms/step; one decode step's wall and device busy.
    ``change``: config fields replaced."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    cfg = configs.get(arch).replace(**(change or {}))
    kinds = attention_kinds(cfg)
    n_attn = sum(kinds.values())
    args = serve.parse_args(["--arch", arch, "--requests", "8", "--slots",
                             "4", "--gen", "16", "--max-len",
                             str(D256_MAX_LEN)])
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    reset_launches()
    res = serve.serve_loop(cfg, params, args)
    launches, variants = read_launches(), read_variants()
    require(cfg.dtype == "bfloat16", f"{arch} serves in {cfg.dtype}")
    require(len(res.completed) == 8
            and all(len(t) == 16 and all(0 <= x < cfg.vocab for x in t)
                    for t in res.completed.values()),
            f"{phase} {arch}: served {sorted(res.completed)}")
    fwd = variants["flash_attention"]
    require(launches["flash_attention"] == fwd["wgmma"]
            == res.steps * n_attn, f"{phase} {arch} launches {launches} "
            f"{variants} for {res.steps} steps x {n_attn}")
    prepared = M.prepare_params(cfg, params)
    base, tok = decode_inputs(torch, cfg, 4, D256_MAX_LEN,
                              torch.Generator("cuda").manual_seed(3))
    cache = tree_map(lambda t: t.to(torch.bfloat16), base)
    pos = torch.tensor(D256_POS, dtype=torch.int32, device="cuda")

    def run():
        with torch.inference_mode():
            M.decode_step(cfg, prepared, tok, cache, pos)

    step_ms = event_ms(torch, run, 10)
    busy_ms = device_ms(torch, run, 3)
    row = {"steps": res.steps, "ms_per_step": res.seconds * 1e3 / res.steps,
           "decode_wall_ms": step_ms, "decode_busy_ms": busy_ms,
           "launches": launches["flash_attention"], "kinds": dict(kinds),
           "variants": variants["flash_attention"]}
    print(f"phase {phase}: {arch} ({cfg.n_layers} layers) served "
          f"{len(res.completed)}/8 requests over 4 slots, {res.steps} "
          f"decode steps, {row['ms_per_step']!r} ms/step, flash launches "
          f"{launches['flash_attention']} per variant {fwd}; one decode "
          f"step at {D256_POS} behind {D256_MAX_LEN} rows: wall "
          f"{step_ms!r} ms, device busy {busy_ms!r} ms [{card}]")
    del params, prepared, base, cache, res
    gc.collect()
    torch.cuda.empty_cache()
    return row


def gemma_phase(torch, card, gen) -> dict:
    """Phase 12: gemma3-1b and recurrentgemma-2b, 12a-d for each."""
    out = {}
    for arch in (GEMMA_ARCH, RG_ARCH):
        t12 = time.perf_counter()
        smoke_phase(torch, arch, "12a")
        out[arch] = {"parity": parity_phase(
            torch, arch, "12b", GEMMA_PARITY_LAYERS[arch],
            (GEMMA_BATCH, GEMMA_SEQ), gen),
                     "train": launcher_train_phase(torch, card, arch),
                     "serve": gemma_serve_phase(torch, card, arch)}
        print(f"phase 12: {arch} {time.perf_counter() - t12:.1f} s of wall "
              f"time")
    return out


def vision_train_phase(torch, card) -> dict:
    """Phase 13a, third part: vision cut to one group (``VISION_CUT``
    layers) trains ``NEW_STEPS`` steps at batch 2 x 2048, each against its
    own [2,1601,7680] image, through ``make_train_step`` (remat dtr, AdamW
    on the launcher's schedule, clipping at 1.0); the launchers cannot,
    as the reference's cannot (no ``img_embed``).  Each step's flash
    launches per variant (forward twice a layer under remat, cross layers
    twice more, backward once each, all ``wgmma``) and the steps' launches
    by mask (``flash_by_mask``: self and cross), finite losses, step
    wall (host clock, synchronized), device busy and idle share (one more
    step, profiled), tokens/s and ``max_memory_allocated``."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items
    from repro_torch.optim import adamw, cosine_schedule
    cfg = configs.get(VISION_ARCH).replace(n_layers=VISION_CUT, remat="dtr")
    n_self, n_cross = flash_layers(cfg)
    calls = n_self + n_cross
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n = sum(t.numel() for _, t in tree_items(params))
    opt = adamw(lr=cosine_schedule(3e-4, warmup=20, total=NEW_STEPS))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    g = torch.Generator("cuda").manual_seed(11)
    batches = [dict(_train_batch(torch, cfg, i, NEW_BATCH, NEW_SEQ),
                    img_embed=image(torch, cfg, NEW_BATCH, g))
               for i in range(NEW_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    with flash_by_mask() as by_mask:
        for i in range(NEW_STEPS):
            reset_launches()
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batches[i])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            per_step.append((read_launches(), read_variants()))
    peak = torch.cuda.max_memory_allocated()
    for counts, variants in per_step:
        fwd, bwd = (variants["flash_attention"],
                    variants["flash_attention_bwd"])
        require(counts["flash_attention"] == fwd["wgmma"] == 2 * calls
                and counts["flash_attention_bwd"] == bwd["wgmma"] == calls,
                f"13a: flash launches per step {counts} {variants}")
    mask = {kind: {d: by_mask[d, kind] for d in ("fwd", "bwd")}
            for kind in ("self", "cross")}
    require(mask["cross"] == {"fwd": 2 * n_cross * NEW_STEPS,
                              "bwd": n_cross * NEW_STEPS}
            and mask["self"]["fwd"] + mask["cross"]["fwd"]
            == sum(c["flash_attention"] for c, _ in per_step)
            and mask["self"]["bwd"] + mask["cross"]["bwd"]
            == sum(c["flash_attention_bwd"] for c, _ in per_step),
            f"13a: flash launches by mask {mask}")
    require(all(math.isfinite(x) for x in losses), "13a finite losses")
    busy = device_ms(torch, lambda: step_fn(params, state, batches[-1]), 1,
                     top=6)
    require(busy is not None, "13a profiler device time")
    wall = statistics.median(step_ms[1:])
    row = {"layers": cfg.n_layers, "params": n, "losses": losses,
           "step_ms": step_ms, "wall_ms": wall, "busy_ms": busy,
           "idle_share": 1 - busy / wall,
           "tokens_per_s": NEW_BATCH * NEW_SEQ / (wall / 1e3),
           "peak_bytes": peak,
           "launches": {k: sum(c[k] for c, _ in per_step)
                        for k in FLASH_STEP_KERNELS},
           "self_launches": mask["self"], "cross_launches": mask["cross"]}
    print(f"phase 13a: {VISION_ARCH} ({cfg.n_layers} layers: {n_self} "
          f"self-attention, {n_cross} cross; {n} parameters) train step, "
          f"batch {NEW_BATCH}x{NEW_SEQ} with [{NEW_BATCH},"
          f"{cfg.cross_attn_tokens},{cfg.cross_attn_dim}] images, remat "
          f"dtr, AdamW: losses {losses}, step ms {step_ms}; one more step: "
          f"device busy {busy!r} ms against the median wall {wall!r} ms, "
          f"idle share {row['idle_share']!r}, {row['tokens_per_s']!r} "
          f"tokens/s; flash launches per step (fwd, bwd) "
          f"{[(c['flash_attention'], c['flash_attention_bwd']) for c, _ in per_step]}"
          f", per variant {[(v['flash_attention'], v['flash_attention_bwd']) for _, v in per_step]}"
          f", over the {NEW_STEPS} steps by mask {mask}; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    del params, state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    return row


def decode_loop_phase(torch, card, arch, phase) -> dict:
    """Phases 13a/13b, last part: the whole model (bf16 activations, its
    weights cast once by ``prepare_params`` and the f32 draw freed) decodes
    ``NEW_DECODE_STEPS`` greedy steps through ``make_serve_step`` for
    ``NEW_DECODE_SLOTS`` slots on per-slot clocks from 0, behind
    ``D256_MAX_LEN`` cache rows (vision: against one [1601,7680] image a
    slot, its K/V projected anew every step): the tokens, flash launches
    (every layer's self attention with ``kv_len``, every cross layer's
    cross call, all ``wgmma``; counted by mask too), the loop's ms a step,
    and one more step's
    wall (CUDA events) and device busy."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items
    cfg = configs.get(arch)
    n_self, n_cross = flash_layers(cfg)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n = sum(t.numel() for _, t in tree_items(params))
    prepared = M.prepare_params(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    slots = NEW_DECODE_SLOTS
    g = torch.Generator("cuda").manual_seed(12)
    img = image(torch, cfg, slots, g)
    cache = M.init_cache(cfg, slots, D256_MAX_LEN, "cuda")
    tok = torch.randint(0, cfg.vocab, token_shape(cfg, slots, 1),
                        generator=g, device="cuda", dtype=torch.int32)
    pos = torch.zeros(slots, dtype=torch.int32, device="cuda")
    serve = make_serve_step(cfg)
    out = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode(), flash_by_mask() as by_mask:
        for _ in range(NEW_DECODE_STEPS):
            tok, cache = serve(prepared, cache, tok, pos, img)
            out.append(tok)
            pos = pos + 1
        torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / NEW_DECODE_STEPS
    launches, variants = read_launches(), read_variants()
    tokens = torch.stack(out).cpu()
    per_step = n_self + n_cross
    require(cfg.dtype == "bfloat16", f"{arch} decodes in {cfg.dtype}")
    require(tokens.shape == (NEW_DECODE_STEPS,) + token_shape(cfg, slots, 1)
            and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
            f"{phase} {arch} tokens {tuple(tokens.shape)}")
    require(launches["flash_attention"] == variants["flash_attention"][
        "wgmma"] == NEW_DECODE_STEPS * per_step
        and by_mask["fwd", "self"] == NEW_DECODE_STEPS * n_self
        and by_mask["fwd", "cross"] == NEW_DECODE_STEPS * n_cross,
        f"{phase} {arch} decode launches {launches} {variants} by mask "
        f"{dict(by_mask)}")

    def one():
        with torch.inference_mode():
            M.decode_step(cfg, prepared, tok, cache, pos, img)

    step_ms = event_ms(torch, one, 10)
    busy_ms = device_ms(torch, one, 3)
    require(busy_ms is not None, f"{phase} {arch} profiler device time")
    row = {"layers": cfg.n_layers, "params": n, "steps": NEW_DECODE_STEPS,
           "loop_ms_per_step": loop_ms, "decode_wall_ms": step_ms,
           "decode_busy_ms": busy_ms, "idle_share": 1 - busy_ms / step_ms,
           "launches": launches["flash_attention"],
           "self_launches": by_mask["fwd", "self"],
           "cross_launches": by_mask["fwd", "cross"],
           "first_tokens": tokens[:4, 0].tolist()}
    print(f"phase {phase}: {arch} whole ({cfg.n_layers} layers, {n} "
          f"parameters, bf16 copy on the card) greedy decode, {slots} slots"
          f"{', image ' + str(list(img.shape)) if img is not None else ''}"
          f", {NEW_DECODE_STEPS} steps: slot 0's first tokens "
          f"{row['first_tokens']}, {loop_ms!r} ms a step in the loop, flash "
          f"launches {launches['flash_attention']} per variant "
          f"{variants['flash_attention']} ({n_self} self + {n_cross} cross a "
          f"step); one more step: wall {step_ms!r} ms, device busy "
          f"{busy_ms!r} ms [{card}]")
    del prepared, cache, img, out, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return row


def new_model_phase(torch, card) -> dict:
    """Phase 13: llama-3.2-vision-11b (13a) and musicgen-large (13b)."""
    out = {}
    t0 = time.perf_counter()
    smoke_phase(torch, VISION_ARCH, "13a")
    out[VISION_ARCH] = {
        "parity": parity_phase(torch, VISION_ARCH, "13a", VISION_CUT,
                               (VISION_PARITY_BATCH, NEW_SEQ),
                               torch.Generator("cuda").manual_seed(8)),
        "train": vision_train_phase(torch, card),
        "decode": decode_loop_phase(torch, card, VISION_ARCH, "13a")}
    print(f"phase 13: {VISION_ARCH} {time.perf_counter() - t0:.1f} s of "
          f"wall time")
    t0 = time.perf_counter()
    smoke_phase(torch, MUSIC_ARCH, "13b")
    out[MUSIC_ARCH] = {
        "parity": parity_phase(torch, MUSIC_ARCH, "13b", MUSIC_PARITY_LAYERS,
                               (NEW_BATCH, NEW_SEQ),
                               torch.Generator("cuda").manual_seed(8)),
        "decode": decode_loop_phase(torch, card, MUSIC_ARCH, "13b"),
        "train": launcher_train_phase(torch, card, MUSIC_ARCH, "13b")}
    print(f"phase 13: {MUSIC_ARCH} {time.perf_counter() - t0:.1f} s of "
          f"wall time")
    return out


# -- 14-16: the soft cap, the launcher's mesh flags, the dry run -------------

def softcap_checks(torch, gen) -> dict:
    """Phase 2 with the soft cap ``SOFTCAP_CHECK``: the backward cases
    (forward with the LSE and backward, every variant the shape takes,
    ``mma`` and ``simt`` forced beside the planned one) of
    ``SOFTCAP_CASES``, f32 and bf16; the decode shapes with mixed
    ``kv_len`` (split keys on ``wgmma``); one bf16 forward forced onto
    ``simt``.  Returns the bf16 max abs errors by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    errs = flash_bwd_checks(torch, gen, list(SOFTCAP_CASES.values()),
                            SOFTCAP_CASES,
                            tuple(str(c) for c in SOFTCAP_CASES.values()),
                            softcap=SOFTCAP_CHECK)
    print(f"phase 2: flash_attention decode, soft cap {SOFTCAP_CHECK}")
    errs.update(decode_kernel_checks(torch, gen, {
        f"{n} capped": s for n, s in (("qwen2-0.5b decode", DECODE),
                                      (SOFTCAP_DECODE,
                                       D256_DECODE[SOFTCAP_DECODE]))},
        softcap=SOFTCAP_CHECK))
    shape = dict(b=2, hq=14, hkv=2, sq=100, skv=100, d=64, kv_len=None)
    q, k, v, _ = inputs(torch, shape, torch.bfloat16, own_gen(
        torch, "softcap simt", gen, ("softcap simt",)))
    before = read_variants()["flash_attention"]["simt"]
    with simt_only():
        err = compare(torch, fa.flash_attention, ref.flash_reference,
                      (q, k, v), dict(causal=True, softcap=SOFTCAP_CHECK),
                      TOL["bfloat16"], f"bfloat16 {shape} soft cap "
                      f"{SOFTCAP_CHECK}, forced")
    require(read_variants()["flash_attention"]["simt"] == before + 1,
            "the forced bf16 forward ran on simt")
    errs["bf16 simt"] = {"fwd": err}
    return errs


def _flex(torch, q, k, v, causal, window, kv_len, do=None):
    """``flex_attention`` with the soft cap ``SOFTCAP`` as its
    ``score_mod`` and the flash kernels' mask as its block mask, compiled:
    the one library call for the capped function (SDPA has no cap).  With
    ``do``, the call also runs its backward against ``do`` (the compiled
    backward kernel: the library's time of the capped backward is this
    call's less the forward's).  A callable, or None (printed) where it
    does not compile."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        sq, skv = q.shape[2], k.shape[2]

        def mask(b, h, qi, kj):
            length = skv if kv_len is None else kv_len[b]
            ok = kj < length
            if causal:
                qpos = qi + (length - sq)
                ok = ok & (kj <= qpos)
                if window:
                    ok = ok & (qpos - kj < window)
            return ok

        def cap(score, b, h, qi, kj):
            return SOFTCAP * torch.tanh(score / SOFTCAP)

        block = create_block_mask(
            mask, B=None if kv_len is None else q.shape[0], H=None,
            Q_LEN=sq, KV_LEN=skv, device="cuda")
        fn = torch.compile(flex_attention)
        if do is not None:
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))

        def call():
            out = fn(q, k, v, score_mod=cap, block_mask=block,
                     enable_gqa=True)
            if do is None:
                return out
            for t in (q, k, v):
                t.grad = None
            out.backward(do)

        call()
        torch.cuda.synchronize()
        return call
    except Exception as e:            # the yardstick only, never the port
        print(f"  flex_attention did not compile here: {e!r}"[:400])
        return None


def softcap_times(torch, card, gen) -> dict:
    """Phase 2's capped rows, timed: at ``SOFTCAP_TIMED``'s train shapes
    the forward with the LSE and the backward, at ``SOFTCAP_DECODE`` the
    decode forward, each capped at ``SOFTCAP`` beside the same call
    uncapped (the rows ``PERF.md`` measured before the cap), the plain
    version and ``flex_attention`` compiled: its forward, and its
    backward as its forward and backward less its forward (the backward
    is no one call)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = {}
    for what, case in SOFTCAP_TIMED.items():
        b, hq, hkv, sq, skv, d, causal, window = case
        shape = dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d, kv_len=None)
        g = own_gen(torch, f"softcap {what}", gen, (f"softcap {what}",))
        q, k, v, _ = inputs(torch, shape, torch.bfloat16, g)
        do = torch.randn(q.shape, generator=g, device="cuda").to(
            torch.bfloat16)
        flex = _flex(torch, q, k, v, causal, window, None)
        flex_bwd = _flex(torch, q, k, v, causal, window, None, do=do)
        label = f"soft cap {SOFTCAP}, {what} {list(case)} bf16"
        fwd = time_row(torch, (
            ("ms", lambda: fa._forward(q, k, v, causal, window, None, True,
                                       softcap=SOFTCAP)),
            ("uncapped_ms", lambda: fa._forward(q, k, v, causal, window,
                                                None, True)),
            ("plain_ms", lambda: ref.flash_reference_lse(
                q, k, v, causal=causal, window=window, softcap=SOFTCAP)),
            *((("library_ms", flex),) if flex else ())), 10,
            attention_bound_ms(shape, causal, 2, "bfloat16", window),
            f"flash_attention forward, {label}", card)
        out, lse = fa._forward(q, k, v, causal, window, None, True,
                               softcap=SOFTCAP)
        out0, lse0 = fa._forward(q, k, v, causal, window, None, True)
        bwd = time_row(torch, (
            ("ms", lambda: fa.flash_attention_bwd(
                q, k, v, out, lse, do, causal=causal, window=window,
                softcap=SOFTCAP)),
            ("uncapped_ms", lambda: fa.flash_attention_bwd(
                q, k, v, out0, lse0, do, causal=causal, window=window)),
            ("plain_ms", lambda: ref.flash_backward_reference(
                q, k, v, out, lse, do, causal=causal, window=window,
                softcap=SOFTCAP)),
            *((("library_fwd_bwd_ms", flex_bwd),) if flex_bwd else ())), 10,
            flash_bwd_bound_ms(case, 2), f"flash_attention_bwd, {label}",
            card)
        fwd.setdefault("library_ms", None)
        both = bwd.get("library_fwd_bwd_ms")
        bwd["library_ms"] = (both - fwd["library_ms"] if both is not None
                             and fwd["library_ms"] is not None else None)
        rows[what] = {"fwd": fwd, "bwd": bwd}
        del q, k, v, do, out, lse, out0, lse0, flex, flex_bwd
        gc.collect()
        torch.cuda.empty_cache()
    shape = D256_DECODE[SOFTCAP_DECODE]
    q, k, v, kv_len = inputs(torch, shape, torch.bfloat16, own_gen(
        torch, f"softcap {SOFTCAP_DECODE}", gen,
        (f"softcap {SOFTCAP_DECODE}",)))
    flex = _flex(torch, q, k, v, True, 0, kv_len)
    kw = dict(causal=True, kv_len=kv_len)
    fwd = time_row(torch, (
        ("ms", lambda: fa.flash_attention(q, k, v, softcap=SOFTCAP, **kw)),
        ("uncapped_ms", lambda: fa.flash_attention(q, k, v, **kw)),
        ("plain_ms", lambda: ref.flash_reference(q, k, v, softcap=SOFTCAP,
                                                 **kw)),
        *((("library_ms", flex),) if flex else ())), 200,
        attention_bound_ms(shape, True, 2, "bfloat16"),
        f"flash_attention, soft cap {SOFTCAP}, {SOFTCAP_DECODE} bf16", card)
    fwd.setdefault("library_ms", None)
    rows[SOFTCAP_DECODE] = {"fwd": fwd}
    return rows


def softcap_phase(torch, card) -> dict:
    """Phase 14: gemma3-1b at full width with ``logit_softcap``
    ``SOFTCAP``: (a) phase 12's parity at its cut, every flash call and
    the gradients kernel against plain, bf16 by the bf16 rule; (b) the
    train launcher's loop, 3 steps at batch 2 x 2048; (c) 8 requests
    served over 4 slots.  Every bf16 launch on ``wgmma``."""
    change = {"logit_softcap": SOFTCAP}
    # A generator of its own: the shared one's draws stay those of the
    # phases after this one.
    gen = torch.Generator("cuda").manual_seed(zlib.crc32(b"phase 14"))
    t14 = time.perf_counter()
    out = {"parity": parity_phase(
        torch, GEMMA_ARCH, "14a", GEMMA_PARITY_LAYERS[GEMMA_ARCH],
        (GEMMA_BATCH, GEMMA_SEQ), gen, change),
        "train": launcher_train_phase(torch, card, GEMMA_ARCH, "14b",
                                      change),
        "serve": gemma_serve_phase(torch, card, GEMMA_ARCH, change, "14c")}
    simt = out["serve"]["variants"]["simt"]
    require(simt == 0, f"14c bf16 serve launches on simt: {simt}")
    print(f"phase 14: {GEMMA_ARCH} with logit_softcap {SOFTCAP}: train "
          f"wall {out['train']['wall_ms']!r} ms beside device busy "
          f"{out['train']['busy_ms']!r} ms a step, serve decode wall "
          f"{out['serve']['decode_wall_ms']!r} ms beside busy "
          f"{out['serve']['decode_busy_ms']!r} ms, simt launches 0 in "
          f"14b and 14c; {time.perf_counter() - t14:.1f} s of wall time "
          f"[{card}]")
    return out


def launcher_mesh_phase(torch, card) -> dict:
    """Phase 15: the train launcher on the card with ``--mesh host --fsdp
    --seq-shard`` gives the losses it gives without them (qwen2-0.5b
    smoke, 3 steps, on the one-device mesh); ``--mesh production`` fails
    with the reference's assertion."""
    from repro_torch.launch import train
    base = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--remat", "none"]
    with tempfile.TemporaryDirectory() as tmp:
        plain = train.main(base + ["--ckpt-dir", f"{tmp}/plain"])
        meshed = train.main(base + ["--mesh", "host", "--fsdp",
                                    "--seq-shard", "--ckpt-dir",
                                    f"{tmp}/mesh"])
        refused = None
        try:
            train.main(base + ["--mesh", "production", "--ckpt-dir",
                               f"{tmp}/prod"])
        except AssertionError as e:
            refused = str(e)
    print(f"phase 15: train launcher, {ARCH} smoke on the card: losses "
          f"{plain.losses} without mesh flags, {meshed.losses} with --mesh "
          f"host --fsdp --seq-shard; --mesh production: {refused!r} "
          f"[{card}]")
    require(plain.losses == meshed.losses, "15: the mesh flags change the "
            "host mesh's losses")
    require(refused is not None and refused.startswith(
        "need 256 devices for mesh (16, 16), have 1"),
        f"15: --mesh production's failure {refused!r}")
    return {"losses": meshed.losses}


# -- 17: context-parallel decode ---------------------------------------------

def split_lse_checks(torch, gen) -> dict:
    """Phase 2 for ``flash_attention_lse`` (a decode call whose LSE goes
    to a merge) at ``SPLIT_LSE``'s shapes, uncapped and capped at
    ``SOFTCAP_CHECK``, f32 (``simt``) and bf16 (``wgmma``, the keys split
    over blocks but at 64 slots): out against ``flash_reference_lse``
    within ``TOL`` and the LSE within ``LSE_TOL`` on the rows that see a
    key; a row that sees none gives zeros and an LSE of -inf (no NaN
    anywhere); a second call's bits equal.  Returns the bf16 uncapped max
    abs errors by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    print("phase 2: flash_attention_lse (decode with each row's LSE, for a "
          "merge) against flash_reference_lse")
    errs = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for what, shape in SPLIT_LSE.items():
            dims = [shape[n] for n in ("b", "hq", "hkv", "sq", "skv", "d")]
            p = fa.plan(*dims, dtype, save_lse=True, for_merge=True)
            split = dtype == torch.bfloat16 and "unsplit" not in what
            require(p["variant"] == ("wgmma" if dtype == torch.bfloat16
                                     else "simt")
                    and (p["kv_splits"] > 1) == split,
                    f"{what} {dtype_name} planned {p}")
            for cap in (0.0, SOFTCAP_CHECK):
                q, k, v, kv_len = inputs(torch, shape, dtype, own_gen(
                    torch, f"split lse {what}", gen, (f"split lse {what}",)))
                before = dict(fa.flash_attention_lse.variant_launches)
                out, lse = fa.flash_attention_lse(q, k, v, kv_len=kv_len,
                                                  softcap=cap)
                out2, lse2 = fa.flash_attention_lse(q, k, v, kv_len=kv_len,
                                                    softcap=cap)
                torch.cuda.synchronize()
                ran = ran_variant({v_: n - before[v_] for v_, n in
                                   fa.flash_attention_lse
                                   .variant_launches.items()})
                same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
                want_out, want_lse = ref.flash_reference_lse(
                    q, k, v, kv_len=kv_len, softcap=cap)
                seen = kv_len > 0
                out_err = (out[seen].float() - want_out[seen].float()).abs() \
                    .max().item() if seen.any() else 0.0
                lse_err = (lse[seen] - want_lse[seen]).abs().max().item() \
                    if seen.any() else 0.0
                empty_ok = bool((out[~seen] == 0).all()
                                and torch.isneginf(lse[~seen]).all()
                                and torch.isfinite(out).all()
                                and not torch.isnan(lse).any())
                ok = (ran == p["variant"] and same and empty_ok
                      and out_err <= TOL[dtype_name] and lse_err <= LSE_TOL)
                print(f"  {dtype_name} {what} {list(dims)} kv_len "
                      f"{shape['kv_len'][:8]} cap {cap} [{ran}, "
                      f"{p['kv_splits']} splits]: out max_abs_err="
                      f"{out_err!r} (tol {TOL[dtype_name]}), lse max|d|="
                      f"{lse_err!r} (tol {LSE_TOL}), empty rows 0 and -inf, "
                      f"no NaN: {empty_ok}, second call same bits: {same} "
                      f"{'ok' if ok else 'FAIL'}")
                require(ok, f"flash_attention_lse against plain: "
                        f"{dtype_name} {what} cap {cap}")
                if dtype == torch.bfloat16 and not cap:
                    errs[what] = out_err
                del q, k, v, kv_len, out, lse, out2, lse2, want_out, want_lse
    return errs


def split_lse_times(torch, card, gen) -> dict:
    """Phase 5 for ``flash_attention_lse`` at ``SPLIT_LSE_TIMED`` (bf16):
    the kernel (``wgmma``, split keys), the same call saving its LSE for a
    backward (which never splits: ``unsplit_ms``), forced onto ``simt``,
    the plain version and one PyTorch call that returns the same pair,
    ``aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp`` (no GQA: k and v repeated to the query heads
    beforehand; ``kv_len`` as an additive -inf bias), beside the bound
    (q, the visible K/V rows, out and the LSE once)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    shape = SPLIT_LSE[SPLIT_LSE_TIMED]
    q, k, v, kv_len = inputs(torch, shape, torch.bfloat16, own_gen(
        torch, "split lse times", gen, ("split lse times",)))
    g = shape["hq"] // shape["hkv"]
    kx, vx = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    bias = torch.where(
        torch.arange(shape["skv"], device="cuda")[None, :] < kv_len[:, None],
        0.0, -math.inf).to(torch.bfloat16)[:, None, None, :].expand(
        -1, shape["hq"], 1, -1).contiguous()

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q, kx, vx, bias, True)

    try:
        library()
        torch.cuda.synchronize()
        lib = (("library_ms", library),)
    except Exception as e:            # the yardstick only, never the port
        print(f"  the efficient attention call failed here: {e!r}"[:400])
        lib = ()
    kw = dict(kv_len=kv_len)
    row = time_row(torch, (
        ("ms", lambda: fa.flash_attention_lse(q, k, v, **kw)),
        ("unsplit_ms", lambda: fa._forward(q, k, v, True, 0, kv_len, True)),
        ("simt_ms", lambda: fa.flash_attention_lse(q, k, v, **kw)),
        ("plain_ms", lambda: ref.flash_reference_lse(q, k, v, **kw)),
        *lib), 200, attention_bound_ms(shape, True, 2, "bfloat16", lse=True),
        f"flash_attention_lse, {SPLIT_LSE_TIMED} {shape} bf16, wgmma with "
        f"split keys", card)
    row.setdefault("library_ms", None)
    return row


def split_kv_phase(torch, card, gen) -> dict:
    """Phase 17: context-parallel decode at full width on one card.  Each
    cache of ``CP_CACHES`` (bf16, in the model's [B,L,KV,D] layout) is cut
    into ``CP_SHARDS`` shards along its sequence; each shard goes through
    ``ops.attention_lse`` with the ``kv_len`` a device of the mesh gives it
    (``ops.shard_kv_len``), and ``ops.merge_attention`` merges them: the
    functions ``ops.split_kv_attention`` runs on each device and over the
    mesh.  The launch counts are zeroed just before and read just after:
    ``CP_SHARDS`` launches of ``flash_attention_lse`` a cache, on
    ``wgmma``, and no other.  The merged output is held against the
    unsplit kernel call (``ops.attention``) and the plain version row by
    row, each (slot, head) within ``TOL`` of its own max|plain| (a slot
    that sees 300000 keys has values near 1e-2, so an absolute ``TOL``
    could not fail there), the merged LSE against ``flash_reference_lse``'s
    within ``LSE_TOL``.  The check is shown able to fail: the same merge
    with shard 0's output zeroed (its LSE kept) must exceed ``TOL`` of the
    row max on some row."""
    from repro_torch.kernels import ops, ref
    rows = {}
    for what, shape in CP_CACHES.items():
        q, k, v, kv_len = inputs(torch, shape, torch.bfloat16, own_gen(
            torch, f"cp {what}", gen, (f"cp {what}",)))
        qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))
        n = shape["skv"] // CP_SHARDS
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        parts = [ops.attention_lse(qm, km[:, r * n:(r + 1) * n],
                                   vm[:, r * n:(r + 1) * n],
                                   kv_len=ops.shard_kv_len(kv_len, r, n))
                 for r in range(CP_SHARDS)]
        out, lse = ops.merge_attention(torch.stack([o for o, _ in parts]),
                                       torch.stack([l_ for _, l_ in parts]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches, variants = read_launches(), read_variants()
        whole = ops.attention(qm, km, vm, kv_len=kv_len)
        plain, plain_lse = ref.flash_reference_lse(q, k, v, kv_len=kv_len)
        plain = plain.transpose(1, 2).float()
        scale = plain.abs().amax(-1).clamp(min=1e-30)

        def of_row_max(got, want):
            """max over (slot, head) rows of max|got - want| / max|plain|"""
            return ((got.float() - want.float()).abs().amax(-1)
                    / scale).max().item()

        err_whole = (out.float() - whole.float()).abs().max().item()
        err_plain = (out.float() - plain).abs().max().item()
        ratio_whole, ratio_plain = of_row_max(out, whole), of_row_max(out,
                                                                      plain)
        lse_err = (lse - plain_lse.transpose(1, 2)).abs().max().item()
        zeroed = torch.stack([o for o, _ in parts])
        zeroed[0] = 0
        ratio_zeroed = of_row_max(ops.merge_attention(
            zeroed, torch.stack([l_ for _, l_ in parts]))[0], plain)
        empty = int(sum(bool((ops.shard_kv_len(kv_len, r, n) == 0).any())
                        for r in range(CP_SHARDS)))
        ok = (launches["flash_attention_lse"] == CP_SHARDS
              and sum(launches.values()) == CP_SHARDS
              and variants["flash_attention_lse"]["simt"] == 0
              and bool(torch.isfinite(out).all())
              and ratio_whole <= TOL["bfloat16"]
              and ratio_plain <= TOL["bfloat16"] and lse_err <= LSE_TOL
              and ratio_zeroed > TOL["bfloat16"])
        dims = [shape[n_] for n_ in ("b", "hq", "hkv", "sq", "skv", "d")]
        print(f"phase 17: {what} {dims} bf16 in {CP_SHARDS} shards of {n} "
              f"rows ({empty} with a slot that sees none of its keys): "
              f"launches {launches}, per variant {variants['flash_attention_lse']}, wall "
              f"{wall_ms!r} ms; merged vs the unsplit kernel call "
              f"max_abs_err={err_whole!r} ({ratio_whole!r} of its row's "
              f"max|plain|), vs plain {err_plain!r} ({ratio_plain!r} of the "
              f"row's max; tol {TOL['bfloat16']} of the row's max), LSE vs "
              f"plain {lse_err!r} (tol {LSE_TOL}); with shard 0's output "
              f"zeroed {ratio_zeroed!r} of the row's max (must exceed the "
              f"tol) {'ok' if ok else 'FAIL'} [{card}]")
        require(ok, f"17: {what} split-KV decode")
        rows[what] = {"shards": CP_SHARDS, "empty_shards": empty,
                      "launches": launches["flash_attention_lse"],
                      "variants": variants["flash_attention_lse"],
                      "err_vs_unsplit": err_whole, "err_vs_plain": err_plain,
                      "ratio_vs_unsplit": ratio_whole,
                      "ratio_vs_plain": ratio_plain,
                      "ratio_shard0_zeroed": ratio_zeroed,
                      "lse_err": lse_err, "wall_ms": wall_ms}
        del q, k, v, kv_len, qm, km, vm, parts, out, lse, whole, plain, \
            zeroed
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def start_dryrun() -> tuple:
    """Phase 16's cells, each a subprocess (the fake process group is
    process-wide), output to files in a temporary directory."""
    import os
    out = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        log = open(Path(out) / f"{arch}_{shape}.log", "w")
        procs.append(((arch, shape, mesh), log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", out],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True)))
    return out, procs


def stop_dryrun(started) -> None:
    """Kill whatever of phase 16 still runs (after a failed phase too)."""
    for _, log, proc in started[1]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def finish_dryrun(started, card) -> dict:
    """Phase 16: wait for each cell (``DRYRUN_TIMEOUT`` s in all), require
    "all cells OK", print its OK lines and return each record's memory,
    FLOPs, collective bytes by kind and roofline terms."""
    import shutil
    out, procs = started
    deadline = time.perf_counter() + DRYRUN_TIMEOUT
    rows = {}
    try:
        for (arch, shape, mesh), log, proc in procs:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            log.flush()
            text = (Path(out) / f"{arch}_{shape}.log").read_text()
            lines = [ln for ln in text.splitlines()
                     if ln.startswith(("OK", "FAIL", "all cells"))]
            print(f"phase 16: dry run {arch} {shape} --mesh {mesh}: exit "
                  f"{rc}\n  " + "\n  ".join(lines))
            require(rc == 0 and "all cells OK" in text,
                    f"16: dry run {arch} {shape}: {text[-2000:]}")
            for m in (("single", "multi") if mesh == "both" else (mesh,)):
                res = json.loads((Path(out) / f"{arch}_{shape}_{m}.json")
                                 .read_text())
                ref = DRYRUN_REFERENCE.get((arch, shape))
                if ref is not None and m == "single":
                    peak = res["memory"]["peak_bytes_per_device"]
                    flops = res["cost"]["flops"]
                    print(f"  {arch} {shape}: peak {peak / 2**30:.2f} GiB "
                          f"(reference {ref[0] / 2**30:.2f}), "
                          f"{flops / 1e12:.1f} TF (reference "
                          f"{ref[1] / 1e12:.1f})")
                    require(peak < 80 * 2**30 and peak <= 2 * ref[0],
                            f"16: {arch} {shape} peak {peak} against the "
                            f"reference's {ref[0]}")
                    require(flops <= 1.5 * ref[1], f"16: {arch} {shape} "
                            f"FLOPs {flops} against the reference's "
                            f"{ref[1]}")
                coll = DRYRUN_REFERENCE_COLL.get((arch, shape))
                if coll is not None and m == "single":
                    got = res["collectives"]["total_bytes"]
                    print(f"  {arch} {shape}: collectives {got / 1e6:.3f} MB "
                          f"a device (reference {coll / 1e6:.3f})")
                    require(got <= 4 * coll, f"16: {arch} {shape} collective "
                            f"bytes {got} against the reference's {coll}")
                rows[f"{arch} {shape} {m}"] = {
                    "chips": res["chips"], "trace_s": res["compile_s"],
                    "memory": res["memory"], "flops": res["cost"]["flops"],
                    "collectives": res["collectives"]["by_kind"],
                    "roofline": {k: res["roofline"][k] for k in (
                        "compute_s", "memory_s", "collective_s",
                        "dominant")}}
    finally:
        stop_dryrun(started)
        shutil.rmtree(out, ignore_errors=True)
    print(f"phase 16: {len(rows)} dry-run cells OK on the card's host "
          f"[{card}]")
    return rows


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
            if "entry function" in line:    # the kernel the lines below are
                print(f"  {name}: {kernel_entry(line.split(chr(39))[1])}")
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
    d256_err = d256_kernel_checks(torch, gen)
    d256_times = {**flash_train_times(torch, card, gen, FLASH_D256, True),
                  **flash_decode_times(torch, card, gen, D256_DECODE)}
    mix_flash_err = flash_bwd_checks(
        torch, gen, list(FLASH_MIXTRAL.values()), FLASH_MIXTRAL,
        tuple(str(c) for c in FLASH_MIXTRAL.values()))
    mix_flash_times = flash_train_times(torch, card, gen, FLASH_MIXTRAL,
                                        True)
    new_flash_err = {
        **flash_bwd_checks(torch, gen, list(FLASH_NEW.values()), FLASH_NEW,
                           tuple(str(c) for c in FLASH_NEW.values())),
        **decode_kernel_checks(torch, gen, NEW_DECODE)}
    new_flash_times = {
        **flash_train_times(torch, card, gen, FLASH_NEW, True, simt=True),
        **flash_decode_times(torch, card, gen, NEW_DECODE)}
    softcap_err = softcap_checks(torch, gen)
    softcap_times_ = softcap_times(torch, card, gen)
    split_lse_err = split_lse_checks(torch, gen)
    split_lse_row = split_lse_times(torch, card, gen)

    print("phase 2: moe_gemm against moe_gemm_reference")
    gemm_errs = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        shapes = [("sweep", s) for s in GEMM_SWEEP] + [
            (f"decode {n}", s) for n, s in GEMM_DECODE.items()] + [
            ("prefill", GEMM_PREFILL)] + list(GEMM_TRAIN.items())
        for what, shape in shapes:
            x, w = gemm_inputs(torch, shape, dtype,
                               own_gen(torch, what, gen, GEMM_FRESH))
            gemm_errs[dtype_name, shape] = compare(
                torch, moe_gemm, ref.moe_gemm_reference, (x, w), {},
                MOE_TOL[dtype_name],
                f"{dtype_name} {what} [{shape[0]},{shape[1]},{shape[2]}]@"
                f"[{shape[0]},{shape[2]},{shape[3]}]")
            del x, w
    gemm_bwd_errs = gemm_bwd_checks(torch, gen)
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
    # Phase 11's grouped-GEMM rows, beside phase 5's.
    gemm_rows = gemm_train_times(torch, card, gen)

    gc.collect()
    torch.cuda.empty_cache()

    # -- 6 and 5 for rwkv6, then for qwen2 training ------------------------
    wkv = rwkv_train_phases(torch, card, gen)
    gc.collect()
    torch.cuda.empty_cache()
    qwen_train = qwen_train_phases(torch, card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. MoE training, autotune, deepseek-v3 (before phases 7-10: after
    # phase 10 the profiler has come back empty in every session) ----------
    t11 = time.perf_counter()
    mix = moe_train_phase(torch, card)
    autotune_row = autotune_phase(torch, card)
    deepseek = deepseek_phase(torch, card, gen)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s of wall time")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 12. gemma3-1b and recurrentgemma-2b ---------------------------------
    t12 = time.perf_counter()
    gemma = gemma_phase(torch, card, gen)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s of wall time")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13. llama-3.2-vision-11b and musicgen-large -------------------------
    t13 = time.perf_counter()
    new_models = new_model_phase(torch, card)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s of wall time")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14. the logit soft cap at full width; 15. the launcher's mesh -------
    softcap = softcap_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launcher_mesh = launcher_mesh_phase(torch, card)
    # -- 17. context-parallel decode: a cache in 16 shards, merged -----------
    split_kv = split_kv_phase(torch, card, gen)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 16's cells trace on the host's other cores beside phases 7-10
    # (their host clocks vary more than that already; PERF.md §6).
    dry = start_dryrun()
    atexit.register(stop_dryrun, dry)

    # -- 7. the eager DTR executor, f32 (TF32 off since phase 1) -------------
    eager_chain(torch, card)
    eager_mlp_phases(torch, card)
    serve_log_replay(qwen_log)

    # -- 8. the planner on real bytes -----------------------------------------
    planner_phase(torch, card, qwen_train["peaks"]["none"])

    # -- 9. the training driver and the paper's experiments -----------------
    t9 = time.perf_counter()
    llama = launcher_phase(torch, card)
    smollm = resume_phase(torch, card)
    examples_phase(torch, card)
    paper_rows = paper_phase(torch, card)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s of wall time")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10. the serve surface ------------------------------------------------
    surface = surface_phase(torch, card, gen)

    # -- 16. the dry run's cells, started after phase 15 ------------------
    dryrun_rows = finish_dryrun(dry, card)

    d = times["decode"]
    tf, tb = flash_train[ARCH]["fwd"], flash_train[ARCH]["bwd"]
    g = gemm_times["decode wi"]
    phase9 = {LLAMA_ARCH: llama, SMOLLM_ARCH: smollm}

    def shapes(kernel, direction):
        """The flash rows at phase 9's train shapes."""
        out = {}
        for arch, run in phase9.items():
            row = flash_train[arch][direction]
            out[arch] = {
                "shape": list(FLASH_TRAIN_SHAPES[arch][:6]),
                "launches": run["launches"][kernel],
                "max_abs_err": flash_train_err[arch][direction],
                "ms": row["ms"], "in_step_ms": run["step"]["inside"][kernel],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}
            if direction == "bwd":
                out[arch]["passes_ms"] = row["ms_passes"]
        return out

    print(json.dumps({"paper_rows": paper_rows}, allow_nan=False))
    print(json.dumps({"autotune": autotune_row, "mixtral_train": mix,
                      "deepseek": deepseek}, allow_nan=False))
    print(json.dumps({"gemma": gemma}, allow_nan=False))
    print(json.dumps({"vision_musicgen": new_models}, allow_nan=False))
    print(json.dumps({"softcap": softcap, "launcher_mesh": launcher_mesh,
                      "dryrun": dryrun_rows, "split_kv": split_kv},
                     allow_nan=False))

    def flash_row(direction, row, shape, extra, launches, err):
        """One flash row at head dim 128 or 256: shape, launches, error
        and times, with ``simt``'s (and its passes) as the previous
        design's."""
        if direction == "bwd":
            extra = dict(extra, passes_ms=row["ms_passes"],
                         previous_passes_ms=row["simt_ms_passes"])
        return {"shape": shape, **extra, "launches": launches,
                "max_abs_err": err,
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "library_kernel")},
                "previous_ms": row["simt_ms"]}

    def d256_rows(direction):
        """The flash rows at head dim 256: each train shape's launches in
        phase 12c's loop (its attention kind's share; recurrentgemma's loop
        runs batch 2, the row's shape batch 1), each decode shape's in
        12d's serve loop."""
        kind_of = {"global": "attn", "local": "attn_local"}
        cases = dict(FLASH_D256)
        if direction == "fwd":
            cases.update(D256_DECODE)
        out = {}
        for what, case in cases.items():
            arch, *rest = what.split()
            kind = kind_of.get(rest[0] if rest else "", "attn_local")
            if isinstance(case, dict):
                run = gemma[arch]["serve"]
                launches = run["steps"] * run["kinds"].get(kind, 0)
                shape = [case[n] for n in ("b", "hq", "hkv", "sq", "skv",
                                           "d")]
                extra = {"kv_len": list(case["kv_len"])}
            else:
                run = gemma[arch]["train"]
                launches = ((2 if direction == "fwd" else 1) * GEMMA_STEPS
                            * run["kinds"].get(kind, 0))
                shape, extra = list(case[:6]), {"window": case[7]}
            out[what] = flash_row(direction, d256_times[what][direction],
                                  shape, extra, launches,
                                  d256_err[what][direction])
        return out

    def d128_rows(direction):
        """The flash rows at mixtral's train shape: launches in phase
        11b's AdamW steps (the last step's count, which every step
        matched, times the steps) and in phase 13a's train steps, whose
        self-attention layers run the same shape."""
        kernel = ("flash_attention" if direction == "fwd"
                  else "flash_attention_bwd")
        by = {"mixtral-8x7b 11b": MIX_STEPS * mix["launches"][kernel],
              f"{VISION_ARCH} 13a": new_models[VISION_ARCH]["train"][
                  "self_launches"][direction]}
        return {arch: flash_row(direction, mix_flash_times[arch][direction],
                                list(case[:6]), {"launches_by": by},
                                sum(by.values()),
                                mix_flash_err[arch][direction])
                for arch, case in FLASH_MIXTRAL.items()}

    def new_rows(direction):
        """The flash rows at phase 13's shapes: vision's cross train shape
        with the cross launches of 13a's train steps and its decode shape
        with those of 13a's decode loop (each counted by its mask,
        ``flash_by_mask``); musicgen's train shape with 13b's launcher
        loop's launches and its decode shape with 13b's decode loop's."""
        vision, music = new_models[VISION_ARCH], new_models[MUSIC_ARCH]
        kernel = ("flash_attention" if direction == "fwd"
                  else "flash_attention_bwd")
        launches = {
            "llama-3.2-vision-11b cross":
                vision["train"]["cross_launches"][direction],
            "musicgen-large": music["train"]["launches"][kernel],
            "llama-3.2-vision-11b cross decode":
                vision["decode"]["cross_launches"],
            "musicgen-large decode": music["decode"]["launches"]}
        cases = dict(FLASH_NEW)
        if direction == "fwd":
            cases.update(NEW_DECODE)
        out = {}
        for what, case in cases.items():
            if isinstance(case, dict):
                shape = [case[n] for n in ("b", "hq", "hkv", "sq", "skv",
                                           "d")]
                extra = {"kv_len": None if case["kv_len"] is None
                         else list(case["kv_len"]),
                         "causal": case.get("causal", True)}
            else:
                shape, extra = list(case[:6]), {"causal": case[6]}
            out[what] = flash_row(direction, new_flash_times[what][direction],
                                  shape, extra, launches[what],
                                  new_flash_err[what][direction])
        return out

    def softcap_rows(direction):
        """The capped flash rows: gemma3-1b's train shapes with phase
        14b's launches of their attention kind, its global decode shape
        with 14c's; the error is phase 2's largest at ``SOFTCAP_CHECK``
        (bf16, planned variants)."""
        kind_of = {"gemma3-1b global": "attn", SOFTCAP_DECODE: "attn"}
        err = max(e[direction] for e in softcap_err.values()
                  if direction in e)
        out = {}
        for what, dirs in softcap_times_.items():
            if direction not in dirs:
                continue
            row = dirs[direction]
            if what == SOFTCAP_DECODE:
                run = softcap["serve"]
                launches = run["steps"] * run["kinds"].get("attn", 0)
                shape = [D256_DECODE[what][n] for n in ("b", "hq", "hkv",
                                                        "sq", "skv", "d")]
            else:
                run = softcap["train"]
                launches = ((2 if direction == "fwd" else 1) * GEMMA_STEPS
                            * run["kinds"].get(kind_of[what], 0))
                shape = list(SOFTCAP_TIMED[what][:6])
            out[what] = {"shape": shape, "softcap": SOFTCAP,
                         "launches": launches, "max_abs_err": err,
                         **{k: row[k] for k in (
                             "ms", "uncapped_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}}
        return out

    def gemm_shape_rows(launches_by, bwd):
        """The phase-11 rows of the forward (``bwd`` False) or backward,
        each shape's share of its run's launches."""
        out = {}
        for what, shape in GEMM_TRAIN.items():
            key = f"{what} bwd" if bwd else what
            if key not in gemm_rows:
                continue
            row = gemm_rows[key]
            out[key] = {
                "shape": list(shape), "launches": round(
                    launches_by[what.rsplit(" ", 1)[0]]
                    * GEMM_SHARE[what.rsplit(" ", 1)[1]]),
                "max_abs_err": gemm_bwd_errs[what] if bwd
                else gemm_errs["bfloat16", shape],
                **{k: row[k] for k in ("ms", "simt_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")
                   + (("previous_ms", "copies_ms") if bwd else ())}}
        return out

    tb_mix = gemm_rows["mixtral train wi bwd"]
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
        "admission_launches": surface["qwen"]["launches"],
        "train_launches": qwen_train["launches"]["flash_attention"],
        "train_max_abs_err": flash_train_err[ARCH]["fwd"],
        "train_ms": tf["ms"], "train_in_step_ms":
            qwen_train["inside"]["flash_attention"],
        "train_plain_ms": tf["plain_ms"], "train_bound_ms": tf["bound_ms"],
        "train_bound_by": tf["bound_by"],
        "train_library_ms": tf["library_ms"],
        "train_shapes": shapes("flash_attention", "fwd"),
        "d256_shapes": d256_rows("fwd"), "d128_shapes": d128_rows("fwd"),
        "vision_musicgen_shapes": new_rows("fwd"),
        "softcap_shapes": softcap_rows("fwd")}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "variant": ran_variant(qwen_train["variants"]),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "note": ("no TPU counterpart: the JAX package differentiates "
                 "_sdpa / _sdpa_blocked (src/repro/models/layers.py:96-172) "
                 "through XLA"),
        "launches": qwen_train["launches"]["flash_attention_bwd"],
        "max_abs_err": flash_train_err[ARCH]["bwd"], "ms": tb["ms"],
        "passes_ms": tb["ms_passes"],
        "in_step_ms": qwen_train["inside"]["flash_attention_bwd"],
        "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "previous_ms": tb["mma_ms"],
        "previous_passes_ms": tb["mma_ms_passes"],
        "simt_ms": tb["simt_ms"],
        "train_shapes": shapes("flash_attention_bwd", "bwd"),
        "d256_shapes": d256_rows("bwd"), "d128_shapes": d128_rows("bwd"),
        "vision_musicgen_shapes": new_rows("bwd"),
        "softcap_shapes": softcap_rows("bwd")}, {
        "name": "moe_gemm", "route": "cuda",
        "variant": ran_variant(moe_variants["moe_gemm"]),
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:41",
        "launches": moe_launches["moe_gemm"],
        "max_abs_err": gemm_errs["bfloat16", GEMM_DECODE["wi"]],
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "previous_ms": g["simt_ms"],
        "train_launches": mix["launches"]["moe_gemm"],
        "shapes": gemm_shape_rows({
            "mixtral train": mix["launches"]["moe_gemm"],
            "deepseek decode": deepseek["serve_launches"],
            "deepseek train": deepseek["train_launches"]["moe_gemm"]},
            bwd=False)}, {
        "name": "moe_gemm_bwd", "route": "cuda",
        "variant": ran_variant(mix["variants"]["moe_gemm_bwd"]),
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:41",
        "note": ("no TPU counterpart: the JAX package differentiates the "
                 "expert einsums (src/repro/models/moe.py:107-110) through "
                 "XLA; dX and dW are two launches of the kernel's DX and DW "
                 "layouts, reading w, x and dY in place"),
        "launches": mix["launches"]["moe_gemm_bwd"],
        "max_abs_err": gemm_bwd_errs["mixtral train wi"],
        "ms": tb_mix["ms"], "plain_ms": tb_mix["plain_ms"],
        "bound_ms": tb_mix["bound_ms"], "bound_by": tb_mix["bound_by"],
        "library_ms": tb_mix["library_ms"],
        "previous_ms": tb_mix["previous_ms"], "simt_ms": tb_mix["simt_ms"],
        "copies_ms": tb_mix["copies_ms"],
        "shapes": gemm_shape_rows({
            "mixtral train": mix["launches"]["moe_gemm_bwd"],
            "deepseek train": deepseek["train_launches"]["moe_gemm_bwd"]},
            bwd=True)}, {
        "name": "flash_attention_lse", "route": "cuda",
        "variant": ran_variant({v_: sum(r["variants"][v_]
                                        for r in split_kv.values())
                                for v_ in ("simt", "wgmma")}),
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "note": ("the forward kernel's decode writing each row's LSE, its "
                 "keys split over blocks (the combine writes the merged "
                 "row statistics): one call a shard of a sequence-sharded "
                 "KV cache, merged by ops.merge_attention; the reference "
                 "lets XLA partition _sdpa over the sharded keys"),
        "shape": [SPLIT_LSE[SPLIT_LSE_TIMED][n] for n in (
            "b", "hq", "hkv", "sq", "skv", "d")],
        "kv_len": list(SPLIT_LSE[SPLIT_LSE_TIMED]["kv_len"]),
        "launches": sum(r["launches"] for r in split_kv.values()),
        "max_abs_err": split_lse_err[SPLIT_LSE_TIMED],
        **{k_: split_lse_row[k_] for k_ in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "unsplit_ms", "simt_ms")}}] + [{
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
