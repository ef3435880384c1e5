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
   ``mma`` backward calls at the train shape give the same bits.
3. Each serve path at full width, with seeded random weights, 8 requests
   over 4 slots, 16 tokens each, ``--capture``: qwen2-0.5b (24 layers),
   then mixtral-8x7b with its depth cut to 4 layers (the 32-layer model
   does not fit one card).  Kernel launch counts, in all and per variant,
   are reset just before each path and read just after; every bf16 launch
   of phases 3-5 must go to the ``wgmma`` variants.  Then each smoke config
   served on the card and on the CPU gives the same tokens.
4. Path parity, per model: one full-width decode step through the kernels
   and through the plain versions, on the same parameters, cache and tokens.
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

The qwen2 phases run first and free their tensors before mixtral's 36 GB
(f32 weights and their bf16 copy) arrive; rwkv6 comes last.  Then one JSON
line per kernel table, the card line, and ``{"ok": true, "device": {...}}``
as the last line.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
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
# to the other side, and 24 layers of random weights amplify that (5.5% of
# max|logits| measured on an H100), so the bound there is the plain path's
# own bf16 error: its distance from the same step in f32.
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


def device_ms(torch, fn, iters, top=0, by_name=None):
    """Device time of one call (kernels only, no launch gaps) from the
    profiler; None where it sees no device time.  Only the device's own
    events count: a CPU operator's entry repeats its kernels' time.  With
    ``top``, also prints the ``top`` kernels by device time per call; a
    dict ``by_name`` receives each kernel's (ms per call, launches per
    call)."""
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
        if total_us > 0:
            break
        print(f"  profiler saw no device time (attempt {attempt + 1}); "
              f"profiling again")
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
    """Plan every flash, grouped-GEMM and WKV call onto its CUDA-core
    variant (the previous design), as for an unaligned input: the same
    kernels' time before this design, on the same inputs and card."""
    from repro_torch.kernels import flash_attention as fa, moe_gemm as mg
    from repro_torch.kernels import rwkv6_chunk as wkv
    mods = fa, mg, wkv
    plans = [m.plan for m in mods]
    for m, plan in zip(mods, plans):
        m.plan = lambda *a, plan=plan, **k: plan(*a, **dict(k, aligned=False))
    try:
        yield
    finally:
        for m, plan in zip(mods, plans):
            m.plan = plan


def _wrappers():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.rwkv6_chunk import rwkv6_bwd, rwkv6_fwd
    return {"flash_attention": flash_attention, "moe_gemm": moe_gemm,
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


def time_row(torch, fns, iters, bound_ms_by, what, card):
    """Device and event time of each named call, beside the bound.  A name
    that starts with ``simt`` is timed with its wrappers planned onto the
    CUDA-core variants."""
    row = {}
    for name, fn in fns:
        with simt_only() if name.startswith("simt") else nullcontext():
            row[name] = device_ms(torch, fn, iters)
            require(row[name] is not None, f"profiler device time, {name}")
            row[name.replace("ms", "wall_ms")] = event_ms(torch, fn, iters)
    row["bound_ms"], row["bound_by"] = bound_ms_by
    print(f"phase 5: {what}: " + ", ".join(
        f"{k}={v!r}" for k, v in row.items()) + f" [{card}]")
    return row


def model_phases(torch, arch, cfg, smoke_flags, card, gen) -> dict:
    """Phases 3-5 for one model at full width: serve, decode-step parity,
    decode-step times.  Returns the serve path's launch counts, in all and
    per variant.  Every tensor it makes is freed when it returns."""
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
    return launches, variants


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
    qwen_launches, qwen_variants = model_phases(
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
    moe_launches, moe_variants = model_phases(
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

    # -- 6 and 5 for rwkv6 -------------------------------------------------
    wkv = rwkv_train_phases(torch, card, gen)

    d = times["decode"]
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
        "previous_ms": d["simt_ms"]}, {
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
