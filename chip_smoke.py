#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero before the last line is printed:

1. The card's name and power limit; TF32 off; every kernel under
   ``src/repro_torch/kernels/csrc/`` built from source, all in parallel.
2. Each kernel against its plain PyTorch version on the card.  Flash
   attention: the JAX package's kernel-test sweep in f32 and bf16, the
   serve path's decode shape with mixed ``kv_len``, and one prefill-sized
   shape.  The MoE grouped GEMM: the JAX package's kernel-test sweep and
   ragged shapes in f32 and bf16, mixtral's decode shapes and a prefill
   shape.
3. Each serve path at full width, with seeded random weights, 8 requests
   over 4 slots, 16 tokens each, ``--capture``: qwen2-0.5b (24 layers),
   then mixtral-8x7b with its depth cut to 4 layers (the 32-layer model
   does not fit one card).  Kernel launch counts are reset just before
   each path and read just after.  Then each smoke config served on the
   card and on the CPU gives the same tokens.
4. Path parity, per model: one full-width decode step through the kernels
   and through the plain versions, on the same parameters, cache and tokens.
5. Times of each kernel, its plain version and the PyTorch library call at
   the decode and prefill shapes, beside the least time the card could take:
   device time per call from the profiler (the kernels' own time, which the
   kernel table reports) and wall time per call from CUDA events around
   back-to-back calls (host dispatch included).  Then, per model, one
   full-width decode step, wall and device-busy time, through the kernels
   and the plain versions.

The qwen2 phases run first and free their tensors before mixtral's 36 GB
(f32 weights and their bf16 copy) arrive.  Then one JSON line per kernel
table, the card line, and ``{"ok": true, "device": {...}}`` as the last
line.
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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
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


def require(cond, what) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
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
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    expect = plain(*args, **kw)
    err = (out.float() - expect.float()).abs().max().item()
    ok = torch.allclose(out.float(), expect.float(), rtol=tol, atol=tol)
    print(f"  {what}: max_abs_err={err!r} tol={tol} "
          f"{'ok' if ok else 'FAIL'}")
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


def device_ms(torch, fn, iters):
    """Device time of one call (kernels only, no launch gaps) from the
    profiler; None where it sees no device time.  Only the device's own
    events count: a CPU operator's entry repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
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
    kernels = ops.flash_attention, ops.moe_gemm
    ops.flash_attention = ref.flash_reference
    ops.moe_gemm = ref.moe_gemm_reference
    try:
        yield
    finally:
        ops.flash_attention, ops.moe_gemm = kernels


def reset_launches():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_gemm
    flash_attention.launches = 0
    moe_gemm.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_gemm
    return {"flash_attention": flash_attention.launches,
            "moe_gemm": moe_gemm.launches}


def time_row(torch, fns, iters, bound_ms_by, what, card):
    """Device and event time of each named call, beside the bound."""
    row = {}
    for name, fn in fns:
        row[name] = device_ms(torch, fn, iters)
        require(row[name] is not None, f"profiler device time, {name}")
        row[name.replace("ms", "wall_ms")] = event_ms(torch, fn, iters)
    row["bound_ms"], row["bound_by"] = bound_ms_by
    print(f"phase 5: {what}: " + ", ".join(
        f"{k}={v!r}" for k, v in row.items()) + f" [{card}]")
    return row


def model_phases(torch, arch, cfg, smoke_flags, card, gen) -> dict:
    """Phases 3-5 for one model at full width: serve, decode-step parity,
    decode-step times.  Returns the path's launch counts.  Every tensor it
    makes is freed when it returns."""
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
        log = Log.loads(Path(args.capture).read_text())
    tokens = sum(len(t) for t in res.completed.values())
    print(f"phase 3: {arch} ({cfg.n_layers} layers): served "
          f"{len(res.completed)}/8 requests, {res.steps} "
          f"decode steps, {res.seconds * 1e3 / res.steps:.3f} ms/step, "
          f"{tokens / res.seconds:.1f} tokens/s, flash_attention "
          f"launches={launches['flash_attention']}, moe_gemm "
          f"launches={launches['moe_gemm']}, captured {log.op_count()} ops, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
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
        with torch.inference_mode(), (plain_kernels(ops, ref) if plain
                                      else nullcontext()):
            logits, _ = M.decode_step(c, M.prepare_params(c, params), tok,
                                      cache, pos)
        torch.cuda.synchronize()
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
    for plain in (False, True):
        cache = cache_in(torch.bfloat16)

        def run():
            with torch.inference_mode():
                M.decode_step(cfg, prepared, tok, cache, pos)

        with plain_kernels(ops, ref) if plain else nullcontext():
            step_ms = event_ms(torch, run, 20)
            busy_ms = device_ms(torch, run, 5)
        print(f"phase 5: {arch} full-width decode step, bf16, 4 slots, "
              f"{'plain' if plain else 'kernel'} path: {step_ms!r} ms, "
              f"device busy {busy_ms!r} ms [{card}]")
    return launches


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

    # -- 3-5 for qwen2, then its flash-attention times -------------------------
    qwen_launches = model_phases(
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
                    ("plain_ms", lambda: ref.flash_reference(*args_, **kw)),
                    ("library_ms", lib)), iters,
            attention_bound_ms(shape, True, 2, "bfloat16"),
            f"{what} {shape} bf16", card)
    print(f"  prefill kernel max_abs_err={prefill_err!r}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3-5 for mixtral, then the grouped GEMM's times ----------------------
    torch.cuda.reset_peak_memory_stats()
    moe_launches = model_phases(
        torch, MOE_ARCH, configs.get(MOE_ARCH).replace(n_layers=MOE_LAYERS),
        ["--requests", "6", "--slots", "2", "--gen", "8", "--max-len", "32"],
        card, gen)
    gc.collect()
    torch.cuda.empty_cache()
    moe_keep = (torch.arange(MOE_ATTN_DECODE["skv"], device="cuda")[None, :]
                < moe_kv_len[:, None])[:, None, None, :]
    time_row(torch, (
        ("ms", lambda: flash_attention(*moe_attn_args, **moe_attn_kw)),
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
                    ("plain_ms", lambda: ref.moe_gemm_reference(x, w)),
                    ("library_ms", lambda: torch.bmm(x, w))), iters,
            gemm_bound_ms(shape, 2, "bfloat16"),
            f"moe_gemm {what} [{shape[0]},{shape[1]},{shape[2]}]@"
            f"[{shape[0]},{shape[2]},{shape[3]}] bf16", card)
        del x, w

    d = times["decode"]
    g = gemm_times["decode wi"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": qwen_launches["flash_attention"],
        "max_abs_err": decode_err,
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"]}, {
        "name": "moe_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:41",
        "launches": moe_launches["moe_gemm"],
        "max_abs_err": gemm_errs["bfloat16", GEMM_DECODE["wi"]],
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"]}]},
        allow_nan=False))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
