#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero before the last line is printed:

1. The card's name and power limit; TF32 off; every kernel under
   ``src/repro_torch/kernels/csrc/`` built from source, all in parallel.
2. Each kernel against its plain PyTorch version on the card: the JAX
   package's kernel-test sweep in f32 and bf16, the serve path's decode
   shape with mixed ``kv_len``, and one prefill-sized shape.
3. The serve path at full width: qwen2-0.5b with seeded random weights,
   8 requests over 4 slots, 16 tokens each, ``--capture``.  Kernel launch
   counts are reset just before and read just after.  Then the smoke
   config served on the card and on the CPU gives the same tokens.
4. Path parity: one full-width decode step through the kernel and through
   the plain version, on the same parameters, cache and tokens.
5. Times of each kernel, its plain version and the PyTorch library call at
   the decode and prefill shapes, beside the least time the card could take:
   device time per call from the profiler (the kernels' own time, which the
   kernel table reports) and wall time per call from CUDA events around
   back-to-back calls (host dispatch included).  Then one full-width decode
   step, wall and device-busy time, through the kernel and the plain version.

Then one JSON line per kernel table, the card line, and
``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

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
# Kernel against plain version: f32 differs only in summation order; bf16
# adds one rounding of the output (the JAX package's kernel tolerances).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
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
    flops = 4 * hq * d * pairs
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextmanager
def plain_attention(ops, ref):
    """Route the model's attention to the plain version, CUDA tensors too."""
    kernel = ops.flash_attention
    ops.flash_attention = ref.flash_reference
    try:
        yield
    finally:
        ops.flash_attention = kernel


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.core.graph import Log
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import TORCH_DTYPES, tree_map

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

    # -- 3. serve at full width ----------------------------------------------
    cfg = configs.get(ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        args = serve.parse_args([
            "--arch", ARCH, "--requests", "8", "--slots", "4", "--gen", "16",
            "--max-len", "128", "--capture", f"{tmp}/serve.log"])
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        flash_attention.launches = 0
        res = serve.serve_loop(cfg, params, args)
        launches = flash_attention.launches
        log = Log.loads(Path(args.capture).read_text())
    tokens = sum(len(t) for t in res.completed.values())
    print(f"phase 3: served {len(res.completed)}/8 requests, {res.steps} "
          f"decode steps, {res.seconds * 1e3 / res.steps:.3f} ms/step, "
          f"{tokens / res.seconds:.1f} tokens/s, flash_attention "
          f"launches={launches}, captured {log.op_count()} ops")
    require(len(res.completed) == 8, f"completed {sorted(res.completed)}")
    require(all(len(t) == 16 and all(0 <= x < cfg.vocab for x in t)
                for t in res.completed.values()), f"tokens {res.completed}")
    require(launches == res.steps * cfg.n_layers,
            f"{launches} launches for {res.steps} steps x {cfg.n_layers}")
    require(0 < log.op_count() == res.log.op_count(), "captured log")

    smoke = configs.get_smoke(ARCH)
    small = serve.parse_args(["--arch", ARCH, "--smoke", "--requests", "6",
                              "--slots", "2", "--gen", "8"])
    cpu_params = M.init_params(smoke, torch.Generator().manual_seed(0))
    on_cpu = serve.serve_loop(smoke, cpu_params, small).completed
    on_card = serve.serve_loop(smoke, tree_map(lambda t: t.cuda(),
                                                cpu_params), small).completed
    print(f"  smoke config, card against CPU: {on_card == on_cpu}")
    require(on_card == on_cpu, f"card {on_card} cpu {on_cpu}")

    # -- 4. path parity ------------------------------------------------------
    base = {n: torch.randn(c.shape, generator=gen, device="cuda")
            for n, c in M.init_cache(cfg, 4, 128, "cuda")["groups"]["slot0"]
            ["attn"].items()}
    tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor([3, 40, 90, 127], dtype=torch.int32, device="cuda")

    def step_logits(dtype, plain):
        c = cfg.replace(dtype=dtype)
        cache = {"groups": {"slot0": {"attn": {
            n: t.to(TORCH_DTYPES[dtype]) for n, t in base.items()}}}}
        with torch.inference_mode(), (plain_attention(ops, ref) if plain
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
    print(f"phase 4: full-width decode step, kernel vs plain: "
          f"f32 max|d|={d32!r} (limit {PARITY_F32} x max|logits|="
          f"{scale!r}); bf16 max|d|={d16!r} (limit: the plain path's own "
          f"bf16-vs-f32 max|d|={noise!r}); bf16 argmax agreement "
          f"{agree:.2f}")
    require(d32 <= PARITY_F32 * scale, f"f32 parity {d32} > {PARITY_F32} x "
            f"{scale}")
    require(d16 <= noise, f"bf16 parity {d16} > bf16 rounding noise {noise}")

    # -- 5. times --------------------------------------------------------------
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
        row = {}
        for name, fn in (("ms", lambda: flash_attention(*args_, **kw)),
                         ("plain_ms",
                          lambda: ref.flash_reference(*args_, **kw)),
                         ("library_ms", lib)):
            row[name] = device_ms(torch, fn, iters)
            require(row[name] is not None, f"profiler device time, {name}")
            row[name.replace("ms", "wall_ms")] = event_ms(torch, fn, iters)
        shape = DECODE if what == "decode" else PREFILL
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            shape, True, 2, "bfloat16")
        times[what] = row
        print(f"phase 5: {what} {shape} bf16: " + ", ".join(
            f"{k}={v!r}" for k, v in row.items()) + f" [{card}]")
    print(f"  prefill kernel max_abs_err={prefill_err!r}")

    prepared = M.prepare_params(cfg, params)
    for plain in (False, True):
        cache = {"groups": {"slot0": {"attn": {
            n: t.to(torch.bfloat16) for n, t in base.items()}}}}

        def run():
            with torch.inference_mode():
                M.decode_step(cfg, prepared, tok, cache, pos)

        with plain_attention(ops, ref) if plain else nullcontext():
            step_ms = event_ms(torch, run, 20)
            busy_ms = device_ms(torch, run, 5)
        print(f"phase 5: full-width decode step, bf16, 4 slots, "
              f"{'plain' if plain else 'kernel'} path: {step_ms!r} ms, "
              f"device busy {busy_ms!r} ms [{card}]")

    d = times["decode"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": launches, "max_abs_err": decode_err,
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"]}]},
        allow_nan=False))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
