"""MoE grouped GEMM: the wrapper over the hand-written Hopper kernel.

The kernel (``csrc/moe_gemm.cu``) replaces the Pallas TPU kernel
``repro.kernels.moe_gemm.moe_grouped_gemm``: one matrix product per expert,
x ``[E,C,d]`` @ w ``[E,d,F]`` -> ``[E,C,F]``, f32 products and accumulation,
the result in x's dtype.  Unlike the Pallas version it takes any positive E,
C, d and F.  A tensor on the CPU goes to the plain version
(``ref.moe_gemm_reference``); a CUDA tensor launches the kernel variant that
:func:`plan` names, or raises.  ``moe_gemm.launches`` counts kernel
launches, ``moe_gemm.variant_launches`` the launches of each variant.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import moe_gemm_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "wgmma": 1}
# x, w, out; E, C, d, F, dtype, variant, block_c; stream
_SIGNATURES = {"moe_gemm_fwd": (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    ctypes.c_int)}


def plan(e: int, c: int, d: int, f: int, dtype: torch.dtype,
         aligned: bool = True) -> dict:
    """The kernel variant and tiles for one call, from its shape alone.

    bf16 goes to ``wgmma`` where TMA can load it: d and F multiples of 8
    (16-byte row strides) and 16-byte-aligned bases (``aligned``).  A
    block there owns 128 F rows by ``block_c`` C columns, the narrowest of
    32, 64 or 128 that holds C (decode's C = 32 in one), over d in steps of
    64.  Everything else (f32, whose product the tensor cores would round
    to TF32, and bf16 shapes TMA refuses) goes to ``simt``: 32 or 64 C rows
    by 64 F columns over d in steps of 32.
    """
    if dtype == torch.bfloat16 and aligned and d % 8 == 0 and f % 8 == 0:
        block_c = 32 if c <= 32 else 64 if c <= 64 else 128
        return {"variant": "wgmma", "block_f": 128, "block_c": block_c,
                "block_d": 64}
    return {"variant": "simt", "block_f": 64,
            "block_c": 32 if c <= 32 else 64, "block_d": 32}


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"want x [E,C,d] and w [E,d,F], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    e, c, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} differ "
                         f"in experts or contraction")
    if min(e, c, d, w.shape[2]) == 0:
        raise ValueError("empty grouped GEMM")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"want float32 or bfloat16 x/w of one dtype, got "
                        f"{x.dtype}, {w.dtype}")
    if x.requires_grad or w.requires_grad:
        raise RuntimeError("moe_gemm has no backward kernel yet; call it "
                           "under torch.no_grad()")


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, d]; w: [E, d, F] -> [E, C, F] in x's dtype."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return moe_gemm_reference(x, w)
    if x.device != w.device or x.device.type != "cuda":
        raise ValueError(f"x and w must lie on one CUDA device, got "
                         f"{x.device}, {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous x and w")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    p = plan(e, c, d, f, x.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, w, out)))
    lib = _build.load("moe_gemm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gemm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                               e, c, d, f, _DTYPES[x.dtype],
                               VARIANTS[p["variant"]], p["block_c"], stream)
    _build.check(lib, err, f"moe_gemm launch ({p['variant']})")
    moe_gemm.launches += 1
    moe_gemm.variant_launches[p["variant"]] += 1
    return out


moe_gemm.launches = 0
moe_gemm.variant_launches = dict.fromkeys(VARIANTS, 0)
