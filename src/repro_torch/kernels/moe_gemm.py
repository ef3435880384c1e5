"""MoE grouped GEMM: the wrapper over the hand-written Hopper kernel.

The kernel (``csrc/moe_gemm.cu``) replaces the Pallas TPU kernel
``repro.kernels.moe_gemm.moe_grouped_gemm``: one matrix product per expert,
x ``[E,C,d]`` @ w ``[E,d,F]`` -> ``[E,C,F]``, f32 products and accumulation,
the result in x's dtype.  Unlike the Pallas version it takes any positive E,
C, d and F.  A tensor on the CPU goes to the plain version
(``ref.moe_gemm_reference``, which autograd differentiates); a CUDA
tensor launches the kernel variant that :func:`plan` names, or raises.

Where x or w requires a gradient, the product is a ``torch.autograd.Function``
whose backward, :func:`moe_gemm_bwd`, is two more grouped GEMMs:
dX[e] = dY[e] @ w[e]^T (``[E,C,F]@[E,F,d]``) and dW[e] = x[e]^T @ dY[e]
(``[E,d,C]@[E,C,F]``).  On ``wgmma`` (bf16) the kernel reads w, x and dY
where they lie, each in its own layout (``csrc/moe_gemm.cu``'s ``DX`` and
``DW``); on ``simt`` (f32) the forward kernel runs on transposed
contiguous copies of w and x.  ``moe_gemm.launches`` and
``moe_gemm_bwd.launches`` count the forward's and the backward's kernel
launches, ``.variant_launches`` those of each variant.  The launches are
dispatcher ops (``repro_torch::moe_gemm_fwd``, ``::moe_gemm_bwd``) with
fake implementations, which the dry run traces.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import moe_gemm_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "wgmma": 1}
_SIGNATURES = {
    # x, w, out; E, C, d, F, dtype, variant, block_c; stream
    "moe_gemm_fwd": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p], ctypes.c_int),
    # x, w, dy, dx, dw; E, C, d, F, block_c, block_d; stream
    "moe_gemm_bwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p], ctypes.c_int)}


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


def plan_backward(e: int, c: int, d: int, f: int, dtype: torch.dtype,
                  aligned: bool = True) -> dict:
    """The backward's variant and tiles: bf16 on ``wgmma`` where TMA can
    read all three operands in place (d and F multiples of 8, 16-byte
    bases), dX in blocks of ``block_c`` C columns as the forward's, dW in
    blocks of ``block_d`` = 64 or 128 d columns; otherwise ``simt``, on
    transposed copies."""
    if dtype == torch.bfloat16 and aligned and d % 8 == 0 and f % 8 == 0:
        return {"variant": "wgmma",
                "block_c": plan(e, c, d, f, dtype)["block_c"],
                "block_d": 64 if d <= 64 else 128}
    return {"variant": "simt"}


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


def _on_card(*ts) -> bool:
    """True for CUDA tensors on one device, False for CPU tensors; raises
    for anything else."""
    if _build.plain(ts):
        return False
    if _build.sharded(ts[0]):
        return True
    if any(t.device != ts[0].device for t in ts) or \
            ts[0].device.type != "cuda":
        raise ValueError(f"the operands must lie on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    return True


def _launch(x, w, counter) -> torch.Tensor:
    """One kernel launch, out = x @ w per expert, counted on ``counter``."""
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
    counter.launches += 1
    counter.variant_launches[p["variant"]] += 1
    return out


class _MoeGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.ops.repro_torch.moe_gemm_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return moe_gemm_bwd(x, w, dy, need=ctx.needs_input_grad)


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, d]; w: [E, d, F] -> [E, C, F] in x's dtype."""
    _check(x, w)
    if not _on_card(x, w):
        return moe_gemm_reference(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MoeGemm.apply(x, w)
    return torch.ops.repro_torch.moe_gemm_fwd(x, w)


@torch.library.custom_op("repro_torch::moe_gemm_fwd", mutates_args=())
def _launch_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward launch, as a dispatcher op so that fake tensors (the
    dry run's) and DTensors reach it."""
    return _launch(x, w, moe_gemm)


@_launch_fwd.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:2], w.shape[2]))


def moe_gemm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 need=(True, True)):
    """The gradients of ``moe_gemm(x, w)`` against ``dy`` ``[E, C, F]``:
    ``(dx, dw)`` in the operands' dtype (None where ``need`` says no), f32
    accumulation.  On the card, one kernel launch each, the variant
    :func:`plan_backward` names; on the CPU the plain version's formula."""
    _check(x, w)
    if dy.shape != (*x.shape[:2], w.shape[2]) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"the product of {tuple(x.shape)} and "
                         f"{tuple(w.shape)} in {x.dtype}")
    if not _on_card(x, w, dy):
        return moe_gemm_bwd_reference(x, w, dy, need)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous x and w")
    dx, dw = torch.ops.repro_torch.moe_gemm_bwd(x, w, dy.contiguous(),
                                                bool(need[0]), bool(need[1]))
    return dx if need[0] else None, dw if need[1] else None


@torch.library.custom_op("repro_torch::moe_gemm_bwd", mutates_args=())
def _launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                need_dx: bool, need_dw: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward launches, as a dispatcher op (see ``_launch_fwd``); a
    gradient not needed comes back empty."""
    need = (need_dx, need_dw)
    e, c, d = x.shape
    f = w.shape[2]
    p = plan_backward(e, c, d, f, x.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, w, dy)))
    if p["variant"] == "simt":
        dx = _launch(dy, w.transpose(1, 2).contiguous(), moe_gemm_bwd) \
            if need[0] else None
        dw = _launch(x.transpose(1, 2).contiguous(), dy, moe_gemm_bwd) \
            if need[1] else None
        return _or_empty(dx, x), _or_empty(dw, w)
    # Fresh allocations: 16-byte aligned.
    dx = torch.empty_like(x) if need[0] else None
    dw = torch.empty_like(w) if need[1] else None
    lib = _build.load("moe_gemm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gemm_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            dx.data_ptr() if need[0] else None,
            dw.data_ptr() if need[1] else None,
            e, c, d, f, p["block_c"], p["block_d"], stream)
    _build.check(lib, err, "moe_gemm backward launch (wgmma)")
    moe_gemm_bwd.launches += sum(need)
    moe_gemm_bwd.variant_launches["wgmma"] += sum(need)
    return _or_empty(dx, x), _or_empty(dw, w)


def _or_empty(g, like):
    return like.new_empty(0) if g is None else g


@_launch_bwd.register_fake
def _(x, w, dy, need_dx, need_dw):
    return (torch.empty_like(x) if need_dx else x.new_empty(0),
            torch.empty_like(w) if need_dw else w.new_empty(0))


def moe_gemm_bwd_reference(x, w, dy, need=(True, True)):
    """The backward's plain version: both products in f32, each gradient
    in its operand's dtype."""
    dy32 = dy.float()
    dx = torch.einsum("ecf,edf->ecd", dy32, w.float()).to(x.dtype) \
        if need[0] else None
    dw = torch.einsum("ecd,ecf->edf", x.float(), dy32).to(w.dtype) \
        if need[1] else None
    return dx, dw


moe_gemm.launches = 0
moe_gemm.variant_launches = dict.fromkeys(VARIANTS, 0)
moe_gemm_bwd.launches = 0
moe_gemm_bwd.variant_launches = dict.fromkeys(VARIANTS, 0)
