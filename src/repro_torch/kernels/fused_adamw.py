"""Gradient clipping and AdamW in one in-place pass over every leaf on the
card: the wrapper over the hand-written kernel ``csrc/fused_adamw.cu``.

It replaces no TPU kernel (the JAX package leaves the clip and the update to
XLA).  The plain version is the per-leaf path of ``optim.optimizers``:
``clip_by_global_norm``, then ``adamw``'s ``update``, then
``apply_updates``, about fourteen elementwise kernels a leaf with a clipped
copy of every gradient and an ``updates`` tree.  Here a step is two
launches over a table of the leaves (:class:`LeafTable`):

- :func:`fused_norm`: the global norm of the gradients and the clip scale
  ``min(1, max_norm / (norm + 1e-9))``, both left on the card;
- :func:`fused_adamw`: for each element, the scale, p, g, m and v read once
  and p, m and v written in place, each op rounded as the per-leaf path
  rounds it, so that given one scale p, m and v are bit for bit the per-leaf
  path's.  Nothing the size of a leaf is allocated.

The pass takes a tree whose every leaf :func:`takes` (f32, contiguous, on
one card, not a shard of the mesh); ``optim.optimizers.adamw`` sends any
other tree whole to the per-leaf path.  ``fused_adamw.launches`` counts
both kernels' launches (two a step), ``.leaves`` the leaves the update
launches wrote, ``.fallback_leaves`` the AdamW leaves on a card that took
the per-leaf path instead.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# Elements of one leaf a block takes at a time (the kernel's CHUNK).
CHUNK = 1 << 16
# The norm's persistent grid is at most this many blocks (its workspace).
MAX_BLOCKS = 2048
_SIGNATURES = {
    # table, n_leaves, n_chunks, workspace, max_norm, out, max_blocks; stream
    "fused_adamw_norm": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    # table, n_leaves, n_chunks, scale; b1, 1 - b1, b2, 1 - b2, 1 / bc1,
    # 1 / bc2, eps, weight decay, -lr; stream
    "fused_adamw_update": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_void_p] + [ctypes.c_float] * 9
                           + [ctypes.c_void_p], ctypes.c_int)}


def takes(p, g, m, v) -> bool:
    """Whether the kernel updates this leaf: parameter, gradient and both
    moments f32 and contiguous, of one size, on one CUDA device, none a
    shard of the mesh (a DTensor's op, not the kernel, places it)."""
    ts = (p, g, m, v)
    return (not any(_build.sharded(t) for t in ts)
            and all(t.device.type == "cuda" and t.device == p.device
                    and t.dtype == torch.float32 and t.is_contiguous()
                    and t.numel() == p.numel() for t in ts))


class LeafTable:
    """The leaves of one optimizer's fused pass as the kernels read them:
    one row ``(p, g, m, v, n, first chunk)`` of 64-bit words a leaf, on
    the card, made on the host and copied over at every :meth:`bind` (a
    gradient may land at another address each step).  Also holds the
    norm's workspace: ``MAX_BLOCKS`` partial sums and a counter."""

    def __init__(self):
        self.table = None
        self.workspace = None
        self.n_leaves = self.n_chunks = 0

    def bind(self, leaves) -> "LeafTable":
        """Point the table at ``leaves``, ``(p, g, m, v)`` tuples that each
        :func:`takes`."""
        chunks = [-(-q[0].numel() // CHUNK) for q in leaves]
        first = np.cumsum([0] + chunks[:-1])
        rows = np.array([[t.data_ptr() for t in q] + [q[0].numel(), c0]
                         for q, c0 in zip(leaves, first)], dtype=np.uint64)
        device = leaves[0][0].device
        if self.workspace is None or self.workspace.device != device:
            self.workspace = torch.zeros(MAX_BLOCKS + 1, dtype=torch.float64,
                                         device=device)
        host = torch.from_numpy(rows.view(np.int64)).pin_memory()
        self.table = host.to(device, non_blocking=True)
        self.n_leaves, self.n_chunks = len(leaves), int(sum(chunks))
        return self


def fused_norm(table: LeafTable, max_norm: float) -> torch.Tensor:
    """One launch: ``[norm, scale]`` (f32, on the card) of the gradients in
    ``table``, the norm's squares in f32 and their sum in f64."""
    out = torch.empty(2, dtype=torch.float32, device=table.table.device)
    lib = _build.load("fused_adamw", _SIGNATURES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.fused_adamw_norm(
            table.table.data_ptr(), table.n_leaves, table.n_chunks,
            table.workspace.data_ptr(), max_norm, out.data_ptr(), MAX_BLOCKS,
            stream)
    _build.check(lib, err, "fused_adamw norm launch")
    fused_adamw.launches += 1
    return out


def fused_adamw(table: LeafTable, scale: torch.Tensor, *, lr_t: float,
                b1: float, b2: float, eps: float, weight_decay: float,
                bc1: float, bc2: float) -> None:
    """One launch: AdamW on every leaf of ``table``, in place, its
    gradients first scaled by ``scale`` (a 0-dim f32 on the card, read
    there).  Every scalar reaches the kernel as PyTorch's kernels take a
    Python scalar: cast to f32, a division by ``bc`` as a product with
    ``1 / f32(bc)``."""
    f32 = np.float32
    lib = _build.load("fused_adamw", _SIGNATURES)
    with torch.cuda.device(scale.device):
        stream = torch.cuda.current_stream(scale.device).cuda_stream
        err = lib.fused_adamw_update(
            table.table.data_ptr(), table.n_leaves, table.n_chunks,
            scale.data_ptr(), b1, 1 - b1, b2, 1 - b2,
            float(f32(1) / f32(bc1)), float(f32(1) / f32(bc2)), eps,
            weight_decay, -lr_t, stream)
    _build.check(lib, err, "fused_adamw update launch")
    fused_adamw.launches += 1
    fused_adamw.leaves += table.n_leaves


fused_adamw.launches = 0
fused_adamw.leaves = 0
fused_adamw.fallback_leaves = 0
