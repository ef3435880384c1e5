"""DTensor sharding strategies of the kernels' dispatcher ops.

The flash attention, grouped GEMM and WKV6 launches are custom ops
(``repro_torch::flash_fwd`` and the rest, each with a fake implementation).
DTensors reach the flash ops: DTensor then needs to know which input
placements each op takes and what its outputs are.  Each strategy below is
one mesh dim's choice; DTensor combines them over the mesh's dims and
redistributes the inputs (an all-gather the collective count sees) when
they come in otherwise.

- flash forward and backward: replicated, or sharded alike over the batch
  (dim 0) or over the heads (dim 1) of q, k, v (and o, lse, dO), which
  keeps each query head with its kv head.  Keys split over devices take
  no strategy here, since their outputs merge by their LSE, not by a sum:
  a decode step over a sequence-sharded KV cache runs
  ``kernels/ops.py::split_kv_attention``, where each device's flash call
  gets its own keys as plain local tensors (``local_map``) and the shards'
  outputs merge by log-sum-exp in DTensor ops (``merge_attention``).

The grouped GEMM and WKV6 take no DTensor: under a mesh the MoE layer and
the RWKV6 recurrence run on each device's shards (``local_map``), where
their ops get plain local tensors.

It also gives ``FlopCounterMode``'s registry a formula for each op, which
it lacks for a custom op: attention 4 D FLOPs a visible (query, key) pair
and query head forward and 10 D backward (S and P.V; S, dP, dV, dK, dQ),
the grouped GEMM 2 E C d F a product, WKV6 4 D^2 a step and head forward
and twice that backward.

:func:`register` is called by the dry run; importing this module registers
nothing.
"""
from __future__ import annotations

_DONE: list = []


def register() -> None:
    """Register every strategy once."""
    if _DONE:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    # Importing the kernel modules defines their ops.
    from ..kernels import flash_attention, moe_gemm, rwkv6_chunk  # noqa: F401
    ops = torch.ops.repro_torch
    R = Replicate()

    @register_sharding(ops.flash_fwd.default)
    def _(q, k, v, kv_len, causal, window, softcap, save_lse, for_merge):
        def case(p):
            kv = None if kv_len is None else (R if p == Shard(1) else p)
            return [p, p], [p, p, p, kv] + [None] * 5
        return [case(p) for p in (R, Shard(0), Shard(1))]

    @register_sharding(ops.flash_bwd.default)
    def _(q, k, v, o, lse, do, causal, window, softcap):
        return [([p] * 3, [p] * 6 + [None] * 3)
                for p in (R, Shard(0), Shard(1))]

    from torch.utils.flop_counter import register_flop_formula

    def pairs(sq, skv, causal, window):
        """Visible (query, key) pairs of one head (query i at key i +
        skv - sq)."""
        if not causal:
            return sq * skv
        offs = skv - sq
        n = 0
        for i in range(sq):
            hi = min(skv, i + offs + 1)
            lo = max(0, i + offs - window + 1) if window > 0 else 0
            n += max(0, hi - lo)
        return n

    @register_flop_formula(ops.flash_fwd)
    def _(q, k, v, kv_len, causal, window, softcap, save_lse, *a,
          out_shape=None, **kw):
        b, hq, sq, d = q
        return 4 * d * b * hq * pairs(sq, k[2], causal, window)

    @register_flop_formula(ops.flash_bwd)
    def _(q, k, v, o, lse, do, causal, window, softcap, *a, out_shape=None,
          **kw):
        b, hq, sq, d = q
        return 10 * d * b * hq * pairs(sq, k[2], causal, window)

    @register_flop_formula(ops.moe_gemm_fwd)
    def _(x, w, *a, out_shape=None, **kw):
        e, c, d = x
        return 2 * e * c * d * w[2]

    @register_flop_formula(ops.moe_gemm_bwd)
    def _(x, w, dy, need_dx, need_dw, *a, out_shape=None, **kw):
        e, c, d = x
        return 2 * e * c * d * w[2] * (int(need_dx) + int(need_dw))

    @register_flop_formula(ops.rwkv6_fwd)
    def _(r, k, v, w_log, u, *a, out_shape=None, **kw):
        bh, s, d = r
        return 4 * bh * s * d * d

    @register_flop_formula(ops.rwkv6_bwd)
    def _(r, k, v, w_log, u, g, *a, out_shape=None, **kw):
        bh, s, d = r
        return 8 * bh * s * d * d

    _DONE.append(True)
