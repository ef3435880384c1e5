"""The flash-attention backward: the port's plain backward
(``ref.flash_backward_reference``, step by step from the forward's output
and row log-sum-exp) and autograd through its plain forward, against
``jax.vjp`` of the JAX package's ``kernels/ref.flash_reference``; the
forward's LSE against a float64 log-sum-exp; each backward variant's tile
schedule (``plan_backward``, ``backward_schedule``, ``bwd_query_range``,
``bwd_key_range``; for ``wgmma`` the dK/dV work split over the query heads
and the fixed-order sum of their partials) written out in plain PyTorch
against the plain backward; and the blocked
plain attention of long sequences against JAX.

All in f32 on the CPU.  Tolerance: each gradient within 1e-5 of its largest
magnitude (the two sides sum the same products in another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GRAD_REL = 1e-5
# (b, hq, hkv, sq, skv, d, causal, window): GQA 4/2 and 4/1, a window, Sq <
# Skv (bottom-right causal), no mask, lengths that are not multiples of 32.
CASES = [
    (2, 4, 2, 16, 16, 8, True, 0),
    (1, 4, 1, 24, 24, 16, True, 0),
    (1, 4, 2, 20, 20, 8, True, 5),
    (2, 4, 1, 12, 40, 16, True, 0),
    (1, 4, 2, 9, 30, 8, True, 7),
    (1, 4, 2, 16, 24, 8, False, 0),
]
IDS = [f"b{c[0]}-{c[1]}/{c[2]}-{c[3]}x{c[4]}-d{c[5]}-"
       f"{'causal' if c[6] else 'full'}-w{c[7]}" for c in CASES]


def _inputs(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hq, sq, d), dtype=np.float32))


def _jax_grads(q, k, v, do, causal, window):
    def grads(q_, k_, v_, do_):
        _, vjp = jax.vjp(lambda *a: jref.flash_reference(
            *a, causal=causal, window=window), q_, k_, v_)
        return vjp(do_)

    return [np.asarray(g) for g in jax.jit(grads)(
        *map(jnp.asarray, (q, k, v, do)))]


def _assert_grads(got, want, what):
    for name, g, w in zip("qkv", got, want):
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g)
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (what, name, err)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(b, hq, hkv, sq, skv, d, causal,
                                        window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d)
    want = _jax_grads(q, k, v, do, causal, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_reference_lse(tq, tk, tv, causal=causal,
                                     window=window)
    _assert_grads(ref.flash_backward_reference(
        tq, tk, tv, o, lse, tdo, causal=causal, window=window), want,
        "step by step")
    # The wrapper on CPU tensors: autograd through the plain forward.
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.flash_attention(*xs, causal=causal, window=window)
    _assert_grads(torch.autograd.grad(out, xs, tdo), want, "autograd")
    # The backward wrapper on CPU tensors is the plain backward.
    _assert_grads(fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo,
                                         causal=causal, window=window),
                  want, "flash_attention_bwd")


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES, ids=IDS)
def test_lse_matches_float64(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v, _ = _inputs(b, hq, hkv, sq, skv, d, seed=1)
    _, lse = ref.flash_reference_lse(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window)
    g = hq // hkv
    s = np.einsum("bkgqd,bksd->bkgqs",
                  q.reshape(b, hkv, g, sq, d).astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(d)
    qpos = np.arange(sq)[:, None] + skv - sq
    kpos = np.arange(skv)[None, :]
    vis = np.ones((sq, skv), bool)
    if causal:
        vis = kpos <= qpos
        if window:
            vis &= qpos - kpos < window
    s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    np.testing.assert_allclose(lse.numpy(), want.reshape(b, hq, sq),
                               rtol=1e-6, atol=1e-6)


def _visible(i, j, sq, skv, causal, window):
    offs = skv - sq
    if not causal:
        return True
    return j <= i + offs and (window == 0 or i + offs - j < window)


def schedule_backward(q, k, v, o, lse, do, *, causal, window, variant):
    """``variant``'s tile schedule (``fa.backward_schedule``) in plain
    PyTorch (f32): the D pass, the dK/dV blocks walking the query tiles of
    ``bwd_query_range`` and the dQ blocks walking the key tiles of
    ``bwd_key_range``.  ``simt`` and ``mma``: a dK/dV block per (key tile,
    b, kv head) walks the G heads of its kv head, from the range's first
    row.  ``wgmma``: a dK/dV block per (b, q head, key tile) writes its
    head's partials, walking from the multiple of ``step`` at or below the
    range's first row, and a reduce pass sums the G heads of each kv head
    in head order; dQ blocks walk from the multiple of ``step`` at or below
    the first key, the last row tile first.  Also returns the (b, head,
    query, key) pairs each pass visits with a visible mask, as lists, so
    that a pair visited twice shows."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    p = fa.backward_schedule(variant, b, hq, hkv, sq, skv, d)
    assert p["dp"] >= d and p["split_heads"] == (variant == "wgmma")
    scale = 1.0 / math.sqrt(d)
    delta = (do * o).sum(-1)                              # [B,Hq,Sq]
    offs = skv - sq

    def tile(bi, h, kh, i0, nr, j0, nk):
        i = torch.arange(i0, i0 + nr)[:, None]
        j = torch.arange(j0, j0 + nk)[None, :]
        vis = torch.ones(nr, nk, dtype=torch.bool)
        if causal:
            vis = j <= i + offs
            if window:
                vis = vis & (i + offs - j < window)
        qs, dos = q[bi, h, i0:i0 + nr], do[bi, h, i0:i0 + nr]
        ks, vs = k[bi, kh, j0:j0 + nk], v[bi, kh, j0:j0 + nk]
        s = qs @ ks.T * scale
        pt = torch.where(vis, torch.exp(s - lse[bi, h, i0:i0 + nr, None]),
                         0.0)
        ds = pt * (dos @ vs.T - delta[bi, h, i0:i0 + nr, None])
        pairs = [(bi, h, i0 + int(a), j0 + int(c)) for a, c in
                 zip(*torch.nonzero(vis, as_tuple=True))]
        return pt, ds, qs, dos, ks, pairs

    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    seen_kv, seen_q = [], []
    keys, step = p["block"], p["step"]
    split = p["split_heads"]

    def first(lo):
        return lo // step * step if split else lo

    if split:
        bh, kv_tiles = p["grid_dkdv"]
        assert bh == b * hq
        part_k = torch.zeros(b, hq, skv, d)
        part_v = torch.zeros(b, hq, skv, d)
    else:
        kv_tiles, bk = p["grid_dkdv"]
        assert bk == b * hkv
    for kt in range(kv_tiles):
        j0 = kt * keys
        nk = min(keys, skv - j0)
        lo, hi = fa.bwd_query_range(j0, nk, sq, skv, causal, window)
        for bi in range(b):
            for h in range(hq):
                kh = h // group
                for i0 in range(first(lo), hi if hi > lo else 0, step):
                    nr = min(step, sq - i0)
                    pt, ds, qs, dos, _, pairs = tile(bi, h, kh, i0, nr, j0,
                                                     nk)
                    if split:
                        part_v[bi, h, j0:j0 + nk] += pt.T @ dos
                        part_k[bi, h, j0:j0 + nk] += ds.T @ qs
                    else:
                        dv[bi, kh, j0:j0 + nk] += pt.T @ dos
                        dk[bi, kh, j0:j0 + nk] += ds.T @ qs * scale
                    seen_kv += pairs
    if split:
        assert p["grid_reduce"] * 128 * 4 >= b * hkv * skv * p["dp"]
        for kh in range(hkv):
            for g in range(group):                        # head order
                dk[:, kh] += part_k[:, kh * group + g]
                dv[:, kh] += part_v[:, kh * group + g]
        dk *= scale
        bh, q_tiles = p["grid_dq"]
        assert bh == b * hq and q_tiles * keys == p["sq_pad"]
        row_tiles = [q_tiles - 1 - y for y in range(q_tiles)]
    else:
        q_tiles, bq = p["grid_dq"]
        assert bq == b * hq
        row_tiles = range(q_tiles)
    rows = p["block"]
    for qt in row_tiles:
        i0 = qt * rows
        nr = min(rows, sq - i0)
        lo, hi = fa.bwd_key_range(i0, nr, sq, skv, causal, window)
        for bi in range(b):
            for h in range(hq):
                for j0 in range(first(lo), hi if hi > lo else 0, step):
                    nk = min(step, skv - j0)
                    _, ds, _, _, ks, pairs = tile(bi, h, h // group, i0, nr,
                                                  j0, nk)
                    dq[bi, h, i0:i0 + nr] += ds @ ks * scale
                    seen_q += pairs
    return (dq, dk, dv), seen_kv, seen_q


@pytest.mark.parametrize("variant,b,hq,hkv,sq,skv,d,causal,window", [
    ("simt", 1, 4, 2, 70, 70, 16, True, 0),
    ("simt", 2, 4, 1, 45, 100, 8, True, 0),
    ("simt", 1, 4, 2, 90, 90, 8, True, 33),
    ("simt", 1, 2, 2, 37, 65, 8, False, 0),
    ("simt", 1, 14, 2, 33, 33, 64, True, 0),
    ("simt", 1, 4, 1, 70, 70, 256, True, 24),
    ("mma", 1, 14, 2, 100, 100, 64, True, 0),
    ("mma", 1, 4, 2, 45, 130, 64, True, 0),
    ("mma", 1, 4, 1, 150, 150, 64, True, 40),
    ("mma", 1, 2, 2, 37, 70, 64, False, 0),
    ("wgmma", 1, 14, 2, 100, 100, 64, True, 0),
    ("wgmma", 1, 4, 2, 45, 130, 64, True, 0),
    ("wgmma", 1, 4, 1, 150, 150, 64, True, 40),
    ("wgmma", 1, 14, 2, 77, 131, 64, True, 33),
    ("wgmma", 1, 2, 2, 37, 70, 64, False, 0),
], ids=["causal-70", "sq<skv", "window-33", "full", "qwen2-heads",
        "d256-window-24", "mma-qwen2-heads", "mma-sq<skv", "mma-window-40",
        "mma-full",
        "wgmma-qwen2-heads", "wgmma-sq<skv", "wgmma-window-40",
        "wgmma-window-33-sq<skv", "wgmma-full"])
def test_backward_schedule_matches_plain(variant, b, hq, hkv, sq, skv, d,
                                         causal, window):
    """The schedule the plan picks (``simt`` for f32, ``wgmma`` for bf16 at
    D 64), and ``mma`` as the forced schedule ``chip_smoke.py`` times."""
    if variant != "mma":
        dtype = torch.bfloat16 if variant == "wgmma" else torch.float32
        assert fa.plan_backward(b, hq, hkv, sq, skv, d, dtype)["variant"] \
            == variant
    q, k, v, do = map(torch.from_numpy, _inputs(b, hq, hkv, sq, skv, d,
                                                seed=2))
    o, lse = ref.flash_reference_lse(q, k, v, causal=causal, window=window)
    got, seen_kv, seen_q = schedule_backward(q, k, v, o, lse, do,
                                             causal=causal, window=window,
                                             variant=variant)
    want = ref.flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    _assert_grads(got, [w.numpy() for w in want], "schedule")
    # Each pass visits every visible (b, head, query, key) pair exactly
    # once, and the tile ranges skip no visible pair.
    every = {(bi, h, i, j) for bi in range(b) for h in range(hq)
             for i in range(sq) for j in range(skv)
             if _visible(i, j, sq, skv, causal, window)}
    for seen in (seen_kv, seen_q):
        assert len(seen) == len(set(seen)) and set(seen) == every


@pytest.mark.parametrize("shape,dtype,planned,variant,dp,grid_dkdv,grid_dq", [
    ((4, 14, 2, 2048, 2048, 64), torch.bfloat16, True, "wgmma", 64,
     (56, 32), (56, 32)),
    ((4, 14, 2, 2048, 2048, 64), torch.bfloat16, False, "mma", 64, (32, 8),
     (32, 56)),
    ((4, 14, 2, 2048, 2048, 64), torch.bfloat16, False, "simt", 64,
     (64, 8), (64, 56)),
    ((4, 14, 2, 2048, 2048, 64), torch.float32, True, "simt", 64, (64, 8),
     (64, 56)),
    ((1, 32, 8, 96, 96, 128), torch.bfloat16, True, "simt", 128, (3, 8),
     (3, 32)),
    ((2, 4, 1, 33, 70, 8), torch.bfloat16, True, "simt", 64, (3, 2),
     (2, 8)),
    ((1, 14, 2, 77, 131, 64), torch.bfloat16, True, "wgmma", 64, (14, 3),
     (14, 2)),
    # gemma3-1b's and recurrentgemma-2b's train shapes: D 256 on simt
    ((2, 4, 1, 2048, 2048, 256), torch.bfloat16, True, "simt", 256,
     (64, 2), (64, 8)),
    ((1, 10, 1, 2048, 2048, 256), torch.bfloat16, True, "simt", 256,
     (64, 1), (64, 10)),
    ((2, 4, 1, 2048, 2048, 256), torch.float32, True, "simt", 256,
     (64, 2), (64, 8)),
    ((1, 2, 1, 40, 40, 136), torch.bfloat16, True, "simt", 256, (2, 1),
     (2, 2)),
])
def test_plan_backward(shape, dtype, planned, variant, dp, grid_dkdv,
                       grid_dq):
    """The planned schedule, or (``planned`` False) the forced ones that
    ``chip_smoke.py`` times beside it: ``mma``, the design before
    ``wgmma``, and the CUDA-core ``simt``."""
    if planned:
        assert fa.plan_backward(*shape, dtype) == \
            fa.backward_schedule(variant, *shape)
    p = fa.backward_schedule(variant, *shape)
    assert p["variant"] == variant and p["dp"] == dp
    assert (p["block"], p["step"]) == fa.BWD_TILES[variant]
    assert p["grid_dkdv"] == grid_dkdv and p["grid_dq"] == grid_dq


@pytest.mark.parametrize("variant,scratch,extra", [
    ("wgmma", 2 * 56 * 2048 + 2 * 56 * 2048 * 64,
     {"split_heads": True, "sq_pad": 2048, "grid_reduce": 2048}),
    ("mma", 56 * 2048, {"split_heads": False}),
    ("simt", 56 * 2048, {"split_heads": False}),
])
def test_backward_scratch(variant, scratch, extra):
    """The f32 scratch each variant's entry point checks: D per query row
    (``simt``, ``mma``); for ``wgmma`` the lse and D rows padded to whole
    64-row tiles and each query head's partial dK and dV (2 x 29.4 MB at
    qwen2's train shape), which the reduce pass sums."""
    p = fa.backward_schedule(variant, 4, 14, 2, 2048, 2048, 64)
    assert p["scratch_floats"] == scratch
    assert {k_: p[k_] for k_ in extra} == extra
    ragged = fa.backward_schedule(variant, 1, 14, 2, 77, 131, 64)
    if variant == "wgmma":
        assert ragged["sq_pad"] == 128
        assert ragged["scratch_floats"] == 2 * 14 * 128 + 2 * 14 * 131 * 64
    else:
        assert ragged["scratch_floats"] == 14 * 77


@pytest.mark.parametrize("d", [12, 264])
def test_plan_backward_refuses_head_dims(d):
    with pytest.raises(ValueError, match="head dim"):
        fa.plan_backward(1, 2, 2, 8, 8, d, torch.float32)


def test_forward_plan_never_splits_when_saving_lse():
    decode = (4, 14, 2, 1, 128, 64, torch.bfloat16)
    assert fa.plan(*decode)["kv_splits"] > 1
    assert fa.plan(*decode, save_lse=True)["kv_splits"] == 1


def test_ops_attention_grads_match_jax():
    """The model-layout adapter differentiates through its three copies."""
    rng = np.random.default_rng(4)
    b, s, h, kv, d = 2, 24, 4, 2, 8
    q, k, v, do = (rng.standard_normal((b, s, n, d), dtype=np.float32)
                   for n in (h, kv, kv, h))

    def jfn(q_, k_, v_):
        out = jref.flash_reference(*(x.transpose(0, 2, 1, 3)
                                     for x in (q_, k_, v_)), window=5)
        return out.transpose(0, 2, 1, 3)

    want = [np.asarray(g) for g in jax.jit(
        lambda *a: jax.vjp(jfn, *a[:3])[1](a[3]))(
        *map(jnp.asarray, (q, k, v, do)))]
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.attention(*xs, window=5)
    _assert_grads(torch.autograd.grad(out, xs, torch.from_numpy(do)), want,
                  "ops.attention")


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES, ids=IDS)
def test_blocked_plain_attention_matches_jax(monkeypatch, b, hq, hkv, sq,
                                             skv, d, causal, window):
    """From ``BLOCKED_ATTN_THRESHOLD`` query rows on, the wrapper's CPU path
    is the blocked plain attention (query blocks, each checkpointed, as the
    JAX model's ``_sdpa_blocked``): output and gradients against JAX's
    ``flash_reference``, with blocks that do not divide the rows."""
    monkeypatch.setattr(fa, "BLOCKED_ATTN_THRESHOLD", sq)
    blocked, calls = fa.flash_reference_blocked, []

    def five_rows(*args, **kwargs):
        calls.append(kwargs)
        return blocked(*args, q_block=5, **kwargs)

    monkeypatch.setattr(fa, "flash_reference_blocked", five_rows)
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=5)
    want_out = np.asarray(jref.flash_reference(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window))
    want = _jax_grads(q, k, v, do, causal, window)
    xs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*xs, causal=causal, window=window)
    assert calls == [{"causal": causal, "window": window}]
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-5)
    _assert_grads(torch.autograd.grad(out, xs, torch.from_numpy(do)), want,
                  "blocked")
