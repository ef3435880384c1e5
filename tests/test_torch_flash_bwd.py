"""The flash-attention backward: the port's plain backward
(``ref.flash_backward_reference``, step by step from the forward's output
and row log-sum-exp) and autograd through its plain forward, against
``jax.vjp`` of the JAX package's ``kernels/ref.flash_reference``; the
forward's LSE against a float64 log-sum-exp; the backward kernels' tile
schedule (``plan_backward``, ``bwd_query_range``, ``bwd_key_range``)
written out in plain PyTorch against the plain backward; and the blocked
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


def schedule_backward(q, k, v, o, lse, do, *, causal, window, dtype):
    """The backward kernels' tile schedule for ``dtype``'s plan, in plain
    PyTorch (f32): the D pass; dK/dV blocks per (key tile, b, kv head)
    walking the G heads and the query tiles of ``bwd_query_range``; dQ
    blocks per (query tile, b, q head) walking the key tiles of
    ``bwd_key_range``.  Also returns the (query, key) pairs each pass visits
    with a visible mask."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    p = fa.plan_backward(b, hq, hkv, sq, skv, d, dtype)
    assert p["dp"] >= d
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
        pairs = {(int(a), int(c)) for a, c in
                 zip(*torch.nonzero(vis, as_tuple=True))}
        pairs = {(i0 + a, j0 + c) for a, c in pairs}
        return pt, ds, qs, dos, ks, pairs

    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    seen_kv, seen_q = set(), set()
    kv_tiles, bk = p["grid_dkdv"]
    assert bk == b * hkv
    keys, step = p["block"], p["step"]
    for kt in range(kv_tiles):
        j0 = kt * keys
        nk = min(keys, skv - j0)
        lo, hi = fa.bwd_query_range(j0, nk, sq, skv, causal, window)
        for bi in range(b):
            for kh in range(hkv):
                for g in range(group):
                    h = kh * group + g
                    for i0 in range(lo, hi, step):
                        nr = min(step, hi - i0)
                        pt, ds, qs, dos, _, pairs = tile(bi, h, kh, i0, nr,
                                                         j0, nk)
                        dv[bi, kh, j0:j0 + nk] += pt.T @ dos
                        dk[bi, kh, j0:j0 + nk] += ds.T @ qs * scale
                        seen_kv |= {(bi, h) + pr for pr in pairs}
    q_tiles, bq = p["grid_dq"]
    assert bq == b * hq
    rows = p["block"]
    for qt in range(q_tiles):
        i0 = qt * rows
        nr = min(rows, sq - i0)
        lo, hi = fa.bwd_key_range(i0, nr, sq, skv, causal, window)
        for bi in range(b):
            for h in range(hq):
                for j0 in range(lo, hi, step):
                    nk = min(step, hi - j0)
                    _, ds, _, _, ks, pairs = tile(bi, h, h // group, i0, nr,
                                                  j0, nk)
                    dq[bi, h, i0:i0 + nr] += ds @ ks * scale
                    seen_q |= {(bi, h) + pr for pr in pairs}
    return (dq, dk, dv), seen_kv, seen_q


@pytest.mark.parametrize("variant,b,hq,hkv,sq,skv,d,causal,window", [
    ("simt", 1, 4, 2, 70, 70, 16, True, 0),
    ("simt", 2, 4, 1, 45, 100, 8, True, 0),
    ("simt", 1, 4, 2, 90, 90, 8, True, 33),
    ("simt", 1, 2, 2, 37, 65, 8, False, 0),
    ("simt", 1, 14, 2, 33, 33, 64, True, 0),
    ("mma", 1, 14, 2, 100, 100, 64, True, 0),
    ("mma", 1, 4, 2, 45, 130, 64, True, 0),
    ("mma", 1, 4, 1, 150, 150, 64, True, 40),
    ("mma", 1, 2, 2, 37, 70, 64, False, 0),
], ids=["causal-70", "sq<skv", "window-33", "full", "qwen2-heads",
        "mma-qwen2-heads", "mma-sq<skv", "mma-window-40", "mma-full"])
def test_backward_schedule_matches_plain(variant, b, hq, hkv, sq, skv, d,
                                         causal, window):
    dtype = torch.bfloat16 if variant == "mma" else torch.float32
    assert fa.plan_backward(b, hq, hkv, sq, skv, d, dtype)["variant"] \
        == variant
    q, k, v, do = map(torch.from_numpy, _inputs(b, hq, hkv, sq, skv, d,
                                                seed=2))
    o, lse = ref.flash_reference_lse(q, k, v, causal=causal, window=window)
    got, seen_kv, seen_q = schedule_backward(q, k, v, o, lse, do,
                                             causal=causal, window=window,
                                             dtype=dtype)
    want = ref.flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    _assert_grads(got, [w.numpy() for w in want], "schedule")
    # Each pass visits every visible (b, head, query, key) pair once, and
    # the tile ranges skip no visible pair.
    every = {(bi, h, i, j) for bi in range(b) for h in range(hq)
             for i in range(sq) for j in range(skv)
             if _visible(i, j, sq, skv, causal, window)}
    assert seen_kv == every and seen_q == every


@pytest.mark.parametrize("shape,dtype,planned,variant,dp,grid_dkdv,grid_dq", [
    ((4, 14, 2, 2048, 2048, 64), torch.bfloat16, True, "mma", 64, (32, 8),
     (32, 56)),
    ((4, 14, 2, 2048, 2048, 64), torch.bfloat16, False, "simt", 64,
     (64, 8), (64, 56)),
    ((4, 14, 2, 2048, 2048, 64), torch.float32, True, "simt", 64, (64, 8),
     (64, 56)),
    ((1, 32, 8, 96, 96, 128), torch.bfloat16, True, "simt", 128, (3, 8),
     (3, 32)),
    ((2, 4, 1, 33, 70, 8), torch.bfloat16, True, "simt", 64, (3, 2),
     (2, 8)),
])
def test_plan_backward(shape, dtype, planned, variant, dp, grid_dkdv,
                       grid_dq):
    """The planned schedule, or (``planned`` False) the CUDA-core one that
    is timed beside ``mma``."""
    p = (fa.plan_backward(*shape, dtype) if planned
         else fa.backward_schedule("simt", *shape))
    assert p["variant"] == variant and p["dp"] == dp
    assert (p["block"], p["step"]) == fa.BWD_TILES[variant]
    assert p["grid_dkdv"] == grid_dkdv and p["grid_dq"] == grid_dq


@pytest.mark.parametrize("d", [12, 136])
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
