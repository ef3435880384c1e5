"""The chunked, time-parallel schedule of the ``mma`` WKV kernels, on the CPU.

``csrc/rwkv6_chunked.cu`` computes the RWKV6 recurrence in 16-step chunks
inside spans of several chunks: a span pass gives each span's local end
state (and, for the backward, its local start adjoint) from zero, a scan
over spans turns those into each span's start state and end adjoint, and an
output pass walks each span's chunks.  ``chunked_forward`` and
``chunked_backward`` write that schedule out in plain f32 PyTorch, with the
kernels' exponents (every one a later cumulative log-decay minus an earlier
one, so never positive) and the backward's four-term decay gradient, and
these tests hold it to the serial oracle, the JAX package's reference and
the JAX model's ``_chunked_wkv`` and to ``jax.vjp`` for all five gradients.
Inputs are made from a seed with numpy.  Tolerances: 2e-4 forward (the
model's chunked form against the serial one, as ``test_torch_rwkv.py``
holds it) and 1e-5 of each gradient's largest magnitude (f32 on both sides,
summation order only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv as JRW  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as wkv  # noqa: E402

CHUNK = wkv.CHUNK
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 1e-5
# The clipped decay's two ends: logw = -exp(4) and -exp(-8) every step.
CLIP_ENDS = {"steep": -float(np.exp(4.0)), "flat": -float(np.exp(-8.0))}


def _inputs(bh, s, d, clip_end=None, seed=0):
    """r, k, v, g ~ N(0,1); log-decay -exp(U[-4, 1.2]) (the JAX kernel
    test's draw) or one clip end everywhere; u ~ 0.3 N(0,1); numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v, g = (rng.standard_normal((bh, s, d), dtype=np.float32)
                  for _ in range(4))
    if clip_end is None:
        wl = -np.exp(rng.uniform(-4.0, 1.2, (bh, s, d))).astype(np.float32)
    else:
        wl = np.full((bh, s, d), CLIP_ENDS[clip_end], np.float32)
    u = rng.standard_normal((bh, d), dtype=np.float32) * 0.3
    return r, k, v, wl, u, g


def _chunks(x, s):
    """[BH,S,D] -> [BH,N,C,D], the ragged last chunk padded with zeros (a
    zero log-decay keeps the chunk's cumulative decay where it ends)."""
    bh, _, d = x.shape
    n = -(-s // CHUNK)
    pad = x.new_zeros(bh, n * CHUNK - s, d)
    return torch.cat([x, pad], 1).reshape(bh, n, CHUNK, d)


def _derived(lw):
    """A chunk's decays, each a later cumulative log-decay minus an earlier
    one, so never above 1:

    - cum, cp: the inclusive and exclusive cumulative log-decays (cp is cum
      shifted by one step, so cp_t - cum_{t-1} is exactly 0), for the
      forward's pairwise weights exp(cp_t - cum_s);
    - pre_t = prod_{j<t} w_j, suf_s = prod_{j>s} w_j and tot = prod_j w_j
      (w = exp(lw)): the factors exp(cp), exp(ce - cum) and exp(ce) as
      running products of the steps' own decays, exact to a few ulps where
      the log-decay sums reach hundreds and their differences would lose
      the digits of a single step's exp(-54.6).
    """
    cum = torch.cumsum(lw, 1)
    cp = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    w = torch.exp(lw)
    one = torch.ones_like(w[:, :1])
    pre = torch.cumprod(torch.cat([one, w[:, :-1]], 1), 1)
    suf = torch.cumprod(torch.cat([one, w.flip(1)[:, :-1]], 1), 1).flip(1)
    return cum, cp, w, pre, suf, pre[:, -1] * w[:, -1]


def _pairwise(cum, cp):
    """exp(cp_t - cum_s) for s < t, else 0: [BH, t, s, D]."""
    diff = cp[:, :, None, :] - cum[:, None, :, :]
    lower = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool), -1)
    return torch.exp(diff.masked_fill(~lower[None, :, :, None],
                                      -float("inf")))


def _pairwise_products(w):
    """prod_{s<j<t} w_j for s < t, else 0: [BH, t, s, D], built step by
    step as the backward kernel's per-channel walk builds it."""
    e = w.new_zeros(w.shape[0], CHUNK, CHUNK, w.shape[-1])
    for t in range(1, CHUNK):
        e[:, t, :t - 1] = e[:, t - 1, :t - 1] * w[:, None, t - 1]
        e[:, t, t - 1] = 1.0
    return e


def _intra(r, k, u, e):
    """The forward's intra-chunk weights, bonus on the diagonal:
    A[t,s] = sum_d r_t k_s exp(cp_t - cum_s) (s < t), A[t,t] = r_t.(u k_t)."""
    a = torch.einsum("btd,bsd,btsd->bts", r, k, e)
    return a + torch.diag_embed((r * u[:, None] * k).sum(-1))


def _exclusive_cumsum(x):
    """sum_{s<t} x_s along dim 1, summed as a running total (a difference
    of inclusive sums would cancel a term of e^-54.6 against one of 1)."""
    return torch.cumsum(torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]],
                                  1), 1)


def _span_bounds(n, span):
    per = span // CHUNK
    return [range(p, min(p + per, n)) for p in range(0, n, per)]


def _scan(loc, dec, reverse=False):
    """Each span's start state (or, reversed, end adjoint) from the local
    ones of the spans before (after) it, in a fixed order."""
    out = torch.zeros_like(loc)
    acc = torch.zeros_like(loc[:, 0])
    order = range(loc.shape[1] - 1, -1, -1) if reverse \
        else range(loc.shape[1])
    for p in order:
        out[:, p] = acc
        acc = dec[:, p, :, None] * acc + loc[:, p]
    return out


def _span_pass(rc, kc, vc, lc, gc, spans):
    """Each span's local end state and local start adjoint, from zero, and
    its total decay (a product of the steps' decays)."""
    bh, _, _, d = rc.shape
    sloc = rc.new_zeros(bh, len(spans), d, d)
    gloc = torch.zeros_like(sloc)
    dec = rc.new_zeros(bh, len(spans), d)
    for p, chunks in enumerate(spans):
        base = rc.new_ones(bh, d)
        for c in chunks:
            _, _, _, pre, suf, tot = _derived(lc[:, c])
            sloc[:, p] = tot[:, :, None] * sloc[:, p] \
                + (kc[:, c] * suf).transpose(1, 2) @ vc[:, c]
            if gc is not None:
                rdec = rc[:, c] * (base[:, None] * pre)
                gloc[:, p] += rdec.transpose(1, 2) @ gc[:, c]
            base = base * tot
        dec[:, p] = base
    return sloc, gloc, dec


def chunked_forward(r, k, v, w_log, u, span=128):
    """The ``mma`` forward's schedule: r, k, v, w_log [BH,S,D], u [BH,D] ->
    f32 [BH,S,D]."""
    bh, s, d = r.shape
    rc, kc, vc, lc = (_chunks(x.float(), s) for x in (r, k, v, w_log))
    u = u.float()
    spans = _span_bounds(rc.shape[1], span)
    sloc, _, dec = _span_pass(rc, kc, vc, lc, None, spans)
    start = _scan(sloc, dec)
    out = torch.zeros_like(rc)
    for p, chunks in enumerate(spans):
        st = start[:, p]
        for c in chunks:
            cum, cp, _, pre, suf, tot = _derived(lc[:, c])
            a = _intra(rc[:, c], kc[:, c], u, _pairwise(cum, cp))
            out[:, c] = (rc[:, c] * pre) @ st + a @ vc[:, c]
            st = tot[:, :, None] * st \
                + (kc[:, c] * suf).transpose(1, 2) @ vc[:, c]
    return out.reshape(bh, -1, d)[:, :s]


def chunked_backward(r, k, v, w_log, u, g, span=64, terms=False):
    """The ``mma`` backward's schedule: -> (gr, gk, gv, gw_log, gu), f32.
    With ``terms``, also the decay gradient's four terms T1..T4, each
    [BH,S,D] (T1 broadcast over its chunk's steps)."""
    bh, s, d = r.shape
    rc, kc, vc, lc, gc = (_chunks(x.float(), s)
                          for x in (r, k, v, w_log, g))
    u = u.float()
    spans = _span_bounds(rc.shape[1], span)
    sloc, gloc, dec = _span_pass(rc, kc, vc, lc, gc, spans)
    s_start, g_end = _scan(sloc, dec), _scan(gloc, dec, reverse=True)
    vg = (gc * vc).sum(-1, keepdim=True)                 # g_t . v_t
    gu = (vg * rc * kc).sum((1, 2))
    grads = [torch.zeros_like(rc) for _ in range(4)]
    parts = [torch.zeros_like(rc) for _ in range(4)]
    for p, chunks in enumerate(spans):
        stash, st = [], s_start[:, p]
        for c in chunks:                                 # forward walk
            stash.append(st)
            _, _, _, _, suf, tot = _derived(lc[:, c])
            st = tot[:, :, None] * st \
                + (kc[:, c] * suf).transpose(1, 2) @ vc[:, c]
        big_g = g_end[:, p]
        for c, s0 in reversed(list(zip(chunks, stash))):  # reverse walk
            rr, kk, vv, gg = rc[:, c], kc[:, c], vc[:, c], gc[:, c]
            cum, cp, w, pre, suf, tot = _derived(lc[:, c])
            bm = gg @ vv.transpose(1, 2)                 # g_t . v_s
            p1 = gg @ s0.transpose(1, 2)                 # S0 g_t
            p2 = vv @ big_g.transpose(1, 2)              # G_end v_s
            x = bm[..., None] * _pairwise_products(w)
            bonus = torch.diagonal(bm, dim1=1, dim2=2)[..., None] * u[:, None]
            gr_inter = pre * p1
            gk_inter = suf * p2
            grads[0][:, c] = gr_inter + bonus * kk \
                + (x * kk[:, None]).sum(2)
            grads[1][:, c] = gk_inter + bonus * rr \
                + (x * rr[:, :, None]).sum(1)
            a = _intra(rr, kk, u, _pairwise(cum, cp))
            grads[2][:, c] = (kk * suf) @ big_g + a.transpose(1, 2) @ gg
            t1 = tot * (big_g * s0).sum(-1)
            t2 = _exclusive_cumsum(kk * gk_inter)
            t3 = _exclusive_cumsum((rr * gr_inter).flip(1)).flip(1)
            m = x * rr[:, :, None] * kk[:, None]          # [BH, t, s, D]
            run = torch.cumsum(m, 2)                      # sum_{s' <= s}
            prev = torch.cat([torch.zeros_like(run[:, :, :1]),
                              run[:, :, :-1]], 2)         # sum_{s' < j}
            after = torch.triu(torch.ones(CHUNK, CHUNK, dtype=torch.bool),
                               1).T                      # t > j
            t4 = (prev * after[None, :, :, None]).sum(1)
            for i, term in enumerate((t1[:, None].expand_as(t2), t2, t3,
                                      t4)):
                parts[i][:, c] = term
            big_g = tot[:, :, None] * big_g \
                + (rr * pre).transpose(1, 2) @ gg
    parts = [x.reshape(bh, -1, d)[:, :s] for x in parts]
    grads[3] = sum(parts)
    out = tuple(x.reshape(bh, -1, d)[:, :s] for x in grads) + (gu,)
    return (out, parts) if terms else out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _vjp(r, k, v, wl, u, g):
    _, vjp = jax.vjp(jref.rwkv6_reference,
                     *(jnp.asarray(x) for x in (r, k, v, wl, u)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_grads(got, expect):
    for name, a, b in zip(("r", "k", "v", "w_log", "u"), got, expect):
        a = a.numpy()
        assert a.shape == b.shape and np.isfinite(a).all(), name
        err = np.abs(a - b).max()
        assert err <= GRAD_REL * np.abs(b).max(), (name, err)


CASES = [(s, d, clip_end) for s in (1, 37, 64, 96) for d in (16, 32)
         for clip_end in (None, "steep", "flat")]


@pytest.mark.parametrize("s,d,clip_end", CASES)
def test_forward_schedule_matches_serial_and_jax(s, d, clip_end):
    """Spans of 32 (several spans from S 37 up) and of the kernel's 128."""
    r, k, v, wl, u, _ = _inputs(2, s, d, clip_end, seed=s + d)
    args = [_t(x) for x in (r, k, v, wl, u)]
    serial = ref.rwkv6_reference(*args).numpy()
    expect = np.asarray(jref.rwkv6_reference(*(jnp.asarray(x)
                                               for x in (r, k, v, wl, u))))
    for span in (32, wkv.plan(2, s, 32, torch.bfloat16)["span_fwd"]):
        out = chunked_forward(*args, span=span).numpy()
        assert out.shape == (2, s, d) and np.isfinite(out).all()
        np.testing.assert_allclose(out, serial, **FWD_TOL)
        np.testing.assert_allclose(out, expect, **FWD_TOL)


@pytest.mark.parametrize("clip_end", [None, "steep", "flat"])
@pytest.mark.parametrize("s", [64, 96])
def test_forward_schedule_matches_model_chunked_form(s, clip_end):
    """In the model layout ([B,S,H,D], u per head, as ``ops.rwkv_mix``
    folds heads into b*h) against ``_chunked_wkv``, where S % 16 == 0."""
    b, h, d = 2, 2, 32
    r, k, v, wl, _, _ = _inputs(b * h, s, d, clip_end, seed=11)
    u = np.random.default_rng(12).standard_normal((h, d),
                                                  dtype=np.float32) * 0.3

    def to_bshd(x):
        return x.reshape(b, h, s, d).transpose(0, 2, 1, 3)

    expect = JRW._chunked_wkv(*(jnp.asarray(to_bshd(x))
                                for x in (r, k, v, wl)), jnp.asarray(u))
    out = chunked_forward(*(_t(x) for x in (r, k, v, wl)),
                          _t(np.tile(u, (b, 1))), span=32)
    np.testing.assert_allclose(to_bshd(out.numpy()), np.asarray(expect),
                               **FWD_TOL)


@pytest.mark.parametrize("s,d,clip_end", CASES)
def test_backward_schedule_matches_jax_vjp(s, d, clip_end):
    """All five gradients, at spans of 32 and of the kernel's 64, against
    ``jax.vjp`` of the serial oracle; at S = 1 the decay's gradient is 0."""
    r, k, v, wl, u, g = _inputs(2, s, d, clip_end, seed=3 * s + d)
    expect = _vjp(r, k, v, wl, u, g)
    for span in (32, wkv.plan(2, s, 32, torch.bfloat16)["span_bwd"]):
        got = chunked_backward(*(_t(x) for x in (r, k, v, wl, u, g)),
                               span=span)
        _assert_grads(got, expect)
    if s == 1:
        assert (got[3] == 0).all()


@pytest.mark.parametrize("s,span", [(16, 64), (96, 32)])
@pytest.mark.parametrize("clip_end", [None, "steep"])
def test_decay_gradient_terms_sum_to_jax(s, span, clip_end):
    """T1..T4 with one chunk and with three spans of two chunks: each term
    finite, their sum the decay gradient of ``jax.vjp``; T1, the state's
    term, is 0 in the first chunk (S0 = 0) and T2, the end adjoint's, in
    the last (G_end = 0)."""
    r, k, v, wl, u, g = _inputs(2, s, 32, clip_end, seed=20)
    expect = _vjp(r, k, v, wl, u, g)[3]
    _, terms = chunked_backward(*(_t(x) for x in (r, k, v, wl, u, g)),
                                span=span, terms=True)
    for term in terms:
        assert torch.isfinite(term).all()
    assert (terms[0][:, :CHUNK] == 0).all()
    assert (terms[1][:, -CHUNK:] == 0).all()
    total = sum(terms).numpy()
    assert np.abs(total - expect).max() <= GRAD_REL * np.abs(expect).max()


def test_steepest_decay_keeps_every_output_finite():
    """At logw = -e^4 every step, the chunked factors stay finite where
    the Pallas kernel's exp(-cum) gives NaN, forward and all gradients."""
    r, k, v, wl, u, g = _inputs(2, 96, 32, "steep", seed=30)
    args = [_t(x) for x in (r, k, v, wl, u)]
    out = chunked_forward(*args, span=32)
    grads = chunked_backward(*args, _t(g), span=32)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(x).all() for x in grads)
    _assert_grads(grads, _vjp(r, k, v, wl, u, g))
