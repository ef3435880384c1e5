"""Attention-logit soft-capping (``logit_softcap`` c: each scaled logit s
becomes c tanh(s / c) before the mask and the softmax) in the port against
the JAX package.

The flash kernels' plain versions (the CPU path of ``ops.attention`` and
``ops.cross_attention``, ``ref.flash_reference_blocked``,
``ref.flash_backward_reference``) against the reference's ``_sdpa`` and
``_sdpa_blocked``: causal with and without a window, cross, one-token
decode under a per-slot ``kv_len``, and the backward against ``jax.vjp``.
Then gemma3-1b, qwen2-0.5b and deepseek-v3-671b (MLA: the reference caps
its blocked path only, which the port follows) at smoke size: logits,
the loss and every gradient, and greedy decode tokens.  Each runs at c 50
(Gemma 2's ``attn_logit_softcapping``) and at c 0.5, where tanh bends the
smoke models' small logits.

Inputs from numpy seeds, f32.  Tolerances: attention outputs and
gradients 1e-5; logits 1e-4; the loss 1e-5 relative and each gradient
leaf ||d|| / ||g|| <= 1e-4; decode tokens identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from torch_parity import (as_np, both_params, check_forward,  # noqa: E402
                          check_loss_and_grads, tokens)

CAPS = [50.0, 0.5]
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-4
B, H, KV, D = 2, 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(cap):
    """A config whose ``head_dim`` (the reference's scale) is D."""
    return jconfigs.get_smoke("qwen2-0.5b").replace(
        logit_softcap=cap, head_dim=D, n_heads=H, n_kv_heads=KV)


def _qkv(sq, skv, seed=0):
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] in the model layout, logits of a few
    units (the scale times 3 on q)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32) * 3
    k, v = (rng.standard_normal((B, skv, KV, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("cap", CAPS)
def test_causal_attention_matches_sdpa(cap, window):
    q, k, v = _qkv(12, 12)
    want = JL._sdpa(_jcfg(cap), *map(jnp.asarray, (q, k, v)),
                    JL.causal_mask(12, 12, window))
    got = ops.attention(*_t(q, k, v), window=window, softcap=cap)
    np.testing.assert_allclose(as_np(got), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("cap", CAPS)
def test_blocked_attention_matches_sdpa_blocked(cap, window):
    """Blocks of 4 query rows, each capped before its mask."""
    q, k, v = _qkv(16, 16, seed=1)
    want = JL._sdpa_blocked(_jcfg(cap), *map(jnp.asarray, (q, k, v)),
                            window, q_block=4)
    got = ref.flash_reference_blocked(
        *(x.transpose(1, 2) for x in _t(q, k, v)), window=window,
        q_block=4, softcap=cap).transpose(1, 2)
    np.testing.assert_allclose(as_np(got), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("cap", CAPS)
def test_cross_attention_matches_sdpa(cap):
    q, k, v = _qkv(6, 11, seed=2)
    want = JL._sdpa(_jcfg(cap), *map(jnp.asarray, (q, k, v)), None)
    got = ops.cross_attention(*_t(q, k, v), softcap=cap)
    np.testing.assert_allclose(as_np(got), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("cap", CAPS)
def test_decode_with_kv_len_matches_sdpa(cap):
    """One query a slot against a 10-row cache, slot b seeing its first
    pos[b] + 1 rows (the reference's per-slot ``decode_mask``)."""
    q, k, v = _qkv(1, 10, seed=3)
    pos = np.array([3, 8], np.int32)
    want = JL._sdpa(_jcfg(cap), *map(jnp.asarray, (q, k, v)),
                    JL.decode_mask(jnp.asarray(pos), 10))
    got = ops.attention(*_t(q, k, v), softcap=cap,
                        kv_len=torch.from_numpy(pos + 1))
    np.testing.assert_allclose(as_np(got), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("cap", CAPS)
def test_backward_reference_matches_jax_grad(cap, window):
    """``flash_backward_reference`` (the backward kernels' plain version,
    dS times 1 - (S'/c)^2) from the forward's output and capped LSE,
    against ``jax.vjp`` of ``_sdpa``; and the wrapper's own gradient."""
    q, k, v = _qkv(12, 12, seed=4)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)
    jcfg = _jcfg(cap)
    mask = JL.causal_mask(12, 12, window)
    _, vjp = jax.vjp(lambda *a: JL._sdpa(jcfg, *a, mask),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in _t(q, k, v, do))
    o, lse = ref.flash_reference_lse(qt, kt, vt, window=window, softcap=cap)
    got = ref.flash_backward_reference(qt, kt, vt, o, lse, dot,
                                       window=window, softcap=cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g.transpose(1, 2)), w, **ATTN_TOL)
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    out = ops.attention(*xs, window=window, softcap=cap)
    for g, w in zip(torch.autograd.grad(out, xs, torch.from_numpy(do)),
                    want):
        np.testing.assert_allclose(as_np(g), w, **ATTN_TOL)


def test_cap_changes_the_function():
    """At c 0.5 the cap moves the output by far more than the tolerance
    (so the model tests below hold a capped path, not an uncapped one)."""
    q, k, v = _qkv(12, 12)
    capped = ops.attention(*_t(q, k, v), softcap=0.5)
    plain = ops.attention(*_t(q, k, v))
    assert (capped - plain).abs().max() > 1e-2


MODELS = ["gemma3-1b", "qwen2-0.5b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", params=[(a, c) for a in MODELS
                                        for c in CAPS],
                ids=lambda p: f"{p[0]}-c{p[1]}")
def model(request):
    arch, cap = request.param
    cfg = configs.get_smoke(arch).replace(logit_softcap=cap)
    jcfg = jconfigs.get_smoke(arch).replace(logit_softcap=cap)
    jparams, params = both_params(cfg, jcfg)
    return cfg, jcfg, params, jparams


def test_forward_logits_match_jax(model):
    cfg, jcfg, params, jparams = model
    check_forward(cfg, jcfg, params, jparams, 2, 16, LOGIT_TOL)


def test_blocked_forward_logits_match_jax(model, monkeypatch):
    """The blocked attention (one block of 32 rows, from a threshold of 16
    rows on), which is where the reference caps MLA's logits."""
    cfg, jcfg, params, jparams = model
    for mod in (JL, fa, MLA):
        monkeypatch.setattr(mod, "BLOCKED_ATTN_THRESHOLD", 16)
    check_forward(cfg, jcfg, params, jparams, 1, 32, LOGIT_TOL)


def test_loss_and_every_gradient_match_jax(model):
    cfg, jcfg, params, jparams = model
    check_loss_and_grads(cfg, jcfg, params, jparams, GRAD_REL)


def test_greedy_decode_tokens_match_jax(model):
    """Eight greedy steps on one shared position clock, each side feeding
    back its own argmax: the same tokens every step."""
    cfg, jcfg, params, jparams = model
    tok = tokens(cfg, 2, 1, seed=6)
    jtok = tok
    cache = M.init_cache(cfg, 2, 16, "cpu")
    jcache = JM.init_cache(jcfg, 2, 16)
    jstep = jax.jit(lambda p, t, c, q: JM.decode_step(jcfg, p, t, c, q))
    for t in range(8):
        logits, cache = M.decode_step(cfg, params, torch.from_numpy(tok),
                                      cache, torch.tensor(t, dtype=torch.int32))
        jlogits, jcache = jstep(jparams, jnp.asarray(jtok), jcache,
                                jnp.int32(t))
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32).numpy()
        jtok = np.asarray(jnp.argmax(jlogits[:, -1:], -1), np.int32)
        np.testing.assert_array_equal(tok, jtok, err_msg=f"step {t}")
