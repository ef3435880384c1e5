"""The port's RWKV6 recurrence and layers against the JAX package's.

Inputs are made from a seed with numpy and handed to both packages.  On the
CPU the port's wrappers run their plain version (a serial f32 scan,
differentiated by autograd); the kernels themselves run only on a CUDA card
(``tests/test_torch_cuda.py``).  Tolerances: the JAX package's for its own
kernel (f32 3e-4, bf16 inputs 4e-2; ``tests/test_kernels.py``), 2e-4 against
the model's chunked form, and 1e-5 of each gradient's largest magnitude
where both sides differentiate the same f32 serial scan (only summation
order differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_chunk import rwkv6_chunk as pallas_rwkv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JRW  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import (  # noqa: E402
    rwkv6_bwd, rwkv6_chunk, rwkv6_fwd)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rwkv as RW  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = {"float32": dict(rtol=3e-4, atol=3e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_REL = 1e-5
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "rwkv6-1.6b"
# The clipped decay's two ends: logw = -exp(4) and -exp(-8) every step.
CLIP_ENDS = {"steep": -float(np.exp(4.0)), "flat": -float(np.exp(-8.0))}
# tests/test_kernels.py's shapes (bh, s, d), then both clip ends.
SHAPES = [(2, 128, 32, None), (1, 256, 64, None), (4, 64, 16, None),
          (1, 128, 64, None), (2, 48, 32, "steep"), (2, 48, 64, "flat")]


def _inputs(bh, s, d, clip_end=None, seed=0):
    """r, k, v ~ N(0,1); log-decay -exp(U[-4, 1.2]) (the JAX test's range)
    or one clip end everywhere; u ~ 0.3 N(0,1); numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, s, d), dtype=np.float32)
               for _ in range(3))
    if clip_end is None:
        wl = -np.exp(rng.uniform(-4.0, 1.2, (bh, s, d))).astype(np.float32)
    else:
        wl = np.full((bh, s, d), CLIP_ENDS[clip_end], np.float32)
    u = (rng.standard_normal((bh, d), dtype=np.float32) * 0.3)
    return r, k, v, wl, u


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d,clip_end", SHAPES)
def test_plain_matches_jax_reference(bh, s, d, clip_end, dtype):
    r, k, v, wl, u = _inputs(bh, s, d, clip_end)
    expect = jref.rwkv6_reference(*(jnp.asarray(x, JDT[dtype])
                                    for x in (r, k, v)),
                                  jnp.asarray(wl), jnp.asarray(u))
    out = rwkv6_chunk(*(_t(x, TDT[dtype]) for x in (r, k, v)), _t(wl),
                      _t(u))
    assert out.dtype == torch.float32 and out.shape == (bh, s, d)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_np(out), np.asarray(expect), **TOL[dtype])


@pytest.mark.parametrize("clip_end", [None, "steep", "flat"])
def test_adapter_matches_model_chunked_form(clip_end):
    """ops.rwkv_mix ([B,S,H,D], u per head) against the model's own
    ``_chunked_wkv`` (chunk 16, pairwise decay differences)."""
    b, s, h, d = 2, 64, 2, 32
    r, k, v, wl, _ = _inputs(b * s, h, d, clip_end, seed=2)
    shape = (b, s, h, d)
    r, k, v, wl = (x.reshape(shape) for x in (r, k, v, wl))
    u = np.random.default_rng(3).standard_normal((h, d),
                                                 dtype=np.float32) * 0.3
    expect = JRW._chunked_wkv(*(jnp.asarray(x) for x in (r, k, v, wl, u)))
    out = ops.rwkv_mix(*(_t(x) for x in (r, k, v, wl, u)))
    assert out.shape == shape
    np.testing.assert_allclose(_np(out), np.asarray(expect), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("bh,s,d,chunk", [(2, 128, 32, 32), (4, 64, 16, 16)])
def test_plain_matches_pallas_interpret(bh, s, d, chunk):
    """Where the Pallas kernel is finite (the JAX test's decay range)."""
    r, k, v, wl, u = _inputs(bh, s, d, seed=4)
    expect = pallas_rwkv(*(jnp.asarray(x) for x in (r, k, v, wl, u)),
                         chunk=chunk, interpret=True)
    out = rwkv6_chunk(*(_t(x) for x in (r, k, v, wl, u)))
    np.testing.assert_allclose(_np(out), np.asarray(expect), **TOL["float32"])


# NaN outputs of the Pallas kernel (interpret mode) out of 4096, at chunk 16
# and chunk 64, with one log-decay at every step (b*h 2, S 64, D 32).
PALLAS_NANS = {-1.0: (0, 0), -3.0: (0, 2176), -6.0: (256, 3136),
               CLIP_ENDS["steep"]: (3584, 3968)}


@pytest.mark.parametrize("logw", sorted(PALLAS_NANS))
def test_pallas_overflows_where_port_is_finite(logw):
    """A limit of the reference kernel, which the port does not copy: its
    exp(-cum) factor overflows f32 once a chunk's log-decay sums past ~-88.7,
    and gives NaN.  The model makes such decays (its clip allows -54.6 per
    step); the serial oracle and the port stay finite and agree."""
    r, k, v, _, u = _inputs(2, 64, 32, seed=5)
    wl = np.full_like(r, logw)
    args = [jnp.asarray(x) for x in (r, k, v, wl, u)]
    nans = tuple(int(np.isnan(np.asarray(
        pallas_rwkv(*args, chunk=c, interpret=True))).sum()) for c in (16, 64))
    assert nans == PALLAS_NANS[logw]
    expect = np.asarray(jref.rwkv6_reference(*args))
    out = _np(rwkv6_chunk(*(_t(x) for x in (r, k, v, wl, u))))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, expect, **TOL["float32"])


def test_init_decays_overflow_a_64_step_chunk():
    """At rwkv6-1.6b's init (w0 ~ N(0, 0.6^2) over 24 x 2048 channels, the
    LoRA term aside), a constant decay exp(w0) per step sums past f32's exp
    range inside a 64-step chunk in 29% of channels, inside 16 in 0.2%."""
    scale = RW.rwkv_defs(configs.get(ARCH))["w0"].init_scale
    w0 = np.random.default_rng(0).standard_normal(24 * 2048) * scale
    rate = np.exp(np.clip(w0, -8.0, 4.0))
    over = {c: float(np.mean(c * rate > np.log(np.finfo(np.float32).max)))
            for c in (16, 64)}
    assert 0.28 < over[64] < 0.31 and 0.001 < over[16] < 0.004, over


@pytest.mark.parametrize("s,clip_end", [(48, None), (48, "steep"),
                                        (48, "flat"), (1, None)])
def test_plain_backward_matches_jax_vjp(s, clip_end):
    """All five gradients of the plain version (autograd, through the
    backward kernel's wrapper on CPU tensors) against ``jax.vjp`` of the
    JAX serial oracle; at S = 1 the decay's gradient is zero."""
    r, k, v, wl, u = _inputs(2, s, 32, clip_end, seed=6)
    g = np.random.default_rng(7).standard_normal(r.shape, dtype=np.float32)
    _, vjp = jax.vjp(jref.rwkv6_reference,
                     *(jnp.asarray(x) for x in (r, k, v, wl, u)))
    expect = vjp(jnp.asarray(g))
    got = rwkv6_bwd(*(_t(x) for x in (r, k, v, wl, u, g)))
    for name, a, b in zip(("r", "k", "v", "w_log", "u"), got, expect):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32, name
        err = np.abs(_np(a) - b).max()
        assert err <= GRAD_REL * np.abs(b).max(), (name, err)


def test_wrappers_take_cpu_tensors_to_the_plain_version():
    r, k, v, wl, u = (_t(x) for x in _inputs(2, 20, 32, seed=8))
    before = rwkv6_fwd.launches, rwkv6_bwd.launches
    out = rwkv6_fwd(r, k, v, wl, u)
    torch.testing.assert_close(out, ref.rwkv6_reference(r, k, v, wl, u),
                               rtol=0, atol=0)
    rwkv6_bwd(r, k, v, wl, u, torch.ones_like(out))
    assert (rwkv6_fwd.launches, rwkv6_bwd.launches) == before


@pytest.mark.parametrize("case", ["rank", "u_shape", "mixed_dtype",
                                  "bf16_logw", "empty"])
def test_wrapper_rejects(case):
    r, k, v, wl, u = (_t(x) for x in _inputs(2, 16, 32, seed=9))
    err = ValueError
    if case == "rank":
        r = r[0]
    elif case == "u_shape":
        u = u[:1]
    elif case == "mixed_dtype":
        k, err = k.to(torch.bfloat16), TypeError
    elif case == "bf16_logw":
        wl, err = wl.to(torch.bfloat16), TypeError
    else:
        r, k, v, wl = (x[:, :0] for x in (r, k, v, wl))
    with pytest.raises(err):
        rwkv6_chunk(r, k, v, wl, u)


# ---------------------------------------------------------------------------
# Layers, on the f32 smoke config with the JAX parameters carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cfg():
    return configs.get_smoke(ARCH)


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(jconfigs.get_smoke(ARCH), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


@pytest.mark.parametrize("which", ["time_mix", "channel_mix", "block"])
def test_layer_matches_jax(cfg, jparams, params, which):
    x = np.random.default_rng(10).standard_normal(
        (2, 32, cfg.d_model), dtype=np.float32)
    jcfg = jconfigs.get_smoke(ARCH)
    jblock = jax.tree.map(lambda t: t[0], jparams["groups"]["slot0"])
    block = {k: _layer0(v) for k, v in params["groups"]["slot0"].items()}
    if which == "time_mix":
        expect, _ = JRW.rwkv_time_mix(jcfg, jblock["mix"], jnp.asarray(x))
        out = RW.rwkv_time_mix(cfg, block["mix"], _t(x))
    elif which == "channel_mix":
        expect, _ = JRW.rwkv_channel_mix(jcfg, jblock["mix"], jnp.asarray(x))
        out = RW.rwkv_channel_mix(cfg, block["mix"], _t(x))
    else:
        pos = jnp.arange(32)
        expect, _ = JM.block_apply(jcfg, "rwkv", jblock, jnp.asarray(x),
                                   positions=pos, moe_layer=False)
        out, _ = M.block_apply(cfg, "rwkv", block, _t(x),
                               positions=torch.arange(32), moe_layer=False)
    np.testing.assert_allclose(_np(out), np.asarray(expect), **LAYER_TOL)


def test_time_mix_refuses_ragged_sequence(cfg, params):
    block = {k: _layer0(v) for k, v in params["groups"]["slot0"].items()}
    with pytest.raises(ValueError, match="chunk 16"):
        RW.rwkv_time_mix(cfg, block["mix"], torch.zeros(1, 24, cfg.d_model))


def test_rwkv_decode_is_not_ported_yet(cfg):
    """Named when rwkv had no decode; it has one now, so this holds its
    cache to the reference's: the f32 recurrent state and the two
    token-shift rows, stacked per group
    (``tests/test_torch_rwkv_decode.py`` holds the values)."""
    mix = M.cache_defs(cfg, 2, 32)["groups"]["slot0"]["mix"]
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert {k: (v.shape, v.dtype) for k, v in mix.items()} == {
        "state": ((cfg.n_groups, 2, h, dh, dh), "float32"),
        "x_att": ((cfg.n_groups, 2, cfg.d_model), cfg.dtype),
        "x_ffn": ((cfg.n_groups, 2, cfg.d_model), cfg.dtype)}
