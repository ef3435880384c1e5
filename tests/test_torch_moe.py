"""The port's mixtral pieces against the JAX package's: the grouped GEMM's
plain version, the expert-FFN adapter, MoE routing and dispatch, windowed
and ring-buffer attention, and the whole smoke model.

The f32 smoke config, with parameters made by ``repro.models.init_params``
and carried across by ``params_from_jax``; inputs made from a seed with
numpy.  Tolerances: the grouped GEMM uses the JAX package's own kernel
tolerances (f32 1e-4: summation order; bf16 3e-2: one rounding of the
output); per layer 1e-5 (the same f32 operations, summed in another order);
logits 1e-4 (three layers and a vocabulary projection of those differences).
"""
import dataclasses
import functools
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import ParamInfo  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gemm import moe_grouped_gemm  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_bwd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402

ARCH = "mixtral-8x7b"
GEMM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=3e-2, atol=3e-2)}
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernels.py's grouped-GEMM sweep: (e, c, d, f, bc, bf, bd)
GEMM_SHAPES = [
    (4, 128, 256, 128, 64, 64, 128),
    (8, 64, 128, 256, 64, 128, 64),
    (2, 256, 512, 64, 128, 64, 256),
    (1, 128, 128, 128, 128, 128, 128),
]


@pytest.fixture(scope="module")
def cfg():
    return configs.get_smoke(ARCH)


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(jconfigs.get_smoke(ARCH), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _group0(tree, key):
    """Layer 0's ``key`` block of a stacked parameter tree."""
    return {k: v[0] for k, v in tree["groups"]["slot0"][key].items()}


def _gemm_inputs(e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d), dtype=np.float32),
            rng.standard_normal((e, d, f), dtype=np.float32))


def _defs(tree, is_jax):
    if not is_jax:
        return {p: (i.shape, i.dtype, i.init_scale)
                for p, i in tree_items(tree)}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, ParamInfo))[0]
    return {".".join(k.key for k in kp): (i.shape, i.dtype, i.init_scale)
            for kp, i in leaves}


# ---------------------------------------------------------------------------
# (a) the grouped GEMM's plain version; the wrapper on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,bc,bf,bd", GEMM_SHAPES)
def test_plain_gemm_matches_jax_reference(e, c, d, f, bc, bf, bd, dtype):
    x, w = _gemm_inputs(e, c, d, f)
    out = ref.moe_gemm_reference(torch.from_numpy(x).to(TDT[dtype]),
                                 torch.from_numpy(w).to(TDT[dtype]))
    expect = jref.moe_gemm_reference(jnp.asarray(x).astype(JDT[dtype]),
                                     jnp.asarray(w).astype(JDT[dtype]))
    assert out.dtype == TDT[dtype] and out.shape == (e, c, f)
    np.testing.assert_allclose(_np(out), _np(expect), **GEMM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,bc,bf,bd", GEMM_SHAPES)
def test_plain_gemm_matches_pallas_interpret(e, c, d, f, bc, bf, bd, dtype):
    x, w = _gemm_inputs(e, c, d, f, seed=1)
    out = ref.moe_gemm_reference(torch.from_numpy(x).to(TDT[dtype]),
                                 torch.from_numpy(w).to(TDT[dtype]))
    expect = moe_grouped_gemm(jnp.asarray(x).astype(JDT[dtype]),
                              jnp.asarray(w).astype(JDT[dtype]),
                              block_c=bc, block_f=bf, block_d=bd,
                              interpret=True)
    np.testing.assert_allclose(_np(out), _np(expect), **GEMM_TOL[dtype])


def test_gemm_wrapper_takes_plain_version_for_cpu_tensors():
    x, w = (torch.from_numpy(a) for a in _gemm_inputs(3, 40, 200, 72))
    before = moe_gemm.launches
    out = moe_gemm(x, w)
    assert moe_gemm.launches == before   # no kernel launched
    torch.testing.assert_close(out, ref.moe_gemm_reference(x, w),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["rank", "experts", "contraction",
                                  "dtypes", "float16", "grad", "empty"])
def test_gemm_wrapper_rejects(case):
    x, w = (torch.from_numpy(a) for a in _gemm_inputs(2, 8, 16, 24))
    if case == "rank":
        x = x[0]
    elif case == "experts":
        w = w[:1]
    elif case == "contraction":
        w = w[:, :-1]
    elif case == "dtypes":
        w = w.to(torch.bfloat16)
    elif case == "float16":
        x, w = x.half(), w.half()
    elif case == "empty":
        x = x[:, :0]
    call = partial(moe_gemm, x, w)
    if case == "grad":
        # A gradient is taken (moe_gemm_bwd); one of the wrong shape is not.
        dy = torch.zeros(2, 8, 23)
        call = partial(moe_gemm_bwd, x.requires_grad_(), w, dy)
    before = moe_gemm.launches, moe_gemm_bwd.launches
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        call()
    assert (moe_gemm.launches, moe_gemm_bwd.launches) == before


# ---------------------------------------------------------------------------
# (b) the expert-FFN layout adapter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,e,c,d,f", [(3, 4, 8, 64, 96), (1, 8, 16, 32, 40)])
def test_expert_ffn_matches_jax_einsum(b, e, c, d, f):
    rng = np.random.default_rng(2)
    buf = rng.standard_normal((b, e, c, d), dtype=np.float32)
    w = rng.standard_normal((e, d, f), dtype=np.float32)
    out = ops.expert_ffn(torch.from_numpy(buf), torch.from_numpy(w))
    expect = jnp.einsum("becd,edf->becf", jnp.asarray(buf), jnp.asarray(w))
    assert out.shape == (b, e, c, f)
    np.testing.assert_allclose(_np(out), _np(expect), **GEMM_TOL["float32"])


# ---------------------------------------------------------------------------
# (c) routing, dispatch and combine
# ---------------------------------------------------------------------------

def _dropped(cfg, p, x):
    """How many assignments the port's dispatch drops on ``x``."""
    scores = torch.softmax(x.float() @ p["router"], dim=-1)
    topi = torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :cfg.top_k]
    b, s, _ = x.shape
    _, _, keep = MOE._dispatch(topi.reshape(b, s * cfg.top_k),
                               MOE.expert_capacity(cfg, s), cfg.n_experts)
    return int((~keep).sum())


@pytest.mark.parametrize("case,b,s,factor", [
    ("decode", 4, 1, None),
    ("overflow", 2, 32, 0.5),      # experts overflow: pins the slot C-1 quirk
    ("roomy", 2, 32, 16.0),        # every assignment fits
])
def test_moe_apply_matches_jax(cfg, params, jparams, case, b, s, factor):
    jcfg = jconfigs.get_smoke(ARCH)
    if factor is not None:
        cfg = cfg.replace(capacity_factor=factor)
        jcfg = jcfg.replace(capacity_factor=factor)
    x = np.random.default_rng(4).standard_normal((b, s, cfg.d_model),
                                                 dtype=np.float32)
    p = _group0(params, "ffn")
    out = MOE.moe_apply(cfg, p, torch.from_numpy(x))
    expect = JMOE.moe_apply(jcfg, _group0(jparams, "ffn"), jnp.asarray(x))
    assert out.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(_np(out), _np(expect), **LAYER_TOL)
    dropped = _dropped(cfg, p, torch.from_numpy(x))
    assert (dropped > 0) == (case == "overflow")


def test_dispatch_matches_jax_per_row():
    rng = np.random.default_rng(5)
    e_flat = rng.integers(0, 4, (3, 40)).astype(np.int32)
    order, slot, keep = MOE._dispatch(torch.from_numpy(e_flat).long(), 8, 4)
    for row in range(3):
        jo, js, jk = JMOE._dispatch_row(jnp.asarray(e_flat[row]), 8, 4)
        np.testing.assert_array_equal(order[row].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(slot[row].numpy(), np.asarray(js))
        np.testing.assert_array_equal(keep[row].numpy(), np.asarray(jk))
    assert not keep.all()


@pytest.mark.parametrize("tokens", [1, 32, 2048])
def test_expert_capacity_matches_jax(cfg, tokens):
    jcfg = jconfigs.get_smoke(ARCH)
    assert MOE.expert_capacity(cfg, tokens) == \
        JMOE.expert_capacity(jcfg, tokens)
    full = configs.get(ARCH)
    assert MOE.expert_capacity(full, tokens) == \
        JMOE.expert_capacity(jconfigs.get(ARCH), tokens)


def test_shared_experts_not_ported(cfg, jparams):
    """Named when shared experts were refused; they are ported now.  One
    shared expert (deepseek's form: a SwiGLU MLP of ``n_shared_experts *
    moe_d_ff``, added to the routed output, with the sigmoid router and
    renormalised top-k weights) against JAX's on the same parameters."""
    deep = cfg.replace(n_shared_experts=1)
    jdeep = jconfigs.get_smoke(ARCH).replace(n_shared_experts=1)
    defs = MOE.moe_defs(deep)
    assert _defs(defs, False) == {
        k: (tuple(s), d, i) for k, (s, d, i) in
        _defs(JMOE.moe_defs(jdeep), True).items()}
    f = deep.moe_d_ff or deep.d_ff
    assert defs["shared"]["wi"].shape == (deep.d_model, f)
    rng = np.random.default_rng(8)
    jp = {**_group0(jparams, "ffn"), "shared": {
        k: jnp.asarray(rng.standard_normal(i.shape, dtype=np.float32) * 0.1)
        for k, i in defs["shared"].items()}}
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    x = rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    out = MOE.moe_apply(deep, p, torch.from_numpy(x))
    expect = JMOE.moe_apply(jdeep, jp, jnp.asarray(x))
    np.testing.assert_allclose(_np(out), _np(expect), **LAYER_TOL)
    routed = MOE.moe_apply(cfg, p, torch.from_numpy(x))
    assert not np.allclose(_np(out), _np(routed))


# ---------------------------------------------------------------------------
# (d) sliding-window attention and ring-buffer decode
# ---------------------------------------------------------------------------

def test_windowed_attention_matches_jax(cfg, params, jparams):
    s = 20                                   # longer than the window (8)
    x = np.random.default_rng(6).standard_normal((2, s, cfg.d_model),
                                                 dtype=np.float32)
    y, c = L.attention_apply(cfg, _group0(params, "attn"),
                             torch.from_numpy(x), positions=torch.arange(s),
                             window=cfg.window)
    jy, _ = JL.attention_apply(cfg, _group0(jparams, "attn"), jnp.asarray(x),
                               positions=jnp.arange(s), window=cfg.window)
    assert c is None
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)


def test_ring_buffer_decode_matches_jax(cfg, params, jparams):
    """20 per-slot decode steps against an 8-row ring: every slot wraps."""
    rng = np.random.default_rng(7)
    b, length = 3, cfg.window
    shape = (b, length, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    p, jp = _group0(params, "attn"), _group0(jparams, "attn")
    pos = np.array([0, 5, 11], np.int32)
    for _ in range(20):
        x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
        y, c = L.attention_apply(
            cfg, p, torch.from_numpy(x),
            positions=torch.from_numpy(pos)[:, None], window=cfg.window,
            cache={**cache, "pos": torch.from_numpy(pos)})
        jy, jc = JL.attention_apply(
            cfg, jp, jnp.asarray(x), positions=jnp.asarray(pos)[:, None],
            window=cfg.window, cache={**jcache, "pos": jnp.asarray(pos)})
        np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(c[n]), _np(jc[n]), **LAYER_TOL)
        np.testing.assert_array_equal(c["pos"].numpy(), pos + 1)
        cache = {"k": c["k"], "v": c["v"]}
        jcache = {"k": jc["k"], "v": jc["v"]}
        pos = pos + 1
    assert pos.min() > 2 * length


# ---------------------------------------------------------------------------
# (e) the whole smoke model; defs, conversion and casting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_mixtral_defs_match_jax(full):
    """Parameters, and ring caches of min(max_len, window) rows for a
    max_len past the window and one short of it."""
    get = "get" if full else "get_smoke"
    cfg, jcfg = getattr(configs, get)(ARCH), getattr(jconfigs, get)(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert _defs(M.param_defs(cfg), False) == \
        _defs(JM.param_defs(jcfg), True)
    for max_len in (cfg.window + 8, cfg.window - 3):
        mine = _defs(M.cache_defs(cfg, 3, max_len), False)
        assert mine == _defs(JM.cache_defs(jcfg, 3, max_len), True)
        assert mine["groups.slot0.attn.k"][0][2] == min(max_len, cfg.window)


def test_params_from_jax_carries_mixtral(cfg, params):
    ffn = params["groups"]["slot0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["router"].shape == (cfg.n_groups, cfg.d_model, cfg.n_experts)
    assert ffn["wi"].shape == (cfg.n_groups, cfg.n_experts, cfg.d_model,
                               cfg.moe_d_ff)
    assert ffn["wo"].shape == (cfg.n_groups, cfg.n_experts, cfg.moe_d_ff,
                               cfg.d_model)
    assert params["embed"]["unembed"].shape == (cfg.d_model, cfg.vocab)


def test_prepare_params_keeps_router_f32(cfg, params):
    bf = M.prepare_params(cfg.replace(dtype="bfloat16"), params)
    ffn = bf["groups"]["slot0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["wi"].dtype == torch.bfloat16
    assert bf["embed"]["unembed"].dtype == torch.bfloat16


def test_mixtral_forward_matches_jax(cfg, params, jparams):
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 19),
                                               dtype=np.int32)
    logits = M.forward(cfg, params, torch.from_numpy(tokens))
    expect = JM.forward(jconfigs.get_smoke(ARCH), jparams,
                        jnp.asarray(tokens))
    assert logits.shape == (2, 19, cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(expect), **LOGIT_TOL)


def test_mixtral_decode_steps_match_jax(cfg, params, jparams):
    """12 per-slot decode steps past the ring's wrap; slot 2 runs on, idle,
    past max_len."""
    b, max_len = 3, 10
    jcfg = jconfigs.get_smoke(ARCH)
    jstep = jax.jit(functools.partial(JM.decode_step, jcfg))
    cache = M.init_cache(cfg, b, max_len, "cpu")
    jcache = JM.init_cache(jcfg, b, max_len)
    pos = np.array([0, 3, 6], np.int32)
    rng = np.random.default_rng(9)
    for _ in range(12):
        tok = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
        logits, cache = M.decode_step(cfg, params, torch.from_numpy(tok),
                                      cache, torch.from_numpy(pos.copy()))
        jlogits, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        np.testing.assert_allclose(_np(logits), _np(jlogits), **LOGIT_TOL)
        pos += 1
    assert pos[2] > max_len
    for n in ("k", "v"):
        np.testing.assert_allclose(
            _np(cache["groups"]["slot0"]["attn"][n]),
            _np(jcache["groups"]["slot0"]["attn"][n]), **LOGIT_TOL)
