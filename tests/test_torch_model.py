"""The port's qwen2 layers and model against the JAX package's.

The f32 smoke config, with parameters made by ``repro.models.init_params``
and carried across by ``params_from_jax``; inputs made from a seed with
numpy.  Tolerances: 1e-5 per layer (the same f32 operations, summed in
another order), 1e-4 on logits (three layers and a vocabulary projection of
those differences).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import ParamInfo  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def cfg():
    return configs.get_smoke(ARCH)


@pytest.fixture(scope="module")
def jparams(cfg):
    return JM.init_params(jconfigs.get_smoke(ARCH), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _group0(tree, key):
    """Layer 0's ``key`` block of a stacked parameter tree."""
    return {k: v[0] for k, v in tree["groups"]["slot0"][key].items()}


@pytest.mark.parametrize("full", [False, True])
def test_config_and_defs_match_jax(full):
    get = "get" if full else "get_smoke"
    cfg, jcfg = getattr(configs, get)(ARCH), getattr(jconfigs, get)(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    mine = {p: (i.shape, i.dtype, i.init_scale)
            for p, i in tree_items(M.param_defs(cfg))}
    theirs = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        JM.param_defs(jcfg), is_leaf=lambda x: isinstance(x, ParamInfo))[0]
    for kp, i in leaves:
        path = ".".join(k.key for k in kp)
        theirs[path] = (i.shape, i.dtype, i.init_scale)
    assert mine == theirs
    assert {p: (i.shape, i.dtype) for p, i in
            tree_items(M.cache_defs(cfg, 3, 16))} == {
        ".".join(k.key for k in kp): (i.shape, i.dtype) for kp, i in
        jax.tree_util.tree_flatten_with_path(
            JM.cache_defs(jcfg, 3, 16),
            is_leaf=lambda x: isinstance(x, ParamInfo))[0]}


def test_init_params_scale_rule(cfg):
    g = torch.Generator().manual_seed(0)
    p = M.init_params(cfg, g)
    assert torch.count_nonzero(p["final_norm"]["scale"]) == 0
    assert torch.count_nonzero(p["groups"]["slot0"]["attn"]["bq"]) == 0
    wq = p["groups"]["slot0"]["attn"]["wq"]          # fan = head_dim
    assert abs(wq.std().item() * np.sqrt(cfg.head_dim) - 1) < 0.1
    assert abs(p["embed"]["tokens"].std().item() - 1) < 0.05  # scale 1.0
    again = M.init_params(cfg, torch.Generator().manual_seed(0))
    for (_, a), (_, b) in zip(tree_items(p), tree_items(again)):
        assert torch.equal(a, b)


def test_params_from_jax_checks_shapes(cfg, jparams):
    tree = jax.tree.map(np.asarray, jparams)
    tree["embed"]["tokens"] = tree["embed"]["tokens"][:, :-1]
    with pytest.raises(ValueError, match="embed.tokens"):
        params_from_jax(tree, cfg, "cpu")
    tree = jax.tree.map(np.asarray, jparams)
    del tree["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(tree, cfg, "cpu")


def test_rmsnorm_matches_jax(cfg, params, jparams):
    x = np.random.default_rng(0).standard_normal((2, 5, cfg.d_model),
                                                 dtype=np.float32)
    scale = np.random.default_rng(1).standard_normal(cfg.d_model,
                                                     dtype=np.float32)
    out = L.rmsnorm_apply(cfg, {"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x))
    expect = JL.rmsnorm_apply(cfg, {"scale": jnp.asarray(scale)},
                              jnp.asarray(x))
    np.testing.assert_allclose(_np(out), _np(expect), **LAYER_TOL)


@pytest.mark.parametrize("positions", ["sequence", "per_slot"])
def test_rope_matches_jax(cfg, positions):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6, 4, cfg.head_dim), dtype=np.float32)
    if positions == "sequence":
        pos = np.arange(6, dtype=np.int32)
    else:   # decode-shaped: [B, 1] clocks near and past max_len
        x = x[:, :1]
        pos = np.array([[0], [126], [131]], np.int32)
    out = L.rope(torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta)
    expect = JL.rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta)
    np.testing.assert_allclose(_np(out), _np(expect), **LAYER_TOL)


def test_attention_full_sequence_matches_jax(cfg, params, jparams):
    x = np.random.default_rng(3).standard_normal((2, 7, cfg.d_model),
                                                 dtype=np.float32)
    p = _group0(params, "attn")
    jp = _group0(jparams, "attn")
    y, c = L.attention_apply(cfg, p, torch.from_numpy(x),
                             positions=torch.arange(7))
    jy, _ = JL.attention_apply(cfg, jp, jnp.asarray(x),
                               positions=jnp.arange(7))
    assert c is None
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)


def test_attention_decode_matches_jax(cfg, params, jparams):
    """Per-slot decode, one slot past the cache end (its write is dropped)."""
    rng = np.random.default_rng(4)
    b, length = 3, 6
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    k = rng.standard_normal((b, length, cfg.n_kv_heads, cfg.head_dim),
                            dtype=np.float32)
    v = rng.standard_normal(k.shape, dtype=np.float32)
    pos = np.array([0, 4, 7], np.int32)
    p = _group0(params, "attn")
    jp = _group0(jparams, "attn")
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "pos": torch.from_numpy(pos)}
    y, c = L.attention_apply(cfg, p, torch.from_numpy(x),
                             positions=torch.from_numpy(pos)[:, None],
                             cache=cache)
    jy, jc = JL.attention_apply(
        cfg, jp, jnp.asarray(x), positions=jnp.asarray(pos)[:, None],
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
               "pos": jnp.asarray(pos)})
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(c[n]), _np(jc[n]), **LAYER_TOL)
    np.testing.assert_array_equal(_np(c["k"][2]), k[2])   # dropped write
    np.testing.assert_array_equal(_np(c["pos"]), pos + 1)


def test_mlp_matches_jax(cfg, params, jparams):
    x = np.random.default_rng(5).standard_normal((2, 5, cfg.d_model),
                                                 dtype=np.float32)
    p = _group0(params, "ffn")
    jp = _group0(jparams, "ffn")
    np.testing.assert_allclose(
        _np(L.mlp_apply(cfg, p, torch.from_numpy(x))),
        _np(JL.mlp_apply(cfg, jp, jnp.asarray(x))), **LAYER_TOL)


def test_embed_unembed_match_jax(cfg, params, jparams):
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 5),
                                               dtype=np.int32)
    x = L.embed_apply(cfg, params["embed"], torch.from_numpy(tokens))
    jx = JL.embed_apply(cfg, jparams["embed"], jnp.asarray(tokens))
    np.testing.assert_allclose(_np(x), _np(jx), **LAYER_TOL)
    np.testing.assert_allclose(
        _np(L.unembed_apply(cfg, params["embed"], x)),
        _np(JL.unembed_apply(cfg, jparams["embed"], jx)), **LAYER_TOL)


def test_forward_logits_match_jax(cfg, params, jparams):
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 11),
                                               dtype=np.int32)
    logits = M.forward(cfg, params, torch.from_numpy(tokens))
    expect = JM.forward(jconfigs.get_smoke(ARCH), jparams,
                        jnp.asarray(tokens))
    assert logits.shape == (2, 11, cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(expect), **LOGIT_TOL)


def test_decode_steps_match_jax(cfg, params, jparams):
    """Eight per-slot decode steps; slot 2's clock runs past max_len."""
    b, max_len = 3, 6
    jcfg = jconfigs.get_smoke(ARCH)
    jstep = jax.jit(functools.partial(JM.decode_step, jcfg))
    cache = M.init_cache(cfg, b, max_len, "cpu")
    jcache = JM.init_cache(jcfg, b, max_len)
    pos = np.array([0, 2, 4], np.int32)
    rng = np.random.default_rng(8)
    for _ in range(8):
        tok = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
        logits, cache = M.decode_step(cfg, params, torch.from_numpy(tok),
                                      cache, torch.from_numpy(pos.copy()))
        jlogits, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        np.testing.assert_allclose(_np(logits), _np(jlogits), **LOGIT_TOL)
        pos += 1
    assert pos[2] > max_len + 1
    for n in ("k", "v"):
        np.testing.assert_allclose(
            _np(cache["groups"]["slot0"]["attn"][n]),
            _np(jcache["groups"]["slot0"]["attn"][n]), **LOGIT_TOL)


def test_prepare_params_casts_once(cfg, params):
    bf = M.prepare_params(cfg.replace(dtype="bfloat16"), params)
    assert bf["groups"]["slot0"]["attn"]["wq"].dtype == torch.bfloat16
    assert bf["embed"]["tokens"].dtype == torch.bfloat16
    assert bf["final_norm"]["scale"].dtype == torch.float32
    assert bf["groups"]["slot0"]["norm1"]["scale"].dtype == torch.float32
    same = M.prepare_params(cfg, params)      # f32 smoke: nothing to cast
    assert same["embed"]["tokens"] is params["embed"]["tokens"]


def test_unsupported_configs_raise():
    """What the model refuses: a block kind the reference has not.
    Attention-logit soft-capping is accepted (tests/test_torch_softcap.py
    holds it to the reference); codebook embeddings and cross blocks are
    ported (tests/test_torch_musicgen.py, tests/test_torch_vision.py), as
    are mixed patterns and a tail stack
    (``test_mixed_pattern_and_tail_stack``)."""
    base = configs.get_smoke(ARCH)
    with pytest.raises(NotImplementedError, match="pattern"):
        M.param_defs(base.replace(pattern=("mamba",)))
    capped = base.replace(logit_softcap=50.0)
    assert M.param_defs(capped).keys() == M.param_defs(base).keys()
    params = M.init_params(capped, torch.Generator().manual_seed(0))
    out = M.forward(capped, params, torch.zeros(1, 4, dtype=torch.int32))
    assert out.shape == (1, 4, capped.vocab) and torch.isfinite(out).all()
    codebooks = M.param_defs(base.replace(n_codebooks=4))["embed"]
    assert codebooks["tokens"].shape == (4, base.vocab, base.d_model)
    cross = base.replace(pattern=("attn", "cross"), n_layers=4,
                         cross_attn_tokens=16, cross_attn_dim=32)
    wk = M.param_defs(cross)["groups"]["slot1"]["cross"]["wk"]
    assert wk.shape == (cross.n_groups, 32, base.n_kv_heads, base.head_dim)


@pytest.mark.parametrize("change,stacks", [
    (dict(pattern=("attn_local", "attn"), n_layers=4), {"groups": 2}),
    (dict(tail=("attn",), n_layers=3), {"groups": 2, "tail": 1}),
    (dict(pattern=("attn", "rglru"), tail=("rglru",), n_layers=5,
          lru_width=32), {"groups": 2, "tail": 1}),
])
def test_mixed_pattern_and_tail_stack(change, stacks):
    """Groups that mix block kinds and a one-group ``tail`` stack: each
    stack's leaves lead with its group count, and the forward runs."""
    cfg = configs.get_smoke(ARCH).replace(**change)
    defs = M.param_defs(cfg)
    assert {s: defs[s]["slot0"]["norm1"]["scale"].shape[0]
            for s in ("groups", "tail") if s in defs} == stacks
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    out = M.forward(cfg, params, torch.zeros(1, 4, dtype=torch.int32))
    assert out.shape == (1, 4, cfg.vocab) and torch.isfinite(out).all()
