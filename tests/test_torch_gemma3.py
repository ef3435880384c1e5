"""The port's gemma3-1b against the JAX package's: parameter and cache
definitions (four groups of five local and one global layer, then a tail
of two local layers, stacked ``[1, ...]``), the gemma embedding scale, the
GeGLU MLP with ``jax.nn.gelu``'s tanh form, the forward below and at the
blocked-attention threshold, the loss and every gradient, decode through
the local layers' ring on both position clocks, and the serve launcher
with ``--capture`` against the JAX launcher.

The f32 smoke config (8 layers: one group and the tail, d 48, 2/1 heads of
24, window 8), parameters from ``repro.models.init_params`` carried across
by ``params_from_jax``, tokens from a numpy seed.  Tolerances: logits
1e-4; the loss 1e-5 relative and each gradient leaf ‖d‖/‖g‖ <= 1e-4; decode
logits 1e-5 of max|logits| a step; the embedding and the MLP 1e-6.
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
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402
from torch_parity import (as_np, both_params, check_decode,  # noqa: E402
                          check_defs, check_forward, check_loss_and_grads,
                          check_served, serve_both, tokens)

ARCH = "gemma3-1b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-4
DECODE_REL = 1e-5
SERVE = ["--arch", ARCH, "--smoke", "--requests", "8", "--slots", "4",
         "--gen", "8", "--max-len", "32", "--kv-budget", "0.3",
         "--chaos-shrink", "0.5", "--chaos-period", "16"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return configs.get_smoke(ARCH)


@pytest.fixture(scope="module")
def jcfg():
    return jconfigs.get_smoke(ARCH)


@pytest.fixture(scope="module")
def both(cfg, jcfg):
    return both_params(cfg, jcfg)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_and_cache_defs_equal_jax(smoke):
    get = configs.get_smoke if smoke else configs.get
    jget = jconfigs.get_smoke if smoke else jconfigs.get
    cfg, jcfg = get(ARCH), jget(ARCH)
    check_defs(cfg, jcfg, batch=4, max_len=1024)
    defs = M.param_defs(cfg)
    assert defs["tail"]["slot0"]["attn"]["wq"].shape[0] == 1
    assert sorted(defs["tail"]) == ["slot0", "slot1"]
    assert sorted(defs["groups"]) == [f"slot{i}" for i in range(6)]
    caches = M.cache_defs(cfg, 4, 1024)
    ring = min(1024, cfg.window)
    # local layers keep a ring of the window; the global one all rows
    assert caches["groups"]["slot0"]["attn"]["k"].shape[2] == ring
    assert caches["groups"]["slot5"]["attn"]["k"].shape[2] == 1024
    assert caches["tail"]["slot1"]["attn"]["k"].shape[:3] == (1, 4, ring)
    assert [s for s, _, _ in M._stacks(cfg)] == ["groups", "tail"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_scale_matches_jax(cfg, jcfg, both, dtype):
    """The token rows times sqrt(d_model), the factor rounded to the
    activation dtype first (sqrt(48) = 6.93 is 6.9375 in bf16)."""
    jparams, params = both
    toks = tokens(cfg, 2, 8)
    c, jc = cfg.replace(dtype=dtype), jcfg.replace(dtype=dtype)
    got = L.embed_apply(c, params["embed"], torch.from_numpy(toks))
    want = JM._embed(jc, jparams["embed"], jnp.asarray(toks))
    np.testing.assert_allclose(as_np(got), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)
    plain = params["embed"]["tokens"][torch.from_numpy(toks).long()]
    ratio = (got.float() / plain.to(got.dtype).float()).flatten()
    factor = float(torch.tensor(np.sqrt(cfg.d_model), dtype=got.dtype))
    assert torch.allclose(ratio[plain.flatten() != 0],
                          torch.tensor(factor), rtol=1e-2)


def test_mlp_gelu_matches_jax_tanh_form(cfg, jcfg, both):
    """``mlp_act`` gelu is ``jax.nn.gelu``'s default, the tanh
    approximation: the port matches JAX within 1e-6, while the exact erf
    form sits farther from it than that."""
    jparams, params = both
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32) * 3
    p = params["groups"]["slot0"]["ffn"]
    jp = jax.tree.map(lambda t: t[0], jparams["groups"])["slot0"]["ffn"]
    got = L.mlp_apply(cfg, {k: v[0] for k, v in p.items()},
                      torch.from_numpy(x))
    want = np.asarray(JL.mlp_apply(jcfg, jp, jnp.asarray(x)))
    np.testing.assert_allclose(as_np(got), want, rtol=1e-6, atol=1e-6)
    t = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(as_np(L.gelu(t)),
                               np.asarray(jax.nn.gelu(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(t)
    assert (erf - L.gelu(t)).abs().max() > 1e-4


@pytest.mark.parametrize("b,s", [(2, 16), (1, 2048)])
def test_forward_logits_match_jax(cfg, jcfg, both, b, s):
    """S 16: every layer's attention in one piece; S 2048 (the blocked
    threshold): the plain attention blocked by 512 query rows, as the JAX
    model's is, in the local and the global layers."""
    jparams, params = both
    check_forward(cfg, jcfg, params, jparams, b, s, LOGIT_TOL)


def test_loss_and_every_gradient_match_jax(cfg, jcfg, both):
    jparams, params = both
    paths = check_loss_and_grads(cfg, jcfg, params, jparams, GRAD_REL)
    assert "tail.slot1.attn.wq" in paths and "groups.slot5.ffn.wg" in paths


def test_remat_gradients_bit_identical(cfg, both):
    """The tail is a checkpointed group like the others."""
    params = both[1]
    toks = {"tokens": torch.from_numpy(tokens(cfg, 2, 8, seed=3))}
    loss, grads = loss_and_grads(cfg, params, toks)
    for remat in ("full", "dtr"):
        loss_r, grads_r = loss_and_grads(cfg.replace(remat=remat), params,
                                         toks)
        assert torch.equal(loss, loss_r)
        for (path, g), (_, g_r) in zip(tree_items(grads),
                                       tree_items(grads_r)):
            assert torch.equal(g, g_r), (remat, path)


@pytest.mark.parametrize("clock,start", [("per_slot", (0, 3, 5, 14)),
                                         ("scalar", (0, 0, 0, 0))])
def test_decode_steps_match_jax(cfg, jcfg, both, clock, start):
    """12 decode steps: the local layers' 8-row rings wrap (positions past
    7), the global layer's 24-row cache fills; per-slot clocks at
    different positions, or one shared clock."""
    jparams, params = both
    cache = check_decode(cfg, jcfg, params, jparams, clock, start, 12, 24,
                         DECODE_REL)
    assert cache["tail"]["slot0"]["attn"]["k"].shape[2] == cfg.window


@pytest.fixture(scope="module")
def served(tmp_path_factory, cfg):
    return serve_both(cfg, SERVE, tmp_path_factory.mktemp("gemma3"))


def test_serve_matches_jax_launcher(served):
    """Under a KV budget with chaos squeezes, so that slots are preempted
    and their rings zeroed: the same tokens, counters, events, printed
    lines and a byte-identical ``--capture`` log."""
    check_served(*served)
