"""The port's llama-3.2-vision-11b against the JAX package's: parameter and
cache definitions (groups of four self-attention layers and one ``cross``
layer, whose ``cross.wk``/``cross.wv`` take the 7680-wide image embeddings),
the cross call's plain version against the reference's ``_sdpa`` with no
mask and its Pallas kernel in interpret mode at ``causal=False`` with
Sq != Skv, the forward with ``img_embed`` below and at the blocked-attention
threshold, the loss and every gradient (``cross.*`` and ``norm_c``
included), the remat policies' gradients, decode on both position clocks,
and the launchers and captures, which refuse where the JAX ones fail.

The f32 smoke config (5 layers: one group, d 64, 4/2 heads of 16, an image
of 17 rows of 48), parameters from ``repro.models.init_params`` carried
across by ``params_from_jax``, tokens and images (N(0, 1) x 0.1) from a
numpy seed.  Tolerances: the cross call 1e-6 (f32, summation order); logits
1e-5 of max|logits| at S 16 and 3.5e-5 at S 2048, where the self layers'
blocked attention sums in another order than the reference's (1.2e-5 of
max on these inputs; 0.90e-5 to 1.72e-5 over token and image seeds 1-6,
and the limit is twice the worst of them); the
loss 1e-5 relative and each gradient leaf ‖d‖/‖g‖ <= 1e-4; decode logits
1e-5 of max|logits| a step, and each cache leaf after 10 steps 1e-5 of its
max|.| (the cross layer's self-attention V reads 1.2e-5 against values up
to 4.4 after four layers of f32 rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as pallas_flash)
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.trace import capture as jcapture  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402
from repro_torch.trace import capture  # noqa: E402
from torch_parity import (as_np, both_params, check_decode,  # noqa: E402
                          check_defs, check_forward, check_loss_and_grads,
                          img_embed, tokens)

ARCH = "llama-3.2-vision-11b"
CROSS_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_REL = {16: 1e-5, 2048: 3.5e-5}
GRAD_REL = 1e-4
DECODE_REL = 1e-5


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
    check_defs(cfg, jcfg, batch=4, max_len=64)
    group = M.param_defs(cfg)["groups"]
    assert sorted(group) == [f"slot{i}" for i in range(5)]
    cross = group["slot4"]
    assert "cross" not in group["slot3"] and "norm_c" in cross
    assert cross["cross"]["wk"].shape == (cfg.n_groups, cfg.cross_attn_dim,
                                          cfg.n_kv_heads, cfg.head_dim)
    assert cross["attn"]["wk"].shape[1] == cfg.d_model
    # The cross block keeps its self attention's KV cache, nothing more.
    assert sorted(M.cache_defs(cfg, 4, 64)["groups"]["slot4"]) == ["attn"]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 4, 2, 16, 17, 16),          # the smoke config's cross call
    (1, 8, 2, 100, 161, 32),        # Sq > Skv, 161 keys: a ragged last tile
    (1, 4, 1, 40, 300, 64),         # Sq < Skv
])
def test_cross_attention_plain_matches_jax_sdpa_and_pallas(jcfg, b, hq, hkv,
                                                           sq, skv, d):
    """``ops.cross_attention``'s plain version (the CPU path) against the
    reference's ``_sdpa`` with ``mask=None`` (what its cross blocks run)
    and against the Pallas kernel in interpret mode at ``causal=False``."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    got = as_np(ops.cross_attention(*map(torch.from_numpy, (q, k, v))))
    sdpa = np.asarray(JL._sdpa(jcfg.replace(head_dim=d), *map(
        jnp.asarray, (q, k, v)), None))
    np.testing.assert_allclose(got, sdpa, **CROSS_TOL)
    pallas = np.asarray(pallas_flash(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal=False, block_q=64, block_k=64,
        interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, pallas, **CROSS_TOL)


def test_cross_attention_blocked_branch_matches_jax_sdpa(jcfg):
    """From 2048 query rows on, the plain path runs blocked by 512 rows;
    the reference's cross call stays one ``_sdpa``."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 2048, 4, 16), (1, 17, 2, 16), (1, 17, 2, 16)))
    got = as_np(ops.cross_attention(*map(torch.from_numpy, (q, k, v))))
    want = np.asarray(JL._sdpa(jcfg, *map(jnp.asarray, (q, k, v)), None))
    np.testing.assert_allclose(got, want, **CROSS_TOL)


@pytest.mark.parametrize("b,s", [(2, 16), (1, 2048)])
def test_forward_logits_match_jax(cfg, jcfg, both, b, s):
    """With ``img_embed``; at S 2048 the self layers' plain attention runs
    blocked, as the JAX model's does, and the cross call over 2048 rows."""
    jparams, params = both
    check_forward(cfg, jcfg, params, jparams, b, s, LOGIT_REL[s])


def test_forward_needs_img_embed(cfg, both):
    with pytest.raises(ValueError, match="img_embed"):
        M.forward(cfg, both[1], torch.from_numpy(tokens(cfg, 1, 8)))


def test_loss_and_every_gradient_match_jax(cfg, jcfg, both):
    jparams, params = both
    paths = check_loss_and_grads(cfg, jcfg, params, jparams, GRAD_REL)
    assert {"groups.slot4.cross.wq", "groups.slot4.cross.wk",
            "groups.slot4.cross.wv", "groups.slot4.cross.wo",
            "groups.slot4.norm_c.scale", "groups.slot4.attn.wk"} <= paths


def test_remat_gradients_bit_identical(cfg, both):
    """Every policy recomputes the cross call from the same image: the
    loss and every gradient equal the run without remat, bit for bit;
    ``names:cross_out`` saves the cross residual by its tag."""
    params = both[1]
    batch = {"tokens": torch.from_numpy(tokens(cfg, 2, 8, seed=3)),
             "img_embed": torch.from_numpy(img_embed(cfg, 2))}
    loss, grads = loss_and_grads(cfg.replace(remat="none"), params, batch)
    for remat in ("full", "dots", "dtr", "names:cross_out"):
        loss_r, grads_r = loss_and_grads(cfg.replace(remat=remat), params,
                                         batch)
        assert torch.equal(loss, loss_r), remat
        for (path, g), (_, g_r) in zip(tree_items(grads),
                                       tree_items(grads_r)):
            assert torch.equal(g, g_r), (remat, path)


@pytest.mark.parametrize("clock,start", [("per_slot", (0, 3, 5, 14)),
                                         ("scalar", (0, 0, 0, 0))])
def test_decode_steps_match_jax(cfg, jcfg, both, clock, start):
    """10 decode steps against ``decode_step`` with ``img_embed``: the
    cross blocks project the image's K/V every step."""
    jparams, params = both
    check_decode(cfg, jcfg, params, jparams, clock, start, 10, 24,
                 DECODE_REL, cache_rel=DECODE_REL)


def _port_surface(surface, tmp_path):
    if surface == "train launcher":
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                    "1", "--batch", "2", "--seq", "16", "--ckpt-dir",
                    str(tmp_path)])
    elif surface == "serve launcher":
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "2", "--slots", "2", "--gen", "2"])
    elif surface == "train capture":
        capture.capture_train_step(ARCH, smoke=True)
    else:
        capture.capture_serve_step(ARCH, smoke=True)


def _jax_surface(surface, tmp_path):
    if surface == "train launcher":
        jtrain.main(["--arch", ARCH, "--smoke", "--steps", "1", "--batch",
                     "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    elif surface == "serve launcher":
        jserve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                     "--slots", "2", "--gen", "2"])
    elif surface == "train capture":
        jcapture.capture_train_step(ARCH, smoke=True)
    else:
        jcapture.capture_serve_step(ARCH, smoke=True)


SURFACES = ["train launcher", "serve launcher", "train capture",
            "serve capture"]


@pytest.mark.parametrize("surface", SURFACES)
def test_port_surface_refuses_up_front(cfg, surface, tmp_path,
                                       monkeypatch):
    """The port refuses before it draws a weight, naming the reference's
    failure."""
    monkeypatch.setattr(M, "init_params", lambda *a: pytest.fail(
        "drew weights before refusing"))
    with pytest.raises(NotImplementedError, match="img_embed.*Size of label"):
        _port_surface(surface, tmp_path)


@pytest.mark.parametrize("surface", SURFACES)
def test_jax_surface_fails_too(surface, tmp_path, capsys):
    """What the refusal stands for: the reference's launcher or capture
    passes no ``img_embed`` and its cross block's einsum fails."""
    with pytest.raises(ValueError, match="Size of label 'd'"):
        _jax_surface(surface, tmp_path)
