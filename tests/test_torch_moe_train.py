"""The MoE train path against the JAX package: the grouped GEMM's gradient
(autograd through the plain version on the CPU, and ``moe_gemm_bwd``'s
plain formula) against ``jax.vjp`` of the reference's plain version; the
MoE layer's gradients, the duplicate-slot case included, and the router's
alone; ``aux_load_balance_loss``; and the mixtral smoke model's loss,
every gradient and three AdamW steps, with and without experts that
overflow.

The f32 smoke config, parameters from ``repro.models.init_params`` carried
across by ``params_from_jax``, inputs drawn from a numpy seed.  Tolerances:
the grouped GEMM's gradients 1e-4 (the kernel tolerance, f32); the loss
1e-5 relative; each gradient leaf ‖d‖/‖g‖ <= 1e-4; parameters after three
AdamW steps (eps 1e-3, as ``tests/test_torch_train.py`` takes it) 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_bwd,  # noqa: E402
                                          moe_gemm_bwd_reference)
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402

ARCH = "mixtral-8x7b"
GEMM_REL = 1e-4
GRAD_REL = 1e-4
ADAM_EPS = 1e-3
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py's grouped-GEMM sweep (e, c, d, f), then a ragged one
# and mixtral's smoke expert shape.
GEMM_SHAPES = [(4, 128, 256, 128), (8, 64, 128, 256), (2, 256, 512, 64),
               (1, 128, 128, 128), (3, 40, 200, 72), (8, 16, 64, 96)]
FACTORS = {"roomy": None, "overflow": 0.5}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(JM.init_params, static_argnums=0)(
        jconfigs.get_smoke(ARCH), jax.random.PRNGKey(0))


def _configs(case):
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    if FACTORS[case] is not None:
        cfg = cfg.replace(capacity_factor=FACTORS[case])
        jcfg = jcfg.replace(capacity_factor=FACTORS[case])
    return cfg, jcfg


def _port(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(_np(a) - _np(b))
                 / max(np.linalg.norm(_np(b)), 1e-30))


def _assert_leaves(grads, jgrads):
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree_items(grads))
    assert flat.keys() == jflat.keys()
    for path, g in flat.items():
        assert g.shape == jflat[path].shape and g.dtype == torch.float32
        assert _rel(g, jflat[path]) <= GRAD_REL, (path, _rel(g, jflat[path]))


# ---------------------------------------------------------------------------
# (a) the grouped GEMM's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES)
def test_gemm_gradient_matches_jax_vjp(e, c, d, f):
    rng = np.random.default_rng(e * c + d)
    x = rng.standard_normal((e, c, d), dtype=np.float32)
    w = rng.standard_normal((e, d, f), dtype=np.float32)
    dy = rng.standard_normal((e, c, f), dtype=np.float32)
    _, vjp = jax.vjp(jref.moe_gemm_reference, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    before = moe_gemm.launches, moe_gemm_bwd.launches
    dx, dw = torch.autograd.grad(moe_gemm(tx, tw), (tx, tw),
                                 torch.from_numpy(dy))
    assert (moe_gemm.launches, moe_gemm_bwd.launches) == before
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want)
        assert np.abs(_np(got) - want).max() <= GEMM_REL * np.abs(want).max()
    # The backward's own plain formula gives the same numbers.
    bx, bw = moe_gemm_bwd(*(torch.from_numpy(a) for a in (x, w, dy)))
    torch.testing.assert_close(bx, dx, rtol=1e-5, atol=1e-5 * float(
        dx.abs().max()))
    torch.testing.assert_close(bw, dw, rtol=1e-5, atol=1e-5 * float(
        dw.abs().max()))


def test_gemm_bwd_reference_dtypes_and_needs():
    rng = np.random.default_rng(3)
    x, w, dy = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(torch.bfloat16) for s in ((2, 8, 16), (2, 16, 24),
                                              (2, 8, 24)))
    dx, dw = moe_gemm_bwd_reference(x, w, dy)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert dx.shape == x.shape and dw.shape == w.shape
    only_x = moe_gemm_bwd_reference(x, w, dy, need=(True, False))
    assert only_x[1] is None and torch.equal(only_x[0], dx)
    with torch.enable_grad():
        xs = [t.detach().float().requires_grad_() for t in (x, w)]
        gx, gw = torch.autograd.grad(ref.moe_gemm_reference(*xs), xs,
                                     dy.float())
    torch.testing.assert_close(dx, gx.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(dw, gw.to(torch.bfloat16), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (b) the MoE layer's gradients, the router's, the auxiliary loss
# ---------------------------------------------------------------------------

def _layer0_ffn(tree):
    return {k: v[0] for k, v in tree["groups"]["slot0"]["ffn"].items()}


@pytest.mark.parametrize("case", sorted(FACTORS))
def test_moe_layer_gradients_match_jax(jparams, case):
    """Input, router and expert gradients of one MoE layer.  With
    ``overflow`` some experts drop assignments: JAX's scatter-set lets only
    the winning (dropped, zero) write of the duplicate slot C-1 take a
    gradient, and the port zeroes that slot; both send the token kept at
    rank C-1 no gradient through its expert."""
    cfg, jcfg = _configs(case)
    x = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model),
                                                 dtype=np.float32)
    g = np.random.default_rng(5).standard_normal(x.shape, dtype=np.float32)
    jp = _layer0_ffn(jparams)
    jdx, jdp = jax.jit(lambda xx, pp, gg: jax.vjp(
        lambda x_, p_: JMOE.moe_apply(jcfg, p_, x_), xx, pp)[1](gg))(
        jnp.asarray(x), jp, jnp.asarray(g))
    p = {k: v.detach().requires_grad_() for k, v in
         _layer0_ffn(_port(jparams, cfg)).items()}
    tx = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        out = MOE.moe_apply(cfg, p, tx)
        grads = torch.autograd.grad(out, [tx, *p.values()],
                                    torch.from_numpy(g))
    assert _rel(grads[0], jdx) <= GRAD_REL
    for (k, _), got in zip(p.items(), grads[1:]):
        assert _rel(got, jdp[k]) <= GRAD_REL, (k, _rel(got, jdp[k]))
    scores = torch.softmax(torch.from_numpy(x) @ p["router"].detach(), -1)
    topi = torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :cfg.top_k]
    _, _, keep = MOE._dispatch(topi.reshape(2, -1),
                               MOE.expert_capacity(cfg, 32), cfg.n_experts)
    assert bool((~keep).any()) == (case == "overflow")


def test_router_gradient_alone_matches_jax(jparams):
    """The combine weights reach the router through top-k (a stable sort
    and a slice against ``lax.top_k``): the router's gradient of a loss on
    the layer's output, with every other leaf held."""
    cfg, jcfg = _configs("roomy")
    x = np.random.default_rng(6).standard_normal((3, 16, cfg.d_model),
                                                 dtype=np.float32)
    jp = _layer0_ffn(jparams)

    def jloss(router):
        return jnp.sum(JMOE.moe_apply(jcfg, {**jp, "router": router},
                                      jnp.asarray(x)) ** 2)

    want = np.asarray(jax.jit(jax.grad(jloss))(jp["router"]))
    p = _layer0_ffn(_port(jparams, cfg))
    router = p["router"].detach().requires_grad_()
    with torch.enable_grad():
        loss = torch.sum(MOE.moe_apply(cfg, {**p, "router": router},
                                       torch.from_numpy(x)) ** 2)
        (got,) = torch.autograd.grad(loss, router)
    assert _rel(got, want) <= GRAD_REL


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_aux_load_balance_loss_matches_jax(arch):
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts),
                                 dtype=np.float32)
    want = JMOE.aux_load_balance_loss(jcfg, jnp.asarray(x),
                                      {"router": jnp.asarray(router)})
    got = MOE.aux_load_balance_loss(cfg, torch.from_numpy(x),
                                    {"router": torch.from_numpy(router)})
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) the mixtral smoke model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(FACTORS))
def test_loss_and_grads_match_jax(jparams, case):
    cfg, jcfg = _configs(case)
    tokens = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=2,
                         seed=1).batch_at(0)["tokens"]
    batch = {"tokens": jnp.asarray(tokens)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch)))(jparams)
    loss, grads = loss_and_grads(cfg, _port(jparams, cfg),
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_leaves(grads, jgrads)


def test_adamw_steps_match_jax(jparams):
    """Three steps of value-and-grad, clipping at 1.0 and AdamW with the
    cosine schedule, experts overflowing: losses, gradient norms and the
    parameters after the last step."""
    cfg, jcfg = _configs("overflow")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=2, seed=0)
    jopt = joptim.adamw(lr=joptim.cosine_schedule(1e-3, warmup=1, total=3),
                        eps=ADAM_EPS)
    opt = optim.adamw(lr=optim.cosine_schedule(1e-3, warmup=1, total=3),
                      eps=ADAM_EPS)
    jstep = jax.jit(jmake_train_step(jcfg, jopt))
    step = make_train_step(cfg, opt)
    jp, jstate = jparams, jopt.init(jparams)
    params = _port(jparams, cfg)
    state = opt.init(params)
    for i in range(3):
        tokens = data.batch_at(i)["tokens"]
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, m = step(params, state,
                                {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    jflat = dict(tree_items(jax.tree.map(np.asarray, jp)))
    for path, t in tree_items(params):
        np.testing.assert_allclose(_np(t), jflat[path], **PARAM_TOL,
                                   err_msg=path)


def test_remat_gradients_bit_identical(jparams):
    """Every remat policy recomputes the MoE layer (dispatch, grouped GEMMs,
    combine) in the backward and gives none's gradients to the bit."""
    cfg, _ = _configs("overflow")
    params = _port(jparams, cfg)
    tokens = torch.from_numpy(SyntheticLM(vocab=cfg.vocab, seq_len=16,
                                          batch=2, seed=2).batch_at(0)[
        "tokens"])
    loss, grads = loss_and_grads(cfg, params, {"tokens": tokens})
    for remat in ("full", "dots", "dtr"):
        loss_r, grads_r = loss_and_grads(cfg.replace(remat=remat), params,
                                         {"tokens": tokens})
        assert torch.equal(loss_r, loss), remat
        for (path, g), (_, g_r) in zip(tree_items(grads),
                                       tree_items(grads_r)):
            assert torch.equal(g, g_r), (remat, path)
