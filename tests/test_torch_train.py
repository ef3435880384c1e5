"""The port's rwkv6 train path against the JAX package's: logits, loss,
every gradient leaf, the optimizer pieces, the data stream and whole train
steps, on the f32 smoke config with the JAX parameters carried across.

On the CPU the recurrence runs its plain version (a serial f32 scan, where
the JAX model runs its chunked form), so the two differ by summation order
and by the chunked form's rounding.  Tolerances: 1e-4 on logits and 1e-5 on
the loss; each gradient leaf within 1e-4 of its largest magnitude; the
optimizer's scalars to the f32 ulp; parameters after three AdamW steps
within 1e-5 (see ``PARAM_TOL``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items, tree_map  # noqa: E402

ARCH = "rwkv6-1.6b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-4
# Three AdamW steps from the same parameters and batches.  Adam's step
# m/(sqrt(v) + eps) turns a gradient within rounding of zero into a step of
# up to lr either way, so these steps take eps = 1e-3: the step is then
# Lipschitz in the gradient with constant ~1/eps, and the two sides'
# gradients (at most 3e-6 apart) move a parameter by lr * 3e-6 / eps = 3e-6
# per step at most.
ADAM_EPS = 1e-3
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
# Adafactor's step g / sqrt(mean g^2 + eps) is of size lr for any gradient
# far above sqrt(eps), rounding noise included: qwen2's k bias has a
# gradient of exactly 0 in exact arithmetic (softmax ignores a logit shift
# shared by a row), so with eps 1e-30 the two sides' noise moves it by lr
# either way.  The step-parity test takes eps 1e-6, under which a gradient
# of 1e-6 or less moves a parameter by at most lr * g / 1e-3.
ADAFACTOR_EPS = 1e-6


@pytest.fixture(scope="module")
def jcfg():
    return jconfigs.get_smoke(ARCH)


@pytest.fixture(scope="module")
def cfg():
    return configs.get_smoke(ARCH)


@pytest.fixture(scope="module")
def jparams(jcfg):
    return JM.init_params(jcfg, jax.random.PRNGKey(0))


def _port(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def tokens():
    return SyntheticLM(vocab=256, seq_len=32, batch=2, seed=1).batch_at(0)[
        "tokens"]


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def test_registry_and_param_count(cfg):
    full = configs.get(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab) == \
        (24, 2048, 7168, 65536)
    n = sum(int(np.prod(i.shape)) for _, i in tree_items(M.param_defs(full)))
    assert n == 1_583_941_632          # the JAX package's param_structs
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim, cfg.dtype) == \
        (3, 64, 32, "float32")


def test_logits_and_loss_match_jax(jcfg, cfg, jparams, tokens):
    params = _port(jparams, cfg)
    expect = JM.forward(jcfg, jparams, jnp.asarray(tokens))
    out = M.forward(cfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(out), np.asarray(expect), **LOGIT_TOL)
    jloss = JM.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    loss = M.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_every_gradient_matches_jax(jcfg, cfg, jparams, tokens):
    batch = {"tokens": jnp.asarray(tokens)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch)))(jparams)
    params = _port(jparams, cfg)
    loss, grads = loss_and_grads(cfg, params,
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree_items(grads))
    assert flat.keys() == jflat.keys() and len(flat) == 20
    for path, g in flat.items():
        want = jflat[path]
        assert g.shape == want.shape and g.dtype == torch.float32, path
        err = np.abs(_np(g) - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (path, err)


QWEN = "qwen2-0.5b"


@pytest.fixture(scope="module")
def jqcfg():
    return jconfigs.get_smoke(QWEN)


@pytest.fixture(scope="module")
def qcfg():
    return configs.get_smoke(QWEN)


@pytest.fixture(scope="module")
def jqparams(jqcfg):
    return JM.init_params(jqcfg, jax.random.PRNGKey(0))


def _assert_grads_match(grads, jgrads):
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree_items(grads))
    assert flat.keys() == jflat.keys()
    for path, g in flat.items():
        want = jflat[path]
        assert g.shape == want.shape and g.dtype == torch.float32, path
        err = np.abs(_np(g) - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (path, err)


def test_qwen2_logits_loss_and_grads_match_jax(jqcfg, qcfg, jqparams,
                                               tokens):
    """The qwen2 smoke train path (attention through the flash wrapper's
    plain version, differentiated by autograd) against ``jax.grad``."""
    params = _port(jqparams, qcfg)
    batch = {"tokens": jnp.asarray(tokens)}
    out = M.forward(qcfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(out), np.asarray(JM.forward(
        jqcfg, jqparams, batch["tokens"])), **LOGIT_TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jqcfg, p, batch)))(jqparams)
    loss, grads = loss_and_grads(qcfg, params,
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert len(dict(tree_items(grads))) == 14      # tied embeddings
    _assert_grads_match(grads, jgrads)


@pytest.mark.parametrize("name", ["adafactor", "sgdm"])
def test_optimizer_train_steps_match_jax(jqcfg, qcfg, jqparams, name):
    """Three qwen2 smoke steps (clipping at 1.0) with Adafactor or SGD with
    momentum, as the reference builds them, on the same batches."""
    data = SyntheticLM(vocab=qcfg.vocab, seq_len=16, batch=2, seed=0)
    kw = {"eps": ADAFACTOR_EPS} if name == "adafactor" else {}
    jopt = joptim.make_optimizer(name, lr=1e-3, **kw)
    opt = optim.make_optimizer(name, lr=1e-3, **kw)
    jstep = jax.jit(jmake_train_step(jqcfg, jopt))
    step = make_train_step(qcfg, opt)
    jp, jstate = jqparams, jopt.init(jqparams)
    params = _port(jqparams, qcfg)
    state = opt.init(params)
    for i in range(3):
        tokens = data.batch_at(i)["tokens"]
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, m = step(params, state,
                                {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    jflat = dict(tree_items(jax.tree.map(np.asarray, jp)))
    for path, t in tree_items(params):
        np.testing.assert_allclose(_np(t), jflat[path], **PARAM_TOL,
                                   err_msg=path)


def test_optimizer_updates_match_jax():
    """Adafactor (factored and unfactored leaves, a stacked 3-d leaf) and
    SGD with momentum, three updates on one tree against the reference."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 4, 6)}
    p = _tree(rng, shapes)
    grads = [_tree(rng, shapes) for _ in range(3)]
    for name in ("adafactor", "sgdm"):
        jopt = joptim.make_optimizer(name, lr=joptim.cosine_schedule(
            1e-2, 1, 10))
        opt = optim.make_optimizer(name, lr=optim.cosine_schedule(
            1e-2, 1, 10))
        jp = jax.tree.map(jnp.asarray, p)
        tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        jstate, state = jopt.init(jp), opt.init(tp)
        for g in grads:
            jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                       jp)
            jp = joptim.apply_updates(jp, jupd)
            upd, state = opt.update(
                {k: torch.from_numpy(v) for k, v in g.items()}, state, tp)
            tp = optim.apply_updates(tp, upd)
        for k in shapes:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {k}")
        jinner = dict(tree_items(jax.tree.map(np.asarray, jstate.inner)))
        for path, t in tree_items(state.inner):
            np.testing.assert_allclose(_np(t), jinner[path], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {path}")


def test_train_cli_qwen2_dtr_adafactor(capsys, tmp_path):
    train.main(["--arch", QWEN, "--smoke", "--device", "cpu", "--remat",
                "dtr", "--optimizer", "adafactor", "--steps", "2",
                "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=qwen2-0.5b" in out and "remat=dtr" in out
    assert "step     1 loss" in out and out.strip().endswith("done")


def test_train_cli_refuses_unknown_remat():
    with pytest.raises(ValueError):
        train.main(["--arch", QWEN, "--smoke", "--device", "cpu",
                    "--remat", "sometimes", "--steps", "1"])


def test_remat_full_matches_none(cfg, jparams, tokens):
    params = _port(jparams, cfg)
    batch = {"tokens": torch.from_numpy(tokens)}
    loss, grads = loss_and_grads(cfg, params, batch)
    loss_r, grads_r = loss_and_grads(cfg.replace(remat="full"), params,
                                     batch)
    assert float(loss_r) == float(loss)
    for (path, g), (_, g_r) in zip(tree_items(grads), tree_items(grads_r)):
        torch.testing.assert_close(g_r, g, rtol=0, atol=0, msg=path)


@pytest.mark.parametrize("where", ["leaf", "stack"])
def test_loss_and_grads_names_a_leaf_it_does_not_reach(cfg, jparams, tokens,
                                                       where):
    """A parameter the loss does not use is refused by name, a plain leaf
    and a stacked one alike (``autograd.grad``'s refusal)."""
    params = _port(jparams, cfg)
    if where == "stack":
        params["groups"]["unused"] = torch.zeros(cfg.n_groups, 3)
    else:
        params["unused"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="no gradient reached "
                       + ("groups.unused .layers" if where == "stack"
                          else "unused$")):
        loss_and_grads(cfg, params, {"tokens": torch.from_numpy(tokens)})


def test_loss_and_grads_removes_its_hooks_when_backward_raises(
        cfg, jparams, tokens, monkeypatch):
    class Fails(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("backward failed")

    loss_fn, register = M.loss_fn, torch.Tensor.register_post_accumulate_grad_hook
    hooked = []

    def spy(self, hook):
        hooked.append((self, register(self, hook)))
        return hooked[-1][1]

    monkeypatch.setattr(M, "loss_fn", lambda *a: Fails.apply(loss_fn(*a)))
    monkeypatch.setattr(torch.Tensor, "register_post_accumulate_grad_hook",
                        spy)
    with pytest.raises(RuntimeError, match="backward failed"):
        loss_and_grads(cfg, _port(jparams, cfg),
                       {"tokens": torch.from_numpy(tokens)})
    assert hooked and all(h.id not in h.hooks_dict_ref() for _, h in hooked)


@pytest.mark.parametrize("remat", ["dtr", "dots", "names:attn_out"])
def test_remat_policies_match_none_and_jax(qcfg, jqcfg, jqparams, tokens,
                                           remat):
    """Every other policy of the reference: bit-equal to remat none on the
    CPU (the recompute repeats the same arithmetic), and equal to JAX's
    gradient under the same policy."""
    params = _port(jqparams, qcfg)
    batch = {"tokens": torch.from_numpy(tokens)}
    loss, grads = loss_and_grads(qcfg, params, batch)
    loss_r, grads_r = loss_and_grads(qcfg.replace(remat=remat), params,
                                     batch)
    assert float(loss_r) == float(loss)
    for (path, g), (_, g_r) in zip(tree_items(grads), tree_items(grads_r)):
        torch.testing.assert_close(g_r, g, rtol=0, atol=0, msg=path)
    jcfg_r = jqcfg.replace(remat=remat)
    jgrads = jax.jit(jax.grad(lambda p: JM.loss_fn(
        jcfg_r, p, {"tokens": jnp.asarray(tokens)})))(jqparams)
    _assert_grads_match(grads_r, jgrads)


@pytest.mark.parametrize("seed,step,batch,seq,vocab",
                         [(0, 0, 4, 32, 256), (0, 7, 2, 33, 65536),
                          (3, 1, 8, 16, 1000)])
def test_synthetic_batches_equal_jax(seed, step, batch, seq, vocab):
    mine = SyntheticLM(vocab=vocab, seq_len=seq, batch=batch,
                       seed=seed).batch_at(step)
    theirs = JSyntheticLM(vocab=vocab, seq_len=seq, batch=batch,
                          seed=seed).batch_at(step)
    assert mine.keys() == theirs.keys()
    assert mine["tokens"].dtype == theirs["tokens"].dtype
    np.testing.assert_array_equal(mine["tokens"], theirs["tokens"])


def test_cosine_schedule_matches_jax():
    mine = optim.cosine_schedule(3e-4, warmup=20, total=100)
    theirs = joptim.cosine_schedule(3e-4, warmup=20, total=100)
    for step in (0, 1, 7, 19, 20, 21, 50, 99, 100, 150):
        want = float(theirs(jnp.asarray(step, jnp.int32)))
        assert mine(step) == pytest.approx(want, rel=2 ** -23), step


def _tree(rng, shapes):
    return {k: rng.standard_normal(s, dtype=np.float32)
            for k, s in shapes.items()}


def test_clip_and_adamw_update_match_jax():
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    p, g1, g2 = (_tree(rng, shapes) for _ in range(3))
    jopt = joptim.adamw(lr=joptim.cosine_schedule(1e-2, 1, 10))
    opt = optim.adamw(lr=optim.cosine_schedule(1e-2, 1, 10))
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jstate, state = jopt.init(jp), opt.init(tp)
    for g in (g1, g2):
        jg, jgn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                             1.0)
        tg, gn = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]),
                                       rtol=1e-6, atol=1e-7)
        jupd, jstate = jopt.update(jg, jstate, jp)
        jp = joptim.apply_updates(jp, jupd)
        upd, state = opt.update(tg, state, tp)
        tp = optim.apply_updates(tp, upd)
    assert state.step == int(jstate.step) == 2
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7)
        for mom in ("m", "v"):
            np.testing.assert_allclose(_np(state.inner[mom][k]),
                                       np.asarray(jstate.inner[mom][k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(jcfg, cfg, jparams, grad_accum):
    """Three steps of value-and-grad, clipping at 1.0 and AdamW with the
    cosine schedule, on the same batches: losses, gradient norms and the
    parameters after the last step."""
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    jopt = joptim.adamw(lr=joptim.cosine_schedule(1e-3, warmup=1, total=3),
                        eps=ADAM_EPS)
    opt = optim.adamw(lr=optim.cosine_schedule(1e-3, warmup=1, total=3),
                      eps=ADAM_EPS)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, grad_accum=grad_accum))
    step = make_train_step(cfg, opt, grad_accum=grad_accum)
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


def test_train_cli_on_cpu(capsys, tmp_path):
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                "--batch", "2", "--seq", "32", "--remat", "none",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=rwkv6-1.6b" in out and "step     2 loss" in out
    assert out.strip().endswith("done")


def test_train_loop_reports_every_step(cfg):
    args = train.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "2",
                             "--batch", "4", "--seq", "16",
                             "--grad-accum", "2", "--remat", "full"])
    params = M.init_params(train.config_from_args(args),
                           torch.Generator().manual_seed(0))
    before = tree_map(torch.clone, params)
    res = train.train_loop(train.config_from_args(args), params, args,
                           verbose=False)
    assert len(res.losses) == len(res.grad_norms) == 2
    assert all(np.isfinite(res.losses)) and res.peak_bytes == 0
    assert any(not torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(before), tree_items(params)))


def test_train_cli_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--remat",
                    "none"])
