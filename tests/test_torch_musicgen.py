"""The port's musicgen-large against the JAX package's: parameter and cache
definitions (``embed.tokens`` [K, vocab, d] and ``embed.unembed`` [K, d,
vocab] for K = 4 codebooks), the codebook embedding (the sum of the K
tables' rows) and unembedding (``[B,S,K,vocab]`` logits), the forward, the
loss (log-softmax over the vocabulary, the mean over batch, positions and
codebooks) and every gradient, the remat policies' gradients, decode on
both position clocks (``[B,1,K]`` tokens in, ``[B,1,K,vocab]`` logits out)
and the serve step's ``[B,1,K]`` greedy tokens, the train launcher against
the JAX launcher's losses, the train and serve captures (``check_log``,
scan == index replay), and the serve launcher, which refuses where the
JAX one fails.

The f32 smoke config (4 layers, d 64, 4/4 heads of 16 (MHA, G = 1), vocab
64, GeGLU), parameters from ``repro.models.init_params`` carried across by
``params_from_jax``, tokens from a numpy seed.  Tolerances: the embedding
1e-6; logits 1e-5 of max|logits|; the loss 1e-5 relative and each gradient
leaf ‖d‖/‖g‖ <= 1e-4; decode logits 1e-5 of max|logits| a step; the
launchers' losses 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.check import check_log  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import (loss_and_grads,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402
from repro_torch.trace import capture  # noqa: E402
from repro_torch.trace import replay as R  # noqa: E402
from torch_parity import (as_np, both_params, check_decode,  # noqa: E402
                          check_defs, check_forward, check_loss_and_grads,
                          tokens)

ARCH = "musicgen-large"
LOGIT_REL = 1e-5
GRAD_REL = 1e-4
DECODE_REL = 1e-5
LOSS_RTOL = 1e-5


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
    embed = M.param_defs(cfg)["embed"]
    k, v, d = cfg.n_codebooks, cfg.vocab, cfg.d_model
    assert (embed["tokens"].shape, embed["unembed"].shape) == (
        (k, v, d), (k, d, v))
    assert cfg.n_heads == cfg.n_kv_heads        # MHA: G = 1


def test_codebook_embedding_matches_jax(cfg, jcfg, both):
    """The sum of the K tables' rows, and the K heads' logits."""
    jparams, params = both
    toks = tokens(cfg, 2, 8)
    got = L.embed_apply(cfg, params["embed"], torch.from_numpy(toks))
    want = JM._embed(jcfg, jparams["embed"], jnp.asarray(toks))
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    x = np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    logits = L.unembed_apply(cfg, params["embed"], torch.from_numpy(x))
    want = JM._unembed(jcfg, jparams["embed"], jnp.asarray(x))
    assert logits.shape == (2, 8, cfg.n_codebooks, cfg.vocab)
    np.testing.assert_allclose(as_np(logits), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forward_logits_match_jax(cfg, jcfg, both):
    jparams, params = both
    check_forward(cfg, jcfg, params, jparams, 2, 16, LOGIT_REL)


def test_loss_and_every_gradient_match_jax(cfg, jcfg, both):
    jparams, params = both
    paths = check_loss_and_grads(cfg, jcfg, params, jparams, GRAD_REL)
    assert {"embed.tokens", "embed.unembed", "groups.slot0.attn.wq"} <= paths


def test_remat_gradients_bit_identical(cfg, both):
    params = both[1]
    batch = {"tokens": torch.from_numpy(tokens(cfg, 2, 8, seed=3))}
    loss, grads = loss_and_grads(cfg.replace(remat="none"), params, batch)
    for remat in ("full", "dots", "dtr"):
        loss_r, grads_r = loss_and_grads(cfg.replace(remat=remat), params,
                                         batch)
        assert torch.equal(loss, loss_r), remat
        for (path, g), (_, g_r) in zip(tree_items(grads),
                                       tree_items(grads_r)):
            assert torch.equal(g, g_r), (remat, path)


@pytest.mark.parametrize("clock,start", [("per_slot", (0, 3, 5, 14)),
                                         ("scalar", (0, 0, 0, 0))])
def test_decode_steps_match_jax(cfg, jcfg, both, clock, start):
    jparams, params = both
    check_decode(cfg, jcfg, params, jparams, clock, start, 10, 24,
                 DECODE_REL)


def test_serve_step_gives_a_token_per_codebook(cfg, jcfg, both):
    """``make_serve_step``'s greedy ``[B,1,K]`` tokens equal the JAX
    serve step's over 6 steps on a shared clock."""
    jparams, params = both
    toks = tokens(cfg, 3, 1, seed=7)
    cache, jcache = M.init_cache(cfg, 3, 16, "cpu"), JM.init_cache(jcfg, 3,
                                                                    16)
    step = make_serve_step(cfg)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    tok, jtok = torch.from_numpy(toks), jnp.asarray(toks)
    for pos in range(6):
        tok, cache = step(params, cache, tok, pos)
        jtok, jcache = jstep(jparams, jcache, jtok, jnp.int32(pos))
        assert tok.shape == (3, 1, cfg.n_codebooks)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


class _Recorded:
    """Stands in for ``DivergenceGuard`` in a launcher: records every
    step's (loss, grad_norm) as the launcher reads them."""

    def __init__(self, guard_cls, record):
        self._cls, self._record = guard_cls, record

    def __call__(self, *a, **kw):
        guard, record = self._cls(*a, **kw), self._record
        check = guard.check

        def recording(loss, gn):
            record.append((float(loss), float(gn)))
            return check(loss, gn)

        guard.check = recording
        return guard


def test_train_launcher_matches_jax_launcher(cfg, jcfg, tmp_path,
                                             monkeypatch, capsys):
    """Both launchers at their defaults (remat dtr, AdamW on the cosine
    schedule) on the smoke config for 3 steps, the JAX launcher's
    ``PRNGKey(0)`` weights carried across: the same losses and gradient
    norms at every step, on the same ``[B,S,K]`` batches."""
    flags = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
             "--seq", "16"]
    jax_steps, port_steps = [], []
    with monkeypatch.context() as mp:
        mp.setattr(jtrain, "DivergenceGuard",
                   _Recorded(jtrain.DivergenceGuard, jax_steps))
        jtrain.main(flags + ["--ckpt-dir", str(tmp_path / "jax")])
    jparams = jax.tree.map(np.asarray, JM.init_params(
        jcfg.replace(remat="dtr"), jax.random.PRNGKey(0)))
    with monkeypatch.context() as mp:
        mp.setattr(train, "DivergenceGuard",
                   _Recorded(train.DivergenceGuard, port_steps))
        mp.setattr(M, "init_params",
                   lambda c, gen: params_from_jax(jparams, c, "cpu"))
        res = train.main(flags + ["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert "arch=musicgen-large" in out and out.strip().endswith("done")
    assert len(jax_steps) == len(port_steps) == 3
    np.testing.assert_allclose(port_steps, jax_steps, rtol=LOSS_RTOL)
    assert res.losses == [l for l, _ in port_steps]


@pytest.fixture(scope="module")
def train_log():
    return capture.capture_train_step(ARCH, smoke=True, batch=2, seq=16)


def test_capture_train_step_replays(train_log):
    """``[B,S,K]`` tokens: the log passes ``check_log``, and scan and index
    replay agree at 0.9 and 0.8 of the activation range."""
    assert train_log.name == "train_step_musicgen-large_b2x16"
    check_log(train_log)
    rep = R.verify_oracle_equivalence(
        train_log, fractions=(0.9, 0.8), thrash_factor=3.0,
        heuristics=("h_dtr_eq", "h_lru"))
    assert rep["ok"], rep["mismatches"]
    assert any(r.ok for r in rep["index_results"].values())


def test_capture_serve_step_replays():
    """``[slots,1,K]`` tokens: ``check_log``, scan == index."""
    log = capture.capture_serve_step(ARCH, smoke=True, slots=4)
    assert log.name == "serve_step_musicgen-large_s4"
    check_log(log)
    rep = R.verify_oracle_equivalence(log, fractions=(0.9,),
                                      thrash_factor=3.0,
                                      heuristics=("h_dtr_eq",))
    assert rep["ok"], rep["mismatches"]


def test_serve_launcher_refuses_up_front(monkeypatch):
    monkeypatch.setattr(M, "init_params", lambda *a: pytest.fail(
        "drew weights before refusing"))
    with pytest.raises(NotImplementedError, match=r"\[slots, 1\].*rank"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "2", "--slots", "2", "--gen", "2"])
    with pytest.raises(NotImplementedError, match="serve launcher"):
        serve.serve_loop(configs.get_smoke(ARCH), {}, serve.parse_args(
            ["--arch", ARCH, "--smoke"]))


def test_jax_serve_launcher_fails_too(capsys):
    """What the refusal stands for: the JAX launcher's ``[slots, 1]``
    token buffer meets its sharding constraint as a rank-2 activation."""
    with pytest.raises(ValueError, match="rank at least 3"):
        jserve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                     "--slots", "2", "--gen", "2"])
