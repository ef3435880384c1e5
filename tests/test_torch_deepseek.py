"""The port's deepseek-v3 against the JAX package's: parameter definitions,
MLA's pieces, the forward in both attention branches (dense logits below
``BLOCKED_ATTN_THRESHOLD`` query rows, the blocked loop from it on), the
loss and every gradient, the absorbed decode on one shared and on per-slot
position clocks, and the serve launcher against the JAX launcher.

The f32 smoke config (one dense layer, three MoE layers of 8 experts with
one shared expert, MLA at q_lora 32, kv_lora 16, nope 16, rope 8, v 16),
parameters from ``repro.models.init_params`` carried across by
``params_from_jax``, tokens drawn from a numpy seed.  Tolerances: logits
1e-4; the loss 1e-5 relative and each gradient leaf ‖d‖/‖g‖ <= 1e-4; decode
logits 1e-5 of max|logits| a step.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import ParamInfo as JParamInfo  # noqa: E402
from repro.launch import admission as jadmission  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_serve_step  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402
from test_torch_serve_admission import (_RecordingJit, _recording,  # noqa: E402
                                        numpy_params)

ARCH = "deepseek-v3-671b"
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
def jparams(jcfg):
    # Jitted: one compile instead of a dispatch per leaf's draw.
    return jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _jax_defs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JParamInfo))[0]
    return {".".join(k.key for k in kp): (tuple(i.shape), i.dtype,
                                          i.init_scale) for kp, i in leaves}


def _defs(tree):
    return {p: (tuple(i.shape), i.dtype, i.init_scale)
            for p, i in tree_items(tree)}


@pytest.mark.parametrize("smoke", [True, False])
def test_param_and_cache_defs_equal_jax(smoke):
    get = configs.get_smoke if smoke else configs.get
    jget = jconfigs.get_smoke if smoke else jconfigs.get
    cfg, jcfg = get(ARCH), jget(ARCH)
    assert _defs(M.param_defs(cfg)) == _jax_defs(JM.param_defs(jcfg))
    assert _defs(M.cache_defs(cfg, 4, 64)) == \
        _jax_defs(JM.cache_defs(jcfg, 4, 64))
    assert (cfg.n_dense_layers, cfg.n_groups) == \
        ((1, 3) if smoke else (3, 58))


def test_rms_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 32), dtype=np.float32) * 3
    scale = rng.standard_normal(32, dtype=np.float32)
    got = MLA._rms(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    want = JMLA._rms(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("s", [16, 2048])
def test_forward_logits_match_jax(cfg, jcfg, params, jparams, s):
    """S 16 takes the dense logits, S 2048 the blocked loop, in every MLA
    layer (the dense one included)."""
    tokens = _tokens(cfg, 2 if s == 16 else 1, s)
    out = M.forward(cfg, params, torch.from_numpy(tokens))
    want = JM.forward(jcfg, jparams, jnp.asarray(tokens))
    assert out.shape == (*tokens.shape, cfg.vocab)
    np.testing.assert_allclose(_np(out), np.asarray(want), **LOGIT_TOL)


def test_blocked_branch_equals_dense_branch(cfg, params, monkeypatch):
    """The blocked loop (from ``BLOCKED_ATTN_THRESHOLD`` rows on) computes
    the dense branch's function, at 8 query rows a block."""
    tokens = torch.from_numpy(_tokens(cfg, 2, 24))
    dense = M.forward(cfg, params, tokens)
    monkeypatch.setattr(MLA, "BLOCKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(MLA._attend_blocked, "__defaults__", (8,))
    blocked = M.forward(cfg, params, tokens)
    np.testing.assert_allclose(_np(blocked), _np(dense), rtol=1e-5,
                               atol=1e-5)


def test_loss_and_every_gradient_match_jax(cfg, jcfg, params, jparams):
    tokens = _tokens(cfg, 2, 16)
    batch = {"tokens": jnp.asarray(tokens)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch)))(jparams)
    loss, grads = loss_and_grads(cfg, params,
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree_items(grads))
    assert flat.keys() == jflat.keys()
    assert any(p.startswith("dense.attn.wkv_a") for p in flat)
    assert any(p.startswith("groups.slot0.ffn.shared.") for p in flat)
    for path, g in flat.items():
        want = jflat[path]
        assert g.shape == want.shape and g.dtype == torch.float32, path
        rel = np.linalg.norm(_np(g) - want) / max(np.linalg.norm(want),
                                                  1e-30)
        assert rel <= GRAD_REL, (path, rel)


def test_remat_gradients_bit_identical(cfg, params):
    tokens = {"tokens": torch.from_numpy(_tokens(cfg, 2, 8, seed=3))}
    loss, grads = loss_and_grads(cfg, params, tokens)
    for remat in ("full", "dtr"):
        loss_r, grads_r = loss_and_grads(cfg.replace(remat=remat), params,
                                         tokens)
        assert torch.equal(loss, loss_r)
        for (path, g), (_, g_r) in zip(tree_items(grads),
                                       tree_items(grads_r)):
            assert torch.equal(g, g_r), (remat, path)


@pytest.mark.parametrize("clock", ["per_slot", "scalar"])
def test_decode_steps_match_jax(cfg, jcfg, params, jparams, clock):
    """8 absorbed decode steps over a latent cache of 8 rows, slots at
    different positions (per-slot clocks, one running past the end, whose
    writes are dropped) or one shared clock; logits every step within
    1e-5 of their max, and the caches."""
    b, max_len = 4, 8
    tokens = _tokens(cfg, b, 8, seed=4)
    cache = M.init_cache(cfg, b, max_len, "cpu")
    jcache = JM.init_cache(jcfg, b, max_len)
    pos = np.array([0, 3, 5, 6], np.int32) if clock == "per_slot" \
        else np.int32(0)
    jstep = jax.jit(lambda p, t, c, q: JM.decode_step(jcfg, p, t, c, q))
    for t in range(8):
        tok = tokens[:, t:t + 1]
        logits, cache = M.decode_step(cfg, params, torch.from_numpy(tok),
                                      cache, torch.from_numpy(
                                          np.asarray(pos)))
        jlogits, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        want = np.asarray(jlogits)
        err = np.abs(_np(logits) - want).max()
        assert err <= DECODE_REL * np.abs(want).max(), (t, err)
        pos = pos + 1
    for path, leaf in tree_items(cache):
        jleaf = dict(tree_items(jax.tree.map(np.asarray, jcache)))[path]
        np.testing.assert_allclose(_np(leaf), jleaf, rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    assert {p.split(".")[-1] for p, _ in tree_items(cache)} == \
        {"ckv", "krope"}


@pytest.fixture(scope="module")
def served(tmp_path_factory, cfg):
    """Both serve launchers on the same numpy-drawn weights, under a KV
    budget with chaos squeezes (so slots are preempted and their latent
    rows zeroed), capturing to serve.log."""
    tmp = tmp_path_factory.mktemp("deepseek")
    flags = SERVE + ["--capture", "serve.log"]
    drawn = numpy_params(cfg)
    jax_run, port_run = {"steps": []}, {"steps": []}
    controllers = []

    class Recorded(jadmission.AdmissionController):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            controllers.append(self)

    for side in ("jax", "port"):
        (tmp / side).mkdir()
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(tmp / "jax")
        mp.setattr(jserve, "jax", _RecordingJit(jax_run["steps"]))
        mp.setattr(jadmission, "AdmissionController", Recorded)
        mp.setattr(JM, "init_params", lambda jcfg, key: jax.tree.map(
            lambda x: jnp.asarray(x, jcfg.param_dtype), drawn))
        jserve.main(flags)
    (ctl,) = controllers
    jax_run.update(lines=out.getvalue().splitlines(),
                   counters=ctl.counters(), events=ctl.events,
                   log=(tmp / "jax" / "serve.log").read_bytes())
    args = serve.parse_args(flags)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(tmp / "port")
        mp.setattr(serve, "make_serve_step",
                   _recording(make_serve_step, port_run["steps"]))
        res = serve.serve_loop(cfg, params_from_jax(drawn, cfg, "cpu"), args)
        serve.report(args, res, torch.device("cpu"))
    port_run.update(lines=out.getvalue().splitlines(),
                    counters=res.counters, events=res.events,
                    log=(tmp / "port" / "serve.log").read_bytes(),
                    result=res)
    return jax_run, port_run


def test_serve_matches_jax_launcher(served):
    """The same next token in every slot at every step, the same admission
    counters and events (preemptions included), a byte-identical captured
    log and the same printed lines but the first line's timing."""
    theirs, mine = served
    assert len(mine["steps"]) == len(theirs["steps"]) > 0
    for a, b in zip(mine["steps"], theirs["steps"]):
        np.testing.assert_array_equal(a, b)
    assert mine["counters"] == theirs["counters"]
    assert mine["counters"]["completed"] == 8
    assert mine["counters"]["preemptions"] > 0
    assert mine["events"] == theirs["events"]
    assert mine["log"] == theirs["log"]
    assert mine["lines"][0].split(",")[:2] == \
        theirs["lines"][0].split(",")[:2]
    assert mine["lines"][1:] == theirs["lines"][1:]
    assert sorted(mine["result"].completed) == list(range(8))


def test_mla_layers_launch_no_flash_kernel(cfg):
    """MLA's attention is plain PyTorch in both branches: its q/k width
    (nope + rope) differs from v's, which one flash head dim cannot
    express."""
    assert cfg.qk_nope_dim + cfg.qk_rope_dim != cfg.v_head_dim
    assert JL.BLOCKED_ATTN_THRESHOLD == MLA.BLOCKED_ATTN_THRESHOLD == 2048
    text = open(MLA.__file__).read()
    assert "flash_attention" not in text and "ops.attention" not in text
