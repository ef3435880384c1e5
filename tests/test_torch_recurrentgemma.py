"""The port's recurrentgemma-2b against the JAX package's: the RG-LRU block
(``models/rglru.py``) in train form against ``jax.lax.associative_scan``'s
and one decode step, the log-depth scan against a sequential recurrence
where the closed form through ``exp(cumsum(log a))`` fails; then the
model: definitions (groups of rglru, rglru, attn_local and a tail of two
rglru layers, with ``rec`` caches), the forward below and at the
blocked-attention threshold, the loss and every gradient, decode on both
position clocks through the attention ring's wrap, and the serve launcher
with ``--capture`` against the JAX launcher (preemptions zero a slot's
``rec`` state as they zero its ring).

The f32 smoke config (5 layers: one group and the tail, d 64, lru width
64, conv width 4, 2/1 heads of 32, window 8), parameters from
``repro.models.init_params`` carried across by ``params_from_jax``, inputs
from a numpy seed.  Tolerances: the RG-LRU block 1e-5 of max|out| (f32; the
scans associate the products in another order); logits 1e-4; the loss
1e-5 relative and each gradient leaf ‖d‖/‖g‖ <= 1e-4; decode logits 1e-5
of max|logits| a step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from torch_parity import (as_np, both_params, check_decode,  # noqa: E402
                          check_defs, check_forward, check_loss_and_grads,
                          check_served, serve_both)

ARCH = "recurrentgemma-2b"
REC_REL = 1e-5
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


def _rec(both, slot="slot0"):
    """Group 0's ``slot`` RG-LRU parameters, JAX's and the port's."""
    jparams, params = both
    return (jax.tree.map(lambda t: t[0], jparams["groups"])[slot]["rec"],
            {k: v[0] for k, v in params["groups"][slot]["rec"].items()})


def _x(cfg, b, s, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [16, 2048])
def test_rglru_train_form_matches_associative_scan(cfg, jcfg, both, s):
    jp, p = _rec(both)
    x = _x(cfg, 2, s)
    got, cache = RG.rglru_apply(cfg, p, torch.from_numpy(x))
    want, _ = jax.jit(lambda q, y: JRG.rglru_apply(jcfg, q, y))(
        jp, jnp.asarray(x))
    want = np.asarray(want)
    assert cache is None
    assert np.abs(as_np(got) - want).max() <= REC_REL * np.abs(want).max()


def test_rglru_decode_step_matches_jax(cfg, jcfg, both):
    """One fused step from a random (h, conv) state."""
    jp, p = _rec(both, "slot1")
    rng = np.random.default_rng(3)
    w, cw = cfg.lru_width, cfg.conv_width
    state = {"h": rng.standard_normal((4, w)).astype(np.float32),
             "conv": rng.standard_normal((4, cw - 1, w)).astype(np.float32)}
    x = _x(cfg, 4, 1, seed=4)
    got, new = RG.rglru_apply(cfg, p, torch.from_numpy(x), cache={
        k: torch.from_numpy(v) for k, v in state.items()})
    want, jnew = JRG.rglru_apply(jcfg, jp, jnp.asarray(x), cache={
        k: jnp.asarray(v) for k, v in state.items()})
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(as_np(new[k]), np.asarray(jnew[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_rglru_decode_chain_equals_train_form(cfg, both):
    """Decoding a sequence token by token from a zero state gives the
    train form's outputs (f32: h rounds to f32, a no-op)."""
    _, p = _rec(both)
    x = torch.from_numpy(_x(cfg, 2, 12, seed=5))
    full, _ = RG.rglru_apply(cfg, p, x)
    cache = {k: torch.zeros(i.shape) for k, i in
             RG.rglru_cache_defs(cfg, 2).items()}
    steps = []
    for t in range(12):
        y, cache = RG.rglru_apply(cfg, p, x[:, t:t + 1], cache=cache)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=1e-5,
                               atol=1e-5)


def test_linear_scan_where_the_closed_form_fails():
    """Steep decays (log a_t down to -8 softplus(lam) a step) over 2048
    steps: the log-depth scan matches the sequential recurrence in f64,
    while exp(cumsum(log a)) underflows to 0 and its reciprocal to inf."""
    rng = np.random.default_rng(6)
    s = 2048
    log_a = -8.0 * np.log1p(np.exp(rng.uniform(0, 3, (2, s, 16)))) \
        * rng.uniform(0, 1, (2, s, 16))
    b = rng.standard_normal((2, s, 16))
    h, want = np.zeros((2, 16)), np.empty((2, s, 16))
    for t in range(s):
        h = np.exp(log_a[:, t]) * h + b[:, t]
        want[:, t] = h
    got = RG.linear_scan(torch.from_numpy(np.exp(log_a)).float(),
                         torch.from_numpy(b).float())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    cum = torch.cumsum(torch.from_numpy(log_a).float(), 1).exp()
    assert (cum[:, -1] == 0).all() and torch.isinf(1 / cum[:, -1]).all()


@pytest.mark.parametrize("smoke", [True, False])
def test_param_and_cache_defs_equal_jax(smoke):
    get = configs.get_smoke if smoke else configs.get
    jget = jconfigs.get_smoke if smoke else jconfigs.get
    cfg, jcfg = get(ARCH), jget(ARCH)
    check_defs(cfg, jcfg)
    caches = M.cache_defs(cfg, 4, 64)
    w = cfg.lru_width
    for stack, n in (("groups", cfg.n_groups), ("tail", 1)):
        rec = caches[stack]["slot1"]["rec"]
        assert rec["h"].shape == (n, 4, w) and rec["h"].dtype == cfg.dtype
        assert rec["conv"].shape == (n, 4, cfg.conv_width - 1, w)
    assert "attn" in caches["groups"]["slot2"]
    assert sorted(M.param_defs(cfg)["tail"]["slot0"]) == [
        "ffn", "norm1", "norm2", "rec"]
    assert (cfg.n_groups, len(cfg.tail)) == ((1, 2) if smoke else (8, 2))


@pytest.mark.parametrize("b,s", [(2, 16), (1, 2048)])
def test_forward_logits_match_jax(cfg, jcfg, both, b, s):
    jparams, params = both
    check_forward(cfg, jcfg, params, jparams, b, s, LOGIT_TOL)


def test_loss_and_every_gradient_match_jax(cfg, jcfg, both):
    jparams, params = both
    paths = check_loss_and_grads(cfg, jcfg, params, jparams, GRAD_REL)
    assert {"tail.slot1.rec.lam", "groups.slot0.rec.conv",
            "groups.slot2.attn.wk"} <= paths


@pytest.mark.parametrize("clock,start", [("per_slot", (0, 3, 5, 14)),
                                         ("scalar", (0, 0, 0, 0))])
def test_decode_steps_match_jax(cfg, jcfg, both, clock, start):
    """12 decode steps: the attention layer's 8-row ring wraps, and the
    rglru layers carry (h, conv) from step to step."""
    jparams, params = both
    cache = check_decode(cfg, jcfg, params, jparams, clock, start, 12, 24,
                         DECODE_REL)
    assert cache["tail"]["slot1"]["rec"]["h"].abs().max() > 0


@pytest.fixture(scope="module")
def served(tmp_path_factory, cfg):
    return serve_both(cfg, SERVE, tmp_path_factory.mktemp("recurrentgemma"))


def test_serve_matches_jax_launcher(served):
    """Preempted slots restart from a zero ``rec`` state and ring: the same
    tokens, counters, events, printed lines and a byte-identical
    ``--capture`` log as the JAX launcher's."""
    check_served(*served)
