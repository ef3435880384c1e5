"""The port's rwkv6 decode (the one-token recurrence and its cache) against
the JAX package's, on the f32 smoke config with parameters drawn with numpy.

* the time-mix and channel-mix one-token branches over 8 steps from a
  random nonzero state: outputs, ``state``, ``x_att``, ``x_ffn``, each
  within 1e-5 of its largest magnitude;
* ``decode_step`` with per-slot clocks, 8 steps: logits and every cache
  leaf, the same tolerance;
* port only: 32 decode steps against ``forward`` over the same 32 tokens,
  each row of logits within 1e-4 of max|logits| (the recurrence one token
  at a time against its full-sequence form);
* the cache's leaves and the serve step model equal the JAX package's.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JRW  # noqa: E402
from repro.trace import capture as jcapture  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rwkv as RW  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items, tree_map  # noqa: E402
from repro_torch.trace import capture  # noqa: E402

ARCH = "rwkv6-1.6b"
REL = 1e-5             # f32, the same one-token arithmetic on both sides
FORWARD_REL = 1e-4     # one token at a time against the full sequence
STEPS, SLOTS = 8, 3


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
def drawn(cfg):
    return numpy_params(cfg)


@pytest.fixture(scope="module")
def jparams(drawn):
    return jax.tree.map(jnp.asarray, drawn)


@pytest.fixture(scope="module")
def params(cfg, drawn):
    return params_from_jax(drawn, cfg, "cpu")


def numpy_params(cfg, seed=0):
    """Parameters for both packages, drawn with numpy leaf by leaf in
    sorted key order (the JAX init's scale rule: ``0.02`` means
    ``1/sqrt(fan-in)``, zero-scale leaves are zeros), as f32 arrays."""
    rng = np.random.default_rng(seed)

    def one(info):
        if info.init_scale == 0.0:
            return np.zeros(info.shape, np.float32)
        scale = info.init_scale if info.init_scale != 0.02 \
            else 1.0 / np.sqrt(max(info.shape[-1], 1))
        return (rng.standard_normal(info.shape) * scale).astype(np.float32)

    return tree_map(one, M.param_defs(cfg))


def _close(mine, theirs, rel=REL, what=""):
    mine = np.asarray(mine.detach() if isinstance(mine, torch.Tensor)
                      else mine, np.float32)
    theirs = np.asarray(theirs, np.float32)
    assert mine.shape == theirs.shape, what
    scale = float(np.abs(theirs).max())
    err = float(np.abs(mine - theirs).max())
    assert err <= rel * scale, f"{what}: max|d| {err} > {rel} x {scale}"


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _mix_cache(cfg, rng):
    """A random nonzero mix cache for SLOTS slots (numpy f32)."""
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"state": rng.standard_normal((SLOTS, h, dh, dh),
                                         dtype=np.float32),
            "x_att": rng.standard_normal((SLOTS, cfg.d_model),
                                         dtype=np.float32),
            "x_ffn": rng.standard_normal((SLOTS, cfg.d_model),
                                         dtype=np.float32)}


@pytest.mark.parametrize("which", ["time_mix", "channel_mix"])
def test_one_token_branch_matches_jax(cfg, jcfg, jparams, params, which):
    rng = np.random.default_rng(3)
    jmix = jax.tree.map(lambda t: t[0], jparams["groups"]["slot0"]["mix"])
    mix = {k: v[0] for k, v in params["groups"]["slot0"]["mix"].items()}
    start = _mix_cache(cfg, rng)
    keys = ("state", "x_att") if which == "time_mix" else ("x_ffn",)
    jcache = {k: jnp.asarray(start[k]) for k in keys}
    cache = {k: _t(start[k]) for k in keys}
    jfn = jax.jit(partial(getattr(JRW, f"rwkv_{which}"), jcfg))
    fn = getattr(RW, f"rwkv_{which}")
    for step in range(STEPS):
        x = rng.standard_normal((SLOTS, 1, cfg.d_model), dtype=np.float32)
        expect, jcache = jfn(jmix, jnp.asarray(x), cache=jcache)
        out, cache = fn(cfg, mix, _t(x), cache=cache)
        _close(out, expect, what=f"{which} output, step {step}")
        assert cache.keys() == jcache.keys()
        for k in keys:
            _close(cache[k], jcache[k], what=f"{which} {k}, step {step}")


def test_decode_step_per_slot_matches_jax(cfg, jcfg, jparams, params):
    """8 steps, slots at clocks 0, 5 and 2 from a random nonzero cache:
    logits and every cache leaf."""
    rng = np.random.default_rng(4)
    start = {"groups": {"slot0": {"mix": {
        k: np.stack([v] * cfg.n_groups)
        for k, v in _mix_cache(cfg, rng).items()}}}}
    jcache = jax.tree.map(jnp.asarray, start)
    cache = tree_map(_t, start)
    jstep = jax.jit(partial(JM.decode_step, jcfg))
    pos = np.array([0, 5, 2], np.int32)
    for step in range(STEPS):
        tok = rng.integers(0, cfg.vocab, (SLOTS, 1)).astype(np.int32)
        expect, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                               jnp.asarray(pos + step))
        logits, cache = M.decode_step(cfg, params, torch.from_numpy(tok),
                                      cache, torch.from_numpy(pos + step))
        _close(logits, expect, what=f"logits, step {step}")
    mine, theirs = dict(tree_items(cache)), dict(tree_items(jcache))
    assert mine.keys() == theirs.keys()
    for k in mine:
        _close(mine[k], theirs[k], what=k)


def test_decode_matches_forward(cfg, params):
    """The recurrence one token at a time, state carried in the cache,
    against the full-sequence forward over the same 32 tokens."""
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    with torch.inference_mode():
        full = M.forward(cfg, params, tokens)
        cache = M.init_cache(cfg, 2, 32, "cpu")
        rows = []
        for t in range(32):
            logits, cache = M.decode_step(cfg, params, tokens[:, t:t + 1],
                                          cache, torch.tensor(t))
            rows.append(logits)
    scale = full.abs().max().item()
    for t, row in enumerate(rows):
        err = (row[:, 0] - full[:, t]).abs().max().item()
        assert err <= FORWARD_REL * scale, (t, err, scale)


def test_decode_takes_any_length_forward_needs_chunks(cfg, params):
    """The chunk-of-16 rule is the full-sequence form's only."""
    mix = {k: v[0] for k, v in params["groups"]["slot0"]["mix"].items()}
    cache = {"state": torch.zeros(1, cfg.d_model // cfg.rwkv_head_dim,
                                  cfg.rwkv_head_dim, cfg.rwkv_head_dim),
             "x_att": torch.zeros(1, cfg.d_model)}
    y, new = RW.rwkv_time_mix(cfg, mix, torch.ones(1, 1, cfg.d_model),
                              cache=cache)
    assert y.shape == (1, 1, cfg.d_model) and new.keys() == cache.keys()
    with pytest.raises(ValueError, match="chunk 16"):
        RW.rwkv_time_mix(cfg, mix, torch.ones(1, 1, cfg.d_model))


@pytest.mark.parametrize("smoke", [True, False])
def test_cache_defs_match_jax(smoke):
    cfg = configs.get_smoke(ARCH) if smoke else configs.get(ARCH)
    jcfg = jconfigs.get_smoke(ARCH) if smoke else jconfigs.get(ARCH)
    mine = {k: (tuple(v.shape), v.dtype)
            for k, v in tree_items(M.cache_defs(cfg, 4, 32))}
    theirs = {k: (tuple(v.shape), str(v.dtype))
              for k, v in tree_items(jax.tree.map(
                  lambda s: s, JM.cache_structs(jcfg, 4, 32)))}
    assert mine == theirs


@pytest.mark.parametrize("smoke", [True, False])
def test_step_model_matches_jax(smoke):
    """The serve trace's slot model: the recurrent state is the "KV" the
    admission controller and the capture price."""
    mine = capture.step_model_from_config(ARCH, smoke=smoke)
    theirs = jcapture.step_model_from_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_serve_step_capture_through_checker():
    """One rwkv decode step traced on fake tensors (the state written back
    in place) gives a log the static checker and both replay engines
    accept."""
    from repro_torch.check import check_log
    from repro_torch.trace.replay import verify_oracle_equivalence
    log = capture.capture_serve_step(ARCH, smoke=True, slots=2, max_len=16)
    assert log.op_count() > 0 and log.meta["kind"] == "serve_step"
    check_log(log)
    assert verify_oracle_equivalence(log, heuristics=("h_dtr_eq",),
                                     fractions=(0.6,))["ok"]
