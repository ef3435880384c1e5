"""Shared checks of a port model against the JAX package's, for the
per-model test files (``test_torch_gemma3.py``,
``test_torch_recurrentgemma.py``): parameter and cache definitions, forward
logits, the loss and every gradient, decode steps on both position clocks,
and both serve launchers on the same numpy-drawn weights.

Each check takes the smoke configs of both packages; parameters come from
``repro.models.init_params``, carried across by ``params_from_jax``, and
tokens from a numpy seed.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import ParamInfo as JParamInfo
from repro.launch import admission as jadmission
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.launch import serve
from repro_torch.launch.steps import loss_and_grads, make_serve_step
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import tree_items
from test_torch_serve_admission import (_RecordingJit, _recording,
                                        numpy_params)


def as_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def both_params(cfg, jcfg):
    """(JAX parameters, the port's copy of them) for the smoke configs."""
    # Jitted: one compile instead of a dispatch per leaf's draw.
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")


def _jax_defs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JParamInfo))[0]
    return {".".join(k.key for k in kp): (tuple(i.shape), i.dtype,
                                          i.init_scale) for kp, i in leaves}


def _defs(tree):
    return {p: (tuple(i.shape), i.dtype, i.init_scale)
            for p, i in tree_items(tree)}


def check_defs(cfg, jcfg, batch=4, max_len=64):
    """Parameter and cache trees: the same paths, shapes, dtypes and init
    scales."""
    assert _defs(M.param_defs(cfg)) == _jax_defs(JM.param_defs(jcfg))
    assert _defs(M.cache_defs(cfg, batch, max_len)) == \
        _jax_defs(JM.cache_defs(jcfg, batch, max_len))


def check_forward(cfg, jcfg, params, jparams, b, s, tol):
    toks = tokens(cfg, b, s)
    out = M.forward(cfg, params, torch.from_numpy(toks))
    want = jax.jit(lambda p, t: JM.forward(jcfg, p, t))(jparams,
                                                        jnp.asarray(toks))
    assert out.shape == (*toks.shape, cfg.vocab)
    np.testing.assert_allclose(as_np(out), np.asarray(want), **tol)


def check_loss_and_grads(cfg, jcfg, params, jparams, grad_rel, b=2, s=16):
    """``loss_and_grads`` against ``jax.value_and_grad``: the loss within
    1e-5 relative and every leaf within ``grad_rel`` as ||d|| / ||g||.
    Returns the port's gradient paths."""
    toks = tokens(cfg, b, s)
    batch = {"tokens": jnp.asarray(toks)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch)))(jparams)
    loss, grads = loss_and_grads(cfg, params,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree_items(grads))
    assert flat.keys() == jflat.keys()
    for path, g in flat.items():
        want = jflat[path]
        assert g.shape == want.shape and g.dtype == torch.float32, path
        rel = np.linalg.norm(as_np(g) - want) / max(np.linalg.norm(want),
                                                    1e-30)
        assert rel <= grad_rel, (path, rel)
    return set(flat)


def check_decode(cfg, jcfg, params, jparams, clock, start, steps, max_len,
                 rel):
    """``steps`` decode steps from ``start`` (per-slot positions, or the
    scalar clock at 0) against the jitted JAX step: logits within ``rel``
    of max|logits| every step, and every cache leaf at the end."""
    b = len(start)
    toks = tokens(cfg, b, steps, seed=4)
    cache = M.init_cache(cfg, b, max_len, "cpu")
    jcache = JM.init_cache(jcfg, b, max_len)
    pos = np.array(start, np.int32) if clock == "per_slot" else np.int32(0)
    jstep = jax.jit(lambda p, t, c, q: JM.decode_step(jcfg, p, t, c, q))
    for t in range(steps):
        tok = toks[:, t:t + 1]
        logits, cache = M.decode_step(cfg, params, torch.from_numpy(tok),
                                      cache, torch.from_numpy(
                                          np.asarray(pos)))
        jlogits, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        want = np.asarray(jlogits)
        err = np.abs(as_np(logits) - want).max()
        assert err <= rel * np.abs(want).max(), (t, err)
        pos = pos + 1
    jflat = dict(tree_items(jax.tree.map(np.asarray, jcache)))
    for path, leaf in tree_items(cache):
        np.testing.assert_allclose(as_np(leaf), jflat[path], rtol=1e-5,
                                   atol=1e-5, err_msg=path)
    return cache


def serve_both(cfg, flags, tmp):
    """Both serve launchers on ``flags`` (with ``--capture serve.log``) and
    the same numpy-drawn weights: (JAX, port) each as a dict of the steps'
    next tokens, the printed lines, the admission counters and events and
    the captured log's bytes."""
    flags = flags + ["--capture", "serve.log"]
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


def check_served(theirs, mine, requests=8):
    """The same next token in every slot at every step, the same admission
    counters and events (preemptions included), a byte-identical captured
    log and the same printed lines but the first line's timing."""
    assert len(mine["steps"]) == len(theirs["steps"]) > 0
    for a, b in zip(mine["steps"], theirs["steps"]):
        np.testing.assert_array_equal(a, b)
    assert mine["counters"] == theirs["counters"]
    assert mine["counters"]["completed"] == requests
    assert mine["counters"]["preemptions"] > 0
    assert mine["events"] == theirs["events"]
    assert mine["log"] == theirs["log"]
    assert mine["lines"][0].split(",")[:2] == \
        theirs["lines"][0].split(",")[:2]
    assert mine["lines"][1:] == theirs["lines"][1:]
    assert sorted(mine["result"].completed) == list(range(requests))
