"""The port's checkpoint manager (``repro_torch.ckpt``) and the launcher's
checkpoint resume and divergence guard: every ``tests/test_ckpt.py`` case
through the port's manager; the same state saved by both packages' managers
gives the same npz keys and values, and each package restores the other's;
a bfloat16 leaf round-trips bit-exactly; an interrupted and resumed
launcher run of the llama3.2-1b smoke config gives the losses and
parameters of an uninterrupted one, bit for bit; a NaN loss is skipped, and
after ``max_skips`` the latest checkpoint restored, as ``DivergenceGuard``
says.
"""
import json
import os
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.ckpt.manager import restore_latest as jrestore_latest  # noqa: E402
from repro.ckpt.manager import save_checkpoint as jsave_checkpoint  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.ckpt.manager import (CheckpointManager,  # noqa: E402
                                      restore_latest, save_checkpoint)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items, tree_map  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes run fastest on one thread (and do not contend with the
    other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.float32)}


# ---------------------------------------------------------------------------
# tests/test_ckpt.py, through the port's manager
# ---------------------------------------------------------------------------

class TestPerHostSharding:
    def test_host_suffix_in_filename(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 7, tree(), host=3)
        assert os.path.exists(os.path.join(path, "arrays.3.npz"))
        assert not os.path.exists(os.path.join(path, "arrays.0.npz"))

    def test_roundtrip_per_host(self, tmp_path):
        t = tree()
        save_checkpoint(str(tmp_path), 12, t, extra={"cursor": 5}, host=1)
        step, restored, extra = restore_latest(str(tmp_path), t, host=1)
        assert step == 12
        assert extra == {"cursor": 5}
        assert torch.equal(restored["w"], t["w"])
        assert torch.equal(restored["b"], t["b"])

    def test_missing_host_shard_fails_loudly(self, tmp_path):
        t = tree()
        save_checkpoint(str(tmp_path), 3, t, host=0)
        with pytest.raises(FileNotFoundError):
            restore_latest(str(tmp_path), t, host=2)


class TestAtomicity:
    def test_crash_mid_save_leaves_no_step_dir(self, tmp_path, monkeypatch):
        t = tree()

        def boom(*a, **k):
            raise RuntimeError("disk full")

        monkeypatch.setattr(np, "savez", boom)
        with pytest.raises(RuntimeError):
            save_checkpoint(str(tmp_path), 5, t)
        # No step dir and no leftover temp dir after the failed save.
        assert [d for d in os.listdir(tmp_path)] == []

    def test_stale_temp_dir_never_shadows_latest(self, tmp_path):
        t = tree()
        save_checkpoint(str(tmp_path), 10, t)
        stale = tmp_path / ".tmp_ckpt_stale"
        stale.mkdir()
        (stale / "manifest.json").write_text("{corrupt")
        step, restored, _ = restore_latest(str(tmp_path), t)
        assert step == 10
        assert torch.equal(restored["w"], t["w"])

    def test_overwrite_same_step_is_atomic(self, tmp_path):
        t = tree()
        save_checkpoint(str(tmp_path), 4, t, extra={"v": 1})
        t2 = {"w": t["w"] * 2, "b": t["b"] * 2}
        save_checkpoint(str(tmp_path), 4, t2, extra={"v": 2})
        step, restored, extra = restore_latest(str(tmp_path), t)
        assert step == 4 and extra == {"v": 2}
        assert torch.equal(restored["w"], t2["w"])


class TestManagerPolicy:
    def test_retention_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every_steps=1, keep=2)
        t = tree()
        for s in (1, 2, 3, 4):
            mgr.save(s, t)
        kept = sorted(d for d in os.listdir(tmp_path)
                      if d.startswith("step_"))
        assert kept == ["step_0000000003", "step_0000000004"]

    def test_maybe_save_cadence(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every_steps=10, keep=5)
        t = tree()
        assert mgr.maybe_save(7, t) is None
        assert mgr.maybe_save(10, t) is not None

    def test_restore_empty_dir(self, tmp_path):
        t = tree()
        step, restored, extra = restore_latest(str(tmp_path / "none"), t)
        assert step is None and restored is t and extra == {}


# ---------------------------------------------------------------------------
# The two packages' checkpoints of one state
# ---------------------------------------------------------------------------

ARCH = "llama3.2-1b"


@lru_cache(maxsize=1)
def _jax_params():
    """The JAX smoke init (immutable arrays: one init serves every test)."""
    jcfg = jconfigs.get_smoke(ARCH)
    return jax.jit(partial(JM.init_params, jcfg))(jax.random.PRNGKey(0))


def _states(opt_name):
    """One train state in both packages: the JAX smoke init carried across,
    and the optimizer's state at step 3 with random moments (the same
    numbers on both sides)."""
    jparams = _jax_params()
    jopt = (joptim.adamw() if opt_name == "adamw" else joptim.adafactor())
    jstate = jopt.init(jparams)
    rng = np.random.default_rng(1)
    inner = jax.tree.map(
        lambda x: rng.random(x.shape, np.float32), jstate.inner)
    jstate = joptim.OptState(jnp.asarray(3, jnp.int32),
                             jax.tree.map(jnp.asarray, inner))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             configs.get_smoke(ARCH), "cpu")
    state = OptState(3, jax.tree.map(torch.from_numpy, inner))
    return {"params": jparams, "opt": jstate}, {"params": params,
                                                "opt": state}


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_same_state_same_npz(tmp_path, opt_name):
    jtree, ttree = _states(opt_name)
    jpath = jsave_checkpoint(str(tmp_path / "jax"), 3, jtree,
                             extra={"data_step": 3})
    tpath = save_checkpoint(str(tmp_path / "torch"), 3, ttree,
                            extra={"data_step": 3})
    with np.load(os.path.join(jpath, "arrays.0.npz")) as a, \
            np.load(os.path.join(tpath, "arrays.0.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt/.step" in a.files
        assert any(k.startswith("opt/.inner/") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tpath, "manifest.json")) as f:
        tman = json.load(f)
    for field in ("step", "keys", "n_hosts", "extra"):
        assert jman[field] == tman[field], field


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_restores_the_others(tmp_path, writer):
    jtree, ttree = _states("adamw")
    if writer == "jax":
        jsave_checkpoint(str(tmp_path), 3, jtree)
        like = {"params": tree_map(torch.zeros_like, ttree["params"]),
                "opt": OptState(0, tree_map(torch.zeros_like,
                                            ttree["opt"].inner))}
        step, got, _ = restore_latest(str(tmp_path), like)
        assert step == 3 and isinstance(got["opt"], OptState)
        assert got["opt"].step == 3 and type(got["opt"].step) is int
        for (pa, a), (pb, b) in zip(tree_items(got["params"]),
                                    tree_items(ttree["params"])):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
        for (_, a), (_, b) in zip(tree_items(got["opt"].inner),
                                  tree_items(ttree["opt"].inner)):
            assert torch.equal(a, b)
    else:
        save_checkpoint(str(tmp_path), 3, ttree)
        like = jax.tree.map(jnp.zeros_like, jtree)
        step, got, _ = jrestore_latest(str(tmp_path), like)
        assert step == 3 and int(got["opt"].step) == 3
        assert got["opt"].step.dtype == np.int32
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bfloat16_round_trips_bit_exactly(tmp_path):
    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"x": x})
    with np.load(os.path.join(tmp_path, "step_0000000001",
                              "arrays.0.npz")) as data:
        assert data["x"].dtype == np.uint16
    _, got, _ = restore_latest(str(tmp_path),
                               {"x": torch.zeros(7, 5, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


# ---------------------------------------------------------------------------
# The launcher: resume and the divergence guard
# ---------------------------------------------------------------------------

def _flags(tmp_path, steps, every):
    return ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
            str(steps), "--batch", "2", "--seq", "16", "--remat", "dtr",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", str(every)]


class Interrupt(Exception):
    pass


def test_interrupted_and_resumed_run_is_bit_identical(tmp_path, capsys):
    whole = train.main(_flags(tmp_path / "whole", 6, 2))

    def stop_at_5(step):
        if step == 5:
            raise Interrupt

    first = train.TrainResult()
    with pytest.raises(Interrupt):
        train.main(_flags(tmp_path / "cut", 6, 2), on_step=stop_at_5,
                   result=first)
    assert first.steps == [0, 1, 2, 3, 4]
    assert sorted(os.listdir(tmp_path / "cut")) == [
        "step_0000000002", "step_0000000004"]
    resumed = train.main(_flags(tmp_path / "cut", 6, 2))
    assert "resumed at step 5" in capsys.readouterr().out
    assert resumed.start_step == 5 and resumed.steps == [5]
    assert first.losses == whole.losses[:5]
    assert resumed.losses == whole.losses[5:]
    for (pa, a), (pb, b) in zip(tree_items(resumed.params),
                                tree_items(whole.params)):
        assert pa == pb and torch.equal(a, b), pa
    assert resumed.opt_state.step == whole.opt_state.step == 6
    for (_, a), (_, b) in zip(tree_items(resumed.opt_state.inner),
                              tree_items(whole.opt_state.inner)):
        assert torch.equal(a, b)
    assert not [d for d in os.listdir(tmp_path / "cut")
                if d.startswith(".tmp_ckpt_")]


def test_nan_loss_is_skipped_then_restored(tmp_path, capsys):
    """A NaN parameter from step 3 on: three steps skipped, the fourth bad
    one restores the step-2 checkpoint, and training goes on finite."""
    res = train.TrainResult()

    def poison(step):
        if step == 3:
            with torch.no_grad():
                res.params["final_norm"]["scale"][0] = float("nan")

    train.main(_flags(tmp_path, 9, 2), on_step=poison, result=res)
    out = capsys.readouterr().out
    assert res.actions == ["ok"] * 3 + ["skip"] * 3 + ["restore"] + \
        ["ok"] * 2
    assert all(np.isnan(res.losses[3:7]))
    assert "step 3: bad step" in out and "step 6: restored from 2" in out
    assert res.opt_state.step == 5      # steps 0-2, then 7 and 8
    assert all(bool(torch.isfinite(t).all())
               for _, t in tree_items(res.params))
