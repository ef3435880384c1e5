"""The port's training driver, examples and paper benchmarks against the
JAX package's, on the CPU at small sizes:

* the launcher's flags take the reference's defaults, and ``--help`` shows
  them; the mesh flags it cannot honour on one card raise;
* the monitors' copy passes ``tests/test_substrate.py::TestMonitors`` and
  the ``MemoryMonitor`` cases of ``tests/test_alloc.py``;
* the llama3.2-1b and smollm-135m smoke configs: logits (within 1e-5 of
  their largest magnitude), loss (1e-5) and every gradient (1e-4 of its
  largest magnitude) against the JAX model;
* Table 1 and Fig. 4: the simulated rows on cut cases against rows computed
  here through ``repro.core``; the eager Table 1 row at dim 128 against the
  JAX original, both at unit cost; the Table 1 row ``chip_smoke.py`` pins;
* the three examples: the quickstart's parts, 20 steps of ``train_lm``
  (loss falls), and ``dynamic_treelstm``'s losses under its byte budget
  equal to an unbudgeted run's.
"""
import argparse
import sys
from dataclasses import asdict
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.table1_maxinput as jtable1  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.alloc import FragStats  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro.core.heuristics import by_name as jby_name  # noqa: E402
from repro.eager import DTRContext as JDTRContext  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.benchmarks import fig4_overhead, table1_maxinput  # noqa: E402
from repro_torch.distributed.monitor import (DivergenceGuard,  # noqa: E402
                                             MemoryMonitor, StragglerMonitor)
from repro_torch.eager import DTRContext  # noqa: E402
from repro_torch.examples import (dynamic_treelstm, quickstart,  # noqa: E402
                                  train_lm)
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes run fastest on one thread (and do not contend with the
    other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The launcher's flags
# ---------------------------------------------------------------------------

class _Parser(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser ``repro.launch.train.main`` builds, caught as it parses."""
    def grab(self, args=None, namespace=None):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parser) as caught:
        jtrain.main([])
    monkeypatch.undo()
    return caught.value.args[0]


def test_launcher_defaults_match_reference(monkeypatch):
    ref = {a.dest: a.default for a in _reference_parser(monkeypatch)._actions
           if a.dest != "help"}
    port = vars(train.parse_args([]))
    shared = ref.keys() & port.keys()
    assert shared == ref.keys()          # every reference flag is taken
    assert {k: port[k] for k in shared} == ref
    assert (port["arch"], port["remat"], port["ckpt_dir"],
            port["ckpt_every"]) == ("llama3.2-1b", "dtr",
                                    "/tmp/repro_train_ckpt", 50)


def test_launcher_help_shows_defaults(monkeypatch, capsys):
    ref = _reference_parser(monkeypatch)
    with pytest.raises(SystemExit):
        train.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for a in ref._actions:
        if a.dest != "help":
            assert f"(default: {a.default})" in text, a.dest


@pytest.mark.parametrize("flags", [["--mesh", "production"], ["--fsdp"],
                                   ["--seq-shard"]])
def test_launcher_refuses_mesh_flags(flags, tmp_path):
    """What the reference's launcher refuses, on one process: the
    production mesh, with its own assertion.  ``--fsdp`` and
    ``--seq-shard`` run on the host mesh (tests/test_torch_sharding.py
    holds their losses to the reference's)."""
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16", "--remat",
            "none", "--ckpt-dir", str(tmp_path), *flags]
    assert train.parse_args(argv).mesh == flags[-1] if "--mesh" in flags \
        else train.parse_args(argv).mesh == "host"
    if "--mesh" in flags:
        with pytest.raises(AssertionError,
                           match=r"need 256 devices for mesh \(16, 16\), "
                                 r"have 1"):
            train.main(argv)
    else:
        assert len(train.main(argv).losses) == 1


def test_device_memory_degrades_on_cpu():
    assert train.device_memory(CPU) == (0, None)


# ---------------------------------------------------------------------------
# The monitors' copy: tests/test_substrate.py and tests/test_alloc.py
# ---------------------------------------------------------------------------

class TestMonitors:
    def test_straggler_flags_outlier(self):
        fired = []
        mon = StragglerMonitor(threshold=2.0, patience=2,
                               on_straggler=fired.append)
        for i in range(10):
            mon.record(i, 0.1)
        mon.record(10, 0.5)
        mon.record(11, 0.5)
        assert any(s.flagged for s in mon.history)
        assert fired, "straggler callback should fire after patience"

    def test_straggler_ewma_robust(self):
        mon = StragglerMonitor()
        for i in range(5):
            mon.record(i, 0.1)
        mon.record(5, 10.0)  # outlier not folded into ewma
        assert mon.ewma < 0.2

    def test_divergence_guard(self):
        g = DivergenceGuard(spike_factor=10.0, max_skips=2)
        assert g.check(1.0, 1.0) == "ok"
        assert g.check(1.1, 1.0) == "ok"
        assert g.check(float("nan"), 1.0) == "skip"
        assert g.check(float("nan"), 1.0) == "skip"
        assert g.check(float("nan"), 1.0) == "restore"
        assert g.check(1.0, 1.0) == "ok"  # recovers

    def test_memory_monitor_surfaces_frag(self):
        mon = MemoryMonitor()
        mon.record(0, peak_bytes=100.0)
        st = FragStats(capacity=100, used=60, free=40, largest_free=10,
                       frag_ratio=0.75, failed_fits=2, evict_windows=1)
        s = mon.record(1, peak_bytes=90.0, frag=st)
        assert s.largest_free == 10 and s.frag_ratio == 0.75
        summary = mon.summary()
        assert summary["peak_bytes"] == 100.0
        assert summary["max_frag_ratio"] == 0.75
        assert summary["min_largest_free"] == 10
        assert summary["failed_fits"] == 2

    def test_memory_monitor_without_telemetry(self):
        mon = MemoryMonitor()
        mon.record(0, peak_bytes=50.0)
        s = mon.summary()
        assert s["peak_bytes"] == 50.0
        assert s["min_largest_free"] is None
        assert s["max_frag_ratio"] is None


# ---------------------------------------------------------------------------
# The two new configs against the JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "smollm-135m"])
def test_smoke_config_matches_jax(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    assert asdict(cfg) == asdict(jcfg)
    assert asdict(configs.get(arch)) == asdict(jconfigs.get(arch))
    jparams = jax.jit(partial(JM.init_params, jcfg))(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32), dtype=np.int32)
    logits = M.forward(cfg, params, torch.from_numpy(tokens))
    want = np.asarray(jax.jit(partial(JM.forward, jcfg))(
        jparams, jnp.asarray(tokens)))
    # The tied N(0, 1) token table gives logits of tens, so the f32
    # summation order shows at 1e-5 of their largest magnitude.
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(
        jcfg, p, {"tokens": jnp.asarray(tokens)})))(jparams)
    loss, grads = loss_and_grads(cfg, params,
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    flat = dict(tree_items(grads))
    assert flat.keys() == jflat.keys()
    for path, g in flat.items():
        want = jflat[path]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (path, err)


# ---------------------------------------------------------------------------
# Table 1 and Fig. 4
# ---------------------------------------------------------------------------

JCASES = {
    "mlp": lambda m: jgraphs.mlp(depth=16, batch=8 * m),
    "transformer": lambda m: jgraphs.transformer(layers=6, d=32, seq=8,
                                                 batch=2 * m),
    "treelstm": lambda m: jgraphs.treelstm(depth=3 + m),
    "lstm": lambda m: jgraphs.lstm(steps=16 * m),
}


def _reference_sim_row(model, multipliers):
    """``benchmarks/table1_maxinput.py::run_simulated``'s row for one model,
    through the JAX package's engine."""
    fn = JCASES[model]
    budget = 1.05 * jsimulator.measure_baseline(fn(1))[0]
    max_plain = max_dtr = 0
    for m in multipliers:
        log = fn(m)
        if jsimulator.measure_baseline(log)[0] <= budget:
            max_plain = m
        r = jsimulator.simulate(log, jby_name("h_dtr_eq"), budget=budget)
        if r.ok and r.slowdown < 2.0:
            max_dtr = m
    return dict(bench="sim", model=model, budget=int(budget),
                max_plain=max_plain, max_dtr=max_dtr,
                gain=round(max_dtr / max(max_plain, 1), 2))


@pytest.mark.parametrize("model", table1_maxinput.MODELS)
def test_run_simulated_matches_reference(model):
    rows = table1_maxinput.run_simulated(models=(model,),
                                         multipliers=range(1, 3))
    assert rows == [_reference_sim_row(model, range(1, 3))]


def test_chip_smoke_pins_the_reference_table1_row():
    """``chip_smoke.py`` phase 9d runs one whole simulated case on the
    card's host and holds its row to this one."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    model = chip_smoke.TABLE1_CASE
    assert chip_smoke.TABLE1_ROW == _reference_sim_row(model, range(1, 9))


@pytest.mark.parametrize("model", ["transformer"])
def test_run_meta_accesses_matches_reference(model):
    log = jgraphs.transformer(layers=8, d=32, seq=16)
    peak, _ = jsimulator.measure_baseline(log)
    want = []
    for h in ("h_dtr", "h_dtr_eq", "h_dtr_local"):
        for frac in (0.6, 0.4):
            r = jsimulator.simulate(log, jby_name(h), budget=frac * peak,
                                    index=False)
            want.append(dict(bench="meta", model=model, heuristic=h,
                             budget=frac, ok=r.ok,
                             meta_accesses=r.meta_accesses,
                             value=r.meta_accesses))
    for opts, tag in ((dict(), "exact"),
                      (dict(ignore_small_frac=0.01), "no_small"),
                      (dict(sample_sqrt=True), "sqrt_sample"),
                      (dict(ignore_small_frac=0.01, sample_sqrt=True),
                       "both")):
        r = jsimulator.simulate(log, jby_name("h_dtr_eq"), budget=0.5 * peak,
                                index=False, **opts)
        want.append(dict(bench="e2_opts", model=model,
                         heuristic=f"h_dtr_eq/{tag}", budget=0.5, ok=r.ok,
                         meta_accesses=r.meta_accesses,
                         value=r.meta_accesses))
    assert fig4_overhead.run_meta_accesses(models=(model,)) == want


def test_eager_treelstm_row_matches_jax_at_unit_cost(monkeypatch):
    monkeypatch.setattr(jtable1, "DTRContext",
                        partial(JDTRContext, use_wallclock_cost=False))
    monkeypatch.setattr(table1_maxinput, "DTRContext",
                        partial(DTRContext, use_wallclock_cost=False))
    rows = table1_maxinput.run_eager_treelstm(dim=128, device="cpu")
    assert rows == jtable1.run_eager_treelstm()
    assert rows[0]["max_dtr"] > rows[0]["max_plain"]


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------

def test_quickstart_three_parts(capsys):
    out = quickstart.main(["--device", "cpu"])
    log = jgraphs.transformer(layers=6, d=32, seq=16)
    peak, _ = jsimulator.measure_baseline(log)
    for frac, r in zip((0.8, 0.5, 0.3), out["simulated"]):
        j = jsimulator.simulate(log, jby_name("h_dtr_eq"),
                                budget=frac * peak)
        assert (r.ok, r.evictions, r.remat_ops) == \
            (j.ok, j.evictions, j.remat_ops)
    assert out["eager"].rt.evictions > 0 and out["eager"].remat_runs > 0
    losses = out["losses"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "== 3." in capsys.readouterr().out


def test_train_lm_learns_on_cpu(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--steps", "20", "--batch", "2",
                         "--seq", "32", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "15"])
    assert out["verdict"] == "LEARNING" and out["steps"] == list(range(20))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000000", "step_0000000015"]
    text = capsys.readouterr().out
    assert "LEARNING" in text and "straggler flags" in text
    again = train_lm.main(["--device", "cpu", "--steps", "18", "--batch",
                           "2", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert again["steps"] == [16, 17]
    assert "resumed at step 16" in capsys.readouterr().out


def test_dynamic_treelstm_budget_changes_no_loss():
    budgeted = dynamic_treelstm.train(CPU, steps=4)
    free = dynamic_treelstm.train(CPU, steps=4, budget=float("inf"))
    assert budgeted["ctx"].remat_runs > 0 and free["ctx"].remat_runs == 0
    assert budgeted["losses"] == free["losses"]
    assert budgeted["over_budget"] <= 0
