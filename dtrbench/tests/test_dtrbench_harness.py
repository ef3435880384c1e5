"""The harness finds its parts by name, a new part is a new file, and a
run's last line has the contract's shape (on the CPU, tiny sizes)."""
from __future__ import annotations

import json
import math
import shutil
import time
import weakref

import pytest

from dtrbench import run as run_mod
from dtrbench.lib import harness
from dtrbench.lib.bench import ROOT as BENCH, Bench

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
# Cells and readers kept as files but held out of BENCHMARK.json: the
# host-paced rwkv6 cells (PERF.md, Open questions).
HELD_BACK_CELLS = {"rwkv6-train-dtr", "rwkv6-train-none"}
HELD_BACK_METRICS = {"wkv_roofline.train"}


def test_benchmark_json_names_files_that_exist():
    bench = Bench()
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert not set(cells) & HELD_BACK_CELLS
    assert set(cells) | HELD_BACK_CELLS == set(bench.cells())
    for name, w in cells.items():
        cell = bench.cell(name)
        assert {k: cell[k] for k in w} == w
        assert bench.traffic(cell["traffic"])["name"] == cell["traffic"]
        cfg = bench.config(cell["config"])
        assert bench.family(cfg).layout(cfg["model"])
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for m in SPEC["per_layer"]:
        assert callable(bench.metric(m["name"]))
        assert set(m.get("workloads", cells)) <= set(cells)
    assert {m["name"] for m in SPEC["per_layer"]} | HELD_BACK_METRICS \
        == set(bench.metric_names())


@pytest.mark.parametrize("cell", ["rwkv6-train-dtr", "mixtral-train-none"])
def test_program_config_takes_every_size_of_the_file(cell):
    bench = Bench()
    c = bench.cell(cell)
    cfg = bench.config(c["config"])
    mcfg = harness.model_config(cfg, bench.traffic(c["traffic"]))
    assert all(getattr(mcfg, k) == v for k, v in cfg["model"].items())
    harness.check_layout(mcfg, bench.family(cfg).layout(cfg["model"]))


def test_unknown_names_are_refused():
    bench = Bench()
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")
    with pytest.raises(KeyError):
        bench.metric("no_such_metric")


def test_parts_added_as_new_files_are_found_without_editing_one(tmp_path):
    """A configuration, a traffic mix, a cell and a metric reader, each a
    new file; no file that was there changes."""
    root = tmp_path / "bench"
    for d in ("configs", "workloads", "traffic", "metrics", "reference"):
        shutil.copytree(BENCH / d, root / d)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "rwkv6-1.6b.json").read_text())
    cfg["name"] = "rwkv6-tiny"
    cfg["model"].update(n_layers=1, d_model=32, n_heads=1, n_kv_heads=1,
                        head_dim=32, rwkv_head_dim=32, d_ff=64, vocab=128,
                        dtype="float32")
    (root / "configs" / "rwkv6-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads(
        (root / "traffic" / "train-4x1024-none.json").read_text())
    traffic.update(name="train-2x32-none", batch=2, seq=32)
    (root / "traffic" / "train-2x32-none.json").write_text(
        json.dumps(traffic))
    cell = json.loads((root / "workloads" / "rwkv6-train-none.json")
                      .read_text())
    cell.update(name="rwkv6-tiny-train", config="rwkv6-tiny",
                traffic="train-2x32-none")
    (root / "workloads" / "rwkv6-tiny-train.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "steps_in_window.train.py").write_text(
        "def read(run):\n    return len(run.stamps) - 1\n")
    bench = Bench(root)
    assert "rwkv6-tiny-train" in bench.cells()
    out = harness.run_cell(bench, "rwkv6-tiny-train", 7, 0.5, False, "cpu",
                           time.perf_counter())
    assert out["correct"]
    assert bench.metric("steps_in_window.train")(out["run"]) >= 1
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_has_the_contract_shape(smoke_bench, traced):
    out = harness.run_cell(smoke_bench, "mixtral-train-dtr-smoke",
                           2 ** 31 + 5, 0.5, traced, "cpu",
                           time.perf_counter())
    names = [(m["name"], m["unit"]) for m in SPEC["per_layer"]
             if "mixtral-train-dtr" in m.get("workloads",
                                             ["mixtral-train-dtr"])]
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 0}
    line = run_mod.result_line(out, smoke_bench, traced, names, device)
    text = json.dumps(line, allow_nan=False)
    back = json.loads(text)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True and back["failed"] == 0
    assert back["attempted"] == len(out["run"].stamps) - 1 >= 1
    for v in back["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    if traced:
        # No device here: only what the host measures is reported.
        assert set(back["metrics"]) <= {n for n, _ in names}
        assert "loop_overhead_share.train" in back["metrics"]
    else:
        assert set(back["metrics"]) == {m["name"] for m in SPEC["end_to_end"]}
    for k, v in back["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


def test_the_peak_opens_with_no_benchmark_buffer_alive(smoke_bench,
                                                      monkeypatch):
    """The start drawn again to read the change is freed before the
    window's peak counter is reset: the program's weights are the only
    drawn buffer alive then."""
    drawn, alive = [], []
    draw = harness.weights.draw

    def tracked(*args, **kwargs):
        flat, leaves = draw(*args, **kwargs)
        drawn.append(weakref.ref(flat))
        return flat, leaves

    monkeypatch.setattr(harness.weights, "draw", tracked)
    monkeypatch.setattr(harness, "open_peak", lambda on_card: alive.append(
        [ref() is not None for ref in drawn]))
    harness.run_cell(smoke_bench, "mixtral-train-dtr-smoke", 11, 0.2, False,
                     "cpu", time.perf_counter())
    assert alive == [[True, False]]


def test_window_steps_are_the_loops_own(smoke_bench):
    out = harness.run_cell(smoke_bench, "mixtral-train-dtr-smoke", 3, 0.5,
                           False, "cpu", time.perf_counter())
    run = out["run"]
    n = len(run.stamps) - 1
    assert len(run.step_seconds) == len(run.losses) == n
    walls = [b - a for a, b in zip(run.stamps, run.stamps[1:])]
    assert all(s <= w for s, w in zip(run.step_seconds, walls))
    assert run.stamps[-1] - run.stamps[0] >= 0.5
    assert 0 < run.setup_s < 60
