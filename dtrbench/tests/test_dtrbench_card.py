"""On the card, at the cells' own sizes: a run prints a correct line, and
the control (fp8 products in the program's place) fails the cell's
limits.  Skipped without a card.

  python -m pytest -q -m requires_cuda dtrbench/tests/test_dtrbench_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from dtrbench.lib import check, harness
from dtrbench.lib.bench import ROOT as BENCH, Bench
from dtrbench.reference import common

pytestmark = pytest.mark.requires_cuda


@pytest.mark.parametrize("cell", ["rwkv6-train-dtr", "mixtral-train-dtr"])
def test_control_fails_at_the_cells_size(cuda, cell):
    bench = Bench()
    c = bench.cell(cell)
    cfg = bench.config(c["config"])
    traffic = dict(bench.traffic(c["traffic"]), lr_total=harness.STEPS_CAP)
    family = bench.family(cfg)
    seed = 2 ** 31 + 17
    ref = common.train_readings(family, cfg["model"], traffic, seed, cuda)
    ctl = common.train_readings(family, cfg["model"], traffic, seed, cuda,
                                common.FP8)
    ok, rows = check.verdict(check.compare(ctl, ref), c["limits"])
    assert not ok, rows


def test_a_short_run_is_correct(cuda):
    # The run is a process of its own: give it the card whole.
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mixtral-train-dtr", "--seed", str(2 ** 31 + 18), "--seconds", "3",
         "--trace", "0"], cwd=BENCH.parent, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
