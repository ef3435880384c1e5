"""The plain references against the port at smoke size on the CPU, and
the control (the reference with fp8 products in the program's place)
failing the cells' own limits there."""
from __future__ import annotations

import time

import pytest

from dtrbench.lib import check, harness
from dtrbench.reference import common

CELLS = ["mixtral-train-dtr", "rwkv6-train-dtr", "mixtral-train-none",
         "rwkv6-train-none"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port_in_f32(smoke_bench, cell):
    """Same weights and tokens, both in f32: the port's three steps (its
    launcher loop, remat policy, plain kernels and AdamW) and the
    reference's agree to f32 rounding, number by number."""
    out = harness.run_cell(smoke_bench, cell + "-smoke", 20260 + len(cell),
                           0.2, False, "cpu", time.perf_counter())
    for name, row in out["checks"].items():
        assert row["value"] < 1e-5, (name, row)
    assert out["correct"]


@pytest.mark.parametrize("cell", ["mixtral-train-dtr", "rwkv6-train-dtr"])
def test_control_fails_the_cells_limits(smoke_bench, cell):
    bench = smoke_bench
    c = bench.cell(cell)
    cfg = bench.config(c["config"] + "-smoke")
    traffic = dict(bench.traffic(c["traffic"] + "-smoke"),
                   lr_total=harness.STEPS_CAP)
    family = bench.family(cfg)
    for seed in (1, 2, 3):
        ref = common.train_readings(family, cfg["model"], traffic, seed,
                                    "cpu")
        ctl = common.train_readings(family, cfg["model"], traffic, seed,
                                    "cpu", common.FP8)
        ok, rows = check.verdict(check.compare(ctl, ref), c["limits"])
        assert not ok, rows


def test_fp8_rounding_keeps_the_scale_and_three_mantissa_bits():
    import torch
    x = torch.tensor([1.0, 1.0626, -3.0, 448.0, 0.0])
    y = common.fp8_round(x, torch.float8_e4m3fn)
    assert y[0] == 1.0 and y[2] == -3.0 and y[3] == 448.0 and y[4] == 0.0
    assert y[1] in (1.0, 1.125)
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((common.fp8_round(g, torch.float8_e4m3fn) - g).abs()
           / g.abs()).median()
    assert 0.005 < rel < 0.04


def test_schedule_and_adamw_scalars_are_the_launchers():
    from repro_torch.optim import cosine_schedule
    lr = cosine_schedule(3e-4, warmup=20, total=harness.STEPS_CAP)
    for step in (1, 2, 3, 25):
        assert common.lr_at(step, 3e-4, common.WARMUP,
                            harness.STEPS_CAP) == lr(step)
