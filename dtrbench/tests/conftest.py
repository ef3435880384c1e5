"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
files with tiny configurations beside them, and the card fixture.

Run from the repository root: ``python -m pytest -q dtrbench/tests``.
Tests marked ``requires_cuda`` run on the card and skip elsewhere; the
fixture ``cuda`` decides, inside the test, never at import.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from dtrbench.lib.bench import ROOT as BENCH, Bench  # noqa: E402

SMOKE = {
    "mixtral-8x7b-2l": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                            d_ff=96, moe_d_ff=96, n_experts=4, vocab=256),
    "rwkv6-1.6b": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                       head_dim=32, rwkv_head_dim=32, d_ff=128, vocab=256),
}
SMOKE_TRAFFIC = dict(batch=2, seq=64)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA card; skips elsewhere")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_smoke_bench(tmp: Path, dtype: str = "float32") -> Bench:
    """A copy of the benchmark's files with, beside each cell, a tiny
    ``<cell>-smoke`` cell of the same family on a ``<config>-smoke``
    configuration (the cell's limits kept), added as new files."""
    root = Path(tmp)
    for d in ("configs", "workloads", "traffic", "metrics", "reference"):
        shutil.copytree(BENCH / d, root / d)
    for name, sizes in SMOKE.items():
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg["name"] = name + "-smoke"
        cfg["model"].update(sizes, dtype=dtype)
        (root / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    for path in sorted((BENCH / "workloads").glob("*.json")):
        cell = json.loads(path.read_text())
        traffic = json.loads(
            (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
        traffic.update(SMOKE_TRAFFIC, name=traffic["name"] + "-smoke")
        (root / "traffic" / f"{traffic['name']}.json").write_text(
            json.dumps(traffic))
        cell.update(name=cell["name"] + "-smoke",
                    config=cell["config"] + "-smoke",
                    traffic=traffic["name"])
        (root / "workloads" / f"{cell['name']}.json").write_text(
            json.dumps(cell))
    return Bench(root)


@pytest.fixture
def smoke_bench(tmp_path):
    return make_smoke_bench(tmp_path)
