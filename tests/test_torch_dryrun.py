"""The port's dry run (``repro_torch.launch.dryrun``) on a fake 256- and
512-rank process group.

The fake group is process-wide state, so each cell runs in a subprocess
(as ``tests/test_dryrun.py`` runs the reference's), with a 300 s limit:
qwen2-0.5b ``decode_32k`` on both meshes, the reference test's cell, with
its fields (``chips``, positive roofline terms, a known ``dominant``) and
an H100's 80 GiB in place of 16, and the largest storages at its peak
and the largest implicitly replicated tensor recorded.  Its argument bytes
a device equal the bytes the reference's specs give on ``AbstractMesh``
(computed here from ``param_pspec``, no compile).  The dry run's tables equal the reference's
by value (read in a subprocess: importing ``repro.launch.dryrun`` forces
jax's device count).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _run(args, timeout=300):
    return subprocess.run([sys.executable, *args], env=ENV,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    res = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
                "--shape", "decode_32k", "--mesh", "both", "--device", "cpu",
                "--out", str(out)])
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "all cells OK" in res.stdout
    return {m: json.loads((out / f"qwen2-0.5b_decode_32k_{m}.json")
                          .read_text()) for m in ("single", "multi")}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_single_cell(cells, mesh):
    res = cells[mesh]
    assert res["chips"] == (512 if mesh == "multi" else 256)
    assert res["memory"]["peak_bytes_per_device"] < 80 * 2**30
    assert res["memory"]["peak_bytes_per_device"] >= \
        res["memory"]["argument_bytes"] > 0
    r = res["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert res["rule_overrides"] == {"kv_seq": "model"}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_peak_tensors_and_implicit_replication_recorded(cells, mesh):
    """The largest storages live at the peak, largest first, none above
    the peak, each with the op that made it; the largest plain tensor that
    met a DTensor op is small (RoPE's angles, not a model tensor)."""
    res = cells[mesh]
    top = res["peak_tensors"]
    sizes = [t["bytes"] for t in top]
    assert len(top) == dryrun.PEAK_TENSORS and sizes == sorted(sizes,
                                                              reverse=True)
    assert sum(sizes) <= res["memory"]["peak_bytes_per_device"]
    assert all(t["op"] and t["local_shape"] for t in top)
    assert 0 < res["implicit_replication"]["max_bytes"] < 2**20


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_argument_bytes_equal_reference_specs(cells, mesh):
    """Parameters, KV caches, the token column and the position clock,
    each a device's shard by the reference's ``param_pspec`` and
    ``pspec`` on the ``AbstractMesh``."""
    shape, names = ((2, 16, 16), ("pod", "data", "model")) \
        if mesh == "multi" else ((16, 16), ("data", "model"))
    amesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    cfg = jconfigs.get("qwen2-0.5b")
    spec = dryrun.SHAPES["decode_32k"]

    def local(shape_, pspec):
        n = list(shape_)
        for i, entry in enumerate(pspec):
            for a in (entry if isinstance(entry, tuple) else (entry,)
                      if entry else ()):
                n[i] //= sizes[a]
        return math.prod(n)

    total = 0
    with JS.mesh_context(None, overrides=dryrun.rule_overrides(
            "decode_32k")):
        for tree in (JM.param_defs(cfg),
                     JM.cache_defs(cfg, spec["batch"], spec["seq"])):
            for info in jax.tree.leaves(
                    tree, is_leaf=lambda x: isinstance(x, JS.ParamInfo)):
                total += local(info.shape, JS.param_pspec(
                    info, mesh=amesh, fsdp=False)) * np.dtype(
                        info.dtype).itemsize
        total += local((spec["batch"], 1),
                       JS.pspec("batch", mesh=amesh)) * 4 + 4
    assert cells[mesh]["memory"]["argument_bytes"] == total


def test_tables_equal_reference():
    res = _run(["-c", (
        "import json; from repro.launch import dryrun as d; "
        "print(json.dumps({'SHAPES': d.SHAPES, 'LONG_OK': sorted(d.LONG_OK),"
        " 'FSDP_ARCHS': sorted(d.FSDP_ARCHS), 'OPTIMIZER': d.OPTIMIZER, "
        "'GRAD_ACCUM': d.GRAD_ACCUM, 'BF16_PARAMS': sorted(d.BF16_PARAMS), "
        "'_CANONICAL': d._CANONICAL, 'CELLS': d.CELLS}))")], timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {"SHAPES": dryrun.SHAPES, "LONG_OK": sorted(dryrun.LONG_OK),
           "FSDP_ARCHS": sorted(dryrun.FSDP_ARCHS),
           "OPTIMIZER": dryrun.OPTIMIZER, "GRAD_ACCUM": dryrun.GRAD_ACCUM,
           "BF16_PARAMS": sorted(dryrun.BF16_PARAMS),
           "_CANONICAL": dryrun._CANONICAL,
           "CELLS": [list(c) for c in dryrun.CELLS]}
    assert got == want
    # 40 cells a mesh less the 6 long-context cells of full-attention
    # archs: 34 on each of the two meshes.
    runs = [c for c in dryrun.CELLS
            if c[1] != "long_500k" or c[0] in dryrun.LONG_OK]
    assert len(runs) * 2 == 68


@pytest.mark.parametrize("shape,want", [
    ("train_4k", {"seq": "model"}), ("prefill_32k", {"seq": "model"}),
    ("decode_32k", {"kv_seq": "model"}),
    ("long_500k", {"batch": None, "kv_seq": ("pod", "data", "model")})])
def test_rule_overrides_are_the_references(shape, want):
    """``repro/launch/dryrun.py``'s overrides per shape, by value."""
    assert dryrun.rule_overrides(shape) == want


def test_production_mesh_needs_its_world():
    """Without the fake group the production mesh fails as the
    reference's does on a host with too few devices."""
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(AssertionError,
                       match=r"need 512 devices for mesh \(2, 16, 16\), "
                             r"have 1"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_perf_variants_are_the_references():
    """``launch/perf.py``'s variants: the reference's, by name and
    arguments, less those of its analytic Pallas-kernel model
    (``flash_analytic``), which the traced kernels make moot."""
    from repro_torch.launch import perf
    res = _run(["-c", (
        "import json; from repro.launch import perf as p; "
        "print(json.dumps({c: [[n, kw] for n, _, kw in v] "
        "for c, v in p.VARIANTS.items()}))")], timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {c: [[n, json.loads(json.dumps(kw))] for n, _, kw in v]
           for c, v in perf.VARIANTS.items()}
    assert got == {c: [[n, kw] for n, kw in v if "flash_analytic" not in kw]
                   for c, v in want.items()}
