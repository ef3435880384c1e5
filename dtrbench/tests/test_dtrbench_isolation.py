"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and nothing in it reads the JAX package's
benchmarks."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

from dtrbench.lib import isolation
from dtrbench.lib.bench import ROOT as BENCH


def test_names_are_compared_whole_at_the_top_level():
    mods = ["repro_torch", "repro_torch.kernels.ops", "reprox", "jaxtyping",
            "numpy", "flax_like", "dtrbench.lib"]
    assert isolation.forbidden_loaded(mods) == []
    mods += ["repro", "repro.core.graphs", "jax.numpy", "jaxlib", "flax"]
    assert isolation.forbidden_loaded(mods) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.core.graphs"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole CPU run of a tiny cell in a fresh process, then the check."""
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(BENCH.parent / 'src')!r}, {str(BENCH.parent)!r},
                        {str(BENCH / 'tests')!r}]
        import torch
        torch.set_num_threads(2)
        from conftest import make_smoke_bench
        from dtrbench.lib import harness, isolation
        bench = make_smoke_bench({str(tmp_path)!r})
        out = harness.run_cell(bench, "mixtral-train-dtr-smoke", 5, 0.2, True,
                               "cpu", time.perf_counter())
        print(json.dumps([out["correct"], isolation.forbidden_loaded()]))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and loaded == []


def test_no_benchmark_file_imports_the_jax_side_or_its_benchmarks():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in isolation.FORBIDDEN | {"benchmarks"}, \
                    (path, n)
        if path.parent.name != "tests":
            assert "benchmarks/" not in path.read_text(), path
