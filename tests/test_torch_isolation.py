"""The port stands alone: it imports neither JAX nor the JAX package, and
its copies of plain-Python modules stay equal to the originals."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_and_no_reference_package(path):
    bad = [(line, mod) for line, mod in _imports(path)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _relative_targets(path: Path):
    """Each relative import of a module, function bodies included (the
    lazy ones too), as the file or package it names."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = path.parent
            for _ in range(node.level - 1):
                base = base.parent
            if node.module:
                yield node.lineno, base.joinpath(*node.module.split("."))
            else:
                for a in node.names:
                    yield node.lineno, base / a.name


@pytest.mark.parametrize("path", PORT_FILES[:-1],
                         ids=[str(p.relative_to(ROOT))
                              for p in PORT_FILES[:-1]])
def test_relative_imports_resolve_inside_the_port(path):
    missing = [(line, str(t.relative_to(ROOT)))
               for line, t in _relative_targets(path)
               if not (t.with_suffix(".py").is_file()
                       or (t / "__init__.py").is_file())]
    assert not missing, f"{path.relative_to(ROOT)} imports {missing}"


def _without_imports(text: str) -> list:
    """The lines of a module that are not import statements."""
    tree = ast.parse(text)
    skip = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            skip.update(range(node.lineno, node.end_lineno + 1))
    return [ln for i, ln in enumerate(text.splitlines(), start=1)
            if i not in skip]


COPIES = [
    "core/graph.py", "models/config.py", "configs/qwen2_0_5b.py",
    "configs/mixtral_8x7b.py", "configs/rwkv6_1_6b.py",
    "configs/llama3_2_1b.py", "configs/smollm_135m.py",
    "configs/deepseek_v3_671b.py", "configs/gemma3_1b.py",
    "configs/recurrentgemma_2b.py", "configs/llama3_2_vision_11b.py",
    "configs/musicgen_large.py",
    # The analysis package's HLO parsers.
    "analysis/hlo.py", "analysis/hlo_cost.py", "analysis/__init__.py",
    # The training loop's health monitors.
    "distributed/monitor.py",
    # The DTR engine the eager executor drives, and what it imports.
    "core/unionfind.py", "core/evict_index.py", "core/heuristics.py",
    "core/runtime.py", "core/simulator.py", "core/graphs.py",
    "faults/__init__.py", "faults/schedule.py", "faults/recovery.py",
    "alloc/__init__.py", "alloc/pool.py", "alloc/allocator.py",
    "offload/__init__.py", "offload/engine.py", "offload/host.py",
    "offload/predictor.py", "offload/transfer.py",
    "check/trace_lint.py", "check/sanitizer.py",
    "trace/record.py", "trace/replay.py",
    "static/__init__.py", "static/chain.py", "static/executor.py",
    "static/lpbound.py", "static/panel.py", "static/solvers.py",
    # The serve loop's admission control.
    "launch/admission.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_originals_apart_from_imports(rel):
    assert _without_imports((PORT / rel).read_text()) == \
        _without_imports((REF / rel).read_text())


def test_registry_holds_ported_architectures_only():
    from repro_torch import configs
    assert configs.get("qwen2-0.5b").n_layers == 24
    assert configs.get_smoke("qwen2_0_5b").dtype == "float32"
    assert configs.get("mixtral-8x7b").n_experts == 8
    assert configs.get_smoke("mixtral_8x7b").window == 8
    assert configs.get("rwkv6-1.6b").pattern == ("rwkv",)
    assert configs.get_smoke("rwkv6_1_6b").rwkv_head_dim == 32
    assert configs.get("llama3.2-1b").n_kv_heads == 8
    assert configs.get_smoke("llama3_2_1b").head_dim == 8
    assert configs.get("smollm-135m").n_heads == 9
    assert configs.get_smoke("smollm_135m").dtype == "float32"
    assert configs.get("deepseek-v3-671b").n_dense_layers == 3
    assert configs.get_smoke("deepseek_v3_671b").mla
    gemma = configs.get("gemma3-1b")
    assert (gemma.n_groups, gemma.pattern, gemma.tail, gemma.window,
            gemma.head_dim, gemma.mlp_act) == (
        4, ("attn_local",) * 5 + ("attn",), ("attn_local", "attn_local"),
        512, 256, "gelu")
    assert configs.get_smoke("gemma3_1b").window == 8
    rg = configs.get("recurrentgemma-2b")
    assert (rg.n_groups, rg.pattern, rg.tail, rg.lru_width, rg.conv_width,
            rg.window, rg.head_dim, rg.mlp_act) == (
        8, ("rglru", "rglru", "attn_local"), ("rglru", "rglru"), 2560, 4,
        2048, 256, "gelu")
    assert configs.get_smoke("recurrentgemma_2b").lru_width == 64
    vision = configs.get("llama-3.2-vision-11b")
    assert (vision.n_groups, vision.pattern, vision.cross_attn_tokens,
            vision.cross_attn_dim) == (8, ("attn",) * 4 + ("cross",), 1601,
                                       7680)
    assert configs.get_smoke("llama3_2_vision_11b").cross_attn_dim == 48
    music = configs.get("musicgen-large")
    assert (music.n_codebooks, music.n_heads, music.n_kv_heads,
            music.head_dim) == (4, 32, 32, 64)
    assert configs.get_smoke("musicgen_large").n_codebooks == 4
    with pytest.raises(KeyError, match="unknown architecture"):
        configs.get("llama-4")


def test_registry_equals_the_reference():
    """Every architecture of the JAX package, in its order, under its
    aliases."""
    from repro import configs as jconfigs
    from repro_torch import configs
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.ALIASES == jconfigs.ALIASES
