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


def _without_imports(text: str) -> list:
    """The lines of a module that are not import statements."""
    tree = ast.parse(text)
    skip = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            skip.update(range(node.lineno, node.end_lineno + 1))
    return [ln for i, ln in enumerate(text.splitlines(), start=1)
            if i not in skip]


@pytest.mark.parametrize("rel", ["core/graph.py", "models/config.py",
                                 "configs/qwen2_0_5b.py",
                                 "configs/mixtral_8x7b.py",
                                 "configs/rwkv6_1_6b.py"])
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
    with pytest.raises(KeyError, match="not yet ported"):
        configs.get("llama3.2-1b")
