"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "superpoint_graph_tpu"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH_DIR / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "superpoint_graph_tpu_torch" not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path)


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from portbench import run

    assert "superpoint_graph_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "superpoint_graph_tpu.ops",
                        types.ModuleType("superpoint_graph_tpu.ops"))
    assert run.forbidden_modules() == ["superpoint_graph_tpu"]
    monkeypatch.delitem(sys.modules, "superpoint_graph_tpu.ops")
    monkeypatch.setitem(sys.modules, "superpoint_graph_tpu_torch_x",
                        types.ModuleType("superpoint_graph_tpu_torch_x"))
    assert "superpoint_graph_tpu" not in run.forbidden_modules()
