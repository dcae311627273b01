"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the plain
reference nothing of the program it judges."""

import ast
import sys
import types
from pathlib import Path

import pytest

from _cpu import rehearse

PKG = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & BANNED


REFERENCE = sorted((PKG / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(PKG)))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    assert "repro_torch" not in _top_level_imports(path)
    assert "regbench" not in _top_level_imports(path)
    # relative imports stay inside the reference package
    depth = len(path.relative_to(PKG / "reference").parts)
    assert all(node.level <= depth for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom))


def test_the_measured_process_holds_no_jax(capsys, monkeypatch):
    rc, line = rehearse(capsys, "claire256-fp32.solve")
    assert rc == 0 and line is not None
    assert not {m.split(".")[0] for m in sys.modules} & BANNED
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = rehearse(capsys, "claire256-fp32.solve")
    assert rc == 4 and line is None
