"""No module of the benchmark imports JAX, Flax or the JAX package
(``repro``, compared whole: ``repro_torch`` is the program), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative imports
    resolve inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)
    # nor the benchmark's modules that call the program
    relative = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            relative |= set((node.module or "").split("."))
            relative |= {a.name for a in node.names}
    assert not relative & {"port", "drivers", "harness", "faults"}


def test_the_guard_sees_what_it_guards(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import plan\n"
                   "import repro_torch\nfrom . import x\n")
    assert imported(bad) == {"jax", "repro", "repro_torch"}
