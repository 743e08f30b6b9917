"""What the benchmark's modules import: never JAX or the JAX package
(compared by whole top-level names: ``repro_torch`` is not ``repro``), and
nothing of the program under test in the reference."""
from __future__ import annotations

import ast
from pathlib import Path

from conftest import PORTBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORTBENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_top_level_imports(f)) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    files = sorted((PORTBENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = set(_top_level_imports(f))
        assert names <= {"__future__", "functools", "hashlib", "math",
                         "typing", "numpy", "torch", "scipy"}, (f, names)
