"""What the benchmark imports, read from its sources: nothing of JAX or
of the JAX package anywhere, and nothing of the program in the
reference.  Names are compared whole by their part before the first dot,
so ``lk_tpu_torch`` is not ``lk_tpu``."""

from __future__ import annotations

import ast

import pytest

from gpubench import harness

SOURCES = sorted(harness.HERE.rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "lk_tpu"}


def imported(path) -> set:
    """Top-level names of every module ``path`` imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not imported(path) & NEVER


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.relative_to(
        harness.HERE).parts],
    ids=lambda p: str(p.relative_to(harness.HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "lk_tpu_torch" not in imported(path)


def test_the_check_compares_names_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import lk_tpu_torch.flow\nfrom jax import numpy\n")
    assert imported(src) == {"lk_tpu_torch", "jax"}
    assert imported(src) & NEVER == {"jax"}
