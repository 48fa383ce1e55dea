"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program under test.  Top-level module
names are compared whole: ``diga_tpu_torch`` begins with ``diga_tpu``."""

from __future__ import annotations

import ast
import os

import pytest

from benchmark.harness.manifest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "diga_tpu"}
SOURCES = sorted(os.path.relpath(os.path.join(d, f), HERE)
                 for d, _, files in os.walk(HERE) for f in files if f.endswith(".py"))


def top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_anywhere(rel):
    assert not top_level_imports(os.path.join(HERE, rel)) & FORBIDDEN


@pytest.mark.parametrize("rel", [s for s in SOURCES if s.startswith("reference" + os.sep)])
def test_reference_imports_nothing_of_the_program(rel):
    names = top_level_imports(os.path.join(HERE, rel))
    assert "diga_tpu_torch" not in names and not names & FORBIDDEN


def test_whole_names_are_compared():
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "diga_tpu_torch".split(".")[0] not in FORBIDDEN
