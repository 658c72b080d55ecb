"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole, so the port's package passes), and the plain
reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "coslam_tpu"}


def _modules():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_imported(path)) & FORBIDDEN


def test_whole_name_comparison():
    names = {"coslam_torch", "jaxtyping", "coslam_tpu"}
    assert {n for n in names if n.split(".")[0] in FORBIDDEN} == {
        "coslam_tpu"}


@pytest.mark.parametrize("name", ["reference.py", "yardstick.py"])
def test_reference_imports_nothing_of_the_program(name):
    imported = set(_imported(os.path.join(HERE, name)))
    assert "coslam_torch" not in imported and not imported & FORBIDDEN
