"""Import hygiene of the benchmark: nothing it runs imports JAX or the JAX
package, and its yardstick (the reference and the counts) imports nothing
of the program. Top-level module names are compared whole."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "marconet_tpu"}
PROGRAM = "marconet_tpu_torch"


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    found = FORBIDDEN & set(_imports(path))
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_yardstick_imports_no_program(sub):
    root = os.path.join(BENCH, sub)
    for f in sorted(os.listdir(root)):
        if f.endswith(".py"):
            mods = set(_imports(os.path.join(root, f)))
            assert PROGRAM not in mods, f"{sub}/{f} imports the program"


def test_top_level_names_compared_whole():
    """``marconet_tpu_torch`` begins with ``marconet_tpu`` and is allowed."""
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    from port_bench import harness
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "marconet_tpu")
