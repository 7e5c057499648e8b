"""Nothing under perfbench/ imports JAX or the JAX package, and the frozen
reference imports nothing of the port: each import's top-level name (the
part before the first dot) compared whole."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "reinforcement_learning_tpu"}
PORT = "reinforcement_learning_torch"


def imported_tops(source: str) -> set:
    tops = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported_tops(path.read_text()) & NEVER


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_tops(path.read_text())


def test_whole_names():
    # the port's name begins with the JAX package's, so names are
    # compared whole, never by prefix
    assert imported_tops("import reinforcement_learning_torch.envs as e\n"
                         "from reinforcement_learning_torch import maths"
                         ) == {PORT}
    assert imported_tops("from jax import numpy\nimport flax.linen\n"
                         "import reinforcement_learning_tpu.envs"
                         ) == NEVER - {"jaxlib"}
