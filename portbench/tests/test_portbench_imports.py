"""What the benchmark's modules import, by whole top-level name: no
module of the benchmark imports JAX or the JAX package, and the
references and traffic import nothing of the program either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tempo_tpu"}
PROGRAM = "tempo_tpu_torch"
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in
                                  ("reference", "traffic")],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_traffic_stand_alone(path):
    assert PROGRAM not in _tops(path)


def test_the_check_compares_whole_names():
    # the program's name begins with the JAX package's: only whole
    # top-level names may match
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "tempo_tpu" in FORBIDDEN
