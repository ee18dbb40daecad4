"""No module under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program under test. Each import's
top-level name (the part before the first dot) is compared whole, so
`mmlspark_tpu_torch` is not taken for `mmlspark_tpu`."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mmlspark_tpu"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mmlspark_tpu_torch" not in imported_tops(path)
    assert "mmlspark_tpu_torch" not in path.read_text()


def test_the_whole_name_is_compared():
    assert "mmlspark_tpu_torch".split(".")[0] not in FORBIDDEN
