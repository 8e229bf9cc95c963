"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cython3dmodelrenderer_tpu"}
PROGRAM = "cython3dmodelrenderer_tpu_torch"
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_check_compares_whole_names():
    assert PROGRAM not in FORBIDDEN
    assert PROGRAM.startswith("cython3dmodelrenderer_tpu")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert PROGRAM not in path.read_text()


def test_no_file_reads_the_jax_benchmark():
    for path in SOURCES:
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        assert "bench.py" not in text and "BENCH_" not in text, path
